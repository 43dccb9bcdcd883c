// One walk over the headers of a live feed's frames: the capture filter, the
// payload decode and the gather into a matrix, in one call
// (io/live_walk.py binds it; parallel/stream.py feeds the live loop with it).
//
// Ethernet frames only (the unknown-linktype fallback of io/decode.py), no
// VLAN or IPv6 extension, non-strict: the rows equal io/decode.py's
// extract_payloads(pcap, mode, keep_invalid=True) masked by
// bpf_protocol_mask(pcap, mode) when bpf_filter is set, and unmasked when it
// is not, row for row.  Those two functions stay the spec.
//
// Every read is guarded by the frame's caplen, and each caplen is clipped to
// the buffer first, so no index array can send a read past either.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kEthHlen = 14;
constexpr int64_t kMinIpHlen = 20;
constexpr int64_t kUdpHlen = 8;
constexpr int64_t kMinTcpHlen = 20;
constexpr int64_t kIpv6Hlen = 40;
constexpr int kEthertypeIpv4 = 0x0800;
constexpr int kEthertypeIpv6 = 0x86DD;
constexpr int kIpprotoUdp = 17;
constexpr int kIpprotoTcp = 6;
constexpr int kIpv6Fragment = 44;

// bpf_protocol_mask's bit: ethertype IPv4 and its protocol byte, or IPv6
// and its next header, directly or behind a fragment header.
bool filter_passes(const uint8_t *p, int64_t cap, int want) {
  if (cap < kEthHlen) return false;
  const int et = (p[12] << 8) | p[13];
  if (et == kEthertypeIpv4) return cap >= kEthHlen + 10 && p[kEthHlen + 9] == want;
  if (et != kEthertypeIpv6 || cap < kEthHlen + 7) return false;
  const int next = p[kEthHlen + 6];
  return next == want || (next == kIpv6Fragment && cap >= kEthHlen + kIpv6Hlen + 1 &&
                          p[kEthHlen + kIpv6Hlen] == want);
}

// decode_headers' predicate and geometry (the native msm_decode with strict
// off), then extract_payloads' clip to the captured bytes: the payload's
// offset in the frame and the bytes to copy, 0 for an invalid frame.
int64_t payload_bytes(const uint8_t *p, int64_t cap, int64_t L, int mode, int64_t *poff) {
  const bool can_ihl = cap >= kEthHlen + 1;
  const int64_t iplen = can_ihl ? (p[kEthHlen] & 0x0F) * 4 : 0;
  bool ok;
  if (mode == 0) {
    ok = L >= kEthHlen && L - kEthHlen >= kMinIpHlen && can_ihl && L - kEthHlen >= iplen &&
         cap >= kEthHlen + 10 && p[kEthHlen + 9] == kIpprotoUdp &&
         L - kEthHlen - iplen >= kUdpHlen;
    *poff = kEthHlen + iplen + kUdpHlen;
  } else {
    ok = can_ihl && iplen >= kMinIpHlen && cap >= kEthHlen + iplen + 13;
    const int64_t tcplen = ok ? (p[kEthHlen + iplen + 12] >> 4) * 4 : 0;
    ok = ok && tcplen >= kMinTcpHlen;
    *poff = kEthHlen + iplen + tcplen;
  }
  if (!ok || L - *poff < 0) return 0;
  const int64_t avail = cap - *poff > 0 ? cap - *poff : 0;
  return L - *poff < avail ? L - *poff : avail;
}

}  // namespace

// Walk frames [0, n) of a capture slice.  A frame is kept when bpf_filter is
// 0 or its filter bit is set; kept frame r's index goes to idx[r], its
// payload length to lengths[r], and its payload to row r of out, a
// C-contiguous matrix of width *width = max(longest kept payload, 1),
// zero past each length.  A kept frame without a valid payload is a
// zero-length row.  out holds out_cap bytes; returns the kept count, or -1
// (nothing written to out) when rows * width exceeds out_cap.  mode is 0 for
// udp and 1 for tcp.
extern "C" int64_t msm_live_walk(const uint8_t *buf, int64_t nbuf, const int64_t *offsets,
                                 const int64_t *caplens, const int64_t *origlens, int64_t n,
                                 int mode, int bpf_filter, uint8_t *out, int64_t out_cap,
                                 int32_t *lengths, int64_t *idx, int64_t *width) {
  const int want = mode == 0 ? kIpprotoUdp : kIpprotoTcp;
  std::vector<int64_t> starts, lens;
  starts.reserve(n > 0 ? n : 0);
  lens.reserve(n > 0 ? n : 0);
  int64_t rows = 0, lmax = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t off = offsets[i];
    int64_t cap = caplens[i];
    if (off < 0 || off > nbuf || cap < 0) cap = 0;
    else if (cap > nbuf - off) cap = nbuf - off;
    const uint8_t *p = cap > 0 ? buf + off : buf;
    if (bpf_filter && !filter_passes(p, cap, want)) continue;
    int64_t poff = 0;
    const int64_t len = payload_bytes(p, cap, origlens[i], mode, &poff);
    idx[rows] = i;
    lengths[rows] = static_cast<int32_t>(len);
    starts.push_back(off + poff);
    lens.push_back(len);
    if (len > lmax) lmax = len;
    rows++;
  }
  const int64_t w = lmax > 0 ? lmax : 1;
  *width = w;
  if (rows > out_cap / w) return -1;
  for (int64_t r = 0; r < rows; r++) {
    uint8_t *row = out + r * w;
    const int64_t len = lens[r];
    if (len > 0) std::memcpy(row, buf + starts[r], static_cast<size_t>(len));
    std::memset(row + len, 0, static_cast<size_t>(w - len));
  }
  return rows;
}
