// Every match of a tile, in order, in one launch on Hopper (sm_90a):
// the kernel of ops/cuda_window.window_find.
//
// It replaces no TPU kernel: the JAX package finds matches with the XLA
// bitmap multithreading_string_matching_tpu/ops/window.py::
// _window_bitmap_group and a host np.nonzero + lexsort in find_matches.
//
// What it computes, for a tile payload uint8[n, L] (n * L < 2^31), row
// lengths int32[n] and a window table words/masks uint32[U, K], lens
// int32[U] (probe.cuh's window form):
//   w_k      = little-endian uint32 of payload[r, s+4k .. s+4k+3], 0 past L
//   hit      = AND_k (w_k & masks[u,k]) == words[u,k]  and  s + lens[u] <= lengths[r]
// every hit as an int64 triple (r, s, u) in out[M, 3], ordered by r, then
// s, then u, and M in scratch[1].
//
// How, in one launch and with no sort:
// - Flattened order.  Row r, start s is position q = r * L + s of the flat
//   [0, n * L) range, so ordering by q, then u, is the required order.  The
//   range is cut into tiles of kTile positions.  A tile stages its bytes
//   and the 4K - 1 after them (words 1..K-1 of its last windows); a window
//   masks the bytes at or past its own row's end L to 0, because the staged
//   bytes there are the next row's (a NUL-tailed pattern in a row whose
//   length exceeds L must see zeros, as the JAX package does).
// - Persistent blocks (as many as are resident) take tiles in increasing
//   order from a ticket counter.  Thread 0 stages the next tile with one
//   bulk copy (cp.async.bulk, the tensor memory accelerator, completing on
//   an mbarrier) into the other stage of a 2-stage ring while the block
//   scans the current one, and asks for the ticket after it an iteration
//   before it is needed.  A tile's base is not 16-byte aligned in general
//   (row slices, any L): the copy starts at the boundary at or below it and
//   reads add the misalignment; a 16-byte chunk that would cross either end
//   of the n * L bytes is read a byte at a time, never past them.
// - The probe table is probe.cuh's build_table (word 0 as the probe), built
//   once a block for the launch.
// - Sweep 1: warp w scans the tile's positions [w * kSpan, (w + 1) * kSpan)
//   in steps of 128, lane l taking 4 neighbouring positions of each step: 3
//   staged words give its 4 windows (neighbouring lanes read neighbouring
//   words: no bank conflicts), and each window takes one test in the 16-bit
//   key map, without branches.  Only a position the map lets through
//   (~1e-3 of the stand-in tile's) takes the full probe: the hash chains,
//   the fit test and words 1..K-1.  A lane keeps a 64-bit mask of its
//   positions with hits.
// - Decoupled look-back (Merrill & Garland 2016): after sweep 1 the tile's
//   count is published as an aggregate flag; kDefer tiles later (so the
//   predecessors' flags are in by then) the whole block reads kLook
//   kThreads predecessors' flags at once (prefetched at the top of the
//   iteration), sums them back to the nearest inclusive prefix and
//   publishes its own.  The flags are per-launch scratch that the entry
//   point clears.  Tiles are claimed in order and every block sweeps its
//   tiles in claim order and publishes an aggregate without waiting, so no
//   look-back waits on a tile whose aggregate cannot come: no deadlock.
// - Sweep 2 (tiles with hits only), from device memory (the stage is
//   reused by then; the bytes are in L2): the steps where some lane hit, in
//   order; a warp exclusive scan of the lanes' counts gives each lane its
//   first slot, and a position's patterns are written in ascending u (a
//   repeated "least u above the last written" walk of its chains, exact for
//   any number of patterns at one position).  A lane's first hit keeps its
//   count and least pattern from sweep 1 (a register a pending tile), so
//   the usual single hit is written with no walk.  Slots at or past cap
//   are not written; the last tile's inclusive prefix is M.
// - A set of more than kMaxChunk patterns is hashed a chunk at a time and
//   finishes each tile at once: sweep 1 runs chunk after chunk (the table
//   rebuilt in between) and keeps each position's count in shared memory;
//   a warp scan turns the counts into each position's end slot, and sweep
//   2 runs the chunks in reverse, each writing its hits just below the
//   position's end and moving the end down, so u stays ascending without a
//   sort (2C - 2 rebuilds a tile).
//
// What bounds it on an H100: the tile read once from device memory (3.35
// TB/s: 0.038 ms for the 128 MB stand-in tile) against ~4 integer
// operations a position for the window and the map test (0.031 ms at the
// int32 rate).  What holds it above that (PERF.md, tools/find_turns.py):
// the per-tile structure (staging, tickets, barriers, look-back), the map
// test's random shared-memory words (bank conflicts), and sweep 2.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using msm_probe::kEnd;
using msm_probe::kMaxMasks;
using msm_probe::kThreads;
using msm_probe::kWarps;

constexpr int kTile = 16384;           // flat positions a tile
constexpr int kSpan = kTile / kWarps;  // positions a warp scans in a tile
constexpr int kSteps = kSpan / 128;    // steps of 128 positions, 4 a lane: 4 bits each
constexpr int kStages = 2;             // tiles in the shared-memory ring
constexpr int kMaxWords = 2048;        // K limit: a stage holds kTile + 4K bytes
constexpr int kLook = 1;               // look-back flags a thread reads at once
constexpr int kTickets = 4;            // the ring of claimed tiles
constexpr unsigned kFull = 0xFFFFFFFFu;
// A tile's flag: 0 until published, then its count (aggregate) or its
// inclusive prefix, tagged in the two top bits.
constexpr unsigned long long kAggregate = 1ull << 62, kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;
static_assert(4 * kSteps == 64, "a lane's position mask is 64 bits");

struct FindArgs {
  const uint8_t* payload;       // uint8[n, L]
  const int32_t* lengths;       // int32[n]
  const uint32_t* words;        // uint32[U, K]
  const uint32_t* masks;        // uint32[U, K]
  const int32_t* lens;          // int32[U]
  int64_t* out;                 // int64[cap, 3]
  int64_t cap;
  unsigned long long* scratch;  // [0] ticket, [1] M, [2 + t] tile t's flag
  int64_t total;                // n * L
  int n, L, U, K, chunk, bits, ntiles, stage_bytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait for phase `parity` of the barrier to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A flag carries its whole message (tag and value in one 64-bit word) and
// guards no other data, so relaxed device-scope accesses suffice.
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(flag), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long peek(const unsigned long long* flag) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(flag) : "memory");
  return v;
}

// Stage tile t's bytes [t * kTile, t * kTile + kTile + 4K - 1), clipped at
// n * L, into dst from the 16-byte boundary at or below the first; thread 0
// at work.  The 16-byte chunks inside the n * L bytes go in one bulk copy
// (the tensor memory accelerator, completing on bar); a chunk that crosses
// either end (the first tile's head, the last tile's tail) is read a byte
// at a time, never past them, before the barrier's arrival.
__device__ __forceinline__ void stage_tile(const FindArgs& a, uint4* dst, int t, uint64_t* bar) {
  const int64_t first = static_cast<int64_t>(t) * kTile;
  const int64_t lo0 = first - static_cast<int64_t>(reinterpret_cast<uintptr_t>(a.payload + first) & 15);
  const int64_t want = first + kTile + 4 * a.K - 1;
  const int nchunks = static_cast<int>(((want < a.total ? want : a.total) - lo0 + 15) >> 4);
  const int c0 = lo0 < 0 ? 1 : 0;                          // first chunk inside
  const int64_t inside = (a.total - lo0) >> 4;             // chunks ending at or before n * L
  const int c1 = static_cast<int>(inside < nchunks ? inside : nchunks);
  for (int c = 0; c < nchunks; ++c) {
    if (c == c0 && c1 > c0) c = c1;  // the bulk copy's chunks
    if (c >= nchunks) break;
    const int64_t lo = lo0 + 16 * c;
    uint32_t b[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 16; ++i) {
      const int64_t x = lo + i;
      if (x >= 0 && x < a.total) b[i >> 2] |= static_cast<uint32_t>(a.payload[x]) << ((i & 3) * 8);
    }
    dst[c] = make_uint4(b[0], b[1], b[2], b[3]);
  }
  const uint32_t bytes = c1 > c0 ? 16u * static_cast<uint32_t>(c1 - c0) : 0u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + c0)), "l"(a.payload + lo0 + 16 * c0), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// Row r and start s of flat position q (below 2^31 + kTile: unsigned
// 32-bit division).
__device__ __forceinline__ void split(unsigned q, int L, int& r, int& s) {
  const unsigned row = q / static_cast<unsigned>(L);
  r = static_cast<int>(row);
  s = static_cast<int>(q - row * static_cast<unsigned>(L));
}

// Word w, its bytes at or past the row's end (room bytes of the row from
// its first byte on) read as 0.
__device__ __forceinline__ uint32_t row_mask(uint32_t w, int room) {
  return w & __funnelshift_lc(0xFFFFFFFFu, 0u, 8 * max(0, min(room, 4)));
}

// The little-endian word at flat byte x of the tile, read from device memory
// a byte at a time (bytes at or past n * L read as 0): sweep 2's reads, after
// the tile's stage is reused.
__device__ __forceinline__ uint32_t flat_word(const FindArgs& a, int64_t x) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x + i < a.total) w |= static_cast<uint32_t>(__ldg(a.payload + x + i)) << (8 * i);
  }
  return w;
}

// The block's probe table: shared memory, the registers of its build, and
// its chunk's patterns.
struct Table {
  const uint2* ent;
  const uint32_t* head;
  const uint32_t* map;
  const uint32_t* mask;   // the distinct probe masks (shared), 0 past nm
  const uint32_t* words;  // offset to the chunk's first pattern
  const uint32_t* masks;
  const int32_t* lens;
  int u0, shift;
  msm_probe::Probe pr;
};

// Call hit(j) for every pattern j of the table's chunk that matches at one
// start s: word(k) is the window's k-th word as stored (row_mask masks it),
// room = L - s the bytes left in the row and fit = len - s the bytes a
// match may span (none fits where fit <= 0).  Rare (a position the key map
// let through), so kept small: the masks are read from shared memory in a
// rolled loop.
template <class W, class F>
__device__ __forceinline__ void visit(const Table& t, int K, int room, int64_t fit, W word, F hit) {
  const uint32_t x = row_mask(word(0), room);
  auto candidate = [&](uint32_t j) {
    if (__ldg(t.lens + j) > fit) return;
    const int64_t g = static_cast<int64_t>(j) * K;
    for (int k = 1; k < K; ++k) {
      if ((row_mask(word(k), room - 4 * k) & __ldg(t.masks + g + k)) != __ldg(t.words + g + k)) return;
    }
    hit(j);
  };
  if (!t.pr.map_on || ((t.map[(x & 0xFFFFu) >> 5] >> (x & 31u)) & 1u)) {
#pragma unroll 1
    for (int i = 0; i < t.pr.nm; ++i) {
      const uint32_t key = x & t.mask[i];
      for (uint32_t e = t.head[msm_probe::bucket(key, i, t.shift)]; e != kEnd;) {
        const uint2 ent = t.ent[e];
        if (ent.x == key && (ent.y >> 16) == static_cast<uint32_t>(i)) candidate(e);
        e = ent.y & 0xFFFFu;
      }
    }
  }
  if (t.pr.wild != kEnd && t.pr.wild_min <= fit) {
    for (uint32_t e = t.pr.wild; e != kEnd;) {
      const uint2 ent = t.ent[e];
      if ((x & __ldg(t.masks + static_cast<int64_t>(e) * K)) == ent.x) candidate(e);
      e = ent.y & 0xFFFFu;
    }
  }
}

// The hits of one position (row r, start s; word(k) its window's k-th word
// as stored): their count and the least pattern among them, or (emit) each
// written at slots slot.. in ascending pattern order, the first being
// `least` and each next the least above the last written (a walk of the
// chains each); slots at or past cap are not written.
template <class W>
__device__ __forceinline__ int count_at(const FindArgs& a, const Table& t, int s, int len, W word,
                                        uint32_t& least) {
  int h = 0;
  least = UINT_MAX;
  visit(t, a.K, a.L - s, static_cast<int64_t>(len) - s, word, [&](uint32_t j) {
    ++h;
    least = min(least, j);
  });
  return h;
}
template <class W>
__device__ __forceinline__ void emit(const FindArgs& a, const Table& t, int r, int s, int len, W word,
                                     int h, uint32_t least, unsigned long long slot) {
  uint32_t best = least;
  for (int k = 0; k < h; ++k) {
    if (k > 0) {
      const uint32_t last = best;
      best = UINT_MAX;
      visit(t, a.K, a.L - s, static_cast<int64_t>(len) - s, word, [&](uint32_t j) {
        if (j > last && j < best) best = j;
      });
    }
    if (slot + k < static_cast<unsigned long long>(a.cap)) {
      int64_t* tr = a.out + 3 * (slot + k);
      tr[0] = r;
      tr[1] = s;
      tr[2] = t.u0 + static_cast<int64_t>(best);
    }
  }
}

// 4 blocks a SM: registers capped at 64 (a few spill), which measured faster
// than 80 registers at 3 blocks a SM (tools/find_turns.py).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads, 4) window_find_kernel(const FindArgs a) {
  // An unchunked set finishes a tile (look-back and sweep 2) kDefer
  // iterations after sweeping it, so its predecessors' counts are in by
  // then.  Sweep 2 reads the tile's bytes from device memory, so the
  // 2-stage ring is free at once (a ring that keeps the stage for sweep 2
  // needs a third stage and was no faster: PERF.md).  A chunked set keeps
  // the tile's position counts (s_end) and finishes each tile at once.
  constexpr int kDefer = kChunked ? 0 : 2;
  constexpr int kSlots = kDefer + 1;  // tiles with shared state
  extern __shared__ uint4 smem[];
  const int sw = a.stage_bytes / 16;
  uint2* s_ent = reinterpret_cast<uint2*>(smem + kStages * sw);     // [chunk]
  uint32_t* s_head = reinterpret_cast<uint32_t*>(s_ent + a.chunk);  // [1 << bits]
  uint32_t* s_end = s_head + (1 << a.bits);                         // chunked: [kTile]
  __shared__ msm_probe::TableShared st;
  __shared__ uint64_t s_full[kStages];    // stage s's bytes are in (one phase a use)
  __shared__ int s_tile[kTickets];        // the tile of iteration i at i % kTickets
  __shared__ unsigned long long s_warp[kSlots][kWarps];  // warps' counts, then first slots
  __shared__ unsigned long long s_count[kSlots];         // a tile's count
  // Look-back state, two sets used in turns, so the one not in use is
  // reset without a barrier of its own.
  __shared__ unsigned long long s_sum[2];                // predecessors' counts
  __shared__ int s_stop[2];                              // the nearest prefix

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = 1 << a.bits;
  const int nchunks = (a.U + a.chunk - 1) / a.chunk;
  const int wfirst = warp * kSpan;
  unsigned long long* flags = a.scratch + 2;

  Table tab;
  tab.ent = s_ent;
  tab.head = s_head;
  tab.map = st.map;
  tab.mask = st.mask;
  tab.shift = 32 - a.bits;
  int built = -1;
  // Build chunk c's table unless it is the one built (block-uniform).
  auto use_chunk = [&](int c) {
    if (c == built) return;
    tab.u0 = c * a.chunk;
    tab.words = a.words + static_cast<int64_t>(tab.u0) * a.K;
    tab.masks = a.masks + static_cast<int64_t>(tab.u0) * a.K;
    tab.lens = a.lens + tab.u0;
    tab.pr = msm_probe::build_table(st, s_ent, s_head, nullptr, T, tab.shift, tab.words, tab.masks,
                                    tab.lens, min(a.chunk, a.U - tab.u0), a.K, 0);
    built = c;
  };
  use_chunk(0);

  auto first_of = [](int t) { return static_cast<int64_t>(t) * kTile; };
  auto npos_of = [&](int t) {
    return static_cast<int>(a.total - first_of(t) < kTile ? a.total - first_of(t) : kTile);
  };

  // A look-back window: flag k of a thread is tile t - 1 - (k kThreads +
  // thread), so the block reads kLook kThreads predecessors at once.
  using Window = unsigned long long[kLook];
  auto look = [&](int t, Window& f) {
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int jj = t - 1 - (k * kThreads + static_cast<int>(threadIdx.x));
      f[k] = jj >= 0 ? peek(flags + jj) : kPrefix;
    }
  };

  int looks = 0;  // look-backs so far (block-uniform)

  // The look-back and sweep 2 of tile t, swept at iteration ti: its warps'
  // counts are in s_warp[ti % kSlots] and s_count[ti % kSlots], hits holds
  // this lane's positions with hits, memo (h << 16 | least pattern) those
  // of the first of them as sweep 1 found them (0: not kept), and f tile
  // t's first look-back
  // window, read earlier (a flag read as 0 is read again; one read as an
  // aggregate that is a prefix by now only makes the walk longer).
  // Block-uniform.
  auto finish = [&](int t, int ti, unsigned long long hits, uint32_t memo, Window& f) {
    const int si = ti % kSlots;
    const unsigned long long count = s_count[si];
    unsigned long long excl = 0;
    if (t > 0) {
      // Back to the nearest inclusive prefix; add up the flags from there.
      const int ls = looks++ & 1;
      for (int base = t;; base -= kLook * kThreads) {
        int near = INT_MAX;
#pragma unroll
        for (int k = 0; k < kLook; ++k) {
          const int dist = k * kThreads + static_cast<int>(threadIdx.x);
          while (f[k] == 0ull) f[k] = peek(flags + (base - 1 - dist));
          if (f[k] >= kPrefix) near = min(near, dist);
        }
        near = __reduce_min_sync(kFull, near);
        if (lane == 0 && near != INT_MAX) atomicMin(&s_stop[ls], near);
        __syncthreads();
        const int stop = s_stop[ls];
        unsigned long long v = 0;
#pragma unroll
        for (int k = 0; k < kLook; ++k)
          if (k * kThreads + static_cast<int>(threadIdx.x) <= stop) v += f[k] & kValue;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane == 0 && v != 0ull) atomicAdd(&s_sum[ls], v);
        __syncthreads();
        if (stop != INT_MAX) break;
        look(base - kLook * kThreads, f);
      }
      excl = s_sum[ls];
      if (threadIdx.x == 0) {
        publish(flags + t, kPrefix | (excl + count));
        s_sum[ls ^ 1] = 0ull;
        s_stop[ls ^ 1] = INT_MAX;
      }
    }
    if (threadIdx.x == 0 && t == a.ntiles - 1) a.scratch[1] = excl + count;
    if (count == 0) return;

    // -- sweep 2: write the tile's hits in order ----------------------------
    // Lane l's bit 4 i + j is position wfirst + 128 i + 4 l + j.
    const int64_t first = first_of(t);
    const int npos = npos_of(t);
    auto pos = [&](int bit) { return wfirst + 128 * (bit >> 2) + 4 * lane + (bit & 3); };
    // Position q's window, from device memory.
    auto window = [&](int q) {
      return [&, q](int k) { return flat_word(a, first + q + 4 * k); };
    };
    if (!kChunked) {
      // The steps where some lane hit, in order; a warp scan of the lanes'
      // counts gives each lane its first slot in the step.
      unsigned long long slot = excl + s_warp[si][warp];
      const unsigned long long any =
          (static_cast<unsigned long long>(__reduce_or_sync(kFull, static_cast<unsigned>(hits >> 32))) << 32)
          | __reduce_or_sync(kFull, static_cast<unsigned>(hits));
      const int lowest = __ffsll(static_cast<long long>(hits)) - 1;
      for (unsigned long long m = any; m != 0;) {
        const int step = (__ffsll(static_cast<long long>(m)) - 1) >> 2;
        m &= ~(0xFull << (4 * step));
        int hs[4], rs[4], ss[4], ls[4], h = 0;
        uint32_t us[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hs[j] = 0;
          if ((hits >> (4 * step + j)) & 1ull) {
            const int q = pos(4 * step + j);
            split(static_cast<unsigned>(first + q), a.L, rs[j], ss[j]);
            if (4 * step + j == lowest && memo != 0u) {  // no second walk for one hit
              hs[j] = static_cast<int>(memo >> 16);
              us[j] = memo & 0xFFFFu;
              ls[j] = hs[j] > 1 ? __ldg(a.lengths + rs[j]) : 0;
            } else {
              ls[j] = __ldg(a.lengths + rs[j]);
              hs[j] = count_at(a, tab, ss[j], ls[j], window(q), us[j]);
            }
            h += hs[j];
          }
        }
        unsigned incl = h;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        unsigned long long at = slot + incl - h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (hs[j]) {
            emit(a, tab, rs[j], ss[j], ls[j], window(pos(4 * step + j)), hs[j], us[j], at);
            at += hs[j];
          }
        }
        slot += __shfl_sync(kFull, incl, 31);
      }
    } else {
      // Each position's count -> its end slot in the tile (a position's
      // hits of all chunks end there), then the chunks in reverse.
      unsigned long long run = s_warp[si][warp];
      const unsigned long long any =
          (static_cast<unsigned long long>(__reduce_or_sync(kFull, static_cast<unsigned>(hits >> 32))) << 32)
          | __reduce_or_sync(kFull, static_cast<unsigned>(hits));
      for (unsigned long long m = any; m != 0;) {
        const int step = (__ffsll(static_cast<long long>(m)) - 1) >> 2;
        m &= ~(0xFull << (4 * step));
        unsigned hs[4], h = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hs[j] = (hits >> (4 * step + j)) & 1ull ? s_end[pos(4 * step + j)] : 0u;
          h += hs[j];
        }
        unsigned incl = h;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        unsigned long long e = run + incl - h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e += hs[j];
          if (hs[j]) s_end[pos(4 * step + j)] = static_cast<uint32_t>(e);
        }
        run += __shfl_sync(kFull, incl, 31);
      }
      for (int c = nchunks - 1; c >= 0; --c) {
        use_chunk(c);
        for (unsigned long long m = hits; m != 0; m &= m - 1) {
          const int q = pos(__ffsll(static_cast<long long>(m)) - 1);
          int r, s;
          split(static_cast<unsigned>(first + q), a.L, r, s);
          const int len = __ldg(a.lengths + r);
          uint32_t least;
          const int h = count_at(a, tab, s, len, window(q), least);
          if (h) {
            const uint32_t e = s_end[q] - h;
            emit(a, tab, r, s, len, window(q), h, least, excl + e);
            s_end[q] = e;
          }
        }
      }
    }
  };

  // The tiles swept and not finished yet, oldest first (block-uniform),
  // and the oldest one's first look-back window.
  int pend_t[kDefer + 1];
  unsigned long long pend_hits[kDefer + 1];
  uint32_t pend_memo[kDefer + 1];
#pragma unroll
  for (int i = 0; i <= kDefer; ++i) pend_t[i] = -1;
  Window fw;

  // Tiles are staged kAhead iterations ahead of their sweep and claimed one
  // iteration before that: thread 0 uses a ticket an iteration after asking
  // for it, so the atomic's round trip is never waited for.
  constexpr int kAhead = kStages - 1;
  static_assert(kAhead >= 1 && kAhead + 2 <= kTickets, "the rings need a tile in flight");
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      s_sum[i] = 0ull;
      s_stop[i] = INT_MAX;
    }
    for (int i = 0; i < kStages; ++i) mbar_init(&s_full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i <= kAhead; ++i) s_tile[i] = static_cast<int>(atomicAdd(a.scratch, 1ull));
    for (int i = 0; i < kAhead; ++i) {
      if (s_tile[i] < a.ntiles) stage_tile(a, smem + i * sw, s_tile[i], &s_full[i]);
    }
  }
  __syncthreads();
  for (int it = 0;; ++it) {
    const int cur = it % kStages, nxt = (it + kAhead) % kStages;
    const int t = s_tile[it % kTickets];  // past the last tile: later tickets are larger
    const int tn = s_tile[(it + kAhead) % kTickets];
    // Thread 0 stages tile tn (issued first: its other requests must not
    // hold the copy back) and asks for the ticket after it.
    if (threadIdx.x == 0 && t < a.ntiles && tn < a.ntiles) stage_tile(a, smem + nxt * sw, tn, &s_full[nxt]);
    unsigned long long ticket = 0;
    if (threadIdx.x == 0) ticket = atomicAdd(a.scratch, 1ull);
    if (kDefer > 0 && pend_t[0] > 0) look(pend_t[0], fw);
    unsigned long long hit_bits = 0;  // this lane's positions with hits
    uint32_t memo = 0;                // and what sweep 1 found at the first (finish)
    if (t < a.ntiles) {
      mbar_wait(&s_full[cur], static_cast<uint32_t>(it / kStages) & 1u);  // this tile's bytes are in
      __syncthreads();

      const uint32_t* stage = reinterpret_cast<const uint32_t*>(smem + cur * sw);
      const int64_t first = first_of(t);
      const int d = static_cast<int>(reinterpret_cast<uintptr_t>(a.payload + first) & 15);
      const int npos = npos_of(t);
      // Lane l's positions at step i are wfirst + 128 i + 4 l + j, j < 4:
      // staged words (d + wfirst) / 4 + 32 i + l .. + 2 hold their windows,
      // shifted by the tile's misalignment d % 4 (neighbouring lanes read
      // neighbouring words: no bank conflicts).
      const uint32_t* wbase = stage + ((d + wfirst) >> 2) + lane;
      const int dm = (d & 3) * 8;

      // -- sweep 1: count ----------------------------------------------------
      unsigned cnt = 0;
      if (kChunked) {
        for (int j = 0; j < 4 * kSteps; ++j) s_end[wfirst + 128 * (j >> 2) + 4 * lane + (j & 3)] = 0u;
      }
      for (int c = 0; c < (kChunked ? nchunks : 1); ++c) {
        if (kChunked) use_chunk(c);
        // Every position takes the full probe where the map cannot gate it,
        // and in rows narrower than 8 bytes (a lane's 4 positions may then
        // span rows whose ends its masking below does not follow).
        const uint32_t every = !tab.pr.map_on || tab.pr.wild != kEnd || a.L < 8 ? 0xFu : 0u;
        // The hot loop: 3 staged words, 4 windows and 4 map tests a step,
        // and a bit in cand for each position the map lets through.  Only a
        // lane whose first start s is past L - 7 has windows that may cross
        // a row's end, and masks them (a position past L is the next row's,
        // with room to spare).  s moves 128 positions a step, (128 mod L)
        // within a row.  Steps past the tile's end read staged bytes that
        // are never used.
        int s;
        {
          int r;
          split(static_cast<unsigned>(first + wfirst + 4 * lane), a.L, r, s);
        }
        const int inc = 128 % a.L, near = a.L - 7;
        unsigned long long cand = 0;
#pragma unroll
        for (int step = 0; step < kSteps; ++step) {
          const uint32_t* w = wbase + 32 * step;
          const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
          const uint32_t v0 = __funnelshift_r(w0, w1, dm), v1 = __funnelshift_r(w1, w2, dm);
          uint32_t x[4] = {v0, __funnelshift_r(v0, v1, 8), __funnelshift_r(v0, v1, 16),
                           __funnelshift_r(v0, v1, 24)};
          if (s > near) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int room = a.L - s - j;
              x[j] = row_mask(x[j], room > 0 ? room : room + a.L);
            }
          }
          uint32_t nib = every;
#pragma unroll
          for (int j = 0; j < 4; ++j) nib |= ((st.map[(x[j] & 0xFFFFu) >> 5] >> (x[j] & 31u)) & 1u) << j;
          cand |= static_cast<unsigned long long>(nib) << (4 * step);
          s += inc;
          s = s >= a.L ? s - a.L : s;
        }
        // The full probe of the candidates (rare), in position order.  A
        // start at or past its row's length fits no pattern (lens >= 1):
        // the fit test drops it, so the length is waited for only at a
        // candidate.
        for (unsigned long long m = cand; m != 0; m &= m - 1) {
          const int bit = __ffsll(static_cast<long long>(m)) - 1;
          const int p = wfirst + 128 * (bit >> 2) + 4 * lane + (bit & 3);
          if (p >= npos) continue;
          int r, q;
          split(static_cast<unsigned>(first + p), a.L, r, q);
          const int len = __ldg(a.lengths + r);
          const int b = d + p;
          int h = 0;
          uint32_t least = UINT_MAX;
          visit(tab, a.K, a.L - q, static_cast<int64_t>(len) - q,
                [&](int k) { return msm_probe::word_at(stage, b + 4 * k); }, [&](uint32_t j) {
                  ++h;
                  least = min(least, j);
                });
          if (h) {
            cnt += h;
            // Candidates come in position order, so the first hit is the
            // lowest bit; a chunked set's count is whole only after its
            // last chunk, so it keeps no memo.
            if (!kChunked && hit_bits == 0 && h < 0x10000) memo = static_cast<uint32_t>(h) << 16 | least;
            hit_bits |= 1ull << bit;
            if (kChunked) s_end[p] += h;
          }
        }
      }
      const unsigned wsum = __reduce_add_sync(kFull, cnt);
      const int si = it % kSlots;
      if (lane == 0) s_warp[si][warp] = wsum;
      __syncthreads();
      // The tile's count, published at once; its warps' first slots.
      if (warp == 0) {
        const unsigned long long own = lane < kWarps ? s_warp[si][lane] : 0ull;
        unsigned long long v = own;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned long long u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += u;
        }
        const unsigned long long count = __shfl_sync(kFull, v, 31);
        if (lane < kWarps) s_warp[si][lane] = v - own;
        if (lane == 0) {
          s_count[si] = count;
          publish(flags + t, (t == 0 ? kPrefix : kAggregate) | count);
        }
      }
      if constexpr (kDefer == 0) {
        __syncthreads();
        Window f;
        look(t, f);
        finish(t, it, hit_bits, 0u, f);
      }
    }
    if constexpr (kDefer > 0) {
      if (pend_t[0] >= 0) finish(pend_t[0], it - kDefer, pend_hits[0], pend_memo[0], fw);
#pragma unroll
      for (int i = 0; i < kDefer; ++i) {
        pend_t[i] = pend_t[i + 1];
        pend_hits[i] = pend_hits[i + 1];
        pend_memo[i] = pend_memo[i + 1];
      }
      pend_t[kDefer - 1] = t < a.ntiles ? t : -1;
      pend_hits[kDefer - 1] = hit_bits;
      pend_memo[kDefer - 1] = memo;
    }
    if (threadIdx.x == 0) s_tile[(it + kAhead + 1) % kTickets] = static_cast<int>(ticket);
    __syncthreads();  // the tile's shared state and the tickets are free
    bool pending = false;
#pragma unroll
    for (int i = 0; i < kDefer; ++i) pending |= pend_t[i] >= 0;
    if (t >= a.ntiles && !pending) break;
  }
}

template <bool kChunked>
cudaError_t find_launch(const FindArgs& a, int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kStages) * a.stage_bytes + 8u * a.chunk +
                      4u * (1u << a.bits) + (kChunked ? 4u * kTile : 0u);
  auto kernel = window_find_kernel<kChunked>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int blocks = static_cast<int>(a.ntiles < resident ? a.ntiles : resident);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int tiles_of(long long n, long long L) {
  return static_cast<int>((n * L + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// Scratch a launch over an [n, L] tile needs, in uint64 words, into *words:
// the ticket, M and one flag a tile.
int msm_window_find_scratch(long long n, long long L, long long* words) {
  if (n < 0 || L < 0 || n >= (1LL << 31) || L >= (1LL << 31) || n * L >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  *words = 2 + tiles_of(n, L);
  return 0;
}

// Every match of the tile as an int64 triple (row, start, unique pattern)
// into out int64[cap, 3], ordered by row, start, pattern; slots at or past
// cap are not written.  The exact match count M goes to scratch[1], where
// scratch uint64[msm_window_find_scratch(n, L)] is cleared here first (on
// the stream, before the launch).  n * L must be below 2^31.
int msm_window_find(const void* payload, const void* lengths, const void* words,
                    const void* masks, const void* lens, void* out, long long cap,
                    void* scratch, long long n, long long L, int U, int K, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long nwords = 0;
  if (msm_window_find_scratch(n, L, &nwords) != 0 || U < 0 || cap < 0 || scratch == nullptr ||
      (cap > 0 && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, 8 * static_cast<size_t>(nwords), st);
  if (err != cudaSuccess || n == 0 || L == 0 || U == 0) return static_cast<int>(err);
  if (K <= 0 || K > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  FindArgs a{};
  a.payload = static_cast<const uint8_t*>(payload);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.words = static_cast<const uint32_t*>(words);
  a.masks = static_cast<const uint32_t*>(masks);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = static_cast<int64_t*>(out);
  a.cap = cap;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.total = n * L;
  a.n = static_cast<int>(n);
  a.L = static_cast<int>(L);
  a.U = U;
  a.K = K;
  a.chunk = U < msm_probe::kMaxChunk ? U : msm_probe::kMaxChunk;
  a.bits = msm_probe::table_bits(U);
  a.ntiles = tiles_of(n, L);
  // The staged bytes (kTile + 4K - 1), the misalignment (< 16) and the
  // word after the last 16-byte chunk, which word_at may load but never uses.
  a.stage_bytes = ((kTile + 4 * K + 15 + 15) / 16 + 1) * 16;
  return static_cast<int>(U > msm_probe::kMaxChunk ? find_launch<true>(a, device, st)
                                                   : find_launch<false>(a, device, st));
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
