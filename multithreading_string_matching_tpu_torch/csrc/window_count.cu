// Shifted-window multi-pattern counting on Hopper (sm_90a).
//
// Replaces the TPU kernel multithreading_string_matching_tpu/ops/
// pallas_window.py::_make_kernel (with window_views), as launched by
// PallasWindowMatcher._one_tile (totals, int32[U]),
// PallasWindowMatcher._one_tile_repeated (totals with a repeats grid axis)
// and PallasWindowMatcher._one_tile_rows (per_row=True, int32[n, U]); and,
// in its halo mode, the TPU kernel _make_halo_kernel as launched by
// PallasWindowMatcher._halo_run (the flow stream's scan rounds).
// Every match as an ordered triple (window_find) is window_find.cu's
// kernel, on the same table build (probe.cuh).
//
// What it computes, for every row r, position i < L and pattern u:
//   w_k      = little-endian uint32 of payload[r, i+4k .. i+4k+3], 0 past L
//   hit      = AND_k (w_k & masks[u,k]) == words[u,k]  and  i + lens[u] <= lengths[r]
//   totals   : out[u]    += reps * hit   (window_count_totals; the grid's
//              y axis runs the whole tile reps times, each re-reading it)
//   per row  : out[r, u] += hit      (window_count_rows)
//   halo     : out[u]    += hit  and  i + lens[u] > min_end  and  i >= ms[r]
//              (window_count_halo: rows are [H halo bytes | round bytes],
//              lengths[r] is the row's valid bytes halo included, min_end = H
//              gives each match to the round its end falls in, and ms[r] =
//              H - real halo bytes keeps matches out of fabricated zeros)
// Outputs are in build (unique-pattern) order, as the TPU kernel's were.
//
// How: the hashed probe of probe.cuh with word 0 as each pattern's probe
// (offset 0).  A staged position costs one key-map test and, where the map
// lets it through, one lookup per distinct word-0 mask (3 for the 97-token
// stand-in set: 2-, 3- and 4-byte words), not one compare per pattern; the
// fit test, the halo tests and words 1..K-1 run
// only on a candidate.  A halo sub-lane row (H + 2,048 bytes) is one
// segment.
//
// What bounds it on an H100: per real position the window build and one
// test in the 16-bit key map (about 4 integer operations), and per mask an
// AND, a hash, a head load and a compare only where the map's bit is set
// (~0.1% of positions for the stand-in set), against 3.35 TB/s of device
// memory for the payload read once: ~4 operations a byte run in less time
// than the byte's read, so memory is the bound (chip_smoke.py counts both
// for each record's bound_ms).
//
// Where the TPU design does not carry over:
// - The TPU compared every pattern at every position (a gather costs ~7.5
//   ns a lane there); a shared-memory gather costs one instruction here.
// - The TPU carried counts in SMEM across a sequential grid.  Here blocks
//   run in parallel and in no order, each warp on rows of its own: a
//   shared-memory histogram per block for totals, integer atomics into the
//   zeroed output for per-row counts (probe.cuh).
// - The TPU dropped the fit mask for NUL-free sets.  Here the fit test
//   i + lens[u] <= lengths[r] is always applied: exact for NUL patterns and
//   for rows that are not zero-filled past their length.
// - The TPU baked pattern words in as immediates.  Here the tables are call
//   arguments, so any U x K works (K <= kMaxWords).
// - No 128-lane padding: any n >= 0 and L >= 0; rows of length 0 count 0.
// - Halo mode: a row's scan starts at max(ms[r], 0), so positions that
//   cannot count are never staged.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kMaxWords = 2048;  // K limit: a segment stages cap + 4K bytes

template <bool kPerRow, bool kHalo = false>
int launch(const void* payload, const void* lengths, const void* words,
           const void* masks, const void* lens, void* out, long long n,
           long long L, int U, int K, int reps, int device, void* stream,
           const void* min_start = nullptr, int min_end = 0) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || L <= 0 || U <= 0) return 0;
  if (K <= 0 || K > kMaxWords || reps <= 0 || reps > 65535 || (kPerRow && reps != 1) ||
      (kHalo && (min_start == nullptr || min_end < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  msm_probe::Args a{};
  a.payload = static_cast<const uint8_t*>(payload);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.min_start = static_cast<const int32_t*>(min_start);
  a.words = static_cast<const uint32_t*>(words);
  a.masks = static_cast<const uint32_t*>(masks);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = static_cast<int32_t*>(out);
  a.n = n;
  a.L = L;
  a.U = U;
  a.K = K;
  a.kw = K;
  a.pc = 0;
  a.min_end = min_end;
  return static_cast<int>(msm_probe::probe_launch<false, kPerRow, kHalo>(
      a, reps, device, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Totals: adds reps times the tile's counts into out int32[U], which the
// caller has zeroed.
int msm_window_count_totals(const void* payload, const void* lengths,
                            const void* words, const void* masks,
                            const void* lens, void* out, long long n,
                            long long L, int U, int K, int reps, int device,
                            void* stream) {
  return launch<false>(payload, lengths, words, masks, lens, out, n, L, U, K,
                       reps, device, stream);
}

// Per row: writes out int32[n, U], which the caller has zeroed.
int msm_window_count_rows(const void* payload, const void* lengths,
                          const void* words, const void* masks,
                          const void* lens, void* out, long long n,
                          long long L, int U, int K, int device,
                          void* stream) {
  return launch<true>(payload, lengths, words, masks, lens, out, n, L, U, K,
                      1, device, stream);
}

// Halo totals (flow rounds): adds into out int32[U], which the caller has
// zeroed.  payload uint8[n, L] rows [halo | bytes], eff int32[n] valid bytes
// per row, ms int32[n] first start column per row, min_end = halo width.
int msm_window_count_halo(const void* payload, const void* eff, const void* ms,
                          const void* words, const void* masks,
                          const void* lens, void* out, long long n,
                          long long L, int U, int K, int min_end, int device,
                          void* stream) {
  return launch<false, true>(payload, eff, words, masks, lens, out, n, L, U, K,
                             1, device, stream, ms, min_end);
}

// The head slot of probe key `key` under the launch's mask_index-th probe
// mask, in a launch over num_patterns patterns (probe.cuh's bucket and
// table size), into *slot; no device work.
int msm_probe_bucket(unsigned int key, int mask_index, int num_patterns, int* slot) {
  if (num_patterns <= 0 || mask_index < 0 || mask_index >= msm_probe::kMaxMasks)
    return static_cast<int>(cudaErrorInvalidValue);
  *slot = static_cast<int>(msm_probe::bucket(key, static_cast<uint32_t>(mask_index),
                                             32 - msm_probe::table_bits(num_patterns)));
  return 0;
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
