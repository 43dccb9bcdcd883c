// Table-driven multi-pattern counting on Hopper (sm_90a): the large-set kernels.
//
// Replaces the TPU kernels of multithreading_string_matching_tpu/ops/
// pallas_table.py, launched once per word-count class:
//   _make_table_kernel (:88)        -> table_count_totals
//       by PallasTableMatcher._class_call (:644), with and without reps
//   _make_table_kernel_rows (:133)  -> table_count_rows
//       by PallasTableMatcher._one_tile_rows (:704)
//   _make_filter_kernel (:160, gate 'pattern-any') -> filter_count_totals
//       by PallasTableMatcher._class_call (:644), with and without reps
//   _make_filter_kernel_rows (:270) -> filter_count_rows
//       by PallasTableMatcher._one_tile_rows (:704)
// and, on one pattern shard's [S, K_max(+1)] block, ShardTableKernel.counts
// (:474) and .rows (:501).
//
// One launch counts one class: U patterns of K words each, given as tables
// words/masks int32[U, kw] (uint32 bit patterns, row stride kw) and lens
// int32[U].  For every row r, start position s < L and pattern u:
//   w_k    = little-endian uint32 of payload[r, s+4k .. s+4k+3], 0 past L
//   hit    = AND_{k<K} (w_k & masks[u,k]) == words[u,k]
//            and s + lens[u] <= lengths[r]
//   totals : out[u]    += reps * hit   (the grid's y axis runs the whole
//            class reps times, each re-reading the tile: with_reps=True)
//   per row: out[r, u] += hit
// Outputs are in the class's own order; the caller maps them to build order.
//
// How: the hashed probe of probe.cuh.
// - filter_count_*: the probe is the filter word and mask (table column K,
//   the pattern's rarest full word, chosen by the host), at the offset of
//   the first of the pattern's K words equal to it.  A match at s puts that
//   word at s + offset, so each match is probed exactly once; a candidate
//   then verifies all K words.  The never-fires sentinel (word 1, mask 0)
//   of padded shard slots is never inserted.
// - table_count_*: the probe is word 0 (offset 0); a candidate verifies
//   words 1..K-1 (the TPU kernel's chain, stopped at the first mismatch).
// A position costs one test in the 16-bit key map and, where its bit is
// set, one lookup per distinct probe mask of the class (one for full filter
// words, at most four), not one probe per pattern, so a class
// of 452 patterns and a shard block of 3,072 cost about the same per byte.
// One launch reads the tile once: a class or block of up to 4,096 patterns
// is hashed whole (probe.cuh kMaxChunk); larger ones are taken in chunks of
// 4,096, each re-staging the tile.  Shared memory holds the staged segment,
// the hash heads, the per-pattern probe entries and the histogram (68 KB at
// 3,072 patterns, beside 17 KB of staging at K = 8), opted in above 48 KB
// with cudaFuncSetAttribute; a candidate reads its K verify words from global
// memory (at most 3,072 x 9 x 8 B, in L2).
//
// What bounds it on an H100: per real position and class launch the window
// build and the map test (about 4 integer operations), and per mask an AND,
// a hash, a head load and a compare where the map's bit is set; a 3,072-rule
// capture pays the map test once per word-count class (8 launches per
// tile), which is what is left of the ~1/U law.  chip_smoke.py counts the
// map tests, the lookups and the candidates' verify chains for each
// record's bound_ms.
//
// Where the TPU design does not carry over:
// - The TPU compared every pattern's probe at every position and gated the
//   verify with an any-reduce ('pattern-any'; the group/hier/pattern modes
//   exist for Mosaic's branch lowering).  Here the probe is a hash lookup
//   and the verify a per-thread branch on a candidate; K is a runtime
//   argument.
// - The TPU carried counts in SMEM across a sequential grid.  Here each
//   block keeps a shared-memory histogram and adds it once per pattern with
//   an integer atomicAdd into the zeroed output (exact, order-free); the
//   per-row form adds each hit into the zeroed output row with an integer
//   atomicAdd.
// - The TPU's grid stepped over row tiles; here each warp scans rows of its
//   own against its block's hash (probe.cuh).
// - The TPU dropped the fit mask for NUL-free sets.  Here it is always
//   applied: exact for NUL patterns and rows that are not zero-filled.
// - The TPU streamed 128-pattern SMEM blocks; here a whole class is hashed.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kMaxK = 512;  // words per pattern: a segment stages cap + 4K bytes

template <bool kFilter, bool kPerRow>
int launch(const void* payload, const void* lengths, const void* words,
           const void* masks, const void* lens, void* out, long long n,
           long long L, int U, int K, int kw, int reps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || L <= 0 || U <= 0) return 0;
  if (K <= 0 || K > kMaxK || kw < K + (kFilter ? 1 : 0) || reps <= 0 || reps > 65535 ||
      (kPerRow && reps != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  msm_probe::Args a{};
  a.payload = static_cast<const uint8_t*>(payload);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.words = static_cast<const uint32_t*>(words);
  a.masks = static_cast<const uint32_t*>(masks);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = static_cast<int32_t*>(out);
  a.n = n;
  a.L = L;
  a.U = U;
  a.K = K;
  a.kw = kw;
  a.pc = kFilter ? K : 0;
  return static_cast<int>(msm_probe::probe_launch<kFilter, kPerRow, false>(
      a, reps, device, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Totals: add reps times the class's counts into out int32[U], which the
// caller has zeroed.  Per row: add into out int32[n, U], which the caller
// has zeroed.

int msm_table_count_totals(const void* payload, const void* lengths, const void* words,
                           const void* masks, const void* lens, void* out, long long n,
                           long long L, int U, int K, int kw, int reps, int device,
                           void* stream) {
  return launch<false, false>(payload, lengths, words, masks, lens, out, n, L, U, K, kw,
                              reps, device, stream);
}

int msm_table_count_rows(const void* payload, const void* lengths, const void* words,
                         const void* masks, const void* lens, void* out, long long n,
                         long long L, int U, int K, int kw, int device, void* stream) {
  return launch<false, true>(payload, lengths, words, masks, lens, out, n, L, U, K, kw, 1,
                             device, stream);
}

int msm_filter_count_totals(const void* payload, const void* lengths, const void* words,
                            const void* masks, const void* lens, void* out, long long n,
                            long long L, int U, int K, int kw, int reps, int device,
                            void* stream) {
  return launch<true, false>(payload, lengths, words, masks, lens, out, n, L, U, K, kw,
                             reps, device, stream);
}

int msm_filter_count_rows(const void* payload, const void* lengths, const void* words,
                          const void* masks, const void* lens, void* out, long long n,
                          long long L, int U, int K, int kw, int device, void* stream) {
  return launch<true, true>(payload, lengths, words, masks, lens, out, n, L, U, K, kw, 1,
                            device, stream);
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
