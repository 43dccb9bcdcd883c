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
//
// One launch counts one class: U patterns of exactly K words each, given as
// tables words/masks int32[U, kw] (uint32 bit patterns, row stride kw) and
// lens int32[U].  For every row r, start position s < L and pattern u:
//   w_k    = little-endian uint32 of payload[r, s+4k .. s+4k+3], 0 past L
//   hit    = AND_{k<K} (w_k & masks[u,k]) == words[u,k]
//            and s + lens[u] <= lengths[r]
//   totals : out[u]    += reps * hit   (the grid's y axis runs the whole
//            class reps times, each re-reading the tile: with_reps=True)
//   per row: out[r, u] += hit
// Outputs are in the class's own order; the caller maps them to build order.
//
// How.  Each block stages a 2,048-position span of one row in shared memory
// (zero past L); each thread keeps the 4-byte windows of up to 8 positions
// of the span in registers and walks the class's pattern heads, one 16-byte
// broadcast load per pattern: probe word, probe mask, length, probe offset.
// A probe hit at position j is a candidate start s = j - offset; only there
// are the fit and the K words verified (a per-thread branch).
// - filter_count_*: the probe is the filter word and mask (table column K,
//   the pattern's rarest full word, chosen by the host), at its own offset
//   inside the pattern.  A match at s puts that word at s + offset, so each
//   match is probed exactly once: no false negatives, and false positives
//   cost one verify.  Padded slots with the never-fires sentinel (word 1,
//   mask 0) are never verified.
// - table_count_*: the probe is word 0 (offset 0), then words 1..K-1: the
//   TPU kernel's K-word chain, stopped at the first mismatch.
// A segment holds 2,048 - 4(K-1) starts, so the probes of all of them lie
// in the span; the next segment starts after them.
//
// What bounds it on an H100: one AND, one compare and one branch per
// pattern per position, about U instruction triples per payload byte (3,072
// patterns: ~9,000 per byte), against 3.35 TB/s of device memory: compute,
// not bandwidth.  The pattern heads are read as shared-memory broadcasts,
// one per 8 positions.  Later work (hashed probe lookup, wgmma, TMA staging)
// is measured against this version.
//
// Where the TPU design does not carry over:
// - The TPU specialised one Mosaic kernel per K and gated with pl.when on an
//   any-reduce over the tile ('pattern-any'; the group/hier/pattern modes
//   exist for Mosaic's branch lowering).  Here K is a runtime argument: only
//   the rare verify depends on it.  The kernel is specialised instead on the
//   number of probe positions per thread (1..8), which is uniform over a
//   block for each segment, so short rows probe no positions past their end.
// - The TPU carried counts in SMEM across a sequential grid.  Here each
//   block keeps a shared-memory histogram and adds it once per pattern with
//   an integer atomicAdd into the zeroed output (exact, order-free); the
//   per-row form gives each row to one block, which stores its output row.
// - The TPU dropped the fit mask for NUL-free sets.  Here it is always
//   applied: exact for NUL patterns and rows that are not zero-filled.
// - The TPU streamed 128-pattern SMEM blocks.  Here the class's tables are
//   staged through shared memory in chunks of at most kTableBytes (24 KB),
//   so a launch stays under the 48 KB default of dynamic shared memory (no
//   cudaFuncSetAttribute opt-in) and eight blocks fit on one SM; a class
//   larger than a chunk re-stages the tile per chunk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // threads per block
constexpr int kPer = 8;                        // probe positions per thread
constexpr int kSpan = kThreads * kPer;         // probe positions per segment
constexpr int kStageBytes = kSpan + 8;         // the last window reads byte kSpan + 2
constexpr int kTableBytes = 24 * 1024;         // pattern tables per chunk
constexpr int kMaxBlocks = 4096;               // rows are strided over at most this many blocks
constexpr int kMaxK = kSpan / 4;               // a segment must hold at least one start

// Little-endian uint32 of the staged bytes b .. b+3.
__device__ __forceinline__ uint32_t word_at(const uint32_t* s, int b) {
  const int q = b >> 2;
  return __funnelshift_r(s[q], s[q + 1], (b & 3) * 8);
}

// Probe every pattern of the chunk at NT positions per thread, verifying
// the candidates; hits go to the shared histogram.
template <int NT>
__device__ __forceinline__ void probe_span(const uint32_t* s_bytes, const uint4* s_head,
                                           const uint32_t* s_words, const uint32_t* s_masks,
                                           int32_t* s_hist, int cu, int K, int nstart,
                                           int64_t room0) {
  uint32_t w[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) w[t] = word_at(s_bytes, threadIdx.x + t * kThreads);
  for (int u = 0; u < cu; ++u) {
    const uint4 h = s_head[u];  // probe word, probe mask, length, probe offset
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if ((w[t] & h.y) != h.x) continue;
      const int s = static_cast<int>(threadIdx.x) + t * kThreads - static_cast<int>(h.w);
      if (s < 0 || s >= nstart || s + static_cast<int64_t>(h.z) > room0) continue;
      const uint32_t* pw = s_words + u * K;
      const uint32_t* pm = s_masks + u * K;
      bool ok = true;
      for (int k = 0; ok && k < K; ++k) ok = (word_at(s_bytes, s + 4 * k) & pm[k]) == pw[k];
      if (ok) atomicAdd(&s_hist[u], 1);
    }
  }
}

template <bool kFilter, bool kPerRow>
__global__ void __launch_bounds__(kThreads)
table_count_kernel(const uint8_t* __restrict__ payload,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ masks,
                   const int32_t* __restrict__ lens,
                   int32_t* __restrict__ out,
                   int64_t n, int64_t L, int U, int K, int kw, int chunk) {
  extern __shared__ uint4 smem[];
  uint4* s_head = smem;                                                // [chunk]
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_head + chunk);     // [chunk, K]
  uint32_t* s_masks = s_words + chunk * K;                             // [chunk, K]
  int32_t* s_hist = reinterpret_cast<int32_t*>(s_masks + chunk * K);   // [chunk]
  uint32_t* s_bytes = reinterpret_cast<uint32_t*>(s_hist + chunk);     // [kStageBytes / 4]
  uint8_t* s_bytes8 = reinterpret_cast<uint8_t*>(s_bytes);
  const int step = kSpan - 4 * (K - 1);  // starts per segment

  for (int u0 = 0; u0 < U; u0 += chunk) {
    const int cu = min(chunk, U - u0);
    __syncthreads();  // the previous chunk's readers are done
    for (int j = threadIdx.x; j < cu * K; j += blockDim.x) {
      const int u = j / K;
      const int64_t g = static_cast<int64_t>(u0 + u) * kw + (j - u * K);
      s_words[j] = words[g];
      s_masks[j] = masks[g];
    }
    for (int j = threadIdx.x; j < cu; j += blockDim.x) {
      const int64_t g = static_cast<int64_t>(u0 + j) * kw;
      uint32_t pw = words[g], pm = masks[g];
      int off = 0;
      if (kFilter) {
        pw = words[g + K];
        pm = masks[g + K];
        for (int k = 0; k < K; ++k) {  // the first pattern word equal to the filter
          if (words[g + k] == pw && masks[g + k] == pm) {
            off = 4 * k;
            break;
          }
        }
      }
      s_head[j] = make_uint4(pw, pm, static_cast<uint32_t>(lens[u0 + j]),
                             static_cast<uint32_t>(off));
      s_hist[j] = 0;
    }
    __syncthreads();

    for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
      const int64_t len = lengths[row];
      // A fitting match starts below min(len, L): s + m <= len with m >= 1.
      const int64_t limit = len < L ? len : L;
      const uint8_t* rowp = payload + row * L;
      for (int64_t seg = 0; seg < limit; seg += step) {
        const int nstart = static_cast<int>(limit - seg < step ? limit - seg : step);
        const int nt = (nstart + 4 * (K - 1) + kThreads - 1) / kThreads;  // block-uniform
        const int nbytes = nt * kThreads + 8;
        for (int j = threadIdx.x; j < nbytes; j += blockDim.x) {
          const int64_t g = seg + j;
          s_bytes8[j] = g < L ? rowp[g] : 0;
        }
        __syncthreads();
        const int64_t room0 = len - seg;  // bytes from the segment's first start to the row's end
        switch (nt) {
          case 1: probe_span<1>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 2: probe_span<2>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 3: probe_span<3>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 4: probe_span<4>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 5: probe_span<5>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 6: probe_span<6>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          case 7: probe_span<7>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
          default: probe_span<8>(s_bytes, s_head, s_words, s_masks, s_hist, cu, K, nstart, room0); break;
        }
        __syncthreads();
      }
      if (kPerRow) {
        // Each thread stores, then clears, the same histogram entries, so
        // the next row needs no extra barrier before its first segment.
        for (int j = threadIdx.x; j < cu; j += blockDim.x) {
          out[row * U + u0 + j] = s_hist[j];
          s_hist[j] = 0;
        }
      }
    }

    if (!kPerRow) {
      __syncthreads();
      for (int j = threadIdx.x; j < cu; j += blockDim.x) {
        if (s_hist[j]) atomicAdd(&out[u0 + j], s_hist[j]);
      }
    }
  }
}

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
  const int per_pattern = static_cast<int>(sizeof(uint4)) + 8 * K + 4;
  const int chunk = U < kTableBytes / per_pattern ? U : kTableBytes / per_pattern;
  const size_t smem = static_cast<size_t>(chunk) * per_pattern + kStageBytes;
  const int blocks = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  table_count_kernel<kFilter, kPerRow><<<dim3(blocks, reps), kThreads, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(out),
      static_cast<int64_t>(n), static_cast<int64_t>(L), U, K, kw, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Totals: add reps times the class's counts into out int32[U], which the
// caller has zeroed.  Per row: write out int32[n, U].

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
