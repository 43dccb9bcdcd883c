// Shifted-window multi-pattern counting on Hopper (sm_90a).
//
// Replaces the TPU kernel multithreading_string_matching_tpu/ops/
// pallas_window.py::_make_kernel (with window_views), as launched by
// PallasWindowMatcher._one_tile (totals, int32[U]),
// PallasWindowMatcher._one_tile_repeated (totals with a repeats grid axis)
// and PallasWindowMatcher._one_tile_rows (per_row=True, int32[n, U]); and,
// in its halo mode, the TPU kernel _make_halo_kernel as launched by
// PallasWindowMatcher._halo_run (the flow stream's scan rounds).
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
// What bounds it on an H100: about sum_u K_u word compares per payload
// byte against 3.35 TB/s of device-memory reads.  At the reference's 97
// patterns (K <= 3) that is a few hundred integer operations per byte read,
// so the kernel is compute-bound, not bandwidth-bound.  The design keeps the
// compare chain cheap: every payload byte is read from device memory once
// per pattern chunk into shared memory, each 4-byte window is two shared
// loads and a funnel shift, pattern tables sit in shared memory and are
// read as broadcasts, and a pattern's chain stops at its first mismatched
// word, so an absent pattern costs about one compare per position.  Later
// work (register-resident word views, per-set specialisation) is measured
// against this version.
//
// Where the TPU design does not carry over:
// - The TPU carried counts in SMEM across a sequential grid.  Here blocks
//   run in parallel and in no order: each block keeps a shared-memory
//   histogram and adds it to the zeroed output with one atomicAdd per
//   pattern (integer atomics: exact and independent of order).  The per-row
//   form gives each row to one block, which stores its row of the output.
// - The TPU dropped the fit mask for NUL-free sets.  Here the fit mask
//   i + lens[u] <= lengths[r] is always applied: exact for NUL patterns
//   and for rows that are not zero-filled past their length.
// - The TPU baked pattern words in as immediates.  Here the tables are call
//   arguments, staged through shared memory in chunks of kTableWords words,
//   so any U x K works (3072 8-byte patterns take three chunks).
// - No 128-lane padding: any n >= 0 and L >= 0; rows of length 0 count 0.
// - Halo mode: the TPU masked every position of the row; here a row's scan
//   starts at max(ms[r], 0), so positions that cannot count are never
//   staged, and the min_end test is one compare per pattern.  A flow round
//   re-laid as fixed-width sub-lanes (FlowStreamMatcher) gives rows of
//   H + 2048 bytes: one full segment and one of H positions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kSeg = 2048;         // row positions staged per segment
constexpr int kTableWords = 2048;  // table words (and as many masks) per chunk
constexpr int kMaxBlocks = 4096;   // rows are strided over at most this many blocks

// Little-endian uint32 of the staged bytes b .. b+3.
__device__ __forceinline__ uint32_t word_at(const uint32_t* s, int b) {
  const int q = b >> 2;
  return __funnelshift_r(s[q], s[q + 1], (b & 3) * 8);
}

template <bool kPerRow, bool kHalo>
__global__ void __launch_bounds__(kThreads)
window_count_kernel(const uint8_t* __restrict__ payload,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ min_start,  // [n], halo mode only
                    const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ lens,
                    int32_t* __restrict__ out,
                    int64_t n, int64_t L, int U, int K, int chunk,
                    int stage_words, int min_end) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_words = smem;                                      // [chunk, K]
  uint32_t* s_masks = s_words + chunk * K;                       // [chunk, K]
  int32_t* s_lens = reinterpret_cast<int32_t*>(s_masks + chunk * K);  // [chunk]
  int32_t* s_hist = s_lens + chunk;                              // [chunk]
  uint32_t* s_bytes = reinterpret_cast<uint32_t*>(s_hist + chunk);    // [stage_words]
  uint8_t* s_bytes8 = reinterpret_cast<uint8_t*>(s_bytes);
  const int stage_bytes = stage_words * 4;

  for (int u0 = 0; u0 < U; u0 += chunk) {
    const int cu = min(chunk, U - u0);
    __syncthreads();  // the previous chunk's readers are done
    for (int j = threadIdx.x; j < cu * K; j += blockDim.x) {
      s_words[j] = words[static_cast<int64_t>(u0) * K + j];
      s_masks[j] = masks[static_cast<int64_t>(u0) * K + j];
    }
    for (int j = threadIdx.x; j < cu; j += blockDim.x) {
      s_lens[j] = lens[u0 + j];
      s_hist[j] = 0;
    }
    __syncthreads();

    for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
      const int64_t len = lengths[row];
      // A fitting match starts below min(len, L): i + m <= len with m >= 1.
      const int64_t limit = len < L ? len : L;
      const uint8_t* rowp = payload + row * L;
      const int64_t first = kHalo && min_start[row] > 0 ? min_start[row] : 0;
      for (int64_t s = first; s < limit; s += kSeg) {
        for (int j = threadIdx.x; j < stage_bytes; j += blockDim.x) {
          const int64_t g = s + j;
          s_bytes8[j] = g < L ? rowp[g] : 0;
        }
        __syncthreads();
        const int nvalid = static_cast<int>(limit - s < kSeg ? limit - s : kSeg);
        for (int i = threadIdx.x; i < nvalid; i += blockDim.x) {
          const int64_t room = len - (s + i);  // bytes from this position to the row's end
          const uint32_t w0 = word_at(s_bytes, i);
          for (int u = 0; u < cu; ++u) {
            if (s_lens[u] > room) continue;
            if (kHalo && s + i + s_lens[u] <= min_end) continue;  // ends in the halo
            const uint32_t* pw = s_words + u * K;
            const uint32_t* pm = s_masks + u * K;
            bool ok = (w0 & pm[0]) == pw[0];
            for (int k = 1; ok && k < K; ++k) {
              const uint32_t m = pm[k];
              ok = m ? (word_at(s_bytes, i + 4 * k) & m) == pw[k] : pw[k] == 0u;
            }
            if (ok) atomicAdd(&s_hist[u], 1);
          }
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

template <bool kPerRow, bool kHalo = false>
int launch(const void* payload, const void* lengths, const void* words,
           const void* masks, const void* lens, void* out, long long n,
           long long L, int U, int K, int reps, int device, void* stream,
           const void* min_start = nullptr, int min_end = 0) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || L <= 0 || U <= 0) return 0;
  if (K <= 0 || K > kTableWords || reps <= 0 || reps > 65535 || (kPerRow && reps != 1) ||
      (kHalo && (min_start == nullptr || min_end < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = U < kTableWords / K ? U : kTableWords / K;
  const int stage_words = kSeg / 4 + K + 1;  // covers byte kSeg - 1 + 4K + 3
  const size_t smem =
      static_cast<size_t>(2 * chunk * K + 2 * chunk + stage_words) * sizeof(uint32_t);
  const int blocks = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  window_count_kernel<kPerRow, kHalo><<<dim3(blocks, reps), kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(min_start),
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(out),
      static_cast<int64_t>(n), static_cast<int64_t>(L), U, K, chunk, stage_words,
      min_end);
  return static_cast<int>(cudaGetLastError());
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

// Per row: writes out int32[n, U].
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

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
