// The matrix-unit formulation of exact byte matching on Hopper (sm_90a):
// a +-1 bit inner product per (position, pattern) on the int8 tensor cores.
//
// Replaces the TPU kernel bench/mxu_match.py::_make_kernel (:63), as
// launched by MxuMatcher._one_tile (:125, the pallas_call at :136).
//
// What it computes, for every row r of a uint8[n, L] tile, position i < L
// and pattern u of P int8[U_pad, C] (C = 8 * window bytes):
//   B[c, i]  = +1 if bit (c % 8) of payload[r, i + c / 8] is set, else -1,
//              with bytes past L read as 0 (all bits -1)
//   score    = sum_c P[u, c] * B[c, i]
//   out[u]  += reps * (score == tgt[u])
// P holds +-1 at the 8 bits of each pattern byte and 0 past the pattern's
// length, and tgt[u] = 8 * len(u), so score == tgt[u] exactly when every
// pattern byte matches.  Padded pattern slots are rows of 0 with tgt 1,
// which no score reaches.  Every score is at most tgt[u] (a +-1 product of
// 8 * len(u) non-zero terms), so the epilogue counts score - tgt[u] == 0
// as the sign bit of score - tgt[u] being clear: the tables must be made as
// ops/mxu.bit_tables makes them.  Like the TPU kernel, it reads no row
// lengths: it counts the tile's whole staged width, so rows must be zero
// past their lengths, and only NUL-free pattern sets count exactly.
//
// What bounds it on an H100: the product, 2 * positions * U * C int8
// operations, over 1,979 dense int8 TOP/s; the bytes (each payload byte
// read once) are ~1/(2 * U * C) of that.  The TPU run found the bit-plane
// build and the epilogue, not the product, to take the time
// (docs/DESIGN.md:176-178).  What the design does about each:
// - Bit planes: the TPU built C shifted +-1 planes of the whole tile
//   ([TN, C, L] int8).  Here a block expands each staged payload byte once
//   into two 32-bit words of four +-1 bytes (its low and high nibble) in
//   shared memory.  An mma.sync B fragment register is then exactly one such
//   word: register 0 of k-step s for lane (g, t) is the nibble t & 1 of byte
//   i + 4s + t / 2, register 1 that of byte i + 4s + 2 + t / 2.  So the
//   windows are never materialised: one shared load per B register, no
//   bank conflict (a warp reads 18 consecutive words).
// - Epilogue: the accumulators start at -tgt[u], so the tensor core leaves
//   score - tgt[u]; a hit is a zero, counted from the sign bit, in
//   registers, for the whole block's work; one warp shuffle reduction and
//   one atomicAdd per pattern per block at the end.
// - The product: mma.sync.m16n8k32 s8 x s8 -> s32.  Each warp owns 16
//   patterns of the block's 128 (warps whose 16 targets are all the
//   padding sentinel 1 skip the product) and runs 8 tiles of 8 positions
//   per k-step, reusing its A fragments (read from the block's shared copy
//   of P) across the 8 tiles.
//   wgmma and TMA are later work; this version is measured as it is.
//
// Where the TPU design does not carry over:
// - The TPU carried the counts across a sequential grid in VMEM.  Here
//   blocks run in parallel and in no order: integer atomics, exact and
//   independent of order.
// - No 128-lane width or 8-row rule: any n >= 0 and L >= 0.  Positions at
//   or past L are masked in the last pass of a row (the TPU counted its
//   zero-padded lanes, which only a NUL pattern could match).
// - Any C up to 800 (window bytes up to 100, so io/patterns.MAX_PATTERN_LEN
//   = 99 fits): the block's 128 rows of P sit in shared memory whole (at
//   most 104 KB, rows spread over the banks by 16 extra bytes each).
// - Repeats: the grid's z axis runs the whole tile reps times, each
//   re-reading it (the TPU's reps grid axis).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockU = kWarps * 16;  // patterns per block: one m16 tile per warp
constexpr int kSeg = 256;             // row positions per work item
constexpr int kTiles = 8;             // n8 tiles per pass
constexpr int kPass = kTiles * 8;     // positions per pass
constexpr int kMaxC = 800;            // columns of P (multiple of 32)
constexpr int kTargetBlocks = 1056;   // 132 SMs x 2 resident blocks x 4 waves

// Four int8 lanes, byte j = +1 if bit j of the nibble x is set, else -1.
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t x) {
  const uint32_t v = (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
  return ~(v * 0xFEu);  // 1 -> 0x01, 0 -> 0xFF; no carries between bytes
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

size_t smem_bytes(int C) {
  return static_cast<size_t>(kBlockU) * (C + 16) + 8u * (kSeg + C / 8);
}

__global__ void __launch_bounds__(kThreads, 2)
mxu_count_kernel(const uint8_t* __restrict__ payload, const int8_t* __restrict__ P,
                 const int32_t* __restrict__ tgt, int32_t* __restrict__ out,
                 int64_t L, int C, int64_t items, int64_t segs_per_row) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int stride = C + 16;  // bytes per staged pattern row
  uint8_t* s_P = smem;        // [kBlockU][stride]
  uint32_t* s_exp = reinterpret_cast<uint32_t*>(smem + kBlockU * stride);  // [2 * stage]
  const int stage = kSeg + C / 8;
  const int nk = C / 32;

  const int u0 = blockIdx.y * kBlockU;
  const int row_words = C / 4;
  for (int j = threadIdx.x; j < kBlockU * row_words; j += kThreads) {
    const int r = j / row_words;
    const int c = j - r * row_words;
    reinterpret_cast<uint32_t*>(s_P + r * stride)[c] =
        reinterpret_cast<const uint32_t*>(P + static_cast<int64_t>(u0 + r) * C)[c];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group: row g (and g + 8) of A, column g of B
  const int t = lane & 3;   // thread in group
  const int m0 = warp * 16;
  const int32_t neg_a = -tgt[u0 + m0 + g];
  const int32_t neg_b = -tgt[u0 + m0 + g + 8];
  // A real pattern's target is 8 * len >= 8; padded slots hold 1.
  const bool live = __any_sync(0xffffffffu, neg_a != -1 || neg_b != -1);
  const uint8_t* pa = s_P + (m0 + g) * stride + 4 * t;
  const uint8_t* pb = pa + 8 * stride;
  // Per thread: scores seen and scores that missed, for rows g and g + 8.
  int seen_a = 0, miss_a = 0, seen_b = 0, miss_b = 0;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t row = item / segs_per_row;
    const int64_t p0 = (item - row * segs_per_row) * kSeg;
    const uint8_t* rp = payload + row * L;
    __syncthreads();  // the previous item's readers are done (and P is staged)
    for (int b = threadIdx.x; b < stage; b += kThreads) {
      const int64_t pos = p0 + b;
      const uint32_t x = pos < L ? rp[pos] : 0u;
      s_exp[2 * b] = pm1_nibble(x & 15u);
      s_exp[2 * b + 1] = pm1_nibble(x >> 4);
    }
    __syncthreads();
    if (!live) continue;
    const int64_t valid = L - p0;  // positions of this item inside the row, > 0
    for (int q = 0; q < kSeg && q < valid; q += kPass) {
      int32_t acc[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        acc[j][0] = acc[j][1] = neg_a;
        acc[j][2] = acc[j][3] = neg_b;
      }
      for (int s = 0; s < nk; ++s) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(pa + 32 * s);
        a[1] = *reinterpret_cast<const uint32_t*>(pb + 32 * s);
        a[2] = *reinterpret_cast<const uint32_t*>(pa + 32 * s + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(pb + 32 * s + 16);
        const uint32_t* e = s_exp + 2 * (q + g + 4 * s + (t >> 1)) + (t & 1);
#pragma unroll
        for (int j = 0; j < kTiles; ++j) mma_s8(acc[j], a, e[16 * j], e[16 * j + 4]);
      }
      if (q + kPass <= valid) {
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          miss_a += (static_cast<uint32_t>(acc[j][0]) >> 31) + (static_cast<uint32_t>(acc[j][1]) >> 31);
          miss_b += (static_cast<uint32_t>(acc[j][2]) >> 31) + (static_cast<uint32_t>(acc[j][3]) >> 31);
        }
        seen_a += 2 * kTiles;
        seen_b += 2 * kTiles;
      } else {  // the row's last pass: positions at or past L do not count
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const int col = q + 8 * j + 2 * t;  // C fragment columns 2t, 2t + 1
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (col + i < valid) {
              ++seen_a;
              ++seen_b;
              miss_a += static_cast<uint32_t>(acc[j][i]) >> 31;
              miss_b += static_cast<uint32_t>(acc[j][2 + i]) >> 31;
            }
          }
        }
      }
    }
  }

  int hit_a = seen_a - miss_a;
  int hit_b = seen_b - miss_b;
  hit_a += __shfl_xor_sync(0xffffffffu, hit_a, 1);
  hit_a += __shfl_xor_sync(0xffffffffu, hit_a, 2);
  hit_b += __shfl_xor_sync(0xffffffffu, hit_b, 1);
  hit_b += __shfl_xor_sync(0xffffffffu, hit_b, 2);
  if (live && t == 0) {
    if (hit_a) atomicAdd(&out[u0 + m0 + g], hit_a);
    if (hit_b) atomicAdd(&out[u0 + m0 + g + 8], hit_b);
  }
}

}  // namespace

extern "C" {

// Adds reps times the tile's counts into out int32[U_pad], which the caller
// has zeroed.  payload uint8[n, L]; P int8[U_pad, C] with U_pad a multiple
// of 128 and C a multiple of 32 up to 800; tgt int32[U_pad].
int msm_mxu_count(const void* payload, const void* P, const void* tgt, void* out,
                  long long n, long long L, int U_pad, int C, int reps, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (U_pad <= 0 || U_pad % kBlockU || C <= 0 || C % 32 ||
      C > kMaxC || reps <= 0 || reps > 65535 || U_pad / kBlockU > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || L <= 0) return 0;
  const size_t smem = smem_bytes(C);
  // The shared-memory limit is raised once per device (a repeat is harmless).
  static unsigned long long attr_set = 0;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(mxu_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxC)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  const long long segs = (L + kSeg - 1) / kSeg;
  const long long items = n * segs;
  const int nblocks_u = U_pad / kBlockU;
  long long bx = (kTargetBlocks + nblocks_u - 1) / nblocks_u;
  if (bx > items) bx = items;
  mxu_count_kernel<<<dim3(static_cast<unsigned>(bx), nblocks_u, reps), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int8_t*>(P),
      static_cast<const int32_t*>(tgt), static_cast<int32_t*>(out), static_cast<int64_t>(L),
      C, static_cast<int64_t>(items), static_cast<int64_t>(segs));
  return static_cast<int>(cudaGetLastError());
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
