// The matrix-unit formulation of exact byte matching on Hopper (sm_90a):
// a +-1 bit inner product per (position, pattern) on the int8 tensor cores,
// issued as warpgroup MMA (wgmma).
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
// which no score reaches.  Like the TPU kernel, it reads no row lengths: it
// counts the tile's whole staged width, so rows must be zero past their
// lengths, and only NUL-free pattern sets count exactly.
//
// What bounds it on an H100: the product, 2 * positions * U * C int8
// operations, over 1,979 dense int8 TOP/s; the bytes (each payload byte
// read once) are ~1/(2 * U * C) of that.  The mma.sync design this replaces
// ran at ~10x that bound.  What held it back, and what this design does:
// 1. Every warp re-read the shared windows (B there) for its own 16
//    patterns: ~2.5 shared loads per mma.  Here the windows are the A
//    operand, in registers, and the patterns the B operand, in shared
//    memory: one wgmma m64nNk32 multiplies 64 positions by up to 256
//    patterns.  The A fragment of lane (g, t) of warp w, register i, at
//    k-step s is one expanded nibble word: nibble t & 1 of byte
//    16w + g + 8 (i & 1) + 4s + 2 (i >> 1) + t / 2 of the M-tile
//    (ops/mxu.window_fragment).  Each staged byte is expanded once into two
//    words of four +-1 bytes (its low and high nibble); a thread then loads
//    2 * NK + 4 words for an M-tile of NK k-steps (steps overlap), with no
//    bank conflict (a warp reads 18 consecutive words).  The patterns sit
//    in the canonical K-major core-matrix layout without swizzle (8 rows x
//    16 bytes a core matrix; ops/mxu.pattern_smem_offset) and reach the
//    tensor cores through a shared-memory descriptor: LBO = 16 N bytes
//    between the two 16-byte K halves of a k-step, SBO = 128 bytes between
//    groups of 8 patterns (bit layout of CUTLASS's cute::GmmaDescriptor).
//    A 128-byte swizzle of the patterns measured no faster.
// 2. The copy did not overlap the product.  Here each warpgroup is a
//    worker of a persistent grid (one block an SM of three warpgroups for
//    N <= 128, of two above) that owns an equal, contiguous range of the
//    launch's M-tiles, cut into units inside one row of at most kSeg
//    positions.  A ring of two raw slots: the cp.async copy of the next
//    unit (an aligned 16-byte superset of its bytes and its C / 8 - 1 byte
//    halo) is in flight while the current one is expanded and multiplied;
//    a cp.async group wait and a warpgroup barrier stand in for an
//    mbarrier.  A match that straddles two units is counted once, by the
//    unit where it starts.  Equal ranges keep the launch's tail short.
// 3. mma.sync is not Hopper's full tensor rate: the product is wgmma
//    (.s32.s8.s8, A from registers, B from shared memory).  The kernel is
//    specialised on the k-steps (NK = C / 32 from 1 to 4: issued with no
//    branch, ptxas keeps them asynchronous); longer patterns take a
//    generic path in groups of four k-steps, which ptxas serialises.  For
//    N <= 96 (at most three k-steps at 96), two M-tiles are in flight in a
//    warpgroup, so the second's product runs while the first's scores are
//    tested.
// 4. Pattern padding: N is the wgmma width (16, 32, 64, 96, 128, 192, 256)
//    that covers the live patterns with the fewest slots (87 -> 96); more
//    than 256 split over blockIdx.y (pt x 3,072 at C = 64: 12 blocks of 256,
//    each holding its 16 KB of patterns beside its ring), so every block
//    reads the tile from L2 for its own patterns.  msm_mxu_count_live takes
//    the live count; msm_mxu_count covers all U_pad slots (pads never hit).
// The epilogue: every score is at most its pattern's target, so a hit is
// score == target.  The first wgmma of an M-tile overwrites the
// accumulators (scale-d 0: nothing to reset), and the common case, no score
// at its target, costs one compare a score (ISETP with an OR into one of
// eight predicate chains).  Only a thread that finds a hit counts exactly
// (positions at or past L masked) into per-pattern shared counters, and
// each block adds them to out with one atomicAdd per pattern.
//
// Where the TPU design does not carry over:
// - The TPU carried the counts across a sequential grid in VMEM.  Here
//   blocks run in parallel and in no order: integer atomics, exact and
//   independent of order.
// - No 128-lane width or 8-row rule: any n >= 0 and L >= 0.
// - Any C up to 800 (window bytes up to 100, so io/patterns.MAX_PATTERN_LEN
//   = 99 fits), in k-steps of 32.
// - Repeats: the persistent grid walks the tile's M-tiles reps times, each
//   pass re-reading them (the TPU's reps grid axis).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Warpgroups per block: three where N <= 128 (at most 168 registers a
// thread, one block an SM), else two.
__host__ __device__ constexpr int wgs(int N) { return N <= 128 ? 3 : 2; }
// Two M-tiles in flight where two accumulator sets and two A fragments fit
// in those 168 registers without spilling (N = 96 at four k-steps does not).
__host__ __device__ constexpr bool pairs(int N, int NK) {
  return NK > 0 && (N <= 64 || (N <= 96 && NK <= 3));
}
constexpr int kSeg = 2048;             // row positions per unit of work, at most
constexpr int kMaxC = 800;             // columns of P (multiple of 32)
constexpr int kChunk = 4;              // k-steps per wgmma group
constexpr int kMaxSmem = 232448;       // a block's shared memory on an H100
constexpr int kWidths[] = {16, 32, 64, 96, 128, 192, 256};
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
// A raw slot: the bytes [p0, p0 + kSeg + C / 8) of a row, copied from the
// 16-byte boundary at or below their start.
__host__ __device__ constexpr int raw_bytes(int C) { return align16(kSeg + C / 8 + 30); }
// Expanded words of a unit: two a byte, and slack for loads past the staged
// bytes (the last chunk's, and a pair's second M-tile past the unit: their
// results are masked).
__host__ __device__ constexpr int exp_words(int C) { return 2 * (kSeg + 64 + C / 8) + 64; }
__host__ __device__ constexpr int wg_bytes(int C) { return 2 * raw_bytes(C) + 4 * exp_words(C); }
__host__ __device__ constexpr int head_bytes(int N, int C) { return align16(N * C + 4 * N); }
constexpr size_t smem_bytes(int N, int C) {
  return static_cast<size_t>(head_bytes(N, C)) + wgs(N) * static_cast<size_t>(wg_bytes(C));
}

// Four int8 lanes, byte j = +1 if bit j of the nibble x is set, else -1.
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t x) {
  // x * 0x204081 puts bit j of x at bit 8j (the four shifted copies do not
  // overlap); then 1 -> 0x01, 0 -> 0xFF, with no carries between bytes.
  const uint32_t v = (x * 0x204081u) & 0x01010101u;
  return ~(v * 0xFEu);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- wgmma m64nNk32 s32.s8.s8, A from registers ---------------------------
// Operands %0-%3 are the A fragment, %4 the B descriptor, %5 the scale-d
// flag (0: D = A B, 1: D += A B), %6 on the N / 2 accumulators; MSM_Rk lists
// the first 8k of them, MSM_OPSk binds them.
#define MSM_R1 "%6, %7, %8, %9, %10, %11, %12, %13"
#define MSM_R2 MSM_R1 ", %14, %15, %16, %17, %18, %19, %20, %21"
#define MSM_R3 MSM_R2 ", %22, %23, %24, %25, %26, %27, %28, %29"
#define MSM_R4 MSM_R3 ", %30, %31, %32, %33, %34, %35, %36, %37"
#define MSM_R5 MSM_R4 ", %38, %39, %40, %41, %42, %43, %44, %45"
#define MSM_R6 MSM_R5 ", %46, %47, %48, %49, %50, %51, %52, %53"
#define MSM_R7 MSM_R6 ", %54, %55, %56, %57, %58, %59, %60, %61"
#define MSM_R8 MSM_R7 ", %62, %63, %64, %65, %66, %67, %68, %69"
#define MSM_R9 MSM_R8 ", %70, %71, %72, %73, %74, %75, %76, %77"
#define MSM_R10 MSM_R9 ", %78, %79, %80, %81, %82, %83, %84, %85"
#define MSM_R11 MSM_R10 ", %86, %87, %88, %89, %90, %91, %92, %93"
#define MSM_R12 MSM_R11 ", %94, %95, %96, %97, %98, %99, %100, %101"
#define MSM_R13 MSM_R12 ", %102, %103, %104, %105, %106, %107, %108, %109"
#define MSM_R14 MSM_R13 ", %110, %111, %112, %113, %114, %115, %116, %117"
#define MSM_R15 MSM_R14 ", %118, %119, %120, %121, %122, %123, %124, %125"
#define MSM_R16 MSM_R15 ", %126, %127, %128, %129, %130, %131, %132, %133"

#define MSM_O8(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                     "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define MSM_OPS1(d) MSM_O8(d, 0)
#define MSM_OPS2(d) MSM_OPS1(d), MSM_O8(d, 8)
#define MSM_OPS3(d) MSM_OPS2(d), MSM_O8(d, 16)
#define MSM_OPS4(d) MSM_OPS3(d), MSM_O8(d, 24)
#define MSM_OPS5(d) MSM_OPS4(d), MSM_O8(d, 32)
#define MSM_OPS6(d) MSM_OPS5(d), MSM_O8(d, 40)
#define MSM_OPS7(d) MSM_OPS6(d), MSM_O8(d, 48)
#define MSM_OPS8(d) MSM_OPS7(d), MSM_O8(d, 56)
#define MSM_OPS9(d) MSM_OPS8(d), MSM_O8(d, 64)
#define MSM_OPS10(d) MSM_OPS9(d), MSM_O8(d, 72)
#define MSM_OPS11(d) MSM_OPS10(d), MSM_O8(d, 80)
#define MSM_OPS12(d) MSM_OPS11(d), MSM_O8(d, 88)
#define MSM_OPS13(d) MSM_OPS12(d), MSM_O8(d, 96)
#define MSM_OPS14(d) MSM_OPS13(d), MSM_O8(d, 104)
#define MSM_OPS15(d) MSM_OPS14(d), MSM_O8(d, 112)
#define MSM_OPS16(d) MSM_OPS15(d), MSM_O8(d, 120)

template <int N>
struct Wgmma;

#define MSM_WGMMA(K, N)                                                                    \
  template <>                                                                              \
  struct Wgmma<N> {                                                                        \
    static __device__ __forceinline__ void run(int32_t (&d)[N / 2], uint32_t a0,          \
                                               uint32_t a1, uint32_t a2, uint32_t a3,      \
                                               uint64_t desc, uint32_t accumulate) {      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                             \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" MSM_R##K       \
                   "}, {%0, %1, %2, %3}, %4, p;\n}\n"                                      \
                   : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(desc), "+r"(accumulate), \
                     MSM_OPS##K(d));                                                       \
    }                                                                                      \
  };

MSM_WGMMA(1, 16)
MSM_WGMMA(2, 32)
MSM_WGMMA(4, 64)
MSM_WGMMA(6, 96)
MSM_WGMMA(8, 128)
MSM_WGMMA(12, 192)
MSM_WGMMA(16, 256)

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {  // all but the last group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Pins register values in place: writes of the accumulators and the A
// fragment stay above the wgmma.fence, reads of the accumulators below the
// wait.
template <typename T, int M>
__device__ __forceinline__ void fence_regs(T (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// B descriptor (cute::GmmaDescriptor): start address, LBO and SBO in 16-byte
// units at bits 0, 16 and 32; base offset 0, layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

// ---- the segment ring ------------------------------------------------------
// A warpgroup's work is a contiguous range of the launch's M-tiles (64
// positions of a row; reps x n x ceil(L / 64) of them), cut into units that
// stay inside one row and hold at most kSeg positions.
struct Unit {
  const uint8_t* src;  // the row's byte at the unit's first position
  int64_t avail;       // bytes of the row from there (> 0)
  int tiles;           // M-tiles in the unit
};

__device__ __forceinline__ Unit unit_at(const uint8_t* payload, int64_t n, int64_t L,
                                        int64_t mt_row, int64_t m, int64_t m_end) {
  const int64_t q = m / mt_row;
  const int64_t t0 = m - q * mt_row;
  int64_t tiles = mt_row - t0;
  if (tiles > kSeg / 64) tiles = kSeg / 64;
  if (tiles > m_end - m) tiles = m_end - m;
  const int64_t p0 = 64 * t0;
  return {payload + (q % n) * L + p0, L - p0, static_cast<int>(tiles)};
}

// One warpgroup copies the unit's bytes and halo into a raw slot, in
// 16-byte cp.async chunks from the boundary at or below the first byte.  The
// last chunk may run up to 15 bytes past the row's (or the tile's) last
// byte, never past its 16-byte chunk.
__device__ __forceinline__ void stage_copy(const Unit& u, int C, uint8_t* dst, int tid) {
  const int64_t want = 64 * u.tiles + C / 8;
  const int64_t count = u.avail < want ? u.avail : want;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(u.src) & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(u.src) + count + 15) &
                       ~static_cast<uintptr_t>(15);
  const int chunks = static_cast<int>((a1 - a0) >> 4);
  const uint32_t d = smem_addr(dst);
  for (int c = tid; c < chunks; c += 128)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(d + 16 * c), "l"(a0 + 16 * static_cast<uintptr_t>(c)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The epilogue of one M-tile: every score is at most its target, so a hit
// is score == target, and the common case, no score at its target, is one
// compare a score (eight independent chains).  Accumulator 4j + a + 2h is
// row r + 8h, column 8j + 2t + a, whose target is tg[2j + a].  Only a
// thread that finds a hit counts exactly (rare): rows at or past valid lie
// at or past the row's end.
template <int N>
__device__ __forceinline__ void count_hits(const int32_t (&acc)[N / 2], const int32_t (&tg)[N / 4],
                                           int r, int valid, int t, int32_t* s_cnt) {
  bool reach[8] = {};
#pragma unroll
  for (int v = 0; v < N / 2; ++v) reach[v & 7] |= acc[v] >= tg[2 * (v >> 2) + (v & 1)];
  if (!((reach[0] | reach[1] | reach[2] | reach[3]) | (reach[4] | reach[5] | reach[6] | reach[7])))
    return;
#pragma unroll
  for (int q = 0; q < N / 2; q += 32) {
    uint32_t hits = 0;
#pragma unroll
    for (int i = 0; i < 32 && q + i < N / 2; ++i)
      hits |= static_cast<uint32_t>(acc[q + i] == tg[2 * ((q + i) >> 2) + ((q + i) & 1)]) << i;
    while (hits) {
      const int v = q + __ffs(hits) - 1;
      hits &= hits - 1;
      if (r + 8 * ((v >> 1) & 1) < valid) atomicAdd(&s_cnt[8 * (v >> 2) + 2 * t + (v & 1)], 1);
    }
  }
}

// ---- the kernel ------------------------------------------------------------
// NK: the k-steps (C / 32) when 1-4, issued without a branch; 0 for any C,
// in groups of kChunk k-steps (ptxas then serialises the wgmma).
template <int N, int NK>
__global__ void __launch_bounds__(128 * wgs(N), 1)
mxu_wgmma_kernel(const uint8_t* __restrict__ payload, const int8_t* __restrict__ P,
                 const int32_t* __restrict__ tgt, int32_t* __restrict__ out, int64_t n,
                 int64_t L, int C, int u_live, int64_t mtiles) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_B = smem;                                          // [C / 16][N / 8][8][16]
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem + N * C);    // [N]
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  uint8_t* s_raw = smem + head_bytes(N, C) + wg * wg_bytes(C);  // [2][raw_bytes]
  uint32_t* s_exp = reinterpret_cast<uint32_t*>(s_raw + 2 * raw_bytes(C));  // [exp_words]
  const int n0 = blockIdx.y * N;
  const int nk = NK ? NK : C / 32;

  constexpr int kWG = wgs(N);
  constexpr int kThreads = 128 * kWG;
  const int64_t workers = static_cast<int64_t>(gridDim.x) * kWG;
  const int64_t worker = static_cast<int64_t>(blockIdx.x) * kWG + wg;
  const int64_t mt_row = (L + 63) / 64;
  const int64_t m_end = mtiles * (worker + 1) / workers;
  int64_t m = mtiles * worker / workers;
  int slot = 0;
  Unit cur = unit_at(payload, n, L, mt_row, m, m_end);
  if (m < m_end) stage_copy(cur, C, s_raw, tid);
  cp_async_commit();

  // The block's N patterns, in core matrices (while the first units'
  // copies are in flight): pattern n, byte c of its row at
  // ((c / 16) * (N / 8) + n / 8) * 128 + (n % 8) * 16 + c % 16; 16-byte
  // chunks where P allows.
  if ((reinterpret_cast<uintptr_t>(P) & 15) == 0) {
    const int row_chunks = C / 16;
    for (int j = threadIdx.x; j < N * row_chunks; j += kThreads) {
      const int n = j / row_chunks;
      const int c = j - n * row_chunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + n < u_live)
        v = reinterpret_cast<const uint4*>(P + static_cast<int64_t>(n0 + n) * C)[c];
      *reinterpret_cast<uint4*>(s_B + (c * (N >> 3) + (n >> 3)) * 128 + (n & 7) * 16) = v;
    }
  } else {
    const int row_words = C / 4;
    for (int j = threadIdx.x; j < N * row_words; j += kThreads) {
      const int n = j / row_words;
      const int c = 4 * (j - n * row_words);
      uint32_t v = 0;
      if (n0 + n < u_live)
        v = *reinterpret_cast<const uint32_t*>(P + static_cast<int64_t>(n0 + n) * C + c);
      *reinterpret_cast<uint32_t*>(s_B + ((c >> 4) * (N >> 3) + (n >> 3)) * 128 + (n & 7) * 16 +
                                   (c & 15)) = v;
    }
  }
  for (int j = threadIdx.x; j < N; j += kThreads) s_cnt[j] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // s_B for the tensor cores
  __syncthreads();

  const int warp = tid >> 5;  // in the warpgroup: rows 16 warp .. 16 warp + 15
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // Accumulator 4j + a + 2h holds row 16 warp + g + 8h, column 8j + 2t + a,
  // whose target is tg[2j + a] (out of reach past the live patterns).
  int32_t tg[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int col = n0 + 8 * j + 2 * t + a;
      tg[2 * j + a] = col < u_live ? tgt[col] : INT32_MAX;
    }
  }
  const uint64_t desc0 = make_desc(smem_addr(s_B), 16 * N, 128);

  while (m < m_end) {
    const int64_t m_next = m + cur.tiles;
    Unit next = cur;
    if (m_next < m_end) {
      next = unit_at(payload, n, L, mt_row, m_next, m_end);
      stage_copy(next, C, s_raw + (slot ^ 1) * raw_bytes(C), tid);
    }
    cp_async_commit();
    cp_async_wait_prev();  // this thread's chunks of the current unit
    warpgroup_bar(wg);     // everyone's chunks; the last unit's readers are done
    const uint8_t* raw = s_raw + slot * raw_bytes(C) + (reinterpret_cast<uintptr_t>(cur.src) & 15);
    for (int b = tid; b < 64 * cur.tiles + C / 8; b += 128) {
      const uint32_t x = b < cur.avail ? raw[b] : 0u;
      reinterpret_cast<uint2*>(s_exp)[b] = make_uint2(pm1_nibble(x & 15u), pm1_nibble(x >> 4));
    }
    warpgroup_bar(wg);

    const int valid = cur.avail < 64 * cur.tiles ? static_cast<int>(cur.avail) : 64 * cur.tiles;
    if constexpr (pairs(N, NK)) {
      // Two M-tiles in flight: the second's product runs while the first's
      // scores are tested.  A unit's odd last M-tile pairs with one past it
      // (stale expanded bytes), whose rows are masked.
      for (int m0 = 0; m0 < valid; m0 += 128) {
        int32_t acc0[N / 2], acc1[N / 2];
        uint32_t w0[2 * NK + 4], w1[2 * NK + 4];
        const uint32_t* e = s_exp + 2 * (m0 + 16 * warp + g) + t;
#pragma unroll
        for (int h = 0; h < 2 * NK + 4; ++h) {
          w0[h] = e[4 * h];
          w1[h] = e[128 + 4 * h];
        }
        fence_regs(w0);
        fence_regs(w1);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < NK; ++i)
          Wgmma<N>::run(acc0, w0[2 * i], w0[2 * i + 4], w0[2 * i + 1], w0[2 * i + 5],
                        desc0 + static_cast<uint64_t>(2 * i * N), i > 0);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < NK; ++i)
          Wgmma<N>::run(acc1, w1[2 * i], w1[2 * i + 4], w1[2 * i + 1], w1[2 * i + 5],
                        desc0 + static_cast<uint64_t>(2 * i * N), i > 0);
        wgmma_commit();
        wgmma_wait_one();
        fence_regs(acc0);
        count_hits<N>(acc0, tg, m0 + 16 * warp + g, valid, t, s_cnt);
        wgmma_wait_all();
        fence_regs(acc1);
        count_hits<N>(acc1, tg, m0 + 64 + 16 * warp + g, valid, t, s_cnt);
      }
    } else {
    for (int m0 = 0; m0 < valid; m0 += 64) {
      int32_t acc[N / 2];  // written by the first wgmma (scale-d 0)
      // Word 4h of e: nibble t & 1 of byte m0 + 16 warp + g + 2h + t / 2.
      const uint32_t* e = s_exp + 2 * (m0 + 16 * warp + g) + t;
      if constexpr (NK > 0) {
        uint32_t w[2 * NK + 4];
#pragma unroll
        for (int h = 0; h < 2 * NK + 4; ++h) w[h] = e[4 * h];
        fence_regs(w);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < NK; ++i)
          Wgmma<N>::run(acc, w[2 * i], w[2 * i + 4], w[2 * i + 1], w[2 * i + 5],
                        desc0 + static_cast<uint64_t>(2 * i * N), i > 0);
        wgmma_commit();
      } else {
        for (int s0 = 0; s0 < nk; s0 += kChunk) {
          if (s0) wgmma_wait_all();  // the last group's A registers are free again
          uint32_t w[2 * kChunk + 4];
#pragma unroll
          for (int h = 0; h < 2 * kChunk + 4; ++h) w[h] = e[8 * s0 + 4 * h];
          fence_regs(w);
          __syncwarp();
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            if (s0 + i < nk)
              Wgmma<N>::run(acc, w[2 * i], w[2 * i + 4], w[2 * i + 1], w[2 * i + 5],
                            desc0 + static_cast<uint64_t>(2 * (s0 + i) * N), s0 + i > 0);
          }
          wgmma_commit();
        }
      }
      wgmma_wait_all();
      fence_regs(acc);

      count_hits<N>(acc, tg, m0 + 16 * warp + g, valid, t, s_cnt);
    }
    }
    m = m_next;
    cur = next;
    slot ^= 1;
  }

  __syncthreads();
  for (int j = threadIdx.x; j < N; j += kThreads)
    if (s_cnt[j]) atomicAdd(&out[n0 + j], s_cnt[j]);
}

// The wgmma width for u_live patterns at depth C: the fewest slots, counting
// 32 more a block for the work every block repeats; ties go to the wider.
int tile_width(int u_live, int C) {
  int best = 0;
  long long best_cost = 0;
  for (int N : kWidths) {
    if (smem_bytes(N, C) > static_cast<size_t>(kMaxSmem)) continue;
    const long long cost = static_cast<long long>((u_live + N - 1) / N) * (N + 32);
    if (best == 0 || cost <= best_cost) {
      best = N;
      best_cost = cost;
    }
  }
  return best;
}

template <int N, int NK>
int launch(const void* payload, const void* P, const void* tgt, void* out, long long n,
           long long L, int C, int reps, int u_live, int device, cudaStream_t stream) {
  // Per device: the shared-memory limit raised once, the SM count, and the
  // resident blocks per SM at each depth.
  static bool attr_set[kMaxDevices];
  static int sms[kMaxDevices];
  static int occupancy[kMaxDevices][kMaxC / 32 + 1];
  cudaError_t err;
  const size_t smem = smem_bytes(N, C);
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(mxu_wgmma_kernel<N, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[device] = true;
  }
  int& occ = occupancy[device][C / 32];
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, mxu_wgmma_kernel<N, NK>,
                                                        128 * wgs(N), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (occ < 1) occ = 1;
  }
  const long long mtiles = n * ((L + 63) / 64) * reps;
  const int ny = (u_live + N - 1) / N;
  long long bx = (static_cast<long long>(sms[device]) * occ + ny - 1) / ny;
  const long long need = (mtiles + wgs(N) - 1) / wgs(N);  // at least one M-tile a warpgroup
  if (bx > need) bx = need;
  mxu_wgmma_kernel<N, NK><<<dim3(static_cast<unsigned>(bx), ny), 128 * wgs(N), smem, stream>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int8_t*>(P),
      static_cast<const int32_t*>(tgt), static_cast<int32_t*>(out), static_cast<int64_t>(n),
      static_cast<int64_t>(L), C, u_live, static_cast<int64_t>(mtiles));
  return static_cast<int>(cudaGetLastError());
}

int count(const void* payload, const void* P, const void* tgt, void* out, long long n,
          long long L, int U_pad, int C, int reps, int u_live, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (U_pad <= 0 || C <= 0 || C % 32 || C > kMaxC || reps <= 0 || u_live <= 0 ||
      u_live > U_pad || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || L <= 0) return 0;
  const int N = tile_width(u_live, C);
  if (N == 0 || (u_live + N - 1) / N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = C / 32;
#define MSM_LAUNCH(W)                                                                  \
  case W:                                                                             \
    switch (nk) {                                                                     \
      case 1: return launch<W, 1>(payload, P, tgt, out, n, L, C, reps, u_live, device, st); \
      case 2: return launch<W, 2>(payload, P, tgt, out, n, L, C, reps, u_live, device, st); \
      case 3: return launch<W, 3>(payload, P, tgt, out, n, L, C, reps, u_live, device, st); \
      case 4: return launch<W, 4>(payload, P, tgt, out, n, L, C, reps, u_live, device, st); \
      default: return launch<W, 0>(payload, P, tgt, out, n, L, C, reps, u_live, device, st); \
    }
  switch (N) {
    MSM_LAUNCH(16)
    MSM_LAUNCH(32)
    MSM_LAUNCH(64)
    MSM_LAUNCH(96)
    MSM_LAUNCH(128)
    MSM_LAUNCH(192)
    MSM_LAUNCH(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MSM_LAUNCH
}

}  // namespace

extern "C" {

// Adds reps times the tile's counts into out int32[U_pad], which the caller
// has zeroed.  payload uint8[n, L]; P int8[U_pad, C] with C a multiple of 32
// up to 800 (rows 4-byte aligned); tgt int32[U_pad].  All U_pad slots are
// counted.
int msm_mxu_count(const void* payload, const void* P, const void* tgt, void* out,
                  long long n, long long L, int U_pad, int C, int reps, int device,
                  void* stream) {
  return count(payload, P, tgt, out, n, L, U_pad, C, reps, U_pad, device, stream);
}

// The same over the first u_live slots only (1 <= u_live <= U_pad): the
// slots past them are padding, which no score reaches; they stay 0.
int msm_mxu_count_live(const void* payload, const void* P, const void* tgt, void* out,
                       long long n, long long L, int U_pad, int C, int reps, int u_live,
                       int device, void* stream) {
  return count(payload, P, tgt, out, n, L, U_pad, C, reps, u_live, device, stream);
}

// The launch shape for u_live patterns at depth C (a multiple of 32 up to
// 800): shape[0] the wgmma width N (the patterns split into
// ceil(u_live / N) blocks of N), shape[1] the warpgroups a block, shape[2]
// its dynamic shared memory in bytes.
int msm_mxu_shape(int u_live, int C, int* shape) {
  if (u_live <= 0 || C <= 0 || C % 32 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int N = tile_width(u_live, C);
  shape[0] = N;
  shape[1] = wgs(N);
  shape[2] = static_cast<int>(smem_bytes(N, C));
  return 0;
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
