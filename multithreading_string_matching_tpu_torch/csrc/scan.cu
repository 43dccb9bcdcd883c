// DFA byte scans on Hopper (sm_90a): the Aho-Corasick engine (ac_scan) and
// the per-pattern KMP engine (kmp_scan).
//
// Neither replaces a Pallas kernel: the JAX package runs both scans as XLA
// lax.scan loops.  ac_scan replaces multithreading_string_matching_tpu/ops/
// scan.py::ac_scan_chunk_impl (the carried-state scan) together with the
// emit contraction of count_matches_ac (hist @ emit_sub); kmp_scan replaces
// ops/scan.py::_kmp_scan.
//
// What they compute, for every lane (row) r with nv = clamp(lengths[r], 0, L):
//   ac_scan : s = states_in[r] (the dead state if outside the table); for
//             i < nv: s = goto[s][payload[r, i]], and every unique pattern u
//             in out_ids[out_ptr[s] .. out_ptr[s+1]) counts once, into
//             out[u] (totals) or out[r, u] (per row); states_out[r] = s.
//             Positions past nv hold the state (never park it), so a later
//             chunk continues the same stream exactly.
//   kmp_scan: for each pattern p with accept state m = accept[p]: s = 0; for
//             i < nv: s = dfa[p][s][payload[r, i]]; count where s == m, into
//             out[p] (totals) or out[r, p] (per row).
//
// What bounds them on an H100: neither bytes nor operations.  A lane's
// next state depends on its last, so each lane is a chain of dependent
// table loads (about 2 operations and one load a byte); the card's
// parallelism is the lane count (kmp: lanes x patterns).  A one-shot tile of
// ~2,000 rows gives ~60 warps; the 100,000 rows of one large tile fill the
// card.  The bound chip_smoke.py records is the larger of the payload's
// read once and the lookups at the int32 peak; these kernels sit far above
// it, by the length of the chain times the load latency.
//
// What the design does about it:
// - The table's home.  Where the goto table fits one block's shared memory
//   (uint16 states: 397 states x 256 x 2 B = 203,264 B for the 97-token
//   stand-in set, after opting in to 227 KB), every block stages it once
//   and each step is a shared-memory load (~30 cycles); larger tables (the
//   3,072-rule set's 51,001 states, 26 MB as uint16; int32 above 65,536
//   states) are read from device memory through L2 (50 MB).  kmp_scan
//   stages one pattern's DFA (at most 256 states of uint8 rows, 64 KB) per
//   block; DFAs past 256 states (int32) are read from device memory.
// - Emission is rare: a bitmap of emitting states in shared memory tests
//   each step with one load; the CSR of outputs is read only on a hit.
//   Totals go to a per-block shared histogram where it fits, else to
//   device-memory atomics.  Per-row counts are plain increments: a lane is
//   its row's only writer.
// - Loads: each lane reads its row 16 bytes at a time (aligned uint4 loads
//   of the 16-byte blocks that hold its bytes), so a byte costs a shift.
// - Blocks: for a staged table, one block per SM where the lanes allow it
//   (128-1,024 threads), so the table is staged as few times as possible;
//   otherwise 256 threads.  kmp_scan's blocks are (pattern, 256 rows), with
//   the patterns on the fast grid axis so neighbouring blocks share rows in
//   L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kGridY = 65535;

struct AcArgs {
  const uint8_t* payload;
  const int32_t* lengths;
  const int32_t* states_in;
  int32_t* states_out;
  const void* table;        // uint16 or int32 [num_states * 256]
  const uint32_t* bits;     // emitting-state bitmap
  const int32_t* out_ptr;   // [num_states + 1]
  const int32_t* out_ids;   // unique pattern ids, by state
  int32_t* out;             // [U] or [n, U], zeroed by the caller
  int64_t n;
  int64_t L;
  uint32_t num_states;
  int U;
  int bits_words;
  int hist_smem;            // 1: totals go through a shared histogram
};

struct KmpArgs {
  const uint8_t* payload;
  const int32_t* lengths;
  const void* table;        // uint8 or int32 [P, M, 256]
  const int32_t* accept;    // [P]
  int32_t* out;             // [P] or [n, P], zeroed by the caller
  int64_t n;
  int64_t L;
  int P;
  int M;
  int64_t r0;               // first row of this launch
};

template <typename T, bool kShared>
__device__ __forceinline__ uint32_t entry(const T* t, uint32_t i) {
  if (kShared) return static_cast<uint32_t>(t[i]);
  return static_cast<uint32_t>(__ldg(t + i));
}

// Visit the bytes payload[row, 0 .. nv) in order, 16-byte aligned blocks at
// a time: step(byte) for each.  Only blocks that hold a byte of the range
// are read, so no load leaves the row's allocation.
template <typename Step>
__device__ __forceinline__ void for_each_byte(const uint8_t* row, int64_t nv, Step step) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t end = start + static_cast<uintptr_t>(nv);
  for (uintptr_t blk = start & ~static_cast<uintptr_t>(15); blk < end; blk += 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(blk));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int lo = blk < start ? static_cast<int>(start - blk) : 0;
    const int hi = end - blk < 16 ? static_cast<int>(end - blk) : 16;
    if (lo == 0 && hi == 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) step((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k >= lo && k < hi) step((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
      }
    }
  }
}

__device__ __forceinline__ int64_t valid_bytes(const int32_t* lengths, int64_t r, int64_t L) {
  const int64_t len = lengths[r];
  return len < 0 ? 0 : (len > L ? L : len);
}

template <typename T, bool kSharedTable, bool kPerRow>
__global__ void __launch_bounds__(1024) ac_scan_kernel(AcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* table = static_cast<const T*>(a.table);
  size_t off = 0;
  if (kSharedTable) {
    // num_states * 256 * sizeof(T) is a multiple of 512 bytes.
    const size_t chunks = static_cast<size_t>(a.num_states) * 256 * sizeof(T) / 16;
    const uint4* src = static_cast<const uint4*>(a.table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (size_t i = threadIdx.x; i < chunks; i += blockDim.x) dst[i] = __ldg(src + i);
    table = reinterpret_cast<const T*>(smem);
    off = chunks * 16;
  }
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + off);
  for (int i = threadIdx.x; i < a.bits_words; i += blockDim.x) s_bits[i] = __ldg(a.bits + i);
  off += 4 * static_cast<size_t>(a.bits_words);
  int32_t* s_hist = (!kPerRow && a.hist_smem) ? reinterpret_cast<int32_t*>(smem + off) : nullptr;
  if (s_hist != nullptr) {
    for (int i = threadIdx.x; i < a.U; i += blockDim.x) s_hist[i] = 0;
  }
  __syncthreads();

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r < a.n) {
    const uint32_t dead = a.num_states - 1;
    uint32_t s = static_cast<uint32_t>(a.states_in[r]);
    if (s > dead) s = dead;
    int32_t* counts = kPerRow ? a.out + r * a.U : (s_hist != nullptr ? s_hist : a.out);
    for_each_byte(a.payload + r * a.L, valid_bytes(a.lengths, r, a.L), [&](uint32_t byte) {
      s = entry<T, kSharedTable>(table, s * 256u + byte);
      if ((s_bits[s >> 5] >> (s & 31u)) & 1u) {
        const int e = __ldg(a.out_ptr + s + 1);
        for (int k = __ldg(a.out_ptr + s); k < e; ++k) {
          const int u = __ldg(a.out_ids + k);
          if (kPerRow) {
            counts[u] += 1;
          } else {
            atomicAdd(counts + u, 1);
          }
        }
      }
    });
    a.states_out[r] = static_cast<int32_t>(s);
  }
  if (s_hist != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < a.U; i += blockDim.x) {
      if (s_hist[i]) atomicAdd(a.out + i, s_hist[i]);
    }
  }
}

template <typename T, bool kSharedDfa, bool kPerRow>
__global__ void __launch_bounds__(256) kmp_scan_kernel(KmpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = static_cast<int>(blockIdx.x);
  const uint32_t m = static_cast<uint32_t>(__ldg(a.accept + p));
  const T* dfa = static_cast<const T*>(a.table) + static_cast<int64_t>(p) * a.M * 256;
  if (kSharedDfa) {
    // Only this pattern's rows 0..m: the rows past its accept are padding.
    const int chunks = static_cast<int>((m + 1) * 256 * sizeof(T) / 16);
    const uint4* src = reinterpret_cast<const uint4*>(dfa);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) dst[i] = __ldg(src + i);
    __syncthreads();
    dfa = reinterpret_cast<const T*>(smem);
  }
  const int64_t r = a.r0 + static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  int cnt = 0;
  if (r < a.n) {
    uint32_t s = 0;
    for_each_byte(a.payload + r * a.L, valid_bytes(a.lengths, r, a.L), [&](uint32_t byte) {
      s = entry<T, kSharedDfa>(dfa, s * 256u + byte);
      cnt += s == m;
    });
    if (kPerRow) a.out[r * a.P + p] = cnt;
  }
  if (!kPerRow) {
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, o);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(a.out + p, cnt);
  }
}

// The card's SM count and opt-in shared memory per block, asked once.
cudaError_t device_limits(int device, int* sms, int* max_smem) {
  static int cached_sms[kMaxDevices];
  static int cached_smem[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[device] == 0) {
    int v = 0;
    cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cached_smem[device] = v;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached_sms[device] = v;
  }
  *sms = cached_sms[device];
  *max_smem = cached_smem[device];
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool kSharedTable, bool kPerRow>
cudaError_t ac_launch(const AcArgs& a, size_t smem, int threads, cudaStream_t stream) {
  auto kernel = ac_scan_kernel<T, kSharedTable, kPerRow>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (a.n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ac_dispatch(AcArgs a, bool per_row, int device, cudaStream_t stream) {
  int sms = 0, max_smem = 0;
  cudaError_t err = device_limits(device, &sms, &max_smem);
  if (err != cudaSuccess) return err;
  const size_t table_bytes = static_cast<size_t>(a.num_states) * 256 * sizeof(T);
  const size_t bits_bytes = 4 * static_cast<size_t>(a.bits_words);
  const size_t hist_bytes = per_row ? 0 : 4 * static_cast<size_t>(a.U);
  const bool shared_table = table_bytes + bits_bytes <= static_cast<size_t>(max_smem);
  size_t smem = (shared_table ? table_bytes : 0) + bits_bytes;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;  // bitmap alone
  a.hist_smem = !per_row && smem + hist_bytes <= static_cast<size_t>(max_smem);
  if (a.hist_smem) smem += hist_bytes;
  int threads = 256;
  if (shared_table) {
    // One block per SM where the lanes allow it: the table is staged once
    // a block.
    const int64_t per_sm = (a.n + sms - 1) / sms;
    const int64_t t = (per_sm + 31) / 32 * 32;
    threads = static_cast<int>(t < 128 ? 128 : (t > 1024 ? 1024 : t));
  }
  if (per_row) {
    return shared_table ? ac_launch<T, true, true>(a, smem, threads, stream)
                        : ac_launch<T, false, true>(a, smem, threads, stream);
  }
  return shared_table ? ac_launch<T, true, false>(a, smem, threads, stream)
                      : ac_launch<T, false, false>(a, smem, threads, stream);
}

template <typename T, bool kSharedDfa, bool kPerRow>
cudaError_t kmp_launch(KmpArgs a, size_t smem, cudaStream_t stream) {
  constexpr int kThreads = 256;
  auto kernel = kmp_scan_kernel<T, kSharedDfa, kPerRow>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t row_blocks = (a.n + kThreads - 1) / kThreads;
  // Patterns on the fast axis (x); rows in slices of at most kGridY blocks.
  for (int64_t rb = 0; rb < row_blocks; rb += kGridY) {
    const int64_t nb = row_blocks - rb < kGridY ? row_blocks - rb : kGridY;
    a.r0 = rb * kThreads;
    kernel<<<dim3(static_cast<unsigned>(a.P), static_cast<unsigned>(nb)), kThreads, smem,
             stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// uint8 DFAs (at most 256 states, 64 KB a pattern) are staged in shared
// memory; int32 ones (patterns past 255 bytes: 257 KB or more) are read from
// device memory.
cudaError_t kmp_dispatch(const KmpArgs& a, int table_bytes, int max_accept, bool per_row,
                         int device, cudaStream_t stream) {
  int sms = 0, max_smem = 0;
  cudaError_t err = device_limits(device, &sms, &max_smem);
  if (err != cudaSuccess) return err;
  if (table_bytes == 4) {
    return per_row ? kmp_launch<int32_t, false, true>(a, 0, stream)
                   : kmp_launch<int32_t, false, false>(a, 0, stream);
  }
  const size_t smem = static_cast<size_t>(max_accept + 1) * 256;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  return per_row ? kmp_launch<uint8_t, true, true>(a, smem, stream)
                 : kmp_launch<uint8_t, true, false>(a, smem, stream);
}

}  // namespace

extern "C" {

// Aho-Corasick scan of payload uint8[n, L] from states_in int32[n]:
// states_out int32[n], and counts added into out (int32[U] totals, or
// int32[n, U] with per_row), which the caller has zeroed.  table holds
// num_states * 256 entries of table_bytes (2: uint16, 4: int32) bytes;
// emit_bits is the bitmap of emitting states, out_ptr/out_ids the CSR of
// the unique patterns each state emits.
int msm_ac_scan(const void* payload, const void* lengths, const void* states_in,
                void* states_out, const void* table, int table_bytes, const void* emit_bits,
                const void* out_ptr, const void* out_ids, void* out, long long n, long long L,
                int num_states, int U, int per_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (L < 0 || num_states <= 0 || U < 0 || (table_bytes != 2 && table_bytes != 4) ||
      (table_bytes == 2 && num_states > 65536))
    return static_cast<int>(cudaErrorInvalidValue);
  AcArgs a{};
  a.payload = static_cast<const uint8_t*>(payload);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.states_in = static_cast<const int32_t*>(states_in);
  a.states_out = static_cast<int32_t*>(states_out);
  a.table = table;
  a.bits = static_cast<const uint32_t*>(emit_bits);
  a.out_ptr = static_cast<const int32_t*>(out_ptr);
  a.out_ids = static_cast<const int32_t*>(out_ids);
  a.out = static_cast<int32_t*>(out);
  a.n = n;
  a.L = L;
  a.num_states = static_cast<uint32_t>(num_states);
  a.U = U;
  a.bits_words = (num_states + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(table_bytes == 2
                              ? ac_dispatch<uint16_t>(a, per_row != 0, device, s)
                              : ac_dispatch<int32_t>(a, per_row != 0, device, s));
}

// Per-pattern KMP scan of payload uint8[n, L]: counts added into out
// (int32[P] totals, or int32[n, P] with per_row), which the caller has
// zeroed.  table holds P stacked DFAs of M * 256 entries of table_bytes (1:
// uint8, 4: int32) bytes; accept[p] in [1, M) is pattern p's accept state,
// max_accept their maximum.
int msm_kmp_scan(const void* payload, const void* lengths, const void* table, int table_bytes,
                 const void* accept, void* out, long long n, long long L, int P, int M,
                 int max_accept, int per_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || P <= 0) return 0;
  if (L < 0 || M < 2 || max_accept < 1 || max_accept >= M ||
      (table_bytes != 1 && table_bytes != 4) || (table_bytes == 1 && M > 256))
    return static_cast<int>(cudaErrorInvalidValue);
  KmpArgs a{};
  a.payload = static_cast<const uint8_t*>(payload);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.table = table;
  a.accept = static_cast<const int32_t*>(accept);
  a.out = static_cast<int32_t*>(out);
  a.n = n;
  a.L = L;
  a.P = P;
  a.M = M;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kmp_dispatch(a, table_bytes, max_accept, per_row != 0, device, s));
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
