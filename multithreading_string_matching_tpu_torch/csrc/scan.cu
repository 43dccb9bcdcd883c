// DFA byte scans on Hopper (sm_90a): the Aho-Corasick engine (ac_scan) and
// the per-pattern KMP engine (kmp_scan).
//
// Neither replaces a Pallas kernel: the JAX package runs both scans as XLA
// lax.scan loops.  ac_scan replaces multithreading_string_matching_tpu/ops/
// scan.py::ac_scan_chunk_impl (the carried-state scan) together with the
// emit contraction of count_matches_ac (hist @ emit_sub); kmp_scan replaces
// ops/scan.py::_kmp_scan.
//
// What they compute, for every lane (row) r of every tile of a launch, with
// nv = clamp(lengths[r], 0, L):
//   ac_scan : s = states_in[r] (the root without states_in; the wrapper
//             refuses states outside [0, dead]); for i < nv:
//             s = goto[s][payload[r, i]], and every unique pattern u in
//             out_ids[out_ptr[s] .. out_ptr[s+1]) counts once, into out[u]
//             (totals) or out[row0 + r, u] (per row); states_out[r] = s.
//             Positions past nv hold the state (never park it), so a later
//             chunk continues the same stream exactly.
//   kmp_scan: for each pattern p with accept state m = accept[p]: s = 0; for
//             i < nv: s = dfa[p][s][payload[r, i]]; count where s == m, into
//             out[p] (totals) or out[row0 + r, p] (per row).
//
// What bounds them on an H100.  A lane's next state depends on its last, so
// a lane is a chain of dependent table loads; the work is about one lookup a
// byte (ac) or a byte and pattern (kmp).  The bound chip_smoke.py records is
// the larger of the payload read once and the lookups' integer operations
// at the int32 peak: bytes for ac_scan, operations for kmp_scan (97 lookups
// a byte for the stand-in set).  The floor under both is the shared-memory
// load rate, 32 lookups a cycle per SM.
//
// What held the first versions back, and what this design does about it:
// - ac_scan ran one thread a lane, one launch a tile.  A bucket tile of
//   ~1,900 rows gave ~60 warps on ~15 of 132 SMs, each a ~1,000-step chain
//   of two dependent loads a byte (the table, then an emit bitmap), and the
//   53 tiles of a pass ran one launch after another.  Now:
//   * Split rows.  Row r is cut into segments of C bytes; segment j > 0
//     starts D bytes early, from the root, and counts only positions at or
//     past j*C.  D is the automaton's greatest state depth: after any text
//     the AC state is the longest suffix of it that is a trie node, at most
//     D bytes long, so a root start D bytes early reaches the state the
//     whole lane reaches.  Segment 0, and any segment whose warm-up would
//     reach before byte 0, starts at byte 0 from states_in[r].  A lane in
//     the dead state stays dead in every segment and counts nothing.  The
//     thread whose segment holds byte nv - 1 (segment 0 when nv == 0)
//     writes states_out[r].  A row's counts have several writers: atomics
//     (emission is rare).
//   * The emit test in the table.  Where the state number leaves a bit free
//     (uint16 tables of at most 32,768 states; int32 tables), the kernel
//     table's entry carries the emitting-state bit of the state it leads
//     to, so a step is one shared load.  uint16 tables of more states keep
//     a bitmap of emitting states in shared memory.
//   * One launch a pass.  A launch takes a list of tiles (payload, lengths,
//     states, its first global work item); persistent blocks walk the
//     global segment index, so a pass over 53 bucket tiles is one launch of
//     ~1.9 M segments, and each block stages the table once.
// - kmp_scan ran one (pattern, 256 rows) block each: every payload byte was
//   fetched and unpacked once per pattern.  Now a block stages the DFAs of a
//   group of G patterns (by DFA size) in shared memory, interleaved as
//   [state][slot][256] uint8 with each pattern's accept state renumbered to
//   the group's last state, and each thread walks its row once, advancing G
//   states held in registers per byte (G independent chains: the loads
//   overlap) and counting each pattern's accepts in a register.  Totals
//   reduce by warp shuffles, then one atomic per (warp, pattern); per-row
//   counts are written once per (row, pattern).  G comes from the host:
//   shared memory, registers (G <= 32) and enough lanes to fill the card.
//   Patterns past 255 bytes (int32 DFAs of 257 or more states) keep one
//   pattern a block, read from device memory.
// - Tables whose home is not shared memory (the 3,072-rule set's 51,112
//   states, 26 MB as uint16; int32 tables) are read through L2 (50 MB).
// - Loads: each thread reads its bytes 16 at a time (aligned uint4 loads of
//   the 16-byte blocks that hold them), so a byte costs a shift.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kKmpThreads = 256;

// One tile of a launch: the wrapper's TILE_DTYPE (ops/scan.py), 64 bytes.
struct Tile {
  const uint8_t* payload;    // uint8[n, L]
  const int32_t* lengths;    // int32[n]
  const int32_t* states_in;  // int32[n], or null: every lane from the root
  int32_t* states_out;       // int32[n], or null: not written
  long long first;           // global index of the tile's first work item
  long long row0;            // the tile's first row in a per-row output
  int n;
  int L;
  int C;                     // segment bytes (ac_scan); 0 (kmp_scan)
  int segs;                  // work items a row: segments (ac), 1 (kmp)
};
static_assert(sizeof(Tile) == 64, "Tile must match ops/scan.py TILE_DTYPE");

struct TileList {
  const Tile* tiles;  // device copy of the list (num > 1)
  Tile one;           // the tile itself when num == 1
  int num;

  __device__ __forceinline__ Tile get(int t) const { return num == 1 ? one : tiles[t]; }
  __device__ __forceinline__ long long first(int t) const {
    return t >= num ? LLONG_MAX : (num == 1 ? one.first : tiles[t].first);
  }
  // The tile that holds global work item g (tiles are in order of first).
  __device__ __forceinline__ int find(long long g) const {
    int lo = 0, hi = num - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tiles[mid].first <= g) lo = mid; else hi = mid - 1;
    }
    return lo;
  }
};

struct AcArgs {
  TileList list;
  long long total;           // segments over the list
  const void* table;         // the kernel table: uint16 or int32 [num_states * 256]
  const uint32_t* bits;      // emitting-state bitmap (unflagged tables)
  const int32_t* out_ptr;    // [num_states + 1]
  const int32_t* out_ids;    // unique pattern ids, by state
  int32_t* out;              // [U] or [rows, U], zeroed by the caller
  uint32_t num_states;
  int D;                     // greatest state depth (warm-up bytes)
  int U;
  int bits_words;
  int hist_smem;             // 1: totals go through a shared histogram
};

struct KmpArgs {
  TileList list;
  long long total;           // rows over the list
  const void* table;         // uint8 or int32 [P, M, 256]
  const int32_t* accept;     // [P]
  const int32_t* order;      // [P] pattern ids by accept state, ascending
  int32_t* out;              // [P] or [rows, P], zeroed by the caller
  int P;
  int M;
  int groups;                // group g holds order[g*P/groups .. (g+1)*P/groups)
};

template <typename T, bool kShared>
__device__ __forceinline__ uint32_t entry(const T* t, uint32_t i) {
  if (kShared) return static_cast<uint32_t>(t[i]);
  return static_cast<uint32_t>(__ldg(t + i));
}

// The bytes lo .. hi-1 of one 16-byte block, shifted out of a 128-bit
// register chain one at a time in a loop that is not unrolled: step(byte)
// for each.
template <typename Step>
__device__ __forceinline__ void block_bytes(uint4 v, int lo, int hi, Step& step) {
  uint32_t x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
#pragma unroll 1
  for (int k = 0; k < hi; ++k) {
    if (k >= lo) step(x0 & 0xFFu);
    x0 = __funnelshift_r(x0, x1, 8);
    x1 = __funnelshift_r(x1, x2, 8);
    x2 = __funnelshift_r(x2, x3, 8);
    x3 >>= 8;
  }
}

// Visit the bytes row[0 .. nv) in order, 16-byte aligned blocks at a time:
// step(byte) for each, unrolled over whole blocks, rolled over the partial
// first and last ones (so the step's code appears twice, not 32 times).
// Only blocks that hold a byte of the range are read, so no load leaves the
// row's allocation.
template <typename Step>
__device__ __forceinline__ void for_each_byte(const uint8_t* row, int64_t nv, Step& step) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t end = start + static_cast<uintptr_t>(nv);
  for (uintptr_t blk = start & ~static_cast<uintptr_t>(15); blk < end; blk += 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(blk));
    const int lo = blk < start ? static_cast<int>(start - blk) : 0;
    const int hi = end - blk < 16 ? static_cast<int>(end - blk) : 16;
    if (lo == 0 && hi == 16) {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) step((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
    } else {
      block_bytes(v, lo, hi, step);
    }
  }
}

// The same walk with every block rolled, and the next block's load issued
// before this block's steps: for steps of many lookups (kmp_scan's G
// patterns a byte), where unrolling 16 of them would blow up the code.
template <typename Step>
__device__ __forceinline__ void for_each_byte_rolled(const uint8_t* row, int64_t nv, Step& step) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t end = start + static_cast<uintptr_t>(nv);
  uintptr_t blk = start & ~static_cast<uintptr_t>(15);
  if (blk >= end) return;
  uint4 next = __ldg(reinterpret_cast<const uint4*>(blk));
  for (; blk < end; blk += 16) {
    const uint4 v = next;
    if (blk + 16 < end) next = __ldg(reinterpret_cast<const uint4*>(blk + 16));
    const int lo = blk < start ? static_cast<int>(start - blk) : 0;
    const int hi = end - blk < 16 ? static_cast<int>(end - blk) : 16;
    block_bytes(v, lo, hi, step);
  }
}

__device__ __forceinline__ int64_t valid_bytes(const int32_t* lengths, int64_t r, int64_t L) {
  const int64_t len = lengths[r];
  return len < 0 ? 0 : (len > L ? L : len);
}

// ---------------------------------------------------------------------------
// ac_scan
// ---------------------------------------------------------------------------

// kFlag: the kernel table's top bit says the state an entry leads to emits.
template <typename T, bool kFlag>
struct AcBits {
  static constexpr uint32_t kFlagBit = kFlag ? (sizeof(T) == 2 ? 0x8000u : 0x80000000u) : 0u;
  static constexpr uint32_t kMask = kFlag ? kFlagBit - 1u : 0xFFFFFFFFu;
};

// A warm-up step: advance, count nothing.
template <typename T, bool kFlag, bool kShared>
struct AcWarm {
  const T* table;
  uint32_t s;
  __device__ __forceinline__ void operator()(uint32_t byte) {
    s = entry<T, kShared>(table, s * 256u + byte) & AcBits<T, kFlag>::kMask;
  }
};

// A counting step: advance, and on an emitting state count each unique
// pattern it emits (the CSR out_ptr / out_ids) into counts.
template <typename T, bool kFlag, bool kShared>
struct AcCount {
  const T* table;
  const uint32_t* bits;  // shared bitmap of emitting states (!kFlag)
  const int32_t* out_ptr;
  const int32_t* out_ids;
  int32_t* counts;
  uint32_t s;
  __device__ __forceinline__ void operator()(uint32_t byte) {
    const uint32_t e = entry<T, kShared>(table, s * 256u + byte);
    s = e & AcBits<T, kFlag>::kMask;
    const bool emits = kFlag ? (e & AcBits<T, kFlag>::kFlagBit) != 0u
                             : ((bits[s >> 5] >> (s & 31u)) & 1u) != 0u;
    if (emits) {
      const int end = __ldg(out_ptr + s + 1);
      for (int k = __ldg(out_ptr + s); k < end; ++k) atomicAdd(counts + __ldg(out_ids + k), 1);
    }
  }
};

template <typename T, bool kFlag, bool kShared, bool kPerRow>
__global__ void __launch_bounds__(1024) ac_scan_kernel(AcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* table = static_cast<const T*>(a.table);
  size_t off = 0;
  if (kShared) {
    // num_states * 256 * sizeof(T) is a multiple of 512 bytes.
    const size_t chunks = static_cast<size_t>(a.num_states) * 256 * sizeof(T) / 16;
    const uint4* src = static_cast<const uint4*>(a.table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (size_t i = threadIdx.x; i < chunks; i += blockDim.x) dst[i] = __ldg(src + i);
    table = reinterpret_cast<const T*>(smem);
    off = chunks * 16;
  }
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + off);
  if (!kFlag) {
    for (int i = threadIdx.x; i < a.bits_words; i += blockDim.x) s_bits[i] = __ldg(a.bits + i);
    off += 4 * static_cast<size_t>(a.bits_words);
  }
  int32_t* s_hist = (!kPerRow && a.hist_smem) ? reinterpret_cast<int32_t*>(smem + off) : nullptr;
  if (s_hist != nullptr) {
    for (int i = threadIdx.x; i < a.U; i += blockDim.x) s_hist[i] = 0;
  }
  __syncthreads();

  const uint32_t dead = a.num_states - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int t = g < a.total ? a.list.find(g) : 0;
  Tile tile = a.list.get(t);
  long long next = a.list.first(t + 1);
  for (; g < a.total; g += stride) {
    while (g >= next) {  // the global index only grows: walk on
      ++t;
      tile = a.list.get(t);
      next = a.list.first(t + 1);
    }
    // n * segs <= n * L < 2^31 (the wrapper splits lists at 2^31 positions).
    const uint32_t local = static_cast<uint32_t>(g - tile.first);
    const uint32_t r = local / static_cast<uint32_t>(tile.segs);
    const uint32_t j = local - r * static_cast<uint32_t>(tile.segs);
    const int64_t nv = valid_bytes(tile.lengths, r, tile.L);
    const int64_t lo = static_cast<int64_t>(j) * tile.C;
    if (j > 0 && lo >= nv) continue;  // past the lane's bytes
    const int64_t hi = lo + tile.C < nv ? lo + tile.C : nv;
    const uint32_t s_in = tile.states_in != nullptr ? static_cast<uint32_t>(tile.states_in[r]) : 0u;
    uint32_t s = s_in;
    if (s_in != dead) {
      int64_t w = lo - a.D;
      if (w > 0) {
        s = 0;  // warm up from the root
      } else {
        w = 0;  // the warm-up would reach before byte 0: the lane's own start
      }
      const uint8_t* row = tile.payload + static_cast<int64_t>(r) * tile.L;
      AcWarm<T, kFlag, kShared> warm{table, s};
      for_each_byte(row + w, lo - w, warm);
      AcCount<T, kFlag, kShared> step{
          table, s_bits, a.out_ptr, a.out_ids,
          kPerRow ? a.out + (tile.row0 + r) * a.U : (s_hist != nullptr ? s_hist : a.out),
          warm.s};
      for_each_byte(row + lo, hi - lo, step);
      s = step.s;
    }
    // The segment that holds byte nv - 1 (segment 0 when nv == 0) owns the
    // lane's final state.
    if (tile.states_out != nullptr && hi == nv) tile.states_out[r] = static_cast<int32_t>(s);
  }
  if (s_hist != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < a.U; i += blockDim.x) {
      if (s_hist[i]) atomicAdd(a.out + i, s_hist[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// kmp_scan
// ---------------------------------------------------------------------------

// Relabel the bytes of a staged DFA word: the accept state m becomes the
// group's last state R - 1.
__device__ __forceinline__ uint32_t relabel(uint32_t w, uint32_t m, uint32_t last) {
  uint32_t out = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = (w >> (8 * q)) & 0xFFu;
    v = v == m ? last : v;
    out |= v << (8 * q);
  }
  return out;
}

template <int kG, bool kPerRow>
__global__ void __launch_bounds__(kKmpThreads) kmp_group_kernel(KmpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];  // uint8 [R][kG][256]
  __shared__ int s_pat[kG];
  __shared__ int s_acc[kG];
  const int grp = blockIdx.x;
  const int p_lo = static_cast<int>(static_cast<long long>(grp) * a.P / a.groups);
  const int gsize = static_cast<int>(static_cast<long long>(grp + 1) * a.P / a.groups) - p_lo;
  if (threadIdx.x < kG) {
    const int k = threadIdx.x;
    const int p = k < gsize ? __ldg(a.order + p_lo + k) : -1;
    s_pat[k] = p;
    s_acc[k] = p < 0 ? -1 : __ldg(a.accept + p);
  }
  __syncthreads();
  // Patterns are in order of accept state: the group's last has the most
  // states.
  const uint32_t R = static_cast<uint32_t>(s_acc[gsize - 1]) + 1u;
  const uint32_t last = R - 1u;
  {
    // Stage rows 0..R-1 of each slot, 4 bytes at a time: state s of slot k
    // at (s * kG + k) * 256.  Slot k's accept state m lands on R - 1; its
    // rows between m and R - 1 are unreachable and zero, as are empty slots
    // (whose state stays 0 and never reaches R - 1 >= 1).
    const uint8_t* dfa = static_cast<const uint8_t*>(a.table);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    const int words = static_cast<int>(R) * kG * 64;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int wb = i & 63;
      const int k = (i >> 6) % kG;
      const int s = (i >> 6) / kG;
      const int p = s_pat[k];
      uint32_t w = 0;
      if (p >= 0) {
        const int m = s_acc[k];
        const int src = s == static_cast<int>(last) ? m : (s < m ? s : -1);
        if (src >= 0) {
          const uint32_t* row = reinterpret_cast<const uint32_t*>(
              dfa + (static_cast<int64_t>(p) * a.M + src) * 256);
          w = relabel(__ldg(row + wb), static_cast<uint32_t>(m), last);
        }
      }
      dst[i] = w;
    }
  }
  __syncthreads();

  const uint8_t* rows = smem;
  uint32_t st[kG];
  int cnt[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) cnt[k] = 0;
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x; g < a.total;
       g += stride) {
    const Tile tile = a.list.get(a.list.num == 1 ? 0 : a.list.find(g));
    const int64_t r = g - tile.first;
#pragma unroll
    for (int k = 0; k < kG; ++k) st[k] = 0;
    if (kPerRow) {
#pragma unroll
      for (int k = 0; k < kG; ++k) cnt[k] = 0;
    }
    auto step = [&](uint32_t byte) {
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const uint32_t e = rows[st[k] * (kG * 256u) + byte + k * 256u];
        st[k] = e;
        cnt[k] += e == last;
      }
    };
    // Up to 4 slots a byte, unrolling whole blocks stays small.
    if (kG <= 4) {
      for_each_byte(tile.payload + r * tile.L, valid_bytes(tile.lengths, r, tile.L), step);
    } else {
      for_each_byte_rolled(tile.payload + r * tile.L, valid_bytes(tile.lengths, r, tile.L), step);
    }
    if (kPerRow) {
      int32_t* out = a.out + (tile.row0 + r) * a.P;
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        if (k < gsize) out[s_pat[k]] = cnt[k];
      }
    }
  }
  if (!kPerRow) {
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      int v = cnt[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
      if ((threadIdx.x & 31) == 0 && k < gsize && v) atomicAdd(a.out + s_pat[k], v);
    }
  }
}

// DFAs past 256 states (patterns past 255 bytes, int32): one pattern a
// block, read from device memory.
template <bool kPerRow>
__global__ void __launch_bounds__(kKmpThreads) kmp_wide_kernel(KmpArgs a) {
  const int p = static_cast<int>(blockIdx.x);
  const uint32_t m = static_cast<uint32_t>(__ldg(a.accept + p));
  const int32_t* dfa = static_cast<const int32_t*>(a.table) + static_cast<int64_t>(p) * a.M * 256;
  int cnt = 0;
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x; g < a.total;
       g += stride) {
    const Tile tile = a.list.get(a.list.num == 1 ? 0 : a.list.find(g));
    const int64_t r = g - tile.first;
    if (kPerRow) cnt = 0;
    uint32_t s = 0;
    auto step = [&](uint32_t byte) {
      s = static_cast<uint32_t>(__ldg(dfa + s * 256u + byte));
      cnt += s == m;
    };
    for_each_byte(tile.payload + r * tile.L, valid_bytes(tile.lengths, r, tile.L), step);
    if (kPerRow) a.out[(tile.row0 + r) * a.P + p] = cnt;
  }
  if (!kPerRow) {
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, o);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(a.out + p, cnt);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

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

// Opt the kernel in to smem bytes of dynamic shared memory; the blocks of
// it that fit one SM at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename T, bool kFlag, bool kShared, bool kPerRow>
cudaError_t ac_launch(const AcArgs& a, size_t smem, int threads, int sms, cudaStream_t stream) {
  auto kernel = ac_scan_kernel<T, kFlag, kShared, kPerRow>;
  int per_sm = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  // Persistent blocks: as many as are resident at once, fewer when the
  // segments run out first.
  long long blocks = (a.total + threads - 1) / threads;
  if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kFlag>
cudaError_t ac_dispatch(AcArgs a, bool per_row, int device, cudaStream_t stream) {
  int sms = 0, max_smem = 0;
  cudaError_t err = device_limits(device, &sms, &max_smem);
  if (err != cudaSuccess) return err;
  const size_t table_bytes = static_cast<size_t>(a.num_states) * 256 * sizeof(T);
  const size_t bits_bytes = kFlag ? 0 : 4 * static_cast<size_t>(a.bits_words);
  const size_t hist_bytes = per_row ? 0 : 4 * static_cast<size_t>(a.U);
  const bool shared_table = table_bytes + bits_bytes <= static_cast<size_t>(max_smem);
  size_t smem = (shared_table ? table_bytes : 0) + bits_bytes;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;  // bitmap alone
  a.hist_smem = !per_row && smem + hist_bytes <= static_cast<size_t>(max_smem);
  if (a.hist_smem) smem += hist_bytes;
  // 128-1,024 threads a block, so that the segments spread over every SM.
  const long long per_sm = (a.total + sms - 1) / sms;
  const long long t = (per_sm + 31) / 32 * 32;
  const int threads = static_cast<int>(t < 128 ? 128 : (t > 1024 ? 1024 : t));
  if (per_row) {
    return shared_table ? ac_launch<T, kFlag, true, true>(a, smem, threads, sms, stream)
                        : ac_launch<T, kFlag, false, true>(a, smem, threads, sms, stream);
  }
  return shared_table ? ac_launch<T, kFlag, true, false>(a, smem, threads, sms, stream)
                      : ac_launch<T, kFlag, false, false>(a, smem, threads, sms, stream);
}

template <typename Kernel>
cudaError_t kmp_launch(Kernel kernel, const KmpArgs& a, int x_blocks, size_t smem, int sms,
                       cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = resident_blocks(kernel, kKmpThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  // Row blocks on y: enough for every resident block, no more than the rows
  // need; each block walks its rows (y, y + gridDim.y, ...).
  const long long row_blocks = (a.total + kKmpThreads - 1) / kKmpThreads;
  long long y = (static_cast<long long>(sms) * per_sm + x_blocks - 1) / x_blocks;
  if (y > row_blocks) y = row_blocks;
  if (y > 65535) y = 65535;
  kernel<<<dim3(static_cast<unsigned>(x_blocks), static_cast<unsigned>(y)), kKmpThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

template <int kG>
cudaError_t kmp_group_launch(const KmpArgs& a, bool per_row, size_t smem, int sms,
                             cudaStream_t stream) {
  return per_row ? kmp_launch(kmp_group_kernel<kG, true>, a, a.groups, smem, sms, stream)
                 : kmp_launch(kmp_group_kernel<kG, false>, a, a.groups, smem, sms, stream);
}

}  // namespace

extern "C" {

// Aho-Corasick scan over a list of num_tiles tiles (tiles_host: the list on
// the host; tiles_dev: its copy on the device, read when num_tiles > 1) of
// total segments: counts added into out (int32[U] totals, or int32[rows, U]
// with per_row), which the caller has zeroed, and each tile's states_out
// where given.  table holds num_states * 256 entries of table_bytes (2:
// uint16, 4: int32) bytes; flagged: each entry's top bit marks an emitting
// next state, else emit_bits is the bitmap of emitting states; out_ptr /
// out_ids the CSR of the unique patterns each state emits; depth the
// greatest state depth.
int msm_ac_scan(const void* tiles_host, const void* tiles_dev, int num_tiles, long long total,
                const void* table, int table_bytes, int flagged, const void* emit_bits,
                const void* out_ptr, const void* out_ids, void* out, int num_states, int depth,
                int U, int per_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total <= 0 || num_tiles <= 0) return 0;
  if (num_states <= 0 || U < 0 || depth < 0 || (table_bytes != 2 && table_bytes != 4) ||
      (table_bytes == 2 && num_states > (flagged ? 32768 : 65536)) ||
      (table_bytes == 4 && !flagged) || (num_tiles > 1 && tiles_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AcArgs a{};
  a.list.tiles = static_cast<const Tile*>(tiles_dev);
  a.list.one = *static_cast<const Tile*>(tiles_host);
  a.list.num = num_tiles;
  a.total = total;
  a.table = table;
  a.bits = static_cast<const uint32_t*>(emit_bits);
  a.out_ptr = static_cast<const int32_t*>(out_ptr);
  a.out_ids = static_cast<const int32_t*>(out_ids);
  a.out = static_cast<int32_t*>(out);
  a.num_states = static_cast<uint32_t>(num_states);
  a.D = depth;
  a.U = U;
  a.bits_words = (num_states + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = per_row != 0;
  if (table_bytes == 4) return static_cast<int>(ac_dispatch<int32_t, true>(a, rows, device, s));
  return static_cast<int>(flagged ? ac_dispatch<uint16_t, true>(a, rows, device, s)
                                  : ac_dispatch<uint16_t, false>(a, rows, device, s));
}

// Per-pattern KMP scan over a list of tiles of total rows: counts added into
// out (int32[P] totals, or int32[rows, P] with per_row), which the caller
// has zeroed.  table holds P stacked DFAs of M * 256 entries of table_bytes
// (1: uint8, 4: int32) bytes; accept[p] in [1, M) is pattern p's accept
// state; order the patterns by accept state.  uint8 DFAs run in groups:
// groups blocks a row block, group_size (1, 2, 4, 8, 12, ..., 32) slots a
// block, smem bytes of staged rows a block; int32 DFAs run one pattern a
// block.
int msm_kmp_scan(const void* tiles_host, const void* tiles_dev, int num_tiles, long long total,
                 const void* table, int table_bytes, const void* accept, const void* order,
                 void* out, int P, int M, int groups, int group_size, long long smem,
                 int per_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total <= 0 || num_tiles <= 0 || P <= 0) return 0;
  if (M < 2 || (table_bytes != 1 && table_bytes != 4) || (table_bytes == 1 && M > 256) ||
      (num_tiles > 1 && tiles_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, max_smem = 0;
  err = device_limits(device, &sms, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  KmpArgs a{};
  a.list.tiles = static_cast<const Tile*>(tiles_dev);
  a.list.one = *static_cast<const Tile*>(tiles_host);
  a.list.num = num_tiles;
  a.total = total;
  a.table = table;
  a.accept = static_cast<const int32_t*>(accept);
  a.order = static_cast<const int32_t*>(order);
  a.out = static_cast<int32_t*>(out);
  a.P = P;
  a.M = M;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = per_row != 0;
  if (table_bytes == 4) {
    a.groups = P;
    return static_cast<int>(rows ? kmp_launch(kmp_wide_kernel<true>, a, P, 0, sms, s)
                                 : kmp_launch(kmp_wide_kernel<false>, a, P, 0, sms, s));
  }
  if (groups < 1 || groups > P || static_cast<long long>(groups) * group_size < P || smem <= 0 ||
      smem > max_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  a.groups = groups;
  const size_t sm = static_cast<size_t>(smem);
  switch (group_size) {
    case 1: return static_cast<int>(kmp_group_launch<1>(a, rows, sm, sms, s));
    case 2: return static_cast<int>(kmp_group_launch<2>(a, rows, sm, sms, s));
    case 4: return static_cast<int>(kmp_group_launch<4>(a, rows, sm, sms, s));
    case 8: return static_cast<int>(kmp_group_launch<8>(a, rows, sm, sms, s));
    case 12: return static_cast<int>(kmp_group_launch<12>(a, rows, sm, sms, s));
    case 16: return static_cast<int>(kmp_group_launch<16>(a, rows, sm, sms, s));
    case 20: return static_cast<int>(kmp_group_launch<20>(a, rows, sm, sms, s));
    case 24: return static_cast<int>(kmp_group_launch<24>(a, rows, sm, sms, s));
    case 28: return static_cast<int>(kmp_group_launch<28>(a, rows, sm, sms, s));
    case 32: return static_cast<int>(kmp_group_launch<32>(a, rows, sm, sms, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* msm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
