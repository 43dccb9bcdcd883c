// The hashed probe shared by the window kernels (window_count.cu) and the
// table and filter kernels (table_count.cu) on Hopper (sm_90a).
//
// What every kernel of both files counts, for row r, start s and pattern u
// of a table words/masks uint32[U, kw] (row stride kw, K words compared):
//   w_k = little-endian uint32 of payload[r, s+4k .. s+4k+3], 0 past L
//   hit = AND_{k<K} (w_k & masks[u,k]) == words[u,k]  and  s + lens[u] <= lengths[r]
//   (halo mode also: s + lens[u] > min_end and s >= min_start[r])
// Each pattern has one probe word: column 0 (window and table forms, at
// offset 0 in the pattern) or column K (filter form: the filter word, at
// the offset of the first of the pattern's K words equal to it).  A match at
// s puts the probe word at s + offset, so probing every position finds
// every match once.
//
// Why a hash.  The TPU kernels compared every pattern's probe at every
// position, because a per-lane gather costs ~7.5 ns there: the time grew
// with U.  On Hopper a shared-memory gather is one instruction per lane.
// So each block builds, at the start of its launch, a chained hash of the
// probe keys in shared memory, and a position costs one lookup per distinct
// probe mask, whatever U is:
//   - the key of pattern u is its probe word; its bucket hashes the key
//     together with the index of its probe mask among the launch's distinct
//     non-zero probe masks (at most kMaxMasks; the pattern programs give at
//     most 4: 0xFF, 0xFFFF, 0xFFFFFF and 0xFFFFFFFF);
//   - insertion is next[u] = atomicExch(&head[h], u) on 32-bit heads: one
//     atomic a pattern, however many patterns share a bucket (a
//     compare-and-swap on packed 16-bit heads is retried by every contender
//     at each success: PERF.md); chain order does not matter, because
//     counts are order-free;
//   - at a staged position a thread builds the 4-byte window once and
//     tests its low 16 bits in a 65,536-bit map of the keys' low 16 bits
//     (8 KB; a 1-byte key sets its 256 bits): one shared load and a bit
//     test, whatever the number of masks.  Only where the bit is set does
//     it, per mask, do one AND, one multiply-shift hash and one head load
//     (at most ~5% of positions at 3,072 full-word keys, ~0.1% for the
//     stand-in set); only a candidate (a chain entry with the same key and
//     mask) walks on to the fit, the halo tests and the verify chain, which
//     reads the pattern's words from global memory (at most 3,072 x 9 x 8
//     B: L2-resident) and stops at the first mismatch.
// Patterns whose probe can never fire (a word with bits outside its mask,
// such as the filter sentinel: word 1, mask 0) are never inserted.
// Patterns whose probe always fires (mask 0, word 0: the padded slots of a
// pattern-shard table block) and patterns of a ninth or later probe mask
// go on a "wildcard" chain that is walked at every position of a segment
// where the shortest of them could still fit; padded slots (length 2^30)
// never fit, so it costs one compare per segment.  The wrappers refuse more
// than kMaxMasks probe masks (ValueError), so the second kind only keeps
// the kernel exact for callers of the C entry points.
//
// Choices:
//   - one hash for every mask, behind the 16-bit map (a direct-indexed
//     table of the 0xFF and 0xFFFF keys' low bits, shared by all masks):
//     without the map each mask cost about as much again as the first (the
//     head loads' bank conflicts: PERF.md); a probe mask whose low 16 bits
//     are neither 0xFF nor 0xFFFF turns the map off for the launch (every
//     position looks up);
//   - table size: the least power of two >= 2 x the chunk's patterns (at
//     least 64 slots), so a random key finds an empty bucket >= 60% of the
//     time; the hash is Fibonacci multiply-shift, the mask index added in
//     before the multiply with a second odd constant (window_count.cu
//     exports it as msm_probe_bucket, so tests build colliding keys from
//     this code and no copy of it);
//   - a launch hashes at most kMaxChunk = 4,096 patterns at once: a larger
//     set is taken in chunks of 4,096, each re-staging the tile (so the
//     3,072-rule classes and shard blocks read their tile once); a chunk's
//     table (80 KB) then fits beside the staging of the longest patterns
//     the window kernels take (K = 2,048, halo mode: 96 KB);
//   - grid: as many blocks as fit on the card at once (occupancy x SMs), so
//     each block builds its table once per launch;
//   - one row per warp: the block's warps share the hash and scan rows of
//     their own, each with its own staging buffer and only warp barriers,
//     so a block has eight rows' loads in flight, not one (a row of ~1 KB
//     is a few loads and a few hundred positions: latency, not compute).
//
// Staging: a segment of a row holds up to kSeg starts (kSeg + min(min_end,
// kSeg) in halo mode, so a flow sub-lane row of H + 2,048 bytes is staged
// once) and stages only the bytes its starts and probes read (starts +
// 4K - 1), in 16-byte loads from the 16-byte-aligned address below the
// segment's first byte; the ragged head and tail chunks are read a byte at
// a time, and bytes at or past L read as 0.  Reads then add the
// misalignment d to every staged index.
//
// Counts: totals go to a shared-memory histogram per block, added to the
// zeroed output with one integer atomicAdd per non-zero pattern count at
// the end of the launch (exact, order-free); per-row counts are added to
// the zeroed output row by integer atomicAdd at each hit (hits are rare:
// the output, not the atomics, is the per-row form's cost).
//
// The table build (build_table) is shared with the ordered find kernel of
// window_find.cu, which scans flattened byte tiles instead of rows.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace msm_probe {

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;   // rows in flight per block
constexpr int kMaxMasks = 8;            // distinct non-zero probe masks per launch
constexpr int kSeg = 2048;              // starts per segment (halo mode: + min(min_end, kSeg))
constexpr int kMaxChunk = 4096;         // patterns hashed at once
constexpr int kMinTableBits = 6;        // at least 64 head slots
constexpr uint32_t kEnd = 0xFFFFu;      // end of a chain
constexpr uint32_t kWildTag = 0xFu;     // mask-index field of a wildcard entry
constexpr int kMapWords = 65536 / 32;   // the 16-bit key map
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr uint32_t kMaskMul = 0x85EBCA77u;

// What one launch counts: the tile, the tables and the layout the launcher
// chose.  Passed by value.
struct Args {
  const uint8_t* payload;     // uint8[n, L]
  const int32_t* lengths;     // int32[n]
  const int32_t* min_start;   // int32[n], halo mode only
  const uint32_t* words;      // uint32[U, kw]
  const uint32_t* masks;      // uint32[U, kw]
  const int32_t* lens;        // int32[U]
  int32_t* out;               // int32[U] (totals) or int32[n, U] (per row)
  int64_t n, L;
  int U, K, kw, pc;           // pc: the probe column (0, or K for the filter)
  int min_end;                // halo mode only
  int chunk, bits, cap, stage_bytes;
};

// Little-endian uint32 of the staged bytes b .. b+3.
__device__ __forceinline__ uint32_t word_at(const uint32_t* s, int b) {
  const int q = b >> 2;
  return __funnelshift_r(s[q], s[q + 1], (b & 3) * 8);
}

__host__ __device__ __forceinline__ uint32_t bucket(uint32_t key, uint32_t mi, int shift) {
  return ((key + mi * kMaskMul) * kHashMul) >> shift;
}

// log2 of the head slots of a launch over U patterns: the least power of
// two >= twice a chunk's patterns, and at least 2^kMinTableBits.
__host__ __device__ inline int table_bits(int U) {
  const int chunk = U < kMaxChunk ? U : kMaxChunk;
  int bits = kMinTableBits;
  while ((1 << bits) < 2 * chunk) ++bits;
  return bits;
}

// The slot of mask m among the block's distinct masks, inserting it in the
// first free slot; -1 when all kMaxMasks slots hold other masks.  Slots fill
// in order and never change, so each mask lands in exactly one slot.
__device__ __forceinline__ int mask_slot(uint32_t* s_mask, uint32_t m) {
  for (int i = 0; i < kMaxMasks; ++i) {
    const uint32_t old = atomicCAS(&s_mask[i], 0u, m);
    if (old == 0u || old == m) return i;
  }
  return -1;
}

// Stage bytes [seg, seg + nb) of row rowp (width L) into s_stage4 from the
// 16-byte-aligned address at or below rowp + seg, one warp (lane) at work;
// returns the misalignment.
__device__ __forceinline__ int stage_segment(uint4* s_stage4, const uint8_t* rowp, int64_t seg,
                                             int64_t L, int nb, int lane) {
  const uint8_t* src = rowp + seg;
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int64_t left = L - seg;
  const int nvalid = static_cast<int>(left < nb ? left : nb);
  const int nchunks = (d + nb + 15) >> 4;
  for (int c = lane; c < nchunks; c += 32) {
    const int lo = 16 * c - d;  // first byte of the chunk, relative to src
    uint4 v;
    if (lo >= 0 && lo + 16 <= nvalid) {
      v = __ldg(reinterpret_cast<const uint4*>(src + lo));
    } else {
      uint32_t b[4] = {0u, 0u, 0u, 0u};
      for (int i = 0; i < 16; ++i) {
        const int x = lo + i;
        if (x >= 0 && x < nvalid) b[i >> 2] |= static_cast<uint32_t>(src[x]) << ((i & 3) * 8);
      }
      v = make_uint4(b[0], b[1], b[2], b[3]);
    }
    s_stage4[c] = v;
  }
  return d;
}

// The shared-memory state of one probe table besides its entries and heads.
struct TableShared {
  uint32_t map[kMapWords];  // bit b: some key's low 16 bits can be b
  uint32_t mask[kMaxMasks];
  uint32_t wild;            // head of the wildcard chain
  int wild_min;             // the shortest wildcard pattern
  int map_off;              // a mask the map cannot hold: look up everywhere
};

// What a thread keeps in registers of a built table.
struct Probe {
  uint32_t mk[kMaxMasks];  // the distinct probe masks, 0 past nm
  int nm;
  uint32_t wild;
  int wild_min;
  bool map_on;
};

// Build the probe table of cu patterns (tables words/masks of row stride
// kw, probe column pc, lengths lens, all offset to the chunk's first
// pattern) in T = 2^(32 - shift) heads, with the whole block at work; clears
// hist[0, cu) when hist is given.  Starts and ends with a block barrier, so
// a caller may rebuild over a table that threads were reading.
__device__ __forceinline__ Probe build_table(TableShared& st, uint2* s_ent, uint32_t* s_head,
                                             int32_t* hist, int T, int shift,
                                             const uint32_t* words, const uint32_t* masks,
                                             const int32_t* lens, int cu, int kw, int pc) {
  __syncthreads();  // the previous table's readers are done
  for (int j = threadIdx.x; j < T; j += kThreads) s_head[j] = kEnd;
  if (hist != nullptr) {
    for (int j = threadIdx.x; j < cu; j += kThreads) hist[j] = 0;
  }
  for (int j = threadIdx.x; j < kMapWords; j += kThreads) st.map[j] = 0u;
  if (threadIdx.x < kMaxMasks) st.mask[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    st.wild = kEnd;
    st.wild_min = INT_MAX;
    st.map_off = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cu; j += kThreads) {
    const int64_t g = static_cast<int64_t>(j) * kw + pc;
    const uint32_t m = __ldg(masks + g);
    if (m != 0u && (__ldg(words + g) & m) == __ldg(words + g)) mask_slot(st.mask, m);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cu; j += kThreads) {
    const int64_t g = static_cast<int64_t>(j) * kw + pc;
    const uint32_t w = __ldg(words + g), m = __ldg(masks + g);
    if ((w & m) != w) continue;  // can never fire
    int mi = -1;
    for (int i = 0; i < kMaxMasks && m != 0u; ++i) {
      if (st.mask[i] == m) {
        mi = i;
        break;
      }
    }
    uint32_t next;
    if (mi >= 0) {
      next = atomicExch(&s_head[bucket(w, mi, shift)], static_cast<uint32_t>(j));
      const uint32_t lo = m & 0xFFFFu;
      if (lo == 0xFFFFu) {
        atomicOr(&st.map[(w & 0xFFFFu) >> 5], 1u << (w & 31u));
      } else if (lo == 0xFFu) {
        for (uint32_t b = w & 0xFFu; b < 65536u; b += 256u) atomicOr(&st.map[b >> 5], 1u << (b & 31u));
      } else {
        st.map_off = 1;
      }
    } else {
      next = atomicExch(&st.wild, static_cast<uint32_t>(j));
      atomicMin(&st.wild_min, __ldg(lens + j));
      mi = kWildTag;
    }
    s_ent[j] = make_uint2(w, (static_cast<uint32_t>(mi) << 16) | next);
  }
  __syncthreads();
  Probe pr;
  pr.nm = 0;
#pragma unroll
  for (int i = 0; i < kMaxMasks; ++i) {
    pr.mk[i] = st.mask[i];
    pr.nm += pr.mk[i] != 0u;
  }
  pr.wild = st.wild;
  pr.wild_min = st.wild_min;
  pr.map_on = st.map_off == 0;
  return pr;
}

template <bool kFilter, bool kPerRow, bool kHalo>
__global__ void __launch_bounds__(kThreads) probe_count_kernel(const Args a) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* s_stage4 = smem + warp * (a.stage_bytes / 16);                       // [kWarps][stage_bytes]
  const uint32_t* s_stage = reinterpret_cast<const uint32_t*>(s_stage4);
  uint2* s_ent = reinterpret_cast<uint2*>(smem + kWarps * (a.stage_bytes / 16));  // [chunk]
  int32_t* s_hist = reinterpret_cast<int32_t*>(s_ent + a.chunk);              // [chunk], totals
  uint32_t* s_head = reinterpret_cast<uint32_t*>(s_hist + a.chunk);           // [1 << bits]
  __shared__ TableShared st;
  const uint32_t* s_map = st.map;

  const int T = 1 << a.bits, shift = 32 - a.bits;
  const int vk = kFilter ? 0 : 1;  // first word to verify after the probe

  for (int u0 = 0; u0 < a.U; u0 += a.chunk) {
    const int cu = min(a.chunk, a.U - u0);
    const uint32_t* words = a.words + static_cast<int64_t>(u0) * a.kw;
    const uint32_t* masks = a.masks + static_cast<int64_t>(u0) * a.kw;
    const int32_t* lens = a.lens + u0;

    const Probe pr = build_table(st, s_ent, s_head, kPerRow ? nullptr : s_hist, T, shift, words,
                                 masks, lens, cu, a.kw, a.pc);
    uint32_t mk[kMaxMasks];
#pragma unroll
    for (int i = 0; i < kMaxMasks; ++i) mk[i] = pr.mk[i];
    const int nm = pr.nm;
    const uint32_t wild = pr.wild;
    const int wild_min = pr.wild_min;
    const bool map_on = pr.map_on;

    // -- scan the rows, one per warp -----------------------------------------
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < a.n;
         row += static_cast<int64_t>(gridDim.x) * kWarps) {
      const int64_t len = a.lengths[row];
      // A fitting match starts below min(len, L): s + m <= len with m >= 1.
      const int64_t limit = len < a.L ? len : a.L;
      const uint8_t* rowp = a.payload + row * a.L;
      const int64_t first = kHalo && a.min_start[row] > 0 ? a.min_start[row] : 0;
      for (int64_t seg = first; seg < limit; seg += a.cap) {
        const int nstart = static_cast<int>(limit - seg < a.cap ? limit - seg : a.cap);
        __syncwarp();  // the previous segment's readers are done
        const int d = stage_segment(s_stage4, rowp, seg, a.L, nstart + 4 * a.K - 1, lane);
        __syncwarp();
        const int64_t room0 = len - seg;  // bytes from the segment's first start to the row's end
        const bool walk_wild = wild != kEnd && wild_min <= room0;
        const int nprobe = nstart + (kFilter ? 4 * (a.K - 1) : 0);

        // A candidate: pattern j's probe word at position p of the segment.
        auto candidate = [&](uint32_t j, int p) {
          const int64_t g = static_cast<int64_t>(j) * a.kw;
          int off = 0;
          if (kFilter) {  // the first of the pattern's words equal to its filter
            const uint32_t fw = __ldg(words + g + a.pc), fm = __ldg(masks + g + a.pc);
            for (int k = 0; k < a.K; ++k) {
              if (__ldg(words + g + k) == fw && __ldg(masks + g + k) == fm) {
                off = 4 * k;
                break;
              }
            }
          }
          const int s = p - off;
          if (s < 0 || s >= nstart) return;  // another segment's start
          const int ln = __ldg(lens + j);
          if (s + static_cast<int64_t>(ln) > room0) return;
          if (kHalo && seg + s + ln <= a.min_end) return;  // ends in the halo
          for (int k = vk; k < a.K; ++k) {
            if ((word_at(s_stage, d + s + 4 * k) & __ldg(masks + g + k)) != __ldg(words + g + k)) return;
          }
          if (kPerRow) {
            atomicAdd(&a.out[row * a.U + u0 + j], 1);
          } else {
            atomicAdd(&s_hist[j], 1);
          }
        };

        for (int p = lane; p < nprobe; p += 32) {
          const uint32_t x = word_at(s_stage, d + p);
          const bool maybe = !map_on || ((s_map[(x & 0xFFFFu) >> 5] >> (x & 31u)) & 1u);
#pragma unroll
          for (int i = 0; i < kMaxMasks; ++i) {
            if (!maybe || i >= nm) break;
            const uint32_t key = x & mk[i];
            for (uint32_t e = s_head[bucket(key, i, shift)]; e != kEnd;) {
              const uint2 ent = s_ent[e];
              if (ent.x == key && (ent.y >> 16) == static_cast<uint32_t>(i)) candidate(e, p);
              e = ent.y & 0xFFFFu;
            }
          }
          if (walk_wild) {
            for (uint32_t e = wild; e != kEnd;) {
              const uint2 ent = s_ent[e];
              if ((x & __ldg(masks + static_cast<int64_t>(e) * a.kw + a.pc)) == ent.x) candidate(e, p);
              e = ent.y & 0xFFFFu;
            }
          }
        }
      }
    }

    if (!kPerRow) {
      __syncthreads();
      for (int j = threadIdx.x; j < cu; j += kThreads) {
        if (s_hist[j]) atomicAdd(&a.out[u0 + j], s_hist[j]);
      }
    }
  }
}

// Choose the layout, opt in to the shared memory it needs, and launch one
// block per resident slot of the card (at most one per kWarps rows), reps
// times over.
template <bool kFilter, bool kPerRow, bool kHalo>
cudaError_t probe_launch(Args a, int reps, int device, cudaStream_t stream) {
  a.chunk = a.U < kMaxChunk ? a.U : kMaxChunk;
  a.bits = table_bits(a.U);
  a.cap = kSeg + (kHalo ? (a.min_end < kSeg ? a.min_end : kSeg) : 0);
  // Per warp: the staged bytes (cap + 4K - 1), the misalignment (< 16) and
  // the word after the last 16-byte chunk, which word_at may load but never
  // uses.
  a.stage_bytes = ((a.cap + 4 * a.K + 15 + 15) / 16 + 1) * 16;
  const size_t smem = static_cast<size_t>(kWarps) * a.stage_bytes + 8u * a.chunk +
                      4u * a.chunk + 4u * (1u << a.bits);
  auto kernel = probe_count_kernel<kFilter, kPerRow, kHalo>;
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
  const int64_t wanted = (a.n + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<dim3(blocks, reps), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace msm_probe
