// Keyed segment sum for NVIDIA Hopper (sm_90a), built with nvcc into a
// shared library with a plain C interface and called through ctypes from
// tensorframes_tpu_torch/ops/segment_reduce.py.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/ops/segment_reduce.py:
// _kernel / _pallas_segment_sum (the pl.pallas_call at line 75), behind
// segment_sum. It computes what that kernel computes, not how:
//   out[s, :] = sum of values[i, :] over the rows i with ids[i] == s,
// rows whose id lies outside [0, S) dropped, N = 0 giving zeros. The TPU
// kernel contracts a one-hot [bn, S] against the values on the MXU only to
// keep scatter-adds off the TPU; here the rows are sorted by segment and
// each segment is summed as one run.
//
// Types: f32, bf16 and f64 values; int32 or int64 ids. Accumulation is in
// f32 for f32 and bf16 and in f64 for f64. No tensor cores, so no TF32.
//
// What bounds it on the H100: memory. The function must read
// N * (d * itemsize + id_size) bytes and write S * d * itemsize bytes, at
// 3.35 TB/s; it does no arithmetic worth counting against a peak rate.
// Rows arrive in any order and S runs to 100,000 and more, so a
// per-segment accumulator cannot stay on chip. The design reads each row a
// small fixed number of times whatever S is:
//
// 1. Keys. Each id becomes a key in [0, S]; an id outside [0, S) becomes
//    the sentinel S, so those rows sort last and are never summed.
// 2. A stable LSD radix sort of (key, row index), passes of digit_bits
//    bits each, as many as the bits of S need (2 of 9 bits at S = 100,000).
//    A pass is a per-block digit histogram (integer shared-memory atomics:
//    counts do not depend on order), an exclusive scan of each digit's
//    row of [digit][block] (one block per digit), and a scatter. In the
//    scatter each warp owns a fixed slice of the block's tile and ranks
//    its rows with one ballot per digit bit and a popcount of the lower
//    lanes with the same digit, so a row's place follows from the block,
//    the warp, the round and the lane: the same on every run. The tile is
//    put in digit order in shared memory first, so that neighbouring
//    threads write neighbouring places.
// 3. Offsets. offsets[s] is the first sorted position whose key is >= s
//    (a binary search per segment); segment s is sorted rows
//    [offsets[s], offsets[s+1]).
// 4. The reduction in sorted order, through a fixed tree of pieces. For
//    d >= 32 a warp takes a segment (or a piece), its lanes take columns
//    and walk the rows in order; for d < 32 a group of 8 lanes does, its
//    lanes striding over the rows and combining through a fixed shuffle
//    tree. The sorted rows (level 0) are cut into fixed pieces of P rows.
//    For each piece that a segment begun earlier runs into, the piece's
//    own group sums that segment's rows in the piece into one partial
//    row; those partials, in piece order, are level 1, cut into pieces of
//    P partials in turn, and so on while a level has more than one piece.
//    A segment's rows at level k are a contiguous run [a_k, b_k), with
//    a_{k+1} = a_k / P + 1 and b_{k+1} = (b_k - 1) / P + 1. Its group
//    adds, level by level, the part of its run in the run's first piece:
//    at most P terms a level, and at most ceil(log_P n) levels (3 at
//    2.5M rows with P = 1,024, 3 at 250k rows with P = 64). So a hot key
//    holding most rows is summed in parallel, and every chain of f32
//    additions is at most P terms a level, whatever the segment's length.
//
// Deterministic: no float atomics, and every order above is fixed by the
// inputs alone, so the same inputs give the same bits on every run.
// The launch (sort tile, digit bits and passes, piece size, lanes per
// group, every grid, the tree's levels) and the scratch (keys and row
// indices, double-buffered: 16 bytes a row; the histograms and digit
// totals; the offsets; each level's partial rows) come from the
// wrapper's plan, segment_reduce.plan_sort; this file checks only the
// limits of its own shared memory and registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // every kernel (segment_reduce._THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 4096;  // the scatter's shared tile, in rows
constexpr int kMaxDigitBits = 9;
constexpr int kMaxDigits = 1 << kMaxDigitBits;
constexpr int kDigitsPerThread = kMaxDigits / kThreads;
constexpr int kMaxLevels = 8;   // levels of piece partials
constexpr int kC = 2;           // columns per lane per sweep, 32-lane groups
constexpr int kU = 8;           // rows loaded at once, 32-lane groups

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename Id>
__device__ __forceinline__ uint32_t to_key(Id id, long long S) {
  const long long v = (long long)id;
  return (v >= 0 && v < S) ? (uint32_t)v : (uint32_t)S;
}

// The key of input row r: from the ids on the first pass, else from keys.
template <bool FIRST, typename Id>
__device__ __forceinline__ uint32_t key_at(const Id* ids, const uint32_t* keys,
                                           int r, long long S) {
  if (FIRST) return to_key(ids[r], S);
  return keys[r];
}

// Exclusive scan of one value per thread over the block (kThreads
// threads, all of which must call it); *total gets the block's sum.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* ws,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? ws[w] : 0u;
    all += ws[w];
  }
  __syncthreads();  // ws may be used again
  *total = all;
  return before + x - v;
}

// Pass step 1: hist[digit * nblocks + block] = rows of the block's tile
// whose digit is `digit`.
template <bool FIRST, typename Id>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const Id* __restrict__ ids, const uint32_t* __restrict__ keys,
                  uint32_t* __restrict__ hist, int n, long long S, int tile,
                  int shift, int nd, int nblocks) {
  __shared__ uint32_t h[kMaxDigits];
  for (int i = threadIdx.x; i < nd; i += kThreads) h[i] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * tile;
  const int rows = min(tile, n - r0);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const uint32_t key = key_at<FIRST>(ids, keys, r0 + i, S);
    atomicAdd(&h[(key >> shift) & (uint32_t)(nd - 1)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nd; i += kThreads)
    hist[(size_t)i * nblocks + blockIdx.x] = h[i];
}

// Pass step 2: block `digit` scans its row of hist in place (exclusive)
// and writes the digit's total.
__global__ void __launch_bounds__(kThreads)
scan_digits_kernel(uint32_t* __restrict__ hist, uint32_t* __restrict__ totals,
                   int nblocks) {
  __shared__ uint32_t ws[kWarps];
  uint32_t* row = hist + (size_t)blockIdx.x * nblocks;
  uint32_t carry = 0;
  for (int base = 0; base < nblocks; base += kThreads) {
    const int i = base + threadIdx.x;
    const uint32_t v = i < nblocks ? row[i] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(v, ws, &total);
    if (i < nblocks) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Pass step 3: the stable scatter. hist holds each digit's scanned row,
// totals each digit's count.
template <bool FIRST, typename Id>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const Id* __restrict__ ids,
                     const uint32_t* __restrict__ keys_in,
                     const uint32_t* __restrict__ idx_in,
                     uint32_t* __restrict__ keys_out,
                     uint32_t* __restrict__ idx_out,
                     const uint32_t* __restrict__ hist,
                     const uint32_t* __restrict__ totals, int n, long long S,
                     int tile, int shift, int digit_bits, int nblocks) {
  __shared__ uint32_t s_key[kMaxTile];
  __shared__ uint16_t s_perm[kMaxTile];           // tile row at each place
  __shared__ uint16_t cnt[kWarps][kMaxDigits];
  __shared__ uint32_t gbase[kMaxDigits];
  __shared__ uint32_t ws[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nd = 1 << digit_bits;
  const uint32_t mask = (uint32_t)(nd - 1);
  const int r0 = blockIdx.x * tile;
  const int rows = min(tile, n - r0);
  for (int i = tid; i < rows; i += kThreads)
    s_key[i] = key_at<FIRST>(ids, keys_in, r0 + i, S);
  for (int i = tid; i < kWarps * kMaxDigits; i += kThreads)
    (&cnt[0][0])[i] = 0;
  __syncthreads();

  // warp w owns tile rows [w0, w1), taken 32 at a time in order. A lane's
  // peers (the lanes with its digit) come from one ballot per digit bit.
  const int per = tile / kWarps;
  const int w0 = warp * per;
  const int w1 = min(w0 + per, rows);
  const unsigned lower = (1u << lane) - 1u;
  auto peers_of = [&](bool ok, uint32_t dig) {
    unsigned peers = __ballot_sync(0xffffffffu, ok);
    for (int b = 0; b < digit_bits; ++b) {
      const bool bit = (dig >> b) & 1u;
      const unsigned bb = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? bb : ~bb;
    }
    return peers;
  };
  for (int i = w0; i < w1; i += 32) {
    const int j = i + lane;
    const bool ok = j < w1;
    const uint32_t dig = ok ? (s_key[j] >> shift) & mask : 0u;
    const unsigned peers = peers_of(ok, dig);
    if (ok && lane == __ffs(peers) - 1) cnt[warp][dig] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread tid owns digits kDigitsPerThread * tid + q: each digit's first
  // place in the tile (after the smaller digits), then each warp's first
  // place; and the offset from a place in the tile to the place in the
  // output
  {
    uint32_t count[kDigitsPerThread], tot[kDigitsPerThread];
    uint32_t csum = 0, tsum = 0;
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int dg = kDigitsPerThread * tid + q;
      count[q] = 0;
      tot[q] = dg < nd ? totals[dg] : 0u;
      if (dg < nd) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) count[q] += cnt[w][dg];
      }
      csum += count[q];
      tsum += tot[q];
    }
    uint32_t all;
    uint32_t local = block_exclusive_scan(csum, ws, &all);
    uint32_t before = block_exclusive_scan(tsum, ws, &all);
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int dg = kDigitsPerThread * tid + q;
      if (dg < nd) {
        uint32_t run = local;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const uint32_t c = cnt[w][dg];
          cnt[w][dg] = (uint16_t)run;
          run += c;
        }
        gbase[dg] = before + hist[(size_t)dg * nblocks + blockIdx.x] - local;
      }
      local += count[q];
      before += tot[q];
    }
  }
  __syncthreads();
  for (int i = w0; i < w1; i += 32) {
    const int j = i + lane;
    const bool ok = j < w1;
    const uint32_t dig = ok ? (s_key[j] >> shift) & mask : 0u;
    const unsigned peers = peers_of(ok, dig);
    if (ok) s_perm[cnt[warp][dig] + __popc(peers & lower)] = (uint16_t)j;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[warp][dig] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads) {
    const int j = s_perm[i];
    const uint32_t key = s_key[j];
    const uint32_t pos = gbase[(key >> shift) & mask] + i;
    keys_out[pos] = key;
    idx_out[pos] = FIRST ? (uint32_t)(r0 + j) : idx_in[r0 + j];
  }
}

// offsets[s] = the first sorted position whose key is >= s, s in [0, S].
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const uint32_t* __restrict__ keys, int n,
               uint32_t* __restrict__ offsets, long long S) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s > S) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)keys[mid] < s) lo = mid + 1;
    else hi = mid;
  }
  offsets[s] = (uint32_t)lo;
}

// The rows of a segment at level 0 are sorted rows [a, b); at level k they
// are the partials of the pieces of level k - 1 that the run enters past
// its first piece. climb moves a run up k levels (empty stays empty).
// Positions stay below 2^31 + piece, so 32-bit division does (64-bit
// division is a long software routine, run here by every lane).
__device__ __forceinline__ void climb(uint32_t& a, uint32_t& b, int k,
                                      uint32_t piece) {
  for (int j = 0; j < k && a < b; ++j) {
    a = a / piece + 1;
    b = (b - 1) / piece + 1;
  }
}

// A 32-lane group (a whole warp; lo and hi the same across it): acc[k] +=
// column c0 + lane + 32 k of rows [lo, hi), in row order. GATHER: row r is
// values row idx[r] (level 0); else row r of a partial array.
template <bool GATHER, typename T, typename Acc>
__device__ __forceinline__ void wide_add(Acc (&acc)[kC],
                                         const T* __restrict__ src,
                                         const uint32_t* __restrict__ idx,
                                         int lo, int hi, long long d,
                                         long long c0) {
  const int lane = threadIdx.x & 31;
  for (int r = lo; r < hi; r += 32) {
    const int cnt = min(32, hi - r);
    uint32_t mine = 0u;
    if (lane < cnt) mine = GATHER ? idx[r + lane] : (uint32_t)(r + lane);
    for (int j = 0; j < cnt; j += kU) {
      Acc x[kU][kC];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long row = __shfl_sync(0xffffffffu, mine, (j + u) & 31);
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          const long long col = c0 + lane + 32 * k;
          x[u][k] = (j + u < cnt && col < d) ? to_acc(src[row * d + col])
                                             : Acc(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int k = 0; k < kC; ++k) acc[k] += x[u][k];
    }
  }
}

// Lane g of an 8-lane group: acc += column col of rows lo + g, lo + g + 8,
// ... below hi; narrow_tree then sums the group's lanes into its lane 0.
template <bool GATHER, typename T, typename Acc>
__device__ __forceinline__ Acc narrow_add(Acc acc, const T* __restrict__ src,
                                          const uint32_t* __restrict__ idx,
                                          int lo, int hi, long long d,
                                          long long col, int g) {
  for (int r = lo + g; r < hi; r += 8)
    acc += to_acc(src[(long long)(GATHER ? idx[r] : (uint32_t)r) * d + col]);
  return acc;
}
template <typename Acc>
__device__ __forceinline__ Acc narrow_tree(Acc acc) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, 8);
  return acc;
}

template <typename Acc>
struct Heads {
  Acc* h[kMaxLevels];  // each level's partial rows
};

// Level `level` of the tree: group e sums the rows of its piece e (of
// piece rows) that continue a segment begun before the piece, into
// partial row e of dst, level + 1. Piece 0, a piece that starts a
// segment, and one in the sentinel's rows write nothing, and nothing
// reads them. Every lane of the warp calls the shuffles: a group with no
// rows sums an empty range.
template <bool GATHER, typename T, typename Acc, int G>
__global__ void __launch_bounds__(kThreads)
head_kernel(const T* __restrict__ src, const uint32_t* __restrict__ idx,
            const uint32_t* __restrict__ keys,
            const uint32_t* __restrict__ offsets, Acc* __restrict__ dst,
            long long d, long long S, int piece, int level,
            long long pieces) {
  constexpr int kGroups = 32 / G;
  const long long e = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                          kGroups + (threadIdx.x & 31) / G;
  uint32_t lo = 0, hi = 0;
  if (e > 0 && e < pieces) {
    long long span = piece;  // sorted rows under one piece of this level
    for (int j = 0; j < level; ++j) span *= piece;
    const uint32_t s = keys[e * span];
    if ((long long)s < S) {
      uint32_t a = offsets[s], b = offsets[s + 1];
      climb(a, b, level, (uint32_t)piece);
      const uint32_t r0 = (uint32_t)(e * piece);
      if (a < r0 && r0 < b) {
        lo = r0;
        hi = min(b, r0 + (uint32_t)piece);
      }
    }
  }
  if constexpr (G == 32) {
    for (long long c0 = 0; c0 < d; c0 += 32 * kC) {
      Acc acc[kC] = {};
      wide_add<GATHER>(acc, src, idx, (int)lo, (int)hi, d, c0);
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const long long col = c0 + (threadIdx.x & 31) + 32 * k;
        if (lo < hi && col < d) dst[e * d + col] = acc[k];
      }
    }
  } else {
    const int g = (threadIdx.x & 31) % G;
    for (long long col = 0; col < d; ++col) {
      const Acc acc = narrow_tree(
          narrow_add<GATHER>(Acc(0), src, idx, (int)lo, (int)hi, d, col, g));
      if (g == 0 && lo < hi) dst[e * d + col] = acc;
    }
  }
}

// out[s] = the sum of segment s: level by level, the part of its run in
// the run's first piece (sorted rows at level 0, partials above).
template <typename T, typename Acc, int G>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const T* __restrict__ values, const uint32_t* __restrict__ idx,
               const uint32_t* __restrict__ offsets, Heads<Acc> heads,
               int levels, T* __restrict__ out, long long d, long long S,
               int piece) {
  constexpr int kGroups = 32 / G;
  const long long s = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                          kGroups + (threadIdx.x & 31) / G;
  const bool active = s < S;
  const uint32_t a0 = active ? offsets[s] : 0u;
  const uint32_t b0 = active ? offsets[s + 1] : 0u;
  const uint32_t p = (uint32_t)piece;
  if constexpr (G == 32) {
    for (long long c0 = 0; c0 < d; c0 += 32 * kC) {
      Acc acc[kC] = {};
      uint32_t a = a0, b = b0;
      for (int k = 0; a < b && k <= levels; ++k) {
        const int end = (int)min(b, (a / p + 1) * p);
        if (k == 0)
          wide_add<true>(acc, values, idx, (int)a, end, d, c0);
        else
          wide_add<false>(acc, heads.h[k - 1], nullptr, (int)a, end, d, c0);
        climb(a, b, 1, p);
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const long long col = c0 + (threadIdx.x & 31) + 32 * k;
        if (active && col < d) store(out + s * d + col, acc[k]);
      }
    }
  } else {
    const int g = (threadIdx.x & 31) % G;
    for (long long col = 0; col < d; ++col) {
      Acc acc = Acc(0);
      uint32_t a = a0, b = b0;
      for (int k = 0; a < b && k <= levels; ++k) {
        const int end = (int)min(b, (a / p + 1) * p);
        if (k == 0)
          acc = narrow_add<true>(acc, values, idx, (int)a, end, d, col, g);
        else
          acc = narrow_add<false>(acc, heads.h[k - 1], nullptr, (int)a, end,
                                  d, col, g);
        climb(a, b, 1, p);
      }
      acc = narrow_tree(acc);
      if (active && g == 0) store(out + s * d + col, acc);
    }
  }
}

// segment_reduce.plan_sort, field for field (its _Launch).
struct Plan {
  int tile;            // rows per sort block
  int sort_blocks;     // blocks of each sort kernel
  int digit_bits;
  int passes;
  int offset_blocks;   // blocks of offsets_kernel
  int lanes;           // lanes per segment and per piece: 32 or 8
  int piece;           // rows per piece, at every level
  int segment_blocks;  // blocks of segment_kernel
  int levels;          // levels of partials
  int head_blocks[kMaxLevels];
  long long head_rows[kMaxLevels];
  // byte offsets in the scratch: keys, idx, hist, totals, offsets, then
  // each level's partials
  long long at[5 + kMaxLevels];
};

template <typename T, typename Acc, int G>
void launch_reduce(const T* values, const uint32_t* idx, const uint32_t* keys,
                   const uint32_t* offsets, Heads<Acc> heads, T* out,
                   long long d, long long S, const Plan& p,
                   cudaStream_t stream) {
  for (int k = 0; k < p.levels; ++k) {
    if (k == 0)
      head_kernel<true, T, Acc, G><<<p.head_blocks[0], kThreads, 0, stream>>>(
          values, idx, keys, offsets, heads.h[0], d, S, p.piece, 0,
          p.head_rows[0]);
    else
      head_kernel<false, Acc, Acc, G><<<p.head_blocks[k], kThreads, 0,
                                        stream>>>(
          heads.h[k - 1], nullptr, keys, offsets, heads.h[k], d, S, p.piece,
          k, p.head_rows[k]);
  }
  segment_kernel<T, Acc, G><<<p.segment_blocks, kThreads, 0, stream>>>(
      values, idx, offsets, heads, p.levels, out, d, S, p.piece);
}

template <typename T, typename Acc, typename Id>
int launch(const void* values, const void* ids, void* out, char* scratch,
           const Plan& p, long long n, long long d, long long S,
           cudaStream_t stream) {
  const int nd = 1 << p.digit_bits;
  const int nn = (int)n;
  const Id* id = static_cast<const Id*>(ids);
  uint32_t* keys = reinterpret_cast<uint32_t*>(scratch + p.at[0]);
  uint32_t* idx = reinterpret_cast<uint32_t*>(scratch + p.at[1]);
  uint32_t* hist = reinterpret_cast<uint32_t*>(scratch + p.at[2]);
  uint32_t* totals = reinterpret_cast<uint32_t*>(scratch + p.at[3]);
  uint32_t* offsets = reinterpret_cast<uint32_t*>(scratch + p.at[4]);
  uint32_t* kb[2] = {keys, keys + n};
  uint32_t* ib[2] = {idx, idx + n};
  for (int q = 0; q < p.passes; ++q) {
    const int shift = q * p.digit_bits;
    const int o = q & 1, in = o ^ 1;
    if (q == 0) {
      radix_hist_kernel<true, Id><<<p.sort_blocks, kThreads, 0, stream>>>(
          id, nullptr, hist, nn, S, p.tile, shift, nd, p.sort_blocks);
    } else {
      radix_hist_kernel<false, Id><<<p.sort_blocks, kThreads, 0, stream>>>(
          id, kb[in], hist, nn, S, p.tile, shift, nd, p.sort_blocks);
    }
    scan_digits_kernel<<<nd, kThreads, 0, stream>>>(hist, totals,
                                                    p.sort_blocks);
    if (q == 0) {
      radix_scatter_kernel<true, Id><<<p.sort_blocks, kThreads, 0, stream>>>(
          id, nullptr, nullptr, kb[o], ib[o], hist, totals, nn, S, p.tile,
          shift, p.digit_bits, p.sort_blocks);
    } else {
      radix_scatter_kernel<false, Id><<<p.sort_blocks, kThreads, 0, stream>>>(
          id, kb[in], ib[in], kb[o], ib[o], hist, totals, nn, S, p.tile,
          shift, p.digit_bits, p.sort_blocks);
    }
  }
  const int fin = (p.passes - 1) & 1;
  offsets_kernel<<<p.offset_blocks, kThreads, 0, stream>>>(kb[fin], nn,
                                                          offsets, S);
  Heads<Acc> heads = {};
  for (int k = 0; k < p.levels; ++k)
    heads.h[k] = reinterpret_cast<Acc*>(scratch + p.at[5 + k]);
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  if (p.lanes == 32)
    launch_reduce<T, Acc, 32>(v, ib[fin], kb[fin], offsets, heads, o, d, S, p,
                              stream);
  else
    launch_reduce<T, Acc, 8>(v, ib[fin], kb[fin], offsets, heads, o, d, S, p,
                             stream);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch_ids(int id_kind, const void* values, const void* ids, void* out,
               char* scratch, const Plan& p, long long n, long long d,
               long long S, cudaStream_t stream) {
  if (id_kind == 0)
    return launch<T, Acc, int32_t>(values, ids, out, scratch, p, n, d, S,
                                   stream);
  if (id_kind == 1)
    return launch<T, Acc, int64_t>(values, ids, out, scratch, p, n, d, S,
                                   stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// value_kind: 0 f32, 1 bf16, 2 f64. id_kind: 0 int32, 1 int64.
// values [n, d], ids [n], out [S, d], contiguous; 1 <= n < 2^31,
// 1 <= S < 2^31, d >= 1. The launch and the scratch's layout are the
// wrapper's plan (segment_reduce.plan_sort): keys and idx [2, n] uint32
// each, hist [2^digit_bits, sort_blocks] and totals [2^digit_bits]
// uint32, offsets [S + 1] uint32, and per level k [head_rows[k], d]
// partials of the accumulation type (f32, f32, f64). Refused here: only
// what this file's shared memory and registers cannot hold.
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int tft_segment_sum(const void* values, const void* ids, void* out,
                               void* scratch, const void* plan, long long n,
                               long long d, long long S, int value_kind,
                               int id_kind, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (n < 1 || n >= (1LL << 31) || S < 1 || S >= (1LL << 31) || d < 1 ||
      p.tile < kWarps || p.tile > kMaxTile || p.tile % kWarps != 0 ||
      p.digit_bits < 1 || p.digit_bits > kMaxDigitBits || p.passes < 1 ||
      p.levels < 0 || p.levels > kMaxLevels || p.piece < 1 ||
      (p.lanes != 32 && p.lanes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  switch (value_kind) {
    case 0:
      return launch_ids<float, float>(id_kind, values, ids, out, sc, p, n, d,
                                      S, st);
    case 1:
      return launch_ids<__nv_bfloat16, float>(id_kind, values, ids, out, sc,
                                              p, n, d, S, st);
    case 2:
      return launch_ids<double, double>(id_kind, values, ids, out, sc, p, n,
                                        d, S, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
