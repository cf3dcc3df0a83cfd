// The backward of exact softmax attention for NVIDIA Hopper (sm_90a), built
// with nvcc into a shared library with a plain C interface and called
// through ctypes from tensorframes_tpu_torch/ops/flash_attention_backward.py.
//
// The JAX package has no backward kernel: it differentiates its plain
// attention (tensorframes_tpu/ops/flash_attention.py, _xla_attention, lines
// 148-157) with XLA's autodiff. This computes the same gradients, dq, dk and
// dv of o = softmax(q k^T * scale [+ top-left causal mask]) v, from q, k, v,
// o, dO and the forward's per-row log-sum-exp (flash_attention.cu writes it
// when a backward will follow), without storing the [Sq, Sk] probabilities:
//
//   P  = exp(S * scale - lse)             recomputed per tile, S = q k^T
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(dO * o)  (= rowsum(P * dP))
//   dS = P * (dP - delta)
//   dQ = scale * dS K,   dK = scale * dS^T Q
//
// FlashAttention-2's deterministic split (Dao, 2023), no atomics, so runs
// are bit-identical:
// - delta_kernel: delta in f32, one warp per query row;
// - dkdv_kernel: one block of 4 warps per (b*h, tile of 64 keys), each warp
//   owning 16 keys. K and V stay in shared memory; the query tiles at or
//   below the diagonal (causal: from the key tile's own index on) stream
//   through a ring of two stages with cp.async, Q and dO with the tile's
//   lse and delta. The scores are computed transposed, keys as the rows:
//   S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers, then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T straight from the
//   registers. A key tile that no query sees is written as zeros. At a head
//   dim of 128 the block's dk and dv features are split in two halves over
//   grid.z (two blocks a key tile, each computing S and dP whole), so that
//   the two accumulators stay at 64 registers a thread together.
// - dq_kernel: one block of 4 warps per (b*h, tile of 64 queries), 16
//   queries a warp; Q, dO, lse and delta stay resident and K, V stream
//   through the ring. S = Q K^T and dP = dO V^T, dS in registers, then
//   dQ += dS K. The tiles with the most key tiles are scheduled first.
// Masked positions (key past Sk, query past Sq, causal q_pos < k_pos) have
// P = 0 exactly, so their gradients are 0; only a tile that reaches past Sq
// or Sk or crosses the warp's diagonal computes masks. Sk = 0 gives dq = 0.
//
// The five products run on the tensor cores with mma.sync, in the two
// fragment patterns of the forward (flash_attention.cu):
// - pattern 1, A and B both rows of shared-memory tiles (the forward's
//   Q.K^T): S^T, dP^T (dk/dv) and S, dP (dq);
// - pattern 2, A an accumulator already in registers (the accumulator
//   layout of two 8-column n-tiles is the A layout of one 16-deep k-step),
//   B read down the columns of a row-major tile (the forward's P.V):
//   dV, dK (A = P^T, dS^T) and dQ (A = dS, B = K). For f32 the k order is
//   permuted within each 8-deep step, the same permutation on the B side.
// Arithmetic, per type:
// - f32: every product is 3xTF32 on m16n8k8, a = a_hi + a_lo with a_hi
//   rounded to TF32 to nearest and a_lo the rest, and
//   a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each operand's fragment read
//   and split straight from shared memory, as in the forward. Rounding hi
//   to nearest keeps each operand to about 2^-21 of itself, without the
//   one-sided error of the forward's truncating split.
// - bf16 / f16: S and dP are one m16n8k16 product with f32 accumulation,
//   exact as the plain version's f32 scores. P and dS are rounded once to
//   the input type for the three products that take them as A, as
//   FlashAttention-2 does (tests/test_torch_flash_backward.py emulates the
//   rounding and holds it to the tolerances on the CPU).
// - Each tile's dV, dK and dQ product is summed on the tensor cores from
//   zero and folded into f32 registers with f32 adds: a running sum kept in
//   the tensor cores' accumulators drifts over many tiles, since their
//   additions do not round to nearest.
// The gradients are rounded once to the input type.
//
// What bounds it on the H100: operations. The gradients need five products
// of 2 * D flops per unmasked (query, key) pair, 8.6e10 flops at
// [8, 2048, 8, 64] causal; the kernels do seven (S and dP are computed in
// both sweeps). In f32 the hi/lo splits that feed the tensor cores take
// more issue slots than the products. wgmma with TMA and a producer warp
// is the next step.
//
// Tiles are 64 rows of the head dim zero-padded to 32, 64 or 128, rows
// padded by 4 words (f32) or 16 bytes (bf16, f16) so that the fragment
// loads meet no bank conflicts. Rows that cp.async cannot take (D *
// itemsize not a multiple of 16 bytes, or an input not 16-byte aligned) go
// through the kernel's own loader, as in the forward.
//
// Layout: q, o, dO, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, H, D], contiguous;
// lse and delta [B*H, Sq] f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // query rows per query tile, keys per key tile
constexpr int kWarps = 4;      // 16 rows of the block's tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // streamed tiles in flight
constexpr int kDeltaThreads = 256;  // delta_kernel: one warp per query row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the two tile kernels: six [64][LD] tiles of T. dkdv:
// K, V, then kStages Q tiles and kStages dO tiles, then each stage's lse
// and delta ([kStages][64] f32 each). dq: Q, dO, then kStages K and V tiles.
template <typename T, int DMAX>
struct Layout {
  static constexpr int kLD = sizeof(T) == 4 ? DMAX + 4 : DMAX + 8;
  static constexpr int kTile = kB * kLD;
  static constexpr int kDqBytes = (2 + 2 * kStages) * kTile * (int)sizeof(T);
  static constexpr int kDkdvBytes = kDqBytes + 2 * kStages * kB * 4;
  // dk and dv features a dkdv block accumulates (grid.z splits DMAX)
  static constexpr int kAcc = DMAX > 64 ? 64 : DMAX;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a.b on the tensor cores, m16n8k16 with 16-bit inputs. The mma
// statements are not volatile: they only read and write registers, so the
// compiler may interleave them with independent work.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1,
                                      __nv_bfloat16) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1, __half) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a.b, m16n8k8 TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
// cvt.rna's rule, here by an integer add and a mask, which issue faster
// than cvt), lo = x - hi exactly; the tensor cores read lo's top 19 bits,
// so hi.b + lo.b carries x to about 2^-21 of itself, with no one-sided
// error in hi.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// (x0, x1) rounded to the 16-bit type, packed low half first.
__device__ __forceinline__ uint32_t pack16(float x0, float x1, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack16(float x0, float x1, __half) {
  const __half2 h = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Start copying rows [0, valid) of a [64, D] tile (row stride rs elements)
// into dst [64][LD]. vec: 16-byte cp.async chunks, rows past valid zero-
// filled; else the block's own loads, rows past valid and columns past D
// written as zero. Columns past D stay as the kernel zeroed them.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long rs, int valid, int D,
                                          bool vec) {
  constexpr int LD = Layout<T, DMAX>::kLD;
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per chunk
  if (vec) {
    const int chunks = D / kPer;
    for (int i = threadIdx.x; i < kB * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPer;
      const bool ok = r < valid;
      cp_async16(dst + r * LD + c, ok ? src + r * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kB * DMAX; i += kThreads) {
      const int r = i / DMAX;
      const int c = i % DMAX;
      float x = 0.f;
      if (r < valid && c < D) x = to_f32(src[r * rs + c]);
      store(dst + r * LD + c, x);
    }
  }
}

// Start copying the lse and delta of a query tile's rows [0, valid) into
// Ls and Dl ([64] f32 each), rows past valid zero-filled.
__device__ __forceinline__ void load_rows(float* Ls, float* Dl,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int valid) {
  const int i = threadIdx.x & (kB - 1);
  const bool ok = i < valid;
  if (threadIdx.x < kB)
    cp_async4(Ls + i, ok ? lse + i : lse, ok ? 4 : 0);
  else if (threadIdx.x < 2 * kB)
    cp_async4(Dl + i, ok ? delta + i : delta, ok ? 4 : 0);
}

// Pattern 1, two products at once: c1 = A1 B1^T and c2 = A2 B2^T for the
// warp's 16 rows of A1 and A2 (from row m0 of [64][LD] tiles) against the
// 64 rows of B1 and B2. c[j] holds n-tile j (B rows 8j .. 8j+7): this
// thread's rows g (e = 0, 1) and g + 8 (e = 2, 3), columns 8j + 2*t4 +
// (e & 1). The forward's Q.K^T.
template <typename T, int DMAX>
__device__ __forceinline__ void scores(const T* A1, const T* A2, const T* B1,
                                       const T* B2, int m0, int lane,
                                       float (&c1)[8][4], float (&c2)[8][4]) {
  constexpr int LD = Layout<T, DMAX>::kLD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c1[j][e] = 0.f;
      c2[j][e] = 0.f;
    }
  if constexpr (sizeof(T) == 4) {
    const int g = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll 2
    for (int kk = 0; kk < DMAX; kk += 8) {
      uint32_t ah[4], al[4], dh[4], dl[4];
      const float* a1 = A1 + (m0 + g) * LD + kk + t4;
      const float* a2 = A2 + (m0 + g) * LD + kk + t4;
      split_tf32(a1[0], ah[0], al[0]);
      split_tf32(a1[8 * LD], ah[1], al[1]);
      split_tf32(a1[4], ah[2], al[2]);
      split_tf32(a1[8 * LD + 4], ah[3], al[3]);
      split_tf32(a2[0], dh[0], dl[0]);
      split_tf32(a2[8 * LD], dh[1], dl[1]);
      split_tf32(a2[4], dh[2], dl[2]);
      split_tf32(a2[8 * LD + 4], dh[3], dl[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* b1 = B1 + (8 * j + g) * LD + kk + t4;
        const float* b2 = B2 + (8 * j + g) * LD + kk + t4;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b1[0], bh0, bl0);
        split_tf32(b1[4], bh1, bl1);
        mma_tf32(c1[j], al, bh0, bh1);
        mma_tf32(c1[j], ah, bl0, bl1);
        mma_tf32(c1[j], ah, bh0, bh1);
        split_tf32(b2[0], bh0, bl0);
        split_tf32(b2[4], bh1, bl1);
        mma_tf32(c2[j], dl, bh0, bh1);
        mma_tf32(c2[j], dh, bl0, bl1);
        mma_tf32(c2[j], dh, bh0, bh1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 32) {
      uint32_t a0[4], a1[4], d0[4], d1[4];
      const int ar = (m0 + (lane & 15)) * LD + kk + (lane >> 4) * 8;
      ldsm_x4(a0, A1 + ar);
      ldsm_x4(a1, A1 + ar + 16);
      ldsm_x4(d0, A2 + ar);
      ldsm_x4(d1, A2 + ar + 16);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int br = (8 * j + (lane & 7)) * LD + kk + (lane >> 3) * 8;
        uint32_t b[4][4];  // n-tiles j, j + 1 of B1, then of B2
        ldsm_x4(b[0], B1 + br);
        ldsm_x4(b[1], B1 + br + 8 * LD);
        ldsm_x4(b[2], B2 + br);
        ldsm_x4(b[3], B2 + br + 8 * LD);
        mma16(c1[j], a0, b[0][0], b[0][1], T());
        mma16(c1[j + 1], a0, b[1][0], b[1][1], T());
        mma16(c2[j], d0, b[2][0], b[2][1], T());
        mma16(c2[j + 1], d0, b[3][0], b[3][1], T());
        mma16(c1[j], a1, b[0][2], b[0][3], T());
        mma16(c1[j + 1], a1, b[1][2], b[1][3], T());
        mma16(c2[j], d1, b[2][2], b[2][3], T());
        mma16(c2[j + 1], d1, b[3][2], b[3][3], T());
      }
    }
  }
}

// Pattern 2: acc[n] += A Bt[:, 8n .. 8n+7] for n < NA, where A is the
// warp's 16 x 64 accumulator of scores() (a[j][e]: row g + 8 (e >> 1),
// column 8j + 2*t4 + (e & 1)) and Bt a [64][LD] tile read down its columns
// from column 0 (the caller offsets it). The forward's P.V. Each call's
// product is summed from zero, NC n-tiles at a time (NC even, dividing
// NA), and folded into acc with f32 adds.
template <typename T, int DMAX, int NA, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[NA][4],
                                           const float (&a)[8][4],
                                           const T* Bt, int lane) {
  constexpr int LD = Layout<T, DMAX>::kLD;
  static_assert(NC % 2 == 0 && NA % NC == 0, "n-tiles in pairs");
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nc = 0; nc < NA; nc += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    if constexpr (sizeof(T) == 4) {
      // k-step ks covers A's columns 8ks .. 8ks+7; logical k t4 is column
      // 2*t4 and logical k t4 + 4 is column 2*t4 + 1, on both sides
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(a[ks][0], ah[0], al[0]);
        split_tf32(a[ks][2], ah[1], al[1]);
        split_tf32(a[ks][1], ah[2], al[2]);
        split_tf32(a[ks][3], ah[3], al[3]);
        const float* b0 = Bt + (8 * ks + 2 * t4) * LD + 8 * nc + g;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0[8 * n], bh0, bl0);
          split_tf32(b0[LD + 8 * n], bh1, bl1);
          mma_tf32(part[n], al, bh0, bh1);
          mma_tf32(part[n], ah, bl0, bl1);
          mma_tf32(part[n], ah, bh0, bh1);
        }
      }
    } else {
      // k-step ks covers A's columns 16ks .. 16ks+15: n-tiles 2ks, 2ks+1
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[4];
        pa[0] = pack16(a[2 * ks][0], a[2 * ks][1], T());
        pa[1] = pack16(a[2 * ks][2], a[2 * ks][3], T());
        pa[2] = pack16(a[2 * ks + 1][0], a[2 * ks + 1][1], T());
        pa[3] = pack16(a[2 * ks + 1][2], a[2 * ks + 1][3], T());
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, Bt + (16 * ks + (lane & 15)) * LD +
                                8 * (nc + n) + (lane >> 4) * 8);
          mma16(part[n], pa, bv[0], bv[1], T());
          mma16(part[n + 1], pa, bv[2], bv[3], T());
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nc + n][e] += part[n][e];
  }
}

// acc * mul into rows [0, valid) of a tile at dst (row stride rs), the
// warp's rows m0 + g + 8 (e >> 1), columns c0 + 8n + 2*t4 + (e & 1) < D.
template <typename T, int NA>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, long long rs,
                                          const float (&acc)[NA][4], int m0,
                                          int c0, int lane, int valid, int D,
                                          float mul) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + g + 8 * r;
    if (row >= valid) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * t4 + e;
        if (col < D) store(dst + row * rs + col, acc[n][2 * r + e] * mul);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int H, int Sq, int D,
             long long rows) {
  const long long r = (long long)blockIdx.x * (kDeltaThreads / 32) +
                      (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long bh = r / Sq;
  const long long i = r - bh * Sq;
  const long long b = bh / H;
  const long long h = bh - b * H;
  const long long off = ((b * Sq + i) * H + h) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f32(o[off + c]), to_f32(dout[off + c]), s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[r] = s;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
            int D, float scale, int causal, int vec) {
  using L = Layout<T, DMAX>;
  constexpr int NA = L::kAcc / 8;  // 8-feature n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + L::kTile;
  T* Qs = Vs + L::kTile;               // kStages tiles
  T* dOs = Qs + kStages * L::kTile;    // kStages tiles
  float* Ls = reinterpret_cast<float*>(dOs + kStages * L::kTile);
  float* Dl = Ls + kStages * kB;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.y;  // the heaviest (causal) key tiles come first
  const int k0 = kt * kB;
  const int f0 = blockIdx.z * L::kAcc;  // the block's features of dk, dv
  const long long rs = (long long)H * D;
  const T* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const T* ob = dout + (long long)b * Sq * rs + (long long)h * D;
  const long long hk = ((long long)b * Sk + k0) * rs + (long long)h * D;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = delta + (long long)bh * Sq;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = (tid >> 5) * 16;  // the warp's first key in the tile
  const float scale_log2 = scale * kLog2e;

  for (int i = tid; i < L::kDkdvBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // causal: query tile qt holds queries below key tile kt's first key only
  // when qt < kt, and then every pair is masked
  const int qt0 = causal ? kt : 0;
  const int nq = (Sq + kB - 1) / kB - qt0;  // query tiles to sweep
  const bool vc = vec != 0;
  const int kvalid = min(kB, Sk - k0);
  load_tile<T, DMAX>(Ks, k + hk, rs, kvalid, D, vc);
  load_tile<T, DMAX>(Vs, v + hk, rs, kvalid, D, vc);
  if (nq > 0) {
    const int q0 = qt0 * kB;
    load_tile<T, DMAX>(Qs, qb + q0 * rs, rs, min(kB, Sq - q0), D, vc);
    load_tile<T, DMAX>(dOs, ob + q0 * rs, rs, min(kB, Sq - q0), D, vc);
    load_rows(Ls, Dl, lb + q0, db + q0, min(kB, Sq - q0));
  }
  cp_async_commit();

  float adk[NA][4], adv[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[n][e] = 0.f;
      adv[n][e] = 0.f;
    }

  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    const int q0 = (qt0 + it) * kB;
    if (it + 1 < nq) {
      const int q1 = q0 + kB;
      const int nv = min(kB, Sq - q1);
      load_tile<T, DMAX>(Qs + (st ^ 1) * L::kTile, qb + q1 * rs, rs, nv, D,
                         vc);
      load_tile<T, DMAX>(dOs + (st ^ 1) * L::kTile, ob + q1 * rs, rs, nv, D,
                         vc);
      load_rows(Ls + (st ^ 1) * kB, Dl + (st ^ 1) * kB, lb + q1, db + q1, nv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile it has landed
    __syncthreads();
    const T* Qt = Qs + st * L::kTile;
    const T* dOt = dOs + st * L::kTile;
    const float* Lt = Ls + st * kB;
    const float* Dt = Dl + st * kB;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys as the rows, the
    // tile's 64 queries as the columns
    float s[8][4], dp[8][4];
    scores<T, DMAX>(Ks, Vs, Qt, dOt, m0, lane, s, dp);

    // P^T and dS^T in place; each thread reads the lse and delta of its
    // own query columns 8j + 2*t4 + (e & 1)
    const bool whole = q0 + kB <= Sq && k0 + m0 + 16 <= Sk &&
                       (!causal || q0 >= k0 + m0 + 15);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lc2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t4);
      const float2 dc2 = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? lc2.y : lc2.x;
        const float dc = (e & 1) ? dc2.y : dc2.x;
        bool ok = true;
        if (!whole) {
          const int qpos = q0 + 8 * j + 2 * t4 + (e & 1);
          const int kpos = k0 + m0 + g + 8 * (e >> 1);
          ok = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
        }
        const float p =
            ok ? exp2f(fmaf(s[j][e], scale_log2, -lc * kLog2e)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dc);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the block's features
    accumulate<T, DMAX, NA, 4>(adv, s, dOt + f0, lane);
    accumulate<T, DMAX, NA, 4>(adk, dp, Qt + f0, lane);
    __syncthreads();  // every read of stage st is done before its refill
  }
  cp_async_wait<0>();  // nothing in flight at exit

  store_acc<T, NA>(dk + hk, rs, adk, m0, f0, lane, kvalid, D, scale);
  store_acc<T, NA>(dv + hk, rs, adv, m0, f0, lane, kvalid, D, 1.f);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Sq, int Sk, int D, float scale,
          int causal, int vec) {
  using L = Layout<T, DMAX>;
  constexpr int NT = DMAX / 8;  // 8-feature n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + L::kTile;
  T* Ks = dOs + L::kTile;             // kStages tiles
  T* Vs = Ks + kStages * L::kTile;    // kStages tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * kB;
  const int qvalid = min(kB, Sq - q0);
  const long long rs = (long long)H * D;
  const long long hq = ((long long)b * Sq + q0) * rs + (long long)h * D;
  const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const T* vb = v + (long long)b * Sk * rs + (long long)h * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = (tid >> 5) * 16;  // the warp's first query in the tile
  const float scale_log2 = scale * kLog2e;

  for (int i = tid; i < L::kDqBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // causal: key tiles past the tile's last query row are wholly masked
  const int k_end = causal ? min(Sk, q0 + kB) : Sk;
  const int nk = (k_end + kB - 1) / kB;
  const bool vc = vec != 0;
  load_tile<T, DMAX>(Qs, q + hq, rs, qvalid, D, vc);
  load_tile<T, DMAX>(dOs, dout + hq, rs, qvalid, D, vc);
  if (nk > 0) {
    load_tile<T, DMAX>(Ks, kb, rs, min(kB, Sk), D, vc);
    load_tile<T, DMAX>(Vs, vb, rs, min(kB, Sk), D, vc);
  }
  cp_async_commit();

  // lse * log2 e and delta of this thread's rows g and g + 8 (0 past Sq)
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + g + 8 * r;
    const bool ok = row < qvalid;
    lr[r] = ok ? lse[(long long)bh * Sq + q0 + row] * kLog2e : 0.f;
    dr[r] = ok ? delta[(long long)bh * Sq + q0 + row] : 0.f;
  }

  float adq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  for (int kj = 0; kj < nk; ++kj) {
    const int st = kj & 1;
    const int k0 = kj * kB;
    if (kj + 1 < nk) {
      const int k1 = k0 + kB;
      load_tile<T, DMAX>(Ks + (st ^ 1) * L::kTile, kb + k1 * rs, rs,
                         min(kB, Sk - k1), D, vc);
      load_tile<T, DMAX>(Vs + (st ^ 1) * L::kTile, vb + k1 * rs, rs,
                         min(kB, Sk - k1), D, vc);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kj has landed
    __syncthreads();
    const T* Kt = Ks + st * L::kTile;
    const T* Vt = Vs + st * L::kTile;

    // S = Q K^T and dP = dO V^T: the warp's 16 queries against 64 keys
    float s[8][4], dp[8][4];
    scores<T, DMAX>(Qs, dOs, Kt, Vt, m0, lane, s, dp);

    // dS in place of S
    const bool whole =
        k0 + kB <= Sk && (!causal || k0 + kB - 1 <= q0 + m0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = q0 + m0 + g + 8 * r;
          ok = kpos < Sk && (!causal || qpos >= kpos);
        }
        const float p = ok ? exp2f(fmaf(s[j][e], scale_log2, -lr[r])) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[r]);
      }

    // dQ += dS K
    accumulate<T, DMAX, NT, (NT < 8 ? NT : 8)>(adq, s, Kt, lane);
    __syncthreads();  // every read of stage st is done before its refill
  }
  cp_async_wait<0>();  // nothing in flight at exit (Q, dO alone when nk == 0)

  store_acc<T, NT>(dq + hq, rs, adq, m0, 0, lane, qvalid, D, scale);
}

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
           float scale, int causal, int smem_dkdv, int smem_dq,
           cudaStream_t stream) {
  using L = Layout<T, DMAX>;
  if (smem_dkdv != L::kDkdvBytes || smem_dq != L::kDqBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  // 16-byte rows and pointers: the tiles are copied with cp.async
  const int vec = (D * (int)sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);

  const long long rows = (long long)B * H * Sq;
  const long long blocks =
      (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  delta_kernel<T><<<(unsigned)blocks, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, H, Sq, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Sk > 0) {
    const dim3 grid((unsigned)(B * H), (unsigned)((Sk + kB - 1) / kB),
                    (unsigned)(DMAX / L::kAcc));
    dkdv_kernel<T, DMAX><<<grid, kThreads, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Sq, Sk, D, scale, causal, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kB - 1) / kB));
  dq_kernel<T, DMAX><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H, Sq, Sk, D, scale,
      causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
             float scale, int causal, int dmax, int smem_dkdv, int smem_dq,
             cudaStream_t stream) {
  if (D > dmax) return (int)cudaErrorInvalidValue;
  switch (dmax) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq,
                           Sk, D, scale, causal, smem_dkdv, smem_dq, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq,
                           Sk, D, scale, causal, smem_dkdv, smem_dq, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            Sq, Sk, D, scale, causal, smem_dkdv, smem_dq,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype_kind: 0 f32, 1 bf16, 2 f16. q, o, dout, dq [B, Sq, H, D]; k, v, dk,
// dv [B, Sk, H, D], all contiguous and of one type; lse [B*H, Sq] f32 from
// the forward; delta [B*H, Sq] f32 scratch. 1 <= D <= dmax, Sq >= 1,
// Sk >= 0 (Sk = 0: dq is zero and there is no dk or dv to write). dmax (32,
// 64 or 128) and the two kernels' dynamic shared memory in bytes come from
// the wrapper's plan (flash_attention_backward.plan_backward) and are
// checked here. Three launches on `stream`: delta, dk and dv, dq. Returns 0
// or the cudaError_t of the first failed launch.
extern "C" int tft_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D, float scale, int causal,
    int dtype_kind, int dmax, int smem_dkdv, int smem_dq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype_kind) {
    case 0:
      return launch_d<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                             Sq, Sk, D, scale, causal, dmax, smem_dkdv,
                             smem_dq, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     B, H, Sq, Sk, D, scale, causal, dmax,
                                     smem_dkdv, smem_dq, st);
    case 2:
      return launch_d<__half>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                              Sq, Sk, D, scale, causal, dmax, smem_dkdv,
                              smem_dq, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tft_flash_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
