// Exact softmax attention (forward) for NVIDIA Hopper (sm_90a), built with
// nvcc into a shared library with a plain C interface and called through
// ctypes from tensorframes_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/ops/flash_attention.py:
// _kernel / _pallas_attention (the pl.pallas_call at line 122), behind
// flash_attention. It computes what that kernel computes, not how:
//   o = softmax(q k^T * scale [+ top-left causal mask]) v
// with the online softmax over key tiles: a running max m, a normalizer l
// and an unnormalized accumulator acc, all f32, the output written once.
// The scale is applied in f32 after the dot; masked scores are -1e30 and
// their probabilities exactly 0; key rows past Sk are masked by position;
// causal is q_pos >= k_pos (top-left, also when Sq != Sk); key tiles wholly
// above the diagonal are skipped; l == 0 is taken as 1. When a backward will
// follow, the kernel also writes each row's log-sum-exp (flash_attention_
// backward.cu recomputes the probabilities from it); otherwise it writes
// nothing more than o.
//
// Layout: q [B, Sq, H, D], k and v [B, Sk, H, D], o like q, contiguous, read
// in place (no transposes to [B*H, S, D]). Types f32, bf16 and f16; output
// in the input type. No atomics: every sum has a fixed order, so runs are
// bit-identical.
//
// What bounds it on the H100: operations, 4 * D flops per causal score
// pair (3.44e10 at [8, 2048, 8, 64] causal), against 134 MB (f32) of q, k,
// v and o. Both products run on the tensor cores with mma.sync (wgmma, TMA
// and warp specialisation are later work); the softmax between them runs
// on the FP32 pipes:
//
// - bf16 / f16: Q.K^T is one m16n8k16 product with f32 accumulation, exact
//   as the reference's dot with preferred_element_type=f32. The reference
//   keeps p in f32 for P.V, so p is split into p_hi = round(p) and
//   p_lo = round(p - p_hi) in the input type and both are multiplied by the
//   exact v: about 16 bits of p for 1.5x the tensor-core work of one
//   product. P stays in registers: the accumulator layout of two key
//   n-tiles is the A layout of one k-step.
// - f32: TF32 keeps 10 bits. Each product is 3xTF32 on m16n8k8:
//   a = a_hi + a_lo with a_hi the TF32 part of a and a_lo = a - a_hi, and
//   a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps the error near
//   f32's. P feeds P.V from registers with its key order permuted within
//   each 8-key step (the same permutation on the V side).
// - Each key tile's P.V is summed on the tensor cores from zero and folded
//   into the running output with f32 FMAs: a running sum kept in the
//   tensor cores' accumulators drifts over many tiles, since their
//   additions do not round to nearest.
// - The softmax runs in base 2 (scores times scale * log2 e, in f32 after
//   the dot), and only a tile that reaches past Sk or crosses the warp's
//   diagonal computes masks.
//
// Work split: one block of 4 warps per (b*h, tile of 64 query rows); each
// warp owns 16 query rows. Key tiles of 64 rows are loaded into a ring of
// two shared-memory stages with cp.async while the previous tile is in
// the tensor cores; rows that cp.async cannot take (D * itemsize not a
// multiple of 16 bytes, or an input not 16-byte aligned) go through the
// kernel's own loader. The head dim is zero-padded to 32, 64 or 128 in
// shared memory. For causal attention the tiles with the most key tiles
// are scheduled first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 64;        // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // K/V tiles in flight
constexpr float kNegInf = -1e30f;

// Shared memory: the Q tile, then kStages K tiles, then kStages V tiles,
// each [64][LD] of T. The row pad keeps the fragment loads free of bank
// conflicts (ldmatrix rows 16 bytes apart mod 128; f32 rows 4 words apart).
template <typename T, int DMAX>
struct Layout {
  static constexpr int kLD = sizeof(T) == 4 ? DMAX + 4 : DMAX + 8;
  static constexpr int kTile = kBQ * kLD;
  static constexpr int kBytes = (1 + 2 * kStages) * kTile * (int)sizeof(T);
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

// c += a.b on the tensor cores, m16n8k16 with 16-bit inputs.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1,
                                      __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a.b, m16n8k8 TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's top 19 bits, so
// hi.b + lo.b carries x to about 2^-20 of itself.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// (x0, x1) = hi + lo, each a pair of 16-bit values packed low half first.
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, __half) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const __half2 l = __floats2half2_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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
    for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPer;
      const bool ok = r < valid;
      cp_async16(dst + r * LD + c, ok ? src + r * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * DMAX; i += kThreads) {
      const int r = i / DMAX;
      const int c = i % DMAX;
      float x = 0.f;
      if (r < valid && c < D) x = to_f32(src[r * rs + c]);
      store(dst + r * LD + c, x);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 float scale, int causal, int vec) {
  using L = Layout<T, DMAX>;
  constexpr int LD = L::kLD;
  constexpr int NT = DMAX / 8;  // 8-column n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + L::kTile;             // kStages tiles
  T* Vs = Ks + kStages * L::kTile;   // kStages tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qi * kBQ;
  const long long rs = (long long)H * D;  // elements between two sequence rows
  const T* qb = q + ((long long)b * Sq + q0) * rs + (long long)h * D;
  const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const T* vb = v + (long long)b * Sk * rs + (long long)h * D;
  T* ob = o + ((long long)b * Sq + q0) * rs + (long long)h * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // the fragment's row group
  const int t4 = lane & 3;   // the thread within the group
  const int m0 = warp * 16;  // the warp's first query row in the tile
  const float scale_log2 = scale * 1.4426950408889634f;  // scale * log2 e

  for (int i = tid; i < L::kBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // causal: key tiles past the tile's last query row are wholly masked
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int nk = (k_end + kBK - 1) / kBK;
  const bool vc = vec != 0;
  load_tile<T, DMAX>(Qs, qb, rs, min(kBQ, Sq - q0), D, vc);
  if (nk > 0) {
    load_tile<T, DMAX>(Ks, kb, rs, min(kBK, Sk), D, vc);
    load_tile<T, DMAX>(Vs, vb, rs, min(kBK, Sk), D, vc);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};          // this thread's share of each row's sum
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kj = 0; kj < nk; ++kj) {
    const int st = kj & 1;
    const int k0 = kj * kBK;
    if (kj + 1 < nk) {
      const int k1 = k0 + kBK;
      load_tile<T, DMAX>(Ks + (st ^ 1) * L::kTile, kb + k1 * rs, rs,
                         min(kBK, Sk - k1), D, vc);
      load_tile<T, DMAX>(Vs + (st ^ 1) * L::kTile, vb + k1 * rs, rs,
                         min(kBK, Sk - k1), D, vc);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kj has landed
    __syncthreads();
    const T* Kt = Ks + st * L::kTile;
    const T* Vt = Vs + st * L::kTile;

    // s[j]: the warp's 16 rows against keys 8j .. 8j+7 of the tile; this
    // thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 2*t4 + (e&1)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += 8) {
        uint32_t ah[4], al[4];
        split_tf32(Qs[(m0 + g) * LD + kk + t4], ah[0], al[0]);
        split_tf32(Qs[(m0 + g + 8) * LD + kk + t4], ah[1], al[1]);
        split_tf32(Qs[(m0 + g) * LD + kk + t4 + 4], ah[2], al[2]);
        split_tf32(Qs[(m0 + g + 8) * LD + kk + t4 + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(Kt[(8 * j + g) * LD + kk + t4], bh0, bl0);
          split_tf32(Kt[(8 * j + g) * LD + kk + t4 + 4], bh1, bl1);
          mma_tf32(s[j], al, bh0, bh1);
          mma_tf32(s[j], ah, bl0, bl1);
          mma_tf32(s[j], ah, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += 32) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, Qs + (m0 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
        ldsm_x4(a1, Qs + (m0 + (lane & 15)) * LD + kk + 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bk[4];
          ldsm_x4(bk, Kt + (8 * j + (lane & 7)) * LD + kk + (lane >> 3) * 8);
          mma16(s[j], a0, bk[0], bk[1], T());
          mma16(s[j], a1, bk[2], bk[3], T());
        }
      }
    }

    // online softmax for rows g (r = 0) and g + 8 (r = 1), in base 2: a
    // score becomes s * (scale * log2 e) in f32 and p = 2^(s - m). Only a
    // tile that reaches past Sk or crosses the warp's diagonal is masked.
    const bool whole =
        k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= q0 + m0);
    float alpha[2];  // the rescale of each row's earlier tiles
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + m0 + g + 8 * r;
      uint32_t seen = 0xffffu;  // bit 2j + (e & 1): the key is not masked
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float x = s[j][e] * scale_log2;
          if (!whole) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            if (kpos >= Sk || (causal && qpos < kpos)) {
              seen &= ~(1u << (2 * j + (e & 1)));
              x = kNegInf;
            }
          }
          s[j][e] = x;
          mc = fmaxf(mc, x);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[r], mc);
      alpha[r] = exp2f(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const bool ok = (seen >> (2 * j + (e & 1))) & 1u;
          const float p = ok ? exp2f(s[j][e] - mn) : 0.f;
          s[j][e] = p;
          ps += p;
        }
      l[r] = alpha[r] * l[r] + ps;
      m[r] = mn;
    }

    // pv = P V for this tile, then acc = alpha acc + pv with f32 FMAs (see
    // the note at the top)
    float pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
    if constexpr (sizeof(T) == 4) {
      // k-step ks covers keys 8ks .. 8ks+7; logical k t4 is key 2*t4 and
      // logical k t4 + 4 is key 2*t4 + 1, on both sides
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t ph[4], pl[4];
        split_tf32(s[ks][0], ph[0], pl[0]);
        split_tf32(s[ks][2], ph[1], pl[1]);
        split_tf32(s[ks][1], ph[2], pl[2]);
        split_tf32(s[ks][3], ph[3], pl[3]);
        const float* v0 = Vt + (8 * ks + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[8 * n], bh0, bl0);
          split_tf32(v0[LD + 8 * n], bh1, bl1);
          mma_tf32(pv[n], pl, bh0, bh1);
          mma_tf32(pv[n], ph, bl0, bl1);
          mma_tf32(pv[n], ph, bh0, bh1);
        }
      }
    } else {
      // k-step ks covers keys 16ks .. 16ks+15: n-tiles 2ks and 2ks+1 of s
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ph[4], pl[4];
        split16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0], T());
        split16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1], T());
        split16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2], T());
        split16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3], T());
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, Vt + (16 * ks + (lane & 15)) * LD + 8 * n +
                                (lane >> 4) * 8);
          mma16(pv[n], pl, bv[0], bv[1], T());
          mma16(pv[n], ph, bv[0], bv[1], T());
          mma16(pv[n + 1], pl, bv[2], bv[3], T());
          mma16(pv[n + 1], ph, bv[2], bv[3], T());
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();  // every read of stage st is done before its refill
  }
  cp_async_wait<0>();  // nothing in flight at exit (Q alone when nk == 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = m0 + g + 8 * r;
    if (q0 + row >= Sq) continue;
    const float li = lr == 0.f ? 1.f : lr;
    // the natural log-sum-exp of the row's scaled scores, for the backward;
    // -inf for a row with no key (Sk = 0), which no backward reads
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * Sq + q0 + row] =
          lr == 0.f ? __int_as_float(0xff800000)
                  : (m[r] + log2f(lr)) * 0.6931471805599453f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t4 + e;
        if (col < D) store(ob + row * rs + col, acc[n][2 * r + e] / li);
      }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, int D, float scale, int causal,
           int smem, int vec, cudaStream_t stream) {
  if (smem != Layout<T, DMAX>::kBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, D,
      scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int Sq, int Sk, int D, float scale, int causal,
             int dmax, int smem, int vec, cudaStream_t stream) {
  if (D > dmax) return (int)cudaErrorInvalidValue;
  switch (dmax) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                            smem, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                            smem, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                            smem, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype_kind: 0 f32, 1 bf16, 2 f16. q [B, Sq, H, D], k and v [B, Sk, H, D],
// o [B, Sq, H, D], all contiguous; 1 <= D <= dmax, Sq >= 1. lse: NULL, or
// [B*H, Sq] f32 that receives each row's natural log-sum-exp of its scaled
// scores (written only when asked for: the backward reads it). dmax (32, 64
// or 128) and smem (its dynamic shared memory in bytes) come from the
// wrapper's plan (flash_attention.plan_launch) and are checked here. vec:
// D * itemsize is a multiple of 16 and every pointer 16-byte aligned, so
// tiles may be copied with cp.async. Returns 0 or the cudaError_t of the
// failed launch.
extern "C" int tft_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype_kind, int dmax,
                                   int smem, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype_kind) {
    case 0:
      return launch_d<float>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                             dmax, smem, vec, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Sk, D, scale,
                                     causal, dmax, smem, vec, st);
    case 2:
      return launch_d<__half>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                              dmax, smem, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tft_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
