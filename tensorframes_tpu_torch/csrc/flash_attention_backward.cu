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
// - dkdv_kernel: one block per (b*h, tile of 64 keys), sweeping the query
//   tiles at or below the diagonal (causal: query tiles from the key tile's
//   own index on; a key tile that no query sees is written as zeros);
// - dq_kernel: one block per (b*h, tile of 64 queries), sweeping the key
//   tiles up to the diagonal, the tiles with the most key tiles first.
// Each recomputes S and P for its tiles. Masked positions (key past Sk,
// query past Sq, causal q_pos < k_pos) have P = 0 exactly, so their
// gradients are 0; a row with Sk = 0 has no key tile and dq = 0.
//
// Arithmetic: every tile is converted to f32 in shared memory and every
// product is summed with f32 FMAs on the CUDA cores (SIMT), for f32, bf16
// and f16 alike; the gradients are rounded once to the input type. This is
// the simple design: f32-exact, with no tensor-core work. What bounds it on
// the H100: operations. The gradients need five products of 2 * D flops per
// unmasked (query, key) pair, 8.6e10 flops at [8, 2048, 8, 64] causal; the
// kernels do seven (S and dP are computed in both sweeps) at the CUDA
// cores' f32 rate, 67 TFLOP/s at most, where the bound counts the tensor
// cores' rate. Moving the products onto the tensor cores (mma.sync, then
// wgmma with TMA) is later work.
//
// Work split inside a block: 256 threads as 16 x 16. For S and dP each
// thread owns a 4 x 4 patch of the 64 x 64 tile (rows ty + 16a, keys
// tx + 16c), reading q, dO, k and v rows four features at a time (float4);
// for the accumulations (dK, dV, dQ) each thread owns 4 rows (4ty .. 4ty+3)
// and DMAX/16 features, read as float4 (or float2 when DMAX is 32) so that
// a warp's loads are contiguous. The head dim is zero-padded to 32, 64 or
// 128 in shared memory.
//
// Layout: q, o, dO, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, H, D], contiguous;
// lse and delta [B*H, Sq] f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // query rows per query tile, keys per key tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLS = kB + 4;    // row stride of the 64 x 64 P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// Shared memory of the two kernels, in floats: four [64][LD] tiles (q, dO,
// k, v), then the score tiles ([64][kLS] each: P and dS for dkdv_kernel,
// dS^T for dq_kernel), then lse * log2 e and delta of the query tile.
template <int DMAX>
struct Layout {
  static constexpr int kLD = DMAX + 4;  // float4 rows, 4 banks apart
  static constexpr int kTile = kB * kLD;
  static constexpr int kDkdvBytes = (4 * kTile + 2 * kB * kLS + 2 * kB) * 4;
  static constexpr int kDqBytes = (4 * kTile + kB * kLS + 2 * kB) * 4;
};

// Rows [0, valid) of a [64, D] tile at src (row stride rs elements) into
// dst [64][LD] as f32; rows past valid and columns D .. DMAX-1 as zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long rs, int valid, int D) {
  constexpr int LD = Layout<DMAX>::kLD;
  for (int i = threadIdx.x; i < kB * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int c = i % DMAX;
    float x = 0.f;
    if (r < valid && c < D) x = to_f32(src[r * rs + c]);
    dst[r * LD + c] = x;
  }
}

// lse * log2 e and delta of the query tile's rows [0, valid), 0 past them.
__device__ __forceinline__ void load_rows(float* Ls, float* Dl,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long base, int valid) {
  const int i = threadIdx.x;
  if (i < kB) {
    Ls[i] = i < valid ? lse[base + i] * kLog2e : 0.f;
    Dl[i] = i < valid ? delta[base + i] : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for this thread's 4 x 4 patch: query rows
// ty + 16a of Qs / dOs, keys tx + 16c of Ks / Vs.
template <int DMAX>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int LD = Layout<DMAX>::kLD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < DMAX; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(x[a].x, y[c].x, s[a][c]);
        s[a][c] = fmaf(x[a].y, y[c].y, s[a][c]);
        s[a][c] = fmaf(x[a].z, y[c].z, s[a][c]);
        s[a][c] = fmaf(x[a].w, y[c].w, s[a][c]);
      }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dp[a][c] = fmaf(x[a].x, y[c].x, dp[a][c]);
        dp[a][c] = fmaf(x[a].y, y[c].y, dp[a][c]);
        dp[a][c] = fmaf(x[a].z, y[c].z, dp[a][c]);
        dp[a][c] = fmaf(x[a].w, y[c].w, dp[a][c]);
      }
  }
}

// The features a thread accumulates: VW consecutive ones at
// VW * tx + 16 * VW * n, n < NV, so that 16 threads read one contiguous row.
template <int DMAX>
struct Cols {
  static constexpr int VW = DMAX >= 64 ? 4 : 2;
  static constexpr int NV = DMAX / (16 * VW);
  static constexpr int N = VW * NV;
  __device__ static __forceinline__ int at(int tx, int n) {
    return VW * tx + 16 * VW * n;
  }
};

// acc[r][VW n + e] += w[r] * row[at(tx, n) + e] for r < 4.
template <int DMAX>
__device__ __forceinline__ void axpy_rows(float (&acc)[4][Cols<DMAX>::N],
                                          const float4& w, const float* row,
                                          int tx) {
  using C = Cols<DMAX>;
  const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int n = 0; n < C::NV; ++n) {
    float v[C::VW];
    if constexpr (C::VW == 4) {
      const float4 t = *reinterpret_cast<const float4*>(row + C::at(tx, n));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(row + C::at(tx, n));
      v[0] = t.x; v[1] = t.y;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        acc[r][C::VW * n + e] = fmaf(wr[r], v[e], acc[r][C::VW * n + e]);
  }
}

// out rows 4ty + r (< valid) of a [64, D] tile at dst, times mul.
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long rs,
                                           const float (&acc)[4][Cols<DMAX>::N],
                                           int ty, int tx, int valid, int D,
                                           float mul) {
  using C = Cols<DMAX>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ty + r;
    if (row >= valid) continue;
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) {
        const int col = C::at(tx, n) + e;
        if (col < D) store(dst + row * rs + col, acc[r][C::VW * n + e] * mul);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int H, int Sq, int D,
             long long rows) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
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
__global__ void __launch_bounds__(kThreads, DMAX == 128 ? 1 : 2)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
            int D, float scale, int causal) {
  using L = Layout<DMAX>;
  using C = Cols<DMAX>;
  constexpr int LD = L::kLD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kTile;
  float* Ks = dOs + L::kTile;
  float* Vs = Ks + L::kTile;
  float* Ps = Vs + L::kTile;  // [query][key]
  float* dSs = Ps + kB * kLS;  // [query][key]
  float* Ls = dSs + kB * kLS;
  float* Dl = Ls + kB;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.y;  // the heaviest (causal) key tiles come first
  const int k0 = kt * kB;
  const int kvalid = min(kB, Sk - k0);
  const long long rs = (long long)H * D;
  const long long hq = (long long)b * Sq * rs + (long long)h * D;
  const long long hk = ((long long)b * Sk + k0) * rs + (long long)h * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, DMAX>(Ks, k + hk, rs, kvalid, D);
  load_tile<T, DMAX>(Vs, v + hk, rs, kvalid, D);
  float adk[4][C::N], adv[4][C::N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < C::N; ++n) {
      adk[r][n] = 0.f;
      adv[r][n] = 0.f;
    }

  // causal: query tile qt holds queries below key tile kt's first key only
  // when qt < kt, and then every pair is masked
  const int nq = (Sq + kB - 1) / kB;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    const int qvalid = min(kB, Sq - q0);
    __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs are done
    load_tile<T, DMAX>(Qs, q + hq + q0 * rs, rs, qvalid, D);
    load_tile<T, DMAX>(dOs, dout + hq + q0 * rs, rs, qvalid, D);
    load_rows(Ls, Dl, lse, delta, (long long)bh * Sq + q0, qvalid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DMAX>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a;
        const int j = tx + 16 * c;
        const bool ok = i < qvalid && j < kvalid && (!causal || q0 + i >= k0 + j);
        const float p = ok ? exp2f(fmaf(s[a][c], scale_log2, -Ls[i])) : 0.f;
        Ps[i * kLS + j] = p;
        dSs[i * kLS + j] = p * (dp[a][c] - Dl[i]);
      }
    __syncthreads();

    // dV[j] += sum_i P[i][j] dO[i],  dK[j] += sum_i dS[i][j] Q[i]
    for (int i = 0; i < qvalid; ++i) {
      const float4 pw = *reinterpret_cast<const float4*>(Ps + i * kLS + 4 * ty);
      const float4 dw = *reinterpret_cast<const float4*>(dSs + i * kLS + 4 * ty);
      axpy_rows<DMAX>(adv, pw, dOs + i * LD, tx);
      axpy_rows<DMAX>(adk, dw, Qs + i * LD, tx);
    }
  }

  store_rows<T, DMAX>(dk + hk, rs, adk, ty, tx, kvalid, D, scale);
  store_rows<T, DMAX>(dv + hk, rs, adv, ty, tx, kvalid, D, 1.f);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 128 ? 1 : 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Sq, int Sk, int D, float scale,
          int causal) {
  using L = Layout<DMAX>;
  using C = Cols<DMAX>;
  constexpr int LD = L::kLD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kTile;
  float* Ks = dOs + L::kTile;
  float* Vs = Ks + L::kTile;
  float* dSt = Vs + L::kTile;  // [key][query]
  float* Ls = dSt + kB * kLS;
  float* Dl = Ls + kB;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * kB;
  const int qvalid = min(kB, Sq - q0);
  const long long rs = (long long)H * D;
  const long long hq = ((long long)b * Sq + q0) * rs + (long long)h * D;
  const long long hk = (long long)b * Sk * rs + (long long)h * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, DMAX>(Qs, q + hq, rs, qvalid, D);
  load_tile<T, DMAX>(dOs, dout + hq, rs, qvalid, D);
  load_rows(Ls, Dl, lse, delta, (long long)bh * Sq + q0, qvalid);
  float adq[4][C::N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < C::N; ++n) adq[r][n] = 0.f;

  // causal: key tiles past the tile's last query row are wholly masked
  const int k_end = causal ? min(Sk, q0 + kB) : Sk;
  const int nk = (k_end + kB - 1) / kB;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kB;
    const int kvalid = min(kB, Sk - k0);
    __syncthreads();  // the last tile's reads of Ks, Vs, dSt are done
    load_tile<T, DMAX>(Ks, k + hk + k0 * rs, rs, kvalid, D);
    load_tile<T, DMAX>(Vs, v + hk + k0 * rs, rs, kvalid, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DMAX>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a;
        const int j = tx + 16 * c;
        const bool ok = i < qvalid && j < kvalid && (!causal || q0 + i >= k0 + j);
        const float p = ok ? exp2f(fmaf(s[a][c], scale_log2, -Ls[i])) : 0.f;
        dSt[j * kLS + i] = p * (dp[a][c] - Dl[i]);
      }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]
    for (int j = 0; j < kvalid; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(dSt + j * kLS + 4 * ty);
      axpy_rows<DMAX>(adq, w, Ks + j * LD, tx);
    }
  }

  store_rows<T, DMAX>(dq + hq, rs, adq, ty, tx, qvalid, D, scale);
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
           float scale, int causal, int smem_dkdv, int smem_dq,
           cudaStream_t stream) {
  using L = Layout<DMAX>;
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

  const long long rows = (long long)B * H * Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  delta_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, H, Sq, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Sk > 0) {
    const dim3 grid((unsigned)(B * H), (unsigned)((Sk + kB - 1) / kB));
    dkdv_kernel<T, DMAX><<<grid, kThreads, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Sq, Sk, D, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kB - 1) / kB));
  dq_kernel<T, DMAX><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H, Sq, Sk, D, scale,
      causal);
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
