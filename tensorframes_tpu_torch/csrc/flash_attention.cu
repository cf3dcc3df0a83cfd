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
// Masked scores are -1e30 and their probabilities exactly 0; key rows past
// Sk are masked; causal is q_pos >= k_pos (top-left, also when Sq != Sk);
// key tiles wholly above the diagonal are skipped; l == 0 is taken as 1.
//
// Layout: q [B, Sq, H, D], k and v [B, Sk, H, D], o like q, contiguous, read
// in place (no transposes to [B*H, S, D]). Types f32, bf16 and f16, widened
// to f32 on the way into shared memory; every product is an f32 FMA on the
// FP32 pipes (no TF32, no tensor cores), so f32 inputs meet the reference's
// 2e-5 tolerance. Output in the input type. No atomics: each output element
// has one writer that sums in a fixed order, so runs are bit-identical.
//
// Work split: one block of 256 threads per (b*h, tile of 64 query rows).
// The TPU's sequential k grid axis becomes a loop over key tiles of 64
// rows, staged in shared memory. Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows 4*ty .. 4*ty+3: it computes their scores against keys
// tx + 16*j (j < 4) and accumulates their outputs for columns
// 4*tx + 64*c .. +3. A row's statistics live in the 16 lanes that share
// its ty and are reduced with warp shuffles. For causal attention the
// tiles with the most key tiles are scheduled first.
//
// What bounds it on the H100: operations. At the main path's shape,
// [8, 2048, 8, 64] causal in f32, the function needs 4 * D flops per
// score pair, 2,098,176 pairs per (b, h): 3.44e10 flops, 0.513 ms on the
// 67 TFLOP/s FP32 pipes, against 134 MB of q, k, v and o, 0.040 ms at
// 3.35 TB/s. TF32 tensor cores would be faster but change the result. The
// design keeps the [Sq, Sk] scores out of device memory (each k and v tile
// is read once per query tile) and feeds the FMAs from registers: per 4
// elements of the contraction a thread loads 8 float4 from shared memory
// for 64 FMAs. mma.sync for bf16/f16, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPLD = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// Stage rows [0, valid) of a [64, D] tile (row stride rs elements) into
// shared memory as f32 [64][DMAX + 4]; rows past valid and columns past D
// are zero, so they add nothing to any product.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long rs, int valid, int D) {
  constexpr int LD = DMAX + 4;
  for (int i = threadIdx.x; i < kBK * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int c = i % DMAX;
    float x = 0.f;
    if (r < valid && c < D) x = to_f32(src[r * rs + c]);
    dst[r * LD + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
                 int Sk, int D, float scale, int causal) {
  constexpr int LD = DMAX + 4;
  constexpr int NC = DMAX / 64;  // float4 column groups per thread in P.V
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;   // [kBK][LD]
  float* Vs = Ks + kBK * LD;   // [kBK][LD]
  float* Ps = Vs + kBK * LD;   // [kBQ][kPLD]

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
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile<T, DMAX>(Qs, qb, rs, min(kBQ, Sq - q0), D);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles past the tile's last query row are wholly masked
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int nk = (k_end + kBK - 1) / kBK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_tile<T, DMAX>(Ks, kb + k0 * rs, rs, min(kBK, Sk - k0), D);
    load_tile<T, DMAX>(Vs, vb + k0 * rs, rs, min(kBK, Sk - k0), D);
    __syncthreads();

    // scores for rows 4*ty + i against keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool ok[4];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || qpos >= kpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        Ps[(4 * ty + i) * kPLD + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows 4*ty + i, columns 4*tx + 64*c .. +3
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * kPLD + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + t) * LD + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                          : t == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) {
      const int col = 4 * tx + 64 * (c / 4) + (c % 4);
      if (col < D) store(ob + r * rs + col, acc[i][c] / li);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr int LD = DMAX + 4;
  const size_t smem =
      (size_t)(kBQ * LD + 2 * kBK * LD + kBQ * kPLD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Sq, int Sk, int D, float scale, int causal,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype_kind: 0 f32, 1 bf16, 2 f16. q [B, Sq, H, D], k and v [B, Sk, H, D],
// o [B, Sq, H, D], all contiguous; 1 <= D <= 128, Sq >= 1.
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int tft_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Sk, int D, float scale,
                                   int causal, int dtype_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype_kind) {
    case 0:
      return launch_d<float>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, D, scale,
                                     causal, st);
    case 2:
      return launch_d<__half>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tft_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
