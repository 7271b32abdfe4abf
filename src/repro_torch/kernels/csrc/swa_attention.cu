// Causal sliding-window flash attention, forward.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/swa_attention.py swa_attention -> _swa_kernel (K6).
// q [B, S, H, hd], k/v [B, S, KH, hd] -> o [B, S, H, hd] in q's dtype,
// o = softmax(q k^T / sqrt(hd), causal, kv within the trailing `window`) v.
// GQA by index: q head h reads kv head h / (H / KH); kv are never repeated
// in memory.  The layouts are the model's own (no transposes around it).
//
// What bounds it on an H100: operations.  At S = 4096, W = 4096, H = 16,
// hd = 128 a sequence needs 68.7 GFLOP of products against 34 MB of q, k,
// v and o in bf16.  This first version runs the products on the fp32 CUDA
// cores from shared-memory tiles (inputs fp32 or bf16, fp32 sums); the
// tensor cores are later work.
//
// Design: one block per (q tile of 64 rows, q head, sequence).  On the TPU
// the kv blocks of the window were a sequential grid axis carrying (m, l,
// acc) in scratch; here the block loops over only the kv tiles that meet
// its window, from max(0, q0 - W + 1) to its last row, with the online
// softmax state (m, l) and the [64, hd] accumulator in registers.  S = q k^T
// is a 4x4 register micro-tile per thread; P goes through shared memory for
// the P v product.  The output is acc / (l + 1e-30), as the reference.
// Templated on hd in {16, 32, 64, 128}.
//
// Plain C interface (ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256, BQ = 64, BK = 64;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [HD][BQ+1], one K/V buffer [HD][BK+1] (>= [BK][HD]), Ps [BQ][BK+1]
  return sizeof(float) * (HD * (BQ + 1) + HD * (BK + 1) + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int H,
               int KH, int window, float scale) {
  constexpr int CJ = HD / 16;              // output columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;                          // [HD][BQ+1], scaled q, d-major
  float* KV = Qs + HD * (BQ + 1);          // Ks [HD][BK+1] | Vs [BK][HD]
  float* Ps = KV + HD * (BK + 1);          // [BQ][BK+1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long qrow = (long long)H * HD, kvrow = (long long)KH * HD;
  const T* qb = q + ((long long)b * S) * qrow + (long long)h * HD;
  const T* kb = k + ((long long)b * S) * kvrow + (long long)kvh * HD;
  const T* vb = v + ((long long)b * S) * kvrow + (long long)kvh * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e % HD;
    Qs[c * (BQ + 1) + r] =
        q0 + r < S ? ld(qb, (long long)(q0 + r) * qrow + c) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int qlast = min(q0 + BQ, S) - 1;
  const int jt0 = max(0, q0 - window + 1) / BK, jt1 = qlast / BK;
  for (int jt = jt0; jt <= jt1; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                       // Qs loaded / KV and Ps free
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e % HD;
      KV[c * (BK + 1) + r] =
          k0 + r < S ? ld(kb, (long long)(k0 + r) * kvrow + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = KV[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float tmax = NEG;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp <= qp && kp > qp - window && kp < S;
        if (ok[j]) tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        psum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                       // Ps written, Ks read
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e % HD;
      KV[r * HD + c] = k0 + r < S ? ld(vb, (long long)(k0 + r) * kvrow + c)
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = KV[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + ((long long)b * S) * qrow + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float inv = 1.f / (l[i] + 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      st(ob, (long long)r * qrow + tx + 16 * j, acc[i][j] * inv);
  }
}

// The dynamic shared memory limit is raised once per instance, before any
// graph capture.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int window, float scale,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_fwd_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KH, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KH, int hd, int window,
                      float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KH, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window >= 1 (the caller maps "no window"
// to S).
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KH, int hd,
                                 int window, float scale, int dtype,
                                 void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KH, hd,
                                              window, scale, st)
                   : launch_hd<float>(q, k, v, o, B, S, H, KH, hd, window,
                                      scale, st));
}
