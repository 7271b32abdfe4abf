// Per-tile stochastic quantizer of the uplink wire codecs (int8 / fp8),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/quantize.py:
//   quantize_bits   <- quantize_2d(x, bits)  (_quant_kernel, caller bits)
//   quantize_philox <- quantize_2d(x, seed=) (_quant_kernel_prng, in-kernel
//                      PRNG); here Philox4x32-10, written out below.
// Both share one tile routine, quant_tile, the way _quant_tile is shared, so
// the two differ only in where the random bits come from.
//
// Wire contract (bitwise with kernels/ref.py::quantize_2d given the same
// bits):
//   - tile 8x128 (one 4-byte fp32 scale per tile is what wire_bytes bills);
//   - scale = max(absmax, 1e-12f) * fp32(1/qmax), multiplied, never divided
//     (0x3c010204 = 1/127, 0x3b124925 = 1/448);
//   - y = x / scale with an IEEE-rounded divide (__fdiv_rn); built without
//     --use_fast_math;
//   - int8: u = (bits >> 8) * 2^-24, q = floor(y + u), clipped to +-127;
//     deterministic: rint(y) (half to even);
//   - fp8: add the low 20 random bits to the fp32 pattern, drop them, clip
//     to +-448, then cvt to e4m3 (round to nearest even, which is also how
//     e4m3 subnormals, |y| < 2^-6, round in the reference).
//
// Philox layout (quantize_philox), per tile (i, j) and element (r, c) of the
// tile, p = r * 128 + c:  key = the client's 64-bit seed (low, high word);
// counter = (j, i, p / 4, 0); bits = word p % 4.  Thread t of the block
// owns elements 4t..4t+3, i.e. exactly the four words of counter t, so one
// Philox call per thread.  kernels/ref.py::philox_bits is the same stream.
//
// Bound: pure data movement.  At the main path's shape (4 clients of
// [864, 64] fp32) quantize_bits moves 1,992,384 B (x and bits in, q and
// scales out), ~0.59 us at 3.35 TB/s; quantize_philox moves 1,107,648 B,
// ~0.33 us.  Both are far below launch latency, so the design is the simple
// one: one CTA of 256 threads per (client, 8x128 tile), one warp per tile
// row, a warp-shuffle + shared-memory absmax reduction with the ragged edge
// read as zeros, and stores only for real elements.  Several tiles per CTA
// and vector loads are later work, once a shape makes bandwidth matter.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 8;
constexpr int kBC = 128;
constexpr int kThreads = kBT * kBC / 4;  // 256: four elements per thread
constexpr int kWarps = kThreads / 32;    // 8: one warp per tile row

enum Fmt { kInt8 = 0, kFp8 = 1 };

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// One client's tile (ti, tj) of x [R, C]; rnd holds the random bits of this
// thread's four elements.  q is int8 or e4m3 bytes, scales [nR, nC].
template <int FMT>
__device__ __forceinline__ void quant_tile(const float* __restrict__ x,
                                           uint8_t* __restrict__ q,
                                           float* __restrict__ scales, int R,
                                           int C, int nC, int ti, int tj,
                                           const uint32_t rnd[4],
                                           bool stochastic) {
  __shared__ float warp_max[kWarps];
  const int t = threadIdx.x;
  const int row = ti * kBT + t / 32;
  const int col0 = tj * kBC + (t % 32) * 4;
  const bool row_ok = row < R;

  float v[4];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = row_ok && col0 + k < C;
    v[k] = ok ? x[(size_t)row * C + col0 + k] : 0.0f;  // ragged edge = 0
    m = fmaxf(m, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (t % 32 == 0) warp_max[t / 32] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);

  const float inv_qmax =
      __int_as_float(FMT == kInt8 ? 0x3c010204 : 0x3b124925);
  const float scale = __fmul_rn(fmaxf(m, 1e-12f), inv_qmax);
  if (t == 0) scales[ti * nC + tj] = scale;
  if (!row_ok) return;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (col0 + k >= C) break;
    float y = __fdiv_rn(v[k], scale);
    uint8_t out;
    if (FMT == kInt8) {
      float qf;
      if (stochastic) {
        const float u = __fmul_rn((float)(rnd[k] >> 8),
                                  __int_as_float(0x33800000));  // 2^-24
        qf = floorf(__fadd_rn(y, u));
      } else {
        qf = rintf(y);
      }
      qf = fminf(fmaxf(qf, -127.0f), 127.0f);
      out = (uint8_t)(int8_t)qf;
    } else {
      if (stochastic) {
        uint32_t b = __float_as_uint(y);
        b = (b + (rnd[k] & 0xFFFFFu)) & 0xFFF00000u;
        y = __uint_as_float(b);
      }
      y = fminf(fmaxf(y, -448.0f), 448.0f);
      out = (uint8_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    }
    q[(size_t)row * C + col0 + k] = out;
  }
}

// grid (nC, nR, n): blockIdx.z is the client.
template <int FMT>
__global__ void __launch_bounds__(kThreads)
    quantize_bits_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ bits,
                         uint8_t* __restrict__ q, float* __restrict__ scales,
                         int R, int C, int stochastic) {
  const int tj = blockIdx.x, ti = blockIdx.y, client = blockIdx.z;
  const int nC = gridDim.x, nR = gridDim.y;
  const size_t off = (size_t)client * R * C;
  uint32_t rnd[4] = {0u, 0u, 0u, 0u};
  if (stochastic) {
    const int t = threadIdx.x;
    const int row = ti * kBT + t / 32;
    const int col0 = tj * kBC + (t % 32) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row < R && col0 + k < C)
        rnd[k] = bits[off + (size_t)row * C + col0 + k];
  }
  quant_tile<FMT>(x + off, q + off, scales + (size_t)client * nR * nC, R, C,
                  nC, ti, tj, rnd, stochastic != 0);
}

template <int FMT>
__global__ void __launch_bounds__(kThreads)
    quantize_philox_kernel(const float* __restrict__ x,
                           const int64_t* __restrict__ seeds,
                           uint8_t* __restrict__ q,
                           float* __restrict__ scales, int R, int C) {
  const int tj = blockIdx.x, ti = blockIdx.y, client = blockIdx.z;
  const int nC = gridDim.x, nR = gridDim.y;
  const size_t off = (size_t)client * R * C;
  const uint64_t seed = (uint64_t)seeds[client];
  uint32_t rnd[4] = {(uint32_t)tj, (uint32_t)ti, (uint32_t)threadIdx.x, 0u};
  philox4x32_10(rnd, (uint32_t)seed, (uint32_t)(seed >> 32));
  quant_tile<FMT>(x + off, q + off, scales + (size_t)client * nR * nC, R, C,
                  nC, ti, tj, rnd, true);
}

dim3 tile_grid(int n, int R, int C) {
  return dim3((C + kBC - 1) / kBC, (R + kBT - 1) / kBT, n);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch; the launch goes on `stream` and does not synchronise.
extern "C" int quantize_bits(const void* x, const void* bits, void* q,
                             void* scales, int n, int R, int C, int fmt,
                             int stochastic, void* stream) {
  const dim3 grid = tile_grid(n, R, C);
  cudaStream_t s = (cudaStream_t)stream;
  if (fmt == kInt8)
    quantize_bits_kernel<kInt8><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const uint32_t*)bits, (uint8_t*)q, (float*)scales,
        R, C, stochastic);
  else
    quantize_bits_kernel<kFp8><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const uint32_t*)bits, (uint8_t*)q, (float*)scales,
        R, C, stochastic);
  return (int)cudaGetLastError();
}

extern "C" int quantize_philox(const void* x, const void* seeds, void* q,
                               void* scales, int n, int R, int C, int fmt,
                               void* stream) {
  const dim3 grid = tile_grid(n, R, C);
  cudaStream_t s = (cudaStream_t)stream;
  if (fmt == kInt8)
    quantize_philox_kernel<kInt8><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const int64_t*)seeds, (uint8_t*)q, (float*)scales,
        R, C);
  else
    quantize_philox_kernel<kFp8><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const int64_t*)seeds, (uint8_t*)q, (float*)scales,
        R, C);
  return (int)cudaGetLastError();
}
