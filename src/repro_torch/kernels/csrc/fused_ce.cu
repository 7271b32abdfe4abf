// Fused linear + cross-entropy for the LM heads, forward and backward.
//
// Replaces the JAX package's Pallas kernels in src/repro/kernels/fused_ce.py:
//   K3  fused_ce_fwd -> _fwd_kernel   per-row (lse, picked) of x @ w
//   K4a fused_ce_bwd -> _dx_kernel    dx = P w^T
//   K4b fused_ce_bwd -> _dw_kernel    dw = x^T P
// with P = (softmax(x @ w) - onehot(labels)) * g / T recomputed from the
// saved per-row lse.  The [T, V] logits never exist in device memory.
//
// Every function is grouped: x [G, T, d], w [G, d, V] (either may have a
// group stride of 0, i.e. be shared by all groups), labels and lse [G, T],
// g [G].  One launch serves all clients of a vmapped client phase.
//
// What bounds them on an H100: operations.  Each of the three does 2*T*d*V
// flops of matrix product (K4a/K4b twice that: the logit recompute and the
// product with P) against (T*d + d*V) * itemsize bytes of inputs and
// outputs; at d = 128 or 1024, T = 4096 and V = 151,936 that is far above
// the 295 flop/byte ridge.  So bf16 inputs (the main path) run every
// product on the tensor cores: mma.sync m16n8k16, bf16 in, fp32
// accumulators, fragments from shared-memory tiles (wgmma/TMA pipelines are
// later work).  fp32 inputs (the tests' and the CPU comparison's) keep
// CUDA-core versions: fp32 FMAs from shared-memory tiles, so fp32 results
// stay fp32-exact up to summation order.  They are a fidelity path, kept
// as simple as possible and not tuned: no bf16 configuration reaches them,
// and rounding fp32 inputs to bf16 would miss the fp32 tolerance.
//
// Design (both versions):
// * K3: a block owns 64 token rows and walks its share of the vocabulary in
//   64-wide tiles, keeping the online max / sum-exp / picked logit of each
//   row in registers (the loop replaces the TPU's sequential vocab grid axis
//   and its scratch).  The server call has G = 1, T = 4096: 64 row blocks
//   would leave half of the 132 SMs idle, so the vocabulary is split across
//   `nsplit` blocks and a second, tiny pass combines the partial
//   (m, l, picked) of each row in a fixed order.
// * K4a: a block owns 16 full rows of dx (16 x d fp32 accumulators in
//   registers, 64 per thread at d = 1024) and walks the whole vocabulary;
//   K4b: a block owns 16 full columns of dw (d x 16 accumulators) and walks
//   all tokens.  Owning the whole d keeps the logit recompute at one pass
//   (splitting d would repeat it d/chunk times), and every output element is
//   summed by one thread in a fixed order: no atomics, the same bits from
//   run to run.  d is at most 1024.
// * Padded vocabulary columns and ragged token rows are masked in-kernel.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;           // threads per block, all kernels
constexpr float NEG = -1e30f;     // finite "minus infinity", as the reference

// The CUDA-core kernels below are instantiated for float only (bf16 inputs
// take the tensor-core kernels further down).
__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }

// ---------------------------------------------------------------------------
// K3: forward, one (group, 64-row tile, vocab split) per block
// ---------------------------------------------------------------------------

constexpr int F_BT = 64, F_BV = 64, F_BK = 32;

// Online (max, sum-exp, picked) update of one row from its logits `lrow` of
// the vocab tile at v0; 4 lanes per row, each scanning every 4th column.
__device__ __forceinline__ void row_stats(const float* lrow, int slane, int v0,
                                          int V, int lab, float& m, float& l,
                                          float& pk) {
  float tmax = NEG;
#pragma unroll
  for (int c = 0; c < F_BV / 4; ++c) {
    const int col = slane + 4 * c;
    if (v0 + col < V) tmax = fmaxf(tmax, lrow[col]);
  }
  tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
  tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
  const float mnew = fmaxf(m, tmax);
  float s = 0.f, pt = 0.f;
#pragma unroll
  for (int c = 0; c < F_BV / 4; ++c) {
    const int col = slane + 4 * c;
    if (v0 + col < V) {
      const float lv = lrow[col];
      s += expf(lv - mnew);
      if (v0 + col == lab) pt += lv;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  pt += __shfl_xor_sync(0xffffffffu, pt, 1);
  pt += __shfl_xor_sync(0xffffffffu, pt, 2);
  l = l * expf(m - mnew) + s;
  m = mnew;
  pk += pt;
}

// The partial (m, l, picked) of row `trow` in vocab split `sp`.
__device__ __forceinline__ void write_part(float* part, float m, float l,
                                           float pk, int G, int Tn, int nsplit,
                                           int g, int sp, int trow,
                                           int slane) {
  if (slane != 0 || trow >= Tn) return;
  const long long plane = (long long)G * nsplit * Tn;
  const long long at = ((long long)g * nsplit + sp) * Tn + trow;
  part[at] = m;
  part[plane + at] = l;
  part[2 * plane + at] = pk;
}

template <typename T>
__global__ void __launch_bounds__(NT)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const int* __restrict__ labels, float* __restrict__ part,
              int G, int Tn, int d, int V, long long xg, long long wg,
              int nsplit, int tiles_per_split) {
  __shared__ float Xs[F_BK][F_BT + 1];      // x tile, k-major
  __shared__ float Ws[F_BK][F_BV];          // w tile
  __shared__ float Ls[F_BT][F_BV + 1];      // logits tile

  const int g = blockIdx.z, sp = blockIdx.y;
  const int r0 = blockIdx.x * F_BT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xb = x + g * xg;
  const T* wb = w + g * wg;

  // row statistics: 4 lanes per row
  const int srow = tid >> 2, slane = tid & 3;
  const int trow = r0 + srow;
  const int lab = trow < Tn ? labels[(long long)g * Tn + trow] : -1;
  float m = NEG, l = 0.f, pk = 0.f;

  const int nv = (V + F_BV - 1) / F_BV;
  const int vt_end = min(nv, (sp + 1) * tiles_per_split);
  for (int vt = sp * tiles_per_split; vt < vt_end; ++vt) {
    const int v0 = vt * F_BV;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += F_BK) {
      for (int e = tid; e < F_BK * F_BT; e += NT) {
        const int r = e / F_BK, k = e % F_BK;
        Xs[k][r] = (r0 + r < Tn && k0 + k < d)
                       ? ld(xb, (long long)(r0 + r) * d + k0 + k) : 0.f;
      }
      for (int e = tid; e < F_BK * F_BV; e += NT) {
        const int k = e / F_BV, c = e % F_BV;
        Ws[k][c] = (k0 + k < d && v0 + c < V)
                       ? ld(wb, (long long)(k0 + k) * V + v0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < F_BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ls[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();

    row_stats(Ls[srow], slane, v0, V, lab, m, l, pk);
    __syncthreads();                        // Ls is rewritten next tile
  }
  write_part(part, m, l, pk, G, Tn, nsplit, g, sp, trow, slane);
}

// Combines the vocab splits of each row, in split order.
__global__ void __launch_bounds__(NT)
ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                  float* __restrict__ picked, int G, int Tn, int nsplit) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)G * Tn) return;
  const long long g = i / Tn, t = i % Tn;
  const long long plane = (long long)G * nsplit * Tn;
  float mx = NEG;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part[(g * nsplit + s) * Tn + t]);
  float l = 0.f, p = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long at = (g * nsplit + s) * Tn + t;
    l += part[plane + at] * expf(part[at] - mx);
    p += part[2 * plane + at];
  }
  lse[i] = mx + logf(l);
  picked[i] = p;
}

// P = (exp(logit - lse) - [v == label]) * scale, 0 off the real rows/cols.
__device__ __forceinline__ float p_of(float logit, float lse_t, int lab,
                                      int v, int V, bool row_ok,
                                      float scale) {
  if (!row_ok || v >= V) return 0.f;
  return (expf(logit - lse_t) - (v == lab ? 1.f : 0.f)) * scale;
}

// ---------------------------------------------------------------------------
// K4a: dx, one (group, 16-row tile) per block, full d in registers
// ---------------------------------------------------------------------------

constexpr int X_BT = 16, X_BV = 64, X_BK = 32, CH = 64;

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gsc, T* __restrict__ dx, int Tn, int d,
             int V, long long xg, long long wg) {
  extern __shared__ float sm[];
  const int dp = d + 1;
  float* Xs = sm;                       // [X_BT][d+1]  the block's x rows
  float* Ws = Xs + X_BT * dp;           // [X_BK][X_BV] w tile (logits)
  float* Ps = Ws + X_BK * X_BV;         // [X_BT][X_BV+1]
  float* Wc = Ps + X_BT * (X_BV + 1);   // [X_BV][CH+1] w chunk, v-major

  const int g = blockIdx.y;
  const int r0 = blockIdx.x * X_BT;
  const int tid = threadIdx.x;
  const T* xb = x + g * xg;
  const T* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;

  for (int e = tid; e < X_BT * d; e += NT) {
    const int r = e / d, k = e % d;
    Xs[r * dp + k] = r0 + r < Tn ? ld(xb, (long long)(r0 + r) * d + k) : 0.f;
  }
  // logits layout: row lr, cols lc + 16 j
  const int lr = tid / 16, lc = tid % 16;
  const bool lrow_ok = r0 + lr < Tn;
  const long long lt = (long long)g * Tn + r0 + lr;
  const int lab = lrow_ok ? labels[lt] : -1;
  const float lse_t = lrow_ok ? lse[lt] : 0.f;
  // accumulator layout: rows ag*4 + i, cols ac + 64 j
  const int ag = tid / 64, ac = tid % 64;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int nv = (V + X_BV - 1) / X_BV;
  for (int vt = 0; vt < nv; ++vt) {
    const int v0 = vt * X_BV;
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d; k0 += X_BK) {
      __syncthreads();
      for (int e = tid; e < X_BK * X_BV; e += NT) {
        const int k = e / X_BV, c = e % X_BV;
        Ws[k * X_BV + c] = (k0 + k < d && v0 + c < V)
                               ? ld(wb, (long long)(k0 + k) * V + v0 + c) : 0.f;
      }
      __syncthreads();
      const int kn = min(X_BK, d - k0);
      for (int k = 0; k < kn; ++k) {
        const float a = Xs[lr * dp + k0 + k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lg[j] = fmaf(a, Ws[k * X_BV + lc + 16 * j], lg[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lc + 16 * j;
      Ps[lr * (X_BV + 1) + c] = p_of(lg[j], lse_t, lab, v0 + c, V, lrow_ok,
                                     scale);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c0 = j * CH;
      if (c0 < d) {
        __syncthreads();                  // Ps written / Wc free
        for (int e = tid; e < CH * X_BV; e += NT) {
          const int c = e / X_BV, v = e % X_BV;
          Wc[v * (CH + 1) + c] = (c0 + c < d && v0 + v < V)
                                     ? ld(wb, (long long)(c0 + c) * V + v0 + v)
                                     : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int v = 0; v < X_BV; ++v) {
          const float wv = Wc[v * (CH + 1) + ac];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(Ps[(ag * 4 + i) * (X_BV + 1) + v], wv, acc[i][j]);
        }
      }
    }
  }
  T* out = dx + (long long)g * Tn * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ag * 4 + i;
    if (r >= Tn) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = ac + CH * j;
      if (c < d) st(out, (long long)r * d + c, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b: dw, one (group, 16-column tile) per block, full d in registers
// ---------------------------------------------------------------------------

constexpr int W_BV = 16, W_BT = 64, W_BK = 32;

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
ce_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gsc, T* __restrict__ dw, int Tn, int d,
             int V, long long xg, long long wg) {
  extern __shared__ float sm[];
  float* Wb = sm;                        // [d][W_BV+1] the block's w columns
  float* Xs = Wb + d * (W_BV + 1);       // [W_BK][W_BT+1] x tile, k-major
  float* Ps = Xs + W_BK * (W_BT + 1);    // [W_BT][W_BV+1]
  float* Xc = Ps + W_BT * (W_BV + 1);    // [W_BT][CH+1] x chunk

  const int g = blockIdx.y;
  const int v0 = blockIdx.x * W_BV;
  const int tid = threadIdx.x;
  const T* xb = x + g * xg;
  const T* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;

  for (int e = tid; e < d * W_BV; e += NT) {
    const int k = e / W_BV, c = e % W_BV;
    Wb[k * (W_BV + 1) + c] =
        v0 + c < V ? ld(wb, (long long)k * V + v0 + c) : 0.f;
  }
  // logits layout: rows lr + 16 i, col lc
  const int lc = tid % 16, lr = tid / 16;
  // accumulator layout: cols (of d) ac + 64 j, vocab columns ag*4 + q
  const int ac = tid % 64, ag = tid / 64;
  float acc[CPT][4];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += W_BT) {
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d; k0 += W_BK) {
      __syncthreads();
      for (int e = tid; e < W_BK * W_BT; e += NT) {
        const int r = e / W_BK, k = e % W_BK;
        Xs[k * (W_BT + 1) + r] = (t0 + r < Tn && k0 + k < d)
                                     ? ld(xb, (long long)(t0 + r) * d + k0 + k)
                                     : 0.f;
      }
      __syncthreads();
      const int kn = min(W_BK, d - k0);
      for (int k = 0; k < kn; ++k) {
        const float b = Wb[(k0 + k) * (W_BV + 1) + lc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          lg[i] = fmaf(Xs[k * (W_BT + 1) + lr + 16 * i], b, lg[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 16 * i, t = t0 + r;
      const bool ok = t < Tn;
      const long long at = (long long)g * Tn + t;
      Ps[r * (W_BV + 1) + lc] =
          p_of(lg[i], ok ? lse[at] : 0.f, ok ? labels[at] : -1, v0 + lc, V,
               ok, scale);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c0 = j * CH;
      if (c0 < d) {
        __syncthreads();                  // Ps written / Xc free
        for (int e = tid; e < W_BT * CH; e += NT) {
          const int r = e / CH, c = e % CH;
          Xc[r * (CH + 1) + c] = (t0 + r < Tn && c0 + c < d)
                                     ? ld(xb, (long long)(t0 + r) * d + c0 + c)
                                     : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < W_BT; ++r) {
          const float xv = Xc[r * (CH + 1) + ac];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][q] = fmaf(xv, Ps[r * (W_BV + 1) + ag * 4 + q], acc[j][q]);
        }
      }
    }
  }
  T* out = dw + (long long)g * d * V;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = ac + CH * j;
    if (c >= d) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + ag * 4 + q;
      if (v < V) st(out, (long long)c * V + v, acc[j][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same three functions on the tensor cores
// ---------------------------------------------------------------------------
// Every product runs as mma.sync m16n8k16 (bf16 in, fp32 accumulators) on
// fragments read from shared memory, 8 warps a block.  The logits are the
// exact products of the bf16 inputs summed in fp32, as on the CUDA cores;
// P enters its products rounded to bf16 (relative error at most 2^-8, the
// same as the bf16 output's own rounding).  Blocking follows the CUDA-core
// versions: K3 a 64-row block walking its vocab split; K4a 16 full dx
// rows, K4b 16 full dw columns, each owner summing its outputs in a fixed
// order.

typedef __nv_bfloat16 bf16;

constexpr int TC_KC = 32;               // d chunk of K3/K4a's streamed w tiles
constexpr int TC_LD = 64 + 8;           // row stride of the 64-wide tiles
constexpr int TCX_BT = 16, TC_CH = 128; // K4a rows; d chunk of the P products
constexpr int TCW_BV = 16, TCW_BT = 64; // K4b vocab columns; token tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 16) at (m0, k0) of a [m][k] tile (k contiguous, row
// stride ld); gq = lane / 4, tq = lane % 4.
__device__ __forceinline__ void frag_a(const bf16* s, int ld, int m0, int k0,
                                       int gq, int tq, uint32_t a[4]) {
  const bf16* p = s + (m0 + gq) * ld + k0 + 2 * tq;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16 x 8) at (k0, n0) of a [n][k] tile (k contiguous).
__device__ __forceinline__ void frag_b_nk(const bf16* s, int ld, int k0,
                                          int n0, int gq, int tq,
                                          uint32_t b[2]) {
  const bf16* p = s + (n0 + gq) * ld + k0 + 2 * tq;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16 x 8) at (k0, n0) of a [k][n] tile (n contiguous, rows
// 16-byte aligned), transposed by ldmatrix.
__device__ __forceinline__ void frag_b_kn(const bf16* s, int ld, int k0,
                                          int n0, int lane, uint32_t b[2]) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(s + (k0 + (lane & 15)) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

__device__ __forceinline__ bf16 ld_or_0(const bf16* p, long long i, bool ok) {
  return ok ? p[i] : __float2bfloat16(0.f);
}

// dst[r][c] = src[r0 + r][c0 + c] (row strides ldd, lds) for r < rows,
// c < cols, 0 outside [0, R) x [0, C); 16-byte vectors where a group of 8
// lies inside and is aligned.  cols is a multiple of 8, dst rows 16-byte
// aligned.  With `transpose`, dst[c][r] instead (vector loads, scalar
// stores).
template <bool transpose>
__device__ __forceinline__ void tile_copy(bf16* dst, int ldd, const bf16* src,
                                          long long lds, int r0, int c0,
                                          int R, int C, int rows, int cols) {
  const int vc = cols / 8;
  for (int e = threadIdx.x; e < rows * vc; e += NT) {
    const int r = e / vc, c = (e % vc) * 8;
    const bool row_ok = r0 + r < R;
    const bf16* sp = src + (long long)(r0 + r) * lds + c0 + c;
    alignas(16) bf16 v[8];
    if (row_ok && c0 + c + 8 <= C &&
        (reinterpret_cast<uintptr_t>(sp) & 15) == 0) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(sp);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = ld_or_0(sp, i, row_ok && c0 + c + i < C);
    }
    if (transpose) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * ldd + r] = v[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ldd + c) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// K3 on the tensor cores.  Warp w computes rows 16 (w % 4) .. +16 and
// columns 32 (w / 4) .. +32 of each 64 x 64 logits tile.
__global__ void __launch_bounds__(NT)
ce_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ labels, float* __restrict__ part,
                 int G, int Tn, int d, int V, long long xg, long long wg,
                 int nsplit, int tiles_per_split) {
  extern __shared__ float smf[];
  const int dp = round_up(d, TC_KC), ldx = dp + 8;
  float* Ls = smf;                                   // [64][65] logits
  bf16* Xs = reinterpret_cast<bf16*>(Ls + F_BT * (F_BV + 1));  // [64][ldx]
  bf16* Ws = Xs + F_BT * ldx;                        // [TC_KC][TC_LD] [c][v]

  const int g = blockIdx.z, sp = blockIdx.y, r0 = blockIdx.x * F_BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp & 3) * 16, nb = (warp >> 2) * 32;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  tile_copy<false>(Xs, ldx, xb, d, r0, 0, Tn, d, F_BT, dp);
  const int srow = tid >> 2, slane = tid & 3, trow = r0 + srow;
  const int lab = trow < Tn ? labels[(long long)g * Tn + trow] : -1;
  float m = NEG, l = 0.f, pk = 0.f;

  const int nv = (V + F_BV - 1) / F_BV;
  const int vt_end = min(nv, (sp + 1) * tiles_per_split);
  for (int vt = sp * tiles_per_split; vt < vt_end; ++vt) {
    const int v0 = vt * F_BV;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < dp; k0 += TC_KC) {
      __syncthreads();                     // Xs loaded / Ws free
      tile_copy<false>(Ws, TC_LD, wb, V, k0, v0, d, V, TC_KC, F_BV);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        uint32_t a[4];
        frag_a(Xs, ldx, mb, k0 + kk, gq, tq, a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          frag_b_kn(Ws, TC_LD, kk, nb + 8 * j, lane, b);
          mma_bf16(acc[j], a, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* top = Ls + (mb + gq) * (F_BV + 1) + nb + 8 * j + 2 * tq;
      top[0] = acc[j][0];
      top[1] = acc[j][1];
      top[8 * (F_BV + 1)] = acc[j][2];
      top[8 * (F_BV + 1) + 1] = acc[j][3];
    }
    __syncthreads();
    row_stats(Ls + srow * (F_BV + 1), slane, v0, V, lab, m, l, pk);
  }
  write_part(part, m, l, pk, G, Tn, nsplit, g, sp, trow, slane);
}

// K4a on the tensor cores: 16 dx rows, d <= 128 * NCH.  Per 64-wide vocab
// tile, warp w computes logits columns 8w .. 8w+8 over all of d, writes its
// P to shared memory, then adds P w^T to its dx columns 128 j + 16 w .. +16
// of every d chunk j.
template <int NCH>
__global__ void __launch_bounds__(NT)
ce_dx_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gsc, bf16* __restrict__ dx, int Tn,
                int d, int V, long long xg, long long wg) {
  extern __shared__ float smf[];
  const int dp = round_up(d, TC_KC), ldx = dp + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smf);     // [16][ldx]
  bf16* Ws = Xs + TCX_BT * ldx;                // [TC_KC][TC_LD]  [c][v]
  bf16* Ps = Ws + TC_KC * TC_LD;               // [16][TC_LD]     [r][v]
  bf16* Wc = Ps + TCX_BT * TC_LD;              // [TC_CH][TC_LD]  [c][v]

  const int g = blockIdx.y, r0 = blockIdx.x * TCX_BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;
  tile_copy<false>(Xs, ldx, xb, d, r0, 0, Tn, d, TCX_BT, dp);
  int lab[2];
  float lse_r[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    ok[h] = r < Tn;
    lab[h] = ok[h] ? labels[(long long)g * Tn + r] : -1;
    lse_r[h] = ok[h] ? lse[(long long)g * Tn + r] : 0.f;
  }
  float acc[NCH][2][4] = {};

  const int nv = (V + F_BV - 1) / F_BV;
  for (int vt = 0; vt < nv; ++vt) {
    const int v0 = vt * F_BV;
    float sl[4] = {};
    for (int k0 = 0; k0 < dp; k0 += TC_KC) {
      __syncthreads();
      tile_copy<false>(Ws, TC_LD, wb, V, k0, v0, d, V, TC_KC, F_BV);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        uint32_t a[4], b[2];
        frag_a(Xs, ldx, 0, k0 + kk, gq, tq, a);
        frag_b_kn(Ws, TC_LD, kk, 8 * warp, lane, b);
        mma_bf16(sl, a, b);
      }
    }
    const int c = 8 * warp + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(Ps + (gq + 8 * h) * TC_LD + c) =
          __floats2bfloat162_rn(
              p_of(sl[2 * h], lse_r[h], lab[h], v0 + c, V, ok[h], scale),
              p_of(sl[2 * h + 1], lse_r[h], lab[h], v0 + c + 1, V, ok[h],
                   scale));
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c0 = j * TC_CH;
      if (c0 < d) {
        __syncthreads();                   // Ps written / Wc free
        tile_copy<false>(Wc, TC_LD, wb, V, c0, v0, d, V, TC_CH, F_BV);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < F_BV; kk += 16) {
          uint32_t a[4];
          frag_a(Ps, TC_LD, 0, kk, gq, tq, a);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t b[2];
            frag_b_nk(Wc, TC_LD, kk, 16 * warp + 8 * nt, gq, tq, b);
            mma_bf16(acc[j][nt], a, b);
          }
        }
      }
    }
  }
  bf16* out = dx + (long long)g * Tn * d;
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int cc = j * TC_CH + 16 * warp + 8 * nt + 2 * tq + i;
          if (ok[h] && cc < d)
            out[(long long)(r0 + gq + 8 * h) * d + cc] =
                __float2bfloat16(acc[j][nt][2 * h + i]);
        }
}

// K4b on the tensor cores: 16 dw columns, d <= 128 * NCH.  Per 64-token
// tile, warp w computes logits rows 16 (w % 4) .. +16, columns 8 (w / 4)
// .. +8 over all of d, writes P^T to shared memory, then adds x^T P to its
// dw rows 128 j + 16 w .. +16 of every d chunk j.
template <int NCH>
__global__ void __launch_bounds__(NT)
ce_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gsc, bf16* __restrict__ dw, int Tn,
                int d, int V, long long xg, long long wg) {
  extern __shared__ float smf[];
  const int dp = round_up(d, 64), ldw = dp + 8;
  bf16* Wt = reinterpret_cast<bf16*>(smf);     // [16][ldw]       [v][c]
  bf16* Xs = Wt + TCW_BV * ldw;                // [64][TC_LD]     [t][c]
  bf16* Pt = Xs + TCW_BT * TC_LD;              // [16][TC_LD]     [v][t]
  bf16* Xc = Pt + TCW_BV * TC_LD;              // [TC_CH][TC_LD]  [c][t]

  const int g = blockIdx.y, v0 = blockIdx.x * TCW_BV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp & 3) * 16, nb = (warp >> 2) * 8;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;
  tile_copy<true>(Wt, ldw, wb, V, 0, v0, d, V, dp, TCW_BV);
  float acc[NCH][2][4] = {};

  for (int t0 = 0; t0 < Tn; t0 += TCW_BT) {
    float sl[4] = {};
    for (int k0 = 0; k0 < dp; k0 += 64) {
      __syncthreads();                     // Wt loaded / Xs free
      tile_copy<false>(Xs, TC_LD, xb, d, t0, k0, Tn, d, TCW_BT, 64);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        uint32_t a[4], b[2];
        frag_a(Xs, TC_LD, mb, kk, gq, tq, a);
        frag_b_nk(Wt, ldw, k0 + kk, nb, gq, tq, b);
        mma_bf16(sl, a, b);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mb + gq + 8 * h, t = t0 + r;
      const bool ok = t < Tn;
      const long long at = (long long)g * Tn + t;
      const float lse_t = ok ? lse[at] : 0.f;
      const int lab = ok ? labels[at] : -1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = nb + 2 * tq + i;
        Pt[v * TC_LD + r] = __float2bfloat16(
            p_of(sl[2 * h + i], lse_t, lab, v0 + v, V, ok, scale));
      }
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c0 = j * TC_CH;
      if (c0 < d) {
        __syncthreads();                   // Pt written / Xc free
        tile_copy<true>(Xc, TC_LD, xb, d, t0, c0, Tn, d, TCW_BT, TC_CH);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TCW_BT; kk += 16) {
          uint32_t a[4];
          frag_a(Xc, TC_LD, 16 * warp, kk, gq, tq, a);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t b[2];
            frag_b_nk(Pt, TC_LD, kk, 8 * nt, gq, tq, b);
            mma_bf16(acc[j][nt], a, b);
          }
        }
      }
    }
  }
  bf16* out = dw + (long long)g * d * V;
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = j * TC_CH + 16 * warp + gq + 8 * h;
          const int v = v0 + 8 * nt + 2 * tq + i;
          if (c < d && v < V)
            out[(long long)c * V + v] = __float2bfloat16(acc[j][nt][2 * h + i]);
        }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

size_t dx_smem(int d) {
  return sizeof(float) * ((size_t)X_BT * (d + 1) + X_BK * X_BV +
                          X_BT * (X_BV + 1) + X_BV * (CH + 1));
}

size_t dw_smem(int d) {
  return sizeof(float) * ((size_t)d * (W_BV + 1) + W_BK * (W_BT + 1) +
                          W_BT * (W_BV + 1) + W_BT * (CH + 1));
}

size_t fwd_tc_smem(int d) {
  return sizeof(float) * F_BT * (F_BV + 1) +
         sizeof(bf16) * (F_BT * (round_up(d, TC_KC) + 8) + TC_KC * TC_LD);
}

size_t dx_tc_smem(int d) {
  return sizeof(bf16) * (TCX_BT * (round_up(d, TC_KC) + 8) +
                         (TC_KC + TCX_BT + TC_CH) * TC_LD);
}

size_t dw_tc_smem(int d) {
  return sizeof(bf16) * (TCW_BV * (round_up(d, 64) + 8) +
                         (TCW_BT + TCW_BV + TC_CH) * TC_LD);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int* labels,
                       float* part, float* lse, float* picked, int G, int Tn,
                       int d, int V, long long xg, long long wg, int nsplit,
                       int tps, cudaStream_t st) {
  dim3 grid((Tn + F_BT - 1) / F_BT, nsplit, G);
  if constexpr (std::is_same<T, bf16>::value) {
    // once, before any graph capture, for the largest d taken
    static const cudaError_t attr = cudaFuncSetAttribute(
        ce_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fwd_tc_smem(16 * CH));
    if (attr != cudaSuccess) return attr;
    ce_fwd_tc_kernel<<<grid, NT, fwd_tc_smem(d), st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), labels,
        part, G, Tn, d, V, xg, wg, nsplit, tps);
  } else {
    ce_fwd_kernel<T><<<grid, NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), labels, part, G,
        Tn, d, V, xg, wg, nsplit, tps);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)G * Tn;
  ce_combine_kernel<<<(unsigned)((rows + NT - 1) / NT), NT, 0, st>>>(
      part, lse, picked, G, Tn, nsplit);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_tc(bool dx_not_dw, const void* x, const void* w,
                      const int* labels, const float* lse, const float* gsc,
                      void* out, int G, int Tn, int d, int V, long long xg,
                      long long wg, cudaStream_t st) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (dx_not_dw) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        ce_dx_tc_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dx_tc_smem(NCH * TC_CH));
    if (attr != cudaSuccess) return attr;
    dim3 grid((Tn + TCX_BT - 1) / TCX_BT, G);
    ce_dx_tc_kernel<NCH><<<grid, NT, dx_tc_smem(d), st>>>(
        xb, wb, labels, lse, gsc, ob, Tn, d, V, xg, wg);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        ce_dw_tc_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dw_tc_smem(NCH * TC_CH));
    if (attr != cudaSuccess) return attr;
    dim3 grid((V + TCW_BV - 1) / TCW_BV, G);
    ce_dw_tc_kernel<NCH><<<grid, NT, dw_tc_smem(d), st>>>(
        xb, wb, labels, lse, gsc, ob, Tn, d, V, xg, wg);
  }
  return cudaGetLastError();
}

// The dynamic shared memory limit is raised once per instance, before any
// graph capture, to what the largest d of its CPT needs.
template <typename T, int CPT>
cudaError_t launch_dx(const void* x, const void* w, const int* labels,
                      const float* lse, const float* gsc, void* out, int G,
                      int Tn, int d, int V, long long xg, long long wg,
                      cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_dx_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dx_smem(CPT * CH));
  if (attr != cudaSuccess) return attr;
  dim3 grid((Tn + X_BT - 1) / X_BT, G);
  ce_dx_kernel<T, CPT><<<grid, NT, dx_smem(d), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, gsc,
      static_cast<T*>(out), Tn, d, V, xg, wg);
  return cudaGetLastError();
}

template <typename T, int CPT>
cudaError_t launch_dw(const void* x, const void* w, const int* labels,
                      const float* lse, const float* gsc, void* out, int G,
                      int Tn, int d, int V, long long xg, long long wg,
                      cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_dw_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dw_smem(CPT * CH));
  if (attr != cudaSuccess) return attr;
  dim3 grid((V + W_BV - 1) / W_BV, G);
  ce_dw_kernel<T, CPT><<<grid, NT, dw_smem(d), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, gsc,
      static_cast<T*>(out), Tn, d, V, xg, wg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(bool dx_not_dw, const void* x, const void* w,
                       const int* labels, const float* lse, const float* gsc,
                       void* out, int G, int Tn, int d, int V, long long xg,
                       long long wg, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int nch = (d + TC_CH - 1) / TC_CH;
#define CE_CASE(N)                                                           \
    if (nch <= N)                                                            \
      return launch_tc<N>(dx_not_dw, x, w, labels, lse, gsc, out, G, Tn, d, \
                          V, xg, wg, st);
    CE_CASE(1) CE_CASE(2) CE_CASE(4) CE_CASE(8)
#undef CE_CASE
  } else {
    const int cpt = (d + CH - 1) / CH;
#define CE_CASE(N)                                                          \
    if (cpt <= N)                                                           \
      return dx_not_dw ? launch_dx<T, N>(x, w, labels, lse, gsc, out, G,    \
                                         Tn, d, V, xg, wg, st)              \
                       : launch_dw<T, N>(x, w, labels, lse, gsc, out, G,    \
                                         Tn, d, V, xg, wg, st);
    CE_CASE(1) CE_CASE(2) CE_CASE(4) CE_CASE(8) CE_CASE(16)
#undef CE_CASE
  }
  return cudaErrorInvalidValue;                   // d > 16 * CH
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  part: scratch fp32 [3, G, nsplit, T].
extern "C" int fused_ce_fwd(const void* x, const void* w, const int* labels,
                            float* part, float* lse, float* picked, int G,
                            int Tn, int d, int V, long long xg, long long wg,
                            int nsplit, int tiles_per_split, int dtype,
                            void* stream) {
  if (d > 16 * CH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_fwd<bf16>(x, w, labels, part, lse, picked, G, Tn,
                                      d, V, xg, wg, nsplit, tiles_per_split,
                                      st)
                   : launch_fwd<float>(x, w, labels, part, lse, picked, G, Tn,
                                       d, V, xg, wg, nsplit, tiles_per_split,
                                       st));
}

extern "C" int fused_ce_dx(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dx, int G,
                           int Tn, int d, int V, long long xg, long long wg,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_bwd<bf16>(true, x, w, labels, lse, g, dx,
                                               G, Tn, d, V, xg, wg, st)
                   : launch_bwd<float>(true, x, w, labels, lse, g, dx, G, Tn,
                                       d, V, xg, wg, st));
}

extern "C" int fused_ce_dw(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dw, int G,
                           int Tn, int d, int V, long long xg, long long wg,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_bwd<bf16>(false, x, w, labels, lse, g,
                                               dw, G, Tn, d, V, xg, wg, st)
                   : launch_bwd<float>(false, x, w, labels, lse, g, dw, G, Tn,
                                       d, V, xg, wg, st));
}
