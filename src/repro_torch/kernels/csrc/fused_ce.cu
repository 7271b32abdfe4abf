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
// * K4a: a block owns 16 rows of dx over one slice of at most DSW = 1024
//   of the d columns (16 x 1024 fp32 accumulators in registers, 64 per
//   thread) and walks the whole vocabulary; K4b: a block owns 16 columns of
//   dw over one d slice and walks all tokens.  Each output element is
//   summed by one thread in a fixed order: no atomics, the same bits from
//   run to run.  Every block recomputes its logit tiles over the full d, so
//   for d > DSW the logits are recomputed ceil(d / DSW) times (4x at the
//   server head's d = 4096): the price of owning outputs without atomics
//   or a staged P in device memory.
// * Every kernel streams x and w through shared memory in chunks of d, as
//   a GEMM main loop does, so any d runs and every tile fits the 48 KB of
//   static shared memory.
// * Padded vocabulary columns, ragged token rows and the ragged end of d
//   are masked in-kernel.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;           // threads per block, all kernels
constexpr int DSW = 1024;         // d columns a K4a/K4b block owns
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
// K4a: dx, one (group, 16-row tile, d slice) per block
// ---------------------------------------------------------------------------

constexpr int X_BT = 16, X_BV = 64, X_BK = 32, CH = 64;

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gsc, T* __restrict__ dx, int Tn, int d,
             int V, long long xg, long long wg) {
  __shared__ float Xs[X_BT][X_BK + 1];  // x chunk (logits)
  __shared__ float Ws[X_BK * X_BV];     // [X_BK][X_BV] w tile (logits)
  __shared__ float Ps[X_BT * (X_BV + 1)];
  __shared__ float Wc[X_BV * (CH + 1)]; // [X_BV][CH+1] w chunk, v-major

  const int g = blockIdx.y;
  const int r0 = blockIdx.x * X_BT, cb = blockIdx.z * DSW;
  const int tid = threadIdx.x;
  const T* xb = x + g * xg;
  const T* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;

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
      for (int e = tid; e < X_BT * X_BK; e += NT) {
        const int r = e / X_BK, k = e % X_BK;
        Xs[r][k] = (r0 + r < Tn && k0 + k < d)
                       ? ld(xb, (long long)(r0 + r) * d + k0 + k) : 0.f;
      }
      __syncthreads();
      const int kn = min(X_BK, d - k0);
      for (int k = 0; k < kn; ++k) {
        const float a = Xs[lr][k];
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
      const int c0 = cb + j * CH;
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
      const int c = cb + ac + CH * j;
      if (c < d) st(out, (long long)r * d + c, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b: dw, one (group, 16-column tile, d slice) per block
// ---------------------------------------------------------------------------

constexpr int W_BV = 16, W_BT = 64, W_BK = 32;

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
ce_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gsc, T* __restrict__ dw, int Tn, int d,
             int V, long long xg, long long wg) {
  __shared__ float Wb[W_BK][W_BV + 1];       // w chunk (logits)
  __shared__ float Xs[W_BK * (W_BT + 1)];    // [W_BK][W_BT+1] x tile, k-major
  __shared__ float Ps[W_BT * (W_BV + 1)];
  __shared__ float Xc[W_BT * (CH + 1)];      // [W_BT][CH+1] x chunk

  const int g = blockIdx.y;
  const int v0 = blockIdx.x * W_BV, cb = blockIdx.z * DSW;
  const int tid = threadIdx.x;
  const T* xb = x + g * xg;
  const T* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;

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
      for (int e = tid; e < W_BK * W_BV; e += NT) {
        const int k = e / W_BV, c = e % W_BV;
        Wb[k][c] = (k0 + k < d && v0 + c < V)
                       ? ld(wb, (long long)(k0 + k) * V + v0 + c) : 0.f;
      }
      __syncthreads();
      const int kn = min(W_BK, d - k0);
      for (int k = 0; k < kn; ++k) {
        const float b = Wb[k][lc];
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
      const int c0 = cb + j * CH;
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
    const int c = cb + ac + CH * j;
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
// versions: K3 a 64-row block walking its vocab split; K4a 16 dx rows, K4b
// 16 dw columns, each over one d slice, each owner summing its outputs in
// a fixed order.  x and w stream through shared memory in 64-deep chunks
// of d.

typedef __nv_bfloat16 bf16;

constexpr int TC_KC = 64;               // d chunk of the streamed logit tiles
constexpr int TC_LD = 64 + 8;           // row stride of the 64-wide tiles
constexpr int TCX_BT = 16, TC_CH = 128; // K4a rows; d chunk of the P products
constexpr int TCW_BV = 16, TCW_BT = 64; // K4b vocab columns; token tile
static_assert(TCX_BT == X_BT && TCW_BV == W_BV,
              "the two versions of K4a/K4b share their grids");

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

// K3 on the tensor cores.  Warp w computes rows 16 (w % 4) .. +16 and
// columns 32 (w / 4) .. +32 of each 64 x 64 logits tile.
__global__ void __launch_bounds__(NT)
ce_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ labels, float* __restrict__ part,
                 int G, int Tn, int d, int V, long long xg, long long wg,
                 int nsplit, int tiles_per_split) {
  __shared__ float Ls[F_BT * (F_BV + 1)];            // [64][65] logits
  __shared__ __align__(16) bf16 Xs[F_BT * TC_LD];    // [64][TC_LD]  [t][c]
  __shared__ __align__(16) bf16 Ws[TC_KC * TC_LD];   // [TC_KC][TC_LD] [c][v]

  const int g = blockIdx.z, sp = blockIdx.y, r0 = blockIdx.x * F_BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp & 3) * 16, nb = (warp >> 2) * 32;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  const int srow = tid >> 2, slane = tid & 3, trow = r0 + srow;
  const int lab = trow < Tn ? labels[(long long)g * Tn + trow] : -1;
  float m = NEG, l = 0.f, pk = 0.f;

  const int nv = (V + F_BV - 1) / F_BV;
  const int vt_end = min(nv, (sp + 1) * tiles_per_split);
  for (int vt = sp * tiles_per_split; vt < vt_end; ++vt) {
    const int v0 = vt * F_BV;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += TC_KC) {
      __syncthreads();                     // previous chunk consumed
      tile_copy<false>(Xs, TC_LD, xb, d, r0, k0, Tn, d, F_BT, TC_KC);
      tile_copy<false>(Ws, TC_LD, wb, V, k0, v0, d, V, TC_KC, F_BV);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        uint32_t a[4];
        frag_a(Xs, TC_LD, mb, kk, gq, tq, a);
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

// K4a on the tensor cores: 16 dx rows over the d slice cb .. cb + 128 NCH.
// Per 64-wide vocab tile, warp w computes logits columns 8w .. 8w+8 over
// all of d, writes its P to shared memory, then adds P w^T to its dx
// columns cb + 128 j + 16 w .. +16 of every d chunk j of the slice.
template <int NCH>
__global__ void __launch_bounds__(NT)
ce_dx_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gsc, bf16* __restrict__ dx, int Tn,
                int d, int V, long long xg, long long wg) {
  __shared__ __align__(16) bf16 Xs[TCX_BT * TC_LD];  // [16][TC_LD]     [r][c]
  __shared__ __align__(16) bf16 Ws[TC_KC * TC_LD];   // [TC_KC][TC_LD]  [c][v]
  __shared__ __align__(16) bf16 Ps[TCX_BT * TC_LD];  // [16][TC_LD]     [r][v]
  __shared__ __align__(16) bf16 Wc[TC_CH * TC_LD];   // [TC_CH][TC_LD]  [c][v]

  const int g = blockIdx.y, r0 = blockIdx.x * TCX_BT, cb = blockIdx.z * DSW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;
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
    for (int k0 = 0; k0 < d; k0 += TC_KC) {
      __syncthreads();                     // previous chunk / Ps consumed
      tile_copy<false>(Xs, TC_LD, xb, d, r0, k0, Tn, d, TCX_BT, TC_KC);
      tile_copy<false>(Ws, TC_LD, wb, V, k0, v0, d, V, TC_KC, F_BV);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        uint32_t a[4], b[2];
        frag_a(Xs, TC_LD, 0, kk, gq, tq, a);
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
      const int c0 = cb + j * TC_CH;
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
          const int cc = cb + j * TC_CH + 16 * warp + 8 * nt + 2 * tq + i;
          if (ok[h] && cc < d)
            out[(long long)(r0 + gq + 8 * h) * d + cc] =
                __float2bfloat16(acc[j][nt][2 * h + i]);
        }
}

// K4b on the tensor cores: 16 dw columns over the d slice cb .. cb + 128
// NCH.  Per 64-token tile, warp w computes logits rows 16 (w % 4) .. +16,
// columns 8 (w / 4) .. +8 over all of d, writes P^T to shared memory, then
// adds x^T P to its dw rows cb + 128 j + 16 w .. +16 of every d chunk j of
// the slice.
template <int NCH>
__global__ void __launch_bounds__(NT)
ce_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gsc, bf16* __restrict__ dw, int Tn,
                int d, int V, long long xg, long long wg) {
  __shared__ __align__(16) bf16 Xs[TCW_BT * TC_LD];  // [64][TC_LD]     [t][c]
  __shared__ __align__(16) bf16 Wt[TCW_BV * TC_LD];  // [16][TC_LD]     [v][c]
  __shared__ __align__(16) bf16 Pt[TCW_BV * TC_LD];  // [16][TC_LD]     [v][t]
  __shared__ __align__(16) bf16 Xc[TC_CH * TC_LD];   // [TC_CH][TC_LD]  [c][t]

  const int g = blockIdx.y, v0 = blockIdx.x * TCW_BV, cb = blockIdx.z * DSW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp & 3) * 16, nb = (warp >> 2) * 8;
  const bf16* xb = x + g * xg;
  const bf16* wb = w + g * wg;
  const float scale = gsc[g] / (float)Tn;
  float acc[NCH][2][4] = {};

  for (int t0 = 0; t0 < Tn; t0 += TCW_BT) {
    float sl[4] = {};
    for (int k0 = 0; k0 < d; k0 += TC_KC) {
      __syncthreads();                     // previous chunk / Pt consumed
      tile_copy<false>(Xs, TC_LD, xb, d, t0, k0, Tn, d, TCW_BT, TC_KC);
      tile_copy<true>(Wt, TC_LD, wb, V, k0, v0, d, V, TC_KC, TCW_BV);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        uint32_t a[4], b[2];
        frag_a(Xs, TC_LD, mb, kk, gq, tq, a);
        frag_b_nk(Wt, TC_LD, kk, nb, gq, tq, b);
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
      const int c0 = cb + j * TC_CH;
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
          const int c = cb + j * TC_CH + 16 * warp + gq + 8 * h;
          const int v = v0 + 8 * nt + 2 * tq + i;
          if (c < d && v < V)
            out[(long long)c * V + v] = __float2bfloat16(acc[j][nt][2 * h + i]);
        }
}

// ---------------------------------------------------------------------------
// Launchers (every kernel's shared memory is static, under 48 KB)
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int* labels,
                       float* part, float* lse, float* picked, int G, int Tn,
                       int d, int V, long long xg, long long wg, int nsplit,
                       int tps, cudaStream_t st) {
  dim3 grid((Tn + F_BT - 1) / F_BT, nsplit, G);
  if constexpr (std::is_same<T, bf16>::value) {
    ce_fwd_tc_kernel<<<grid, NT, 0, st>>>(
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

// One backward kernel; N is the instance's number of d chunks per slice
// (TC_CH wide on the tensor cores, CH on the CUDA cores).
template <typename T, int N>
cudaError_t launch_one(bool dx_not_dw, const void* x, const void* w,
                       const int* labels, const float* lse, const float* gsc,
                       void* out, int G, int Tn, int d, int V, long long xg,
                       long long wg, int nds, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (dx_not_dw) {
    dim3 grid((Tn + X_BT - 1) / X_BT, G, nds);
    if constexpr (std::is_same<T, bf16>::value)
      ce_dx_tc_kernel<N><<<grid, NT, 0, st>>>(xt, wt, labels, lse, gsc, ot,
                                              Tn, d, V, xg, wg);
    else
      ce_dx_kernel<T, N><<<grid, NT, 0, st>>>(xt, wt, labels, lse, gsc, ot,
                                              Tn, d, V, xg, wg);
  } else {
    dim3 grid((V + W_BV - 1) / W_BV, G, nds);
    if constexpr (std::is_same<T, bf16>::value)
      ce_dw_tc_kernel<N><<<grid, NT, 0, st>>>(xt, wt, labels, lse, gsc, ot,
                                              Tn, d, V, xg, wg);
    else
      ce_dw_kernel<T, N><<<grid, NT, 0, st>>>(xt, wt, labels, lse, gsc, ot,
                                              Tn, d, V, xg, wg);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(bool dx_not_dw, const void* x, const void* w,
                       const int* labels, const float* lse, const float* gsc,
                       void* out, int G, int Tn, int d, int V, long long xg,
                       long long wg, int nds, cudaStream_t st) {
  if (nds != (d + DSW - 1) / DSW) return cudaErrorInvalidValue;
  const int width = d < DSW ? d : DSW;        // columns of the widest slice
  const int nch = std::is_same<T, bf16>::value
                      ? (width + TC_CH - 1) / TC_CH : (width + CH - 1) / CH;
#define CE_CASE(N)                                                            \
  if (nch <= N)                                                               \
    return launch_one<T, N>(dx_not_dw, x, w, labels, lse, gsc, out, G, Tn, d, \
                            V, xg, wg, nds, st);
  CE_CASE(1) CE_CASE(2) CE_CASE(4) CE_CASE(8)
  if constexpr (!std::is_same<T, bf16>::value) { CE_CASE(16) }
#undef CE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  part: scratch fp32 [3, G, nsplit, T].
extern "C" int fused_ce_fwd(const void* x, const void* w, const int* labels,
                            float* part, float* lse, float* picked, int G,
                            int Tn, int d, int V, long long xg, long long wg,
                            int nsplit, int tiles_per_split, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_fwd<bf16>(x, w, labels, part, lse, picked, G, Tn,
                                      d, V, xg, wg, nsplit, tiles_per_split,
                                      st)
                   : launch_fwd<float>(x, w, labels, part, lse, picked, G, Tn,
                                       d, V, xg, wg, nsplit, tiles_per_split,
                                       st));
}

// nds: the number of d slices, ceil(d / 1024) (fused_ce.launch_plan).
extern "C" int fused_ce_dx(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dx, int G,
                           int Tn, int d, int V, long long xg, long long wg,
                           int nds, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_bwd<bf16>(true, x, w, labels, lse, g, dx, G, Tn,
                                      d, V, xg, wg, nds, st)
                   : launch_bwd<float>(true, x, w, labels, lse, g, dx, G, Tn,
                                       d, V, xg, wg, nds, st));
}

extern "C" int fused_ce_dw(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dw, int G,
                           int Tn, int d, int V, long long xg, long long wg,
                           int nds, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_bwd<bf16>(false, x, w, labels, lse, g, dw, G, Tn,
                                      d, V, xg, wg, nds, st)
                   : launch_bwd<float>(false, x, w, labels, lse, g, dw, G, Tn,
                                       d, V, xg, wg, nds, st));
}
