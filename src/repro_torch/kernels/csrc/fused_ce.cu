// Fused linear + cross-entropy for the LM heads, forward and backward.
//
// Replaces the JAX package's Pallas kernels in src/repro/kernels/fused_ce.py:
//   K3  fused_ce_fwd -> _fwd_kernel   (:87)   per-row (lse, picked) of x @ w
//   K4a fused_ce_bwd -> _dx_kernel    (:186)  dx = P w^T
//   K4b fused_ce_bwd -> _dw_kernel    (:201)  dw = x^T P
// with P = (softmax(x @ w) - onehot(labels)) * g / T recomputed from the
// saved per-row lse.  The [T, V] logits never exist whole in device memory.
//
// Every function is grouped: x [G, T, d], w [G, d, V] (either may have a
// group stride of 0, i.e. be shared by all groups), labels and lse [G, T],
// g [G].  One launch serves all clients of a vmapped client phase.
//
// What bounds them on an H100: tensor-core operations at the server heads
// (each product is 2 T d V flops against (T d + d V) * 2 bytes, far above
// the 295 flop/byte ridge); at the d = 128 aux heads the products are
// short, and the forward's exps (T V of them on the special-function units)
// and the backward's bytes of P weigh as much as the products.
//
// bf16, the main path: every logit product runs in one TMA + wgmma GEMM
// main loop (ce_gemm_kernel): a 128 x 128 output tile at a time, 3
// warpgroups (one TMA producer, two wgmma consumers of 64 rows each), a
// 4-stage ring of 64-deep bf16 tiles in dynamic shared memory fed by TMA
// (128-byte swizzle, zero fill out of bounds) and mbarriers, wgmma
// m64n128k16 with fp32 accumulators in registers; wgmma's transpose bits
// read x^T and w^T (MN-major tiles) straight from shared memory.  Four
// epilogues share it:
//   K3 (CE_F): a block owns 128 token rows and one split of the
//      vocabulary, and walks the split's 128-column tiles in order; the
//      producer streams the (tile, k step) pairs of the whole split through
//      the ring, so the next tile's loads overlap this tile's epilogue.
//      After each tile the epilogue masks the columns past V and updates
//      each row's running max, sum of exps and picked logit in registers
//      (the loop replaces the TPU's sequential vocab grid axis and its
//      scratch); at the end of the split it writes the row's (m, l, picked)
//      partial, and a second pass combines the splits of each row in split
//      order.  The splits (fused_ce.launch_plan) fill 132 SMs at one
//      160 KB block an SM.
//   The backward, for each vocabulary chunk c of width Vc (the P scratch
//   G T Vc bf16 stays <= 256 MiB, fused_ce.bwd_plan), in order:
//   1. P pass (CE_P): logits x @ w[:, c] over all of d, once; the epilogue
//      writes P_c = (exp(l - lse) - onehot) g / T in bf16 to the scratch
//      (0 past V);
//   2. dx (CE_DX): dx_acc += P_c w[:, c]^T, one block per (row tile, d
//      tile), summed over Vc inside the block; chunk partials added in
//      chunk order in fp32 device memory, the last chunk writes dx in bf16;
//   3. dw (CE_DW): dw[:, :, c] = x^T P_c, one block per (d tile, vocab
//      tile), summed over all T inside the block, written once in bf16.
//   fused_ce_bwd shares one P pass between dx and dw.  Each logit is
//   computed once a call.  P enters its products rounded to bf16.
// Every output element has one owner and a fixed summation order: no
// atomics, the same bits from run to run.
//
// fp32 inputs (the tests' and the CPU comparison's fidelity path, reached
// by no bf16 configuration) keep CUDA-core versions of all three, kept as
// they were and not tuned: a K3 block owns 64 token rows and walks its
// split in 64-wide tiles; a K4a block owns 16 dx rows, a K4b block 16 dw
// columns, each over one slice of at most 1024 columns of d, recomputing
// its logits per slice.
//
// Plain C interface (ctypes); each launcher returns a cudaError_t.  The
// Hopper building blocks (mbarriers, TMA, wgmma, tensor maps) are in
// hopper.cuh.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;           // threads per block, all kernels
constexpr int DSW = 1024;         // d columns an fp32 K4a/K4b block owns
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
// fp32 K4a: dx, one (group, 16-row tile, d slice) per block
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
// fp32 K4b: dw, one (group, 16-column tile, d slice) per block
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
// bf16 on Hopper: one TMA + wgmma GEMM main loop, four epilogues
// ---------------------------------------------------------------------------
// A block computes 128 x 128 tiles C[m0 + i][n0 + j] = sum_k A[m][k]
// B[k][n]: one tile, or for K3 every vocabulary tile of its split in turn.
// Warpgroup 0 is the producer: one thread keeps G_ST stages of 64-deep A
// and B tiles in flight with TMA (each tile two 64 x 64 boxes, 128-byte
// rows, 128-byte swizzle), across tile boundaries.  Warpgroups 1 and 2 each
// own 64 rows of C and issue wgmma m64n128k16 on the stage that has
// arrived; a stage goes back to the producer once the wgmma group after it
// has been issued and the one reading it has completed (after a tile's last
// group, once it has completed).
//
// The four modes, with their operands as stored in device memory:
//   CE_F  C[t][v]    = x[t][:]  . w[:][v]       A = x K-major,  B = w MN-major
//   CE_P  C[t][v]    = x[t][:]  . w[:][c0+v]    A = x K-major,  B = w MN-major
//   CE_DX C[t][dc]   = P[t][:]  . w[dc][c0+:]   A = P K-major,  B = w K-major
//   CE_DW C[dc][v]   = x[:][dc] . P[:][v]       A = x MN-major, B = P MN-major
// (K-major: the k index is contiguous; MN-major: m or n is, and wgmma's
// transpose bit reads the tile as it lies.)  Out-of-bounds rows and columns
// of every tile arrive as zeros, so ragged T, d and V need no masks in the
// main loop.

enum { CE_P = 0, CE_DX = 1, CE_DW = 2, CE_F = 3 };

constexpr int G_BM = 128, G_BN = 128, G_BK = 64, G_ST = 4;
constexpr int G_THREADS = 384;               // 3 warpgroups
constexpr int G_BOX = 64 * 64;               // elements of one TMA box
constexpr uint32_t G_STAGE_BYTES = 4 * G_BOX * 2;   // A and B, two boxes each
constexpr int G_SMEM = G_ST * G_STAGE_BYTES + 1024 + 2 * G_ST * 8;

struct GemmArgs {
  const int* labels;
  const float* lse;
  const float* gsc;
  bf16* p;            // P scratch [G, T, ldp] (written by CE_P)
  float* acc;         // dx partial sums [G, T, d] fp32 (CE_DX)
  bf16* out;          // dx [G, T, d] (CE_DX) or dw [G, d, V] (CE_DW)
  float* part;        // K3 partials [3, G, nsplit, T] (CE_F)
  int Tn, d, V, ldp;
  int c0, cw;         // the chunk: vocabulary columns c0 .. c0 + cw
  int first, last;    // CE_DX: the first / last chunk
  int x_groups, w_groups;   // 0: one copy shared by all groups
  int nk;             // 64-deep k steps
  int nsplit, tps;    // CE_F: vocabulary splits, 128-column tiles a split
};

// K3's epilogue of one vocabulary tile at column n0, for this thread's
// rows r (h = 0) and r + 8 (h = 1): columns past V masked out, then each
// row's running max m (the same on the 4 lanes of the row's quad), this
// lane's share of the sum of exps l (ex2.approx on the special-function
// units), and the picked logit pk, which the lane holding column
// labels[row] adds.
__device__ __forceinline__ void fwd_tile(float (&d)[64], int n0, int V,
                                         int lane, const int (&lab)[2],
                                         float (&m)[2], float (&l)[2],
                                         float (&pk)[2]) {
  const int cl = n0 + 2 * (lane % 4);
  if (n0 + G_BN > V) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cl + 8 * j + (q & 1) >= V) d[4 * j + q] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mb = mx * LOG2E;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        s += ex2(fmaf(d[4 * j + 2 * h + i], LOG2E, -mb));
    l[h] = l[h] * ex2((m[h] - mx) * LOG2E) + s;
    m[h] = mx;
    if ((unsigned)(lab[h] - n0) < (unsigned)G_BN) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (cl + 8 * j + i == lab[h]) pk[h] += d[4 * j + 2 * h + i];
    }
  }
}

// Grid: (M tiles, N tiles or, for CE_F, vocabulary splits, G).  Map a is
// A's tensor and b B's: for CE_F and CE_P x and w, for CE_DX P and w, for
// CE_DW x and P.
template <int MODE>
__global__ void __launch_bounds__(G_THREADS, 1)
ce_gemm_kernel(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb, const GemmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_ST * G_STAGE_BYTES);
  uint64_t* empty = full + G_ST;

  const int m0 = blockIdx.x * G_BM, g = blockIdx.z;
  const int gx = a.x_groups ? g : 0, gw = a.w_groups ? g : 0;
  const int wg = threadIdx.x / 128;
  // The block's output tiles: tile = 0 .. ntiles - 1 at columns
  // (vt0 + tile) G_BN
  const int vt0 = MODE == CE_F ? blockIdx.y * a.tps : blockIdx.y;
  const int ntiles =
      MODE == CE_F ? min(a.tps, (a.V + G_BN - 1) / G_BN - vt0) : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);               // the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    if (threadIdx.x == 0) {
      int it = 0;                            // loads issued
      for (int tile = 0; tile < ntiles; ++tile) {
        const int n0 = (vt0 + tile) * G_BN;
        for (int kt = 0; kt < a.nk; ++kt, ++it) {
          const int s = it % G_ST, k0 = kt * G_BK;
          if (it >= G_ST) mbar_wait(&empty[s], ((it / G_ST) - 1) & 1);
          bf16* sa = reinterpret_cast<bf16*>(smem + s * G_STAGE_BYTES);
          bf16* sb = sa + 2 * G_BOX;
          mbar_expect_tx(&full[s], G_STAGE_BYTES);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (MODE == CE_P || MODE == CE_F) {
              tma_box(sa + h * G_BOX, &ma, &full[s], k0, m0 + 64 * h, gx);
              tma_box(sb + h * G_BOX, &mb, &full[s], a.c0 + n0 + 64 * h, k0,
                      gw);
            } else if (MODE == CE_DX) {
              tma_box(sa + h * G_BOX, &ma, &full[s], k0, m0 + 64 * h, g);
              tma_box(sb + h * G_BOX, &mb, &full[s], a.c0 + k0, n0 + 64 * h,
                      gw);
            } else {
              tma_box(sa + h * G_BOX, &ma, &full[s], m0 + 64 * h, k0, gx);
              tma_box(sb + h * G_BOX, &mb, &full[s], n0 + 64 * h, k0, g);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127 -------
    const int wc = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
    constexpr int TA = MODE == CE_DW, TB = MODE != CE_DX;
    // d[4j + 2h + i] is C[r + 8h][8j + 2 (lane % 4) + i] of the tile
    const int r = m0 + 64 * wc + 16 * warp + lane / 4;
    float d[64];
    // CE_F: the running (max, sum of exps, picked logit) of rows r, r + 8
    float fm[2] = {-1e30f, -1e30f}, fl[2] = {0.f, 0.f}, fp[2] = {0.f, 0.f};
    int lab[2] = {-1, -1};
    if (MODE == CE_F) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < a.Tn)
          lab[h] = a.labels[(long long)g * a.Tn + r + 8 * h];
    }

    int it = 0;                              // stages consumed
    for (int tile = 0; tile < ntiles; ++tile) {
      const int n0 = (vt0 + tile) * G_BN;
      for (int kt = 0; kt < a.nk; ++kt, ++it) {
        const int s = it % G_ST;
        mbar_wait(&full[s], (it / G_ST) & 1);
        const bf16* sa =
            reinterpret_cast<const bf16*>(smem + s * G_STAGE_BYTES);
        const bf16* sb = sa + 2 * G_BOX;
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < G_BK / 16; ++j) {
          // A: this warpgroup's 64 rows; k advances 16 columns (K-major) or
          // 16 rows (MN-major) of the tile.
          const uint64_t da = TA
              ? gdesc(sa + wc * G_BOX + j * 16 * 64, 8192, 1024)
              : gdesc(sa + wc * G_BOX + j * 16, 16, 1024);
          const uint64_t db = TB ? gdesc(sb + j * 16 * 64, 8192, 1024)
                                 : gdesc(sb + j * 16, 16, 1024);
          wgmma_m64n128k16<TA, TB>(d, da, db, kt > 0 || j > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();                     // stage it - 1 has been read
        fence_regs(d);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % G_ST]);
      }
      wgmma_wait<0>();
      fence_regs(d);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % G_ST]);

      // ---- epilogue ------------------------------------------------------
      const int cl = n0 + 2 * (lane % 4);
      if (MODE == CE_F) {
        fwd_tile(d, n0, a.V, lane, lab, fm, fl, fp);
      } else if (MODE == CE_P) {
        const float scale = a.gsc[g] / (float)a.Tn;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = r + 8 * h;
          if (t >= a.Tn) continue;
          const long long at = (long long)g * a.Tn + t;
          const float lse_t = a.lse[at];
          const int lb = a.labels[at] - a.c0;
          bf16* prow = a.p + at * a.ldp;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int v = cl + 8 * j;
            float pv[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              pv[i] = v + i < a.cw
                          ? (expf(d[4 * j + 2 * h + i] - lse_t) -
                             (v + i == lb ? 1.f : 0.f)) * scale
                          : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(prow + v) =
                __floats2bfloat162_rn(pv[0], pv[1]);
          }
        }
      } else if (MODE == CE_DX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = r + 8 * h;
          if (t >= a.Tn) continue;
          const long long row = ((long long)g * a.Tn + t) * a.d;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = cl + 8 * j;
            if (c >= a.d) continue;              // d is a multiple of 8
            float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
            if (!a.first) {
              const float2 prev =
                  *reinterpret_cast<const float2*>(a.acc + row + c);
              v.x = prev.x + v.x;
              v.y = prev.y + v.y;
            }
            if (a.last)
              *reinterpret_cast<__nv_bfloat162*>(a.out + row + c) =
                  __floats2bfloat162_rn(v.x, v.y);
            else
              *reinterpret_cast<float2*>(a.acc + row + c) = v;
          }
        }
      } else {
        const bool even = (a.V & 1) == 0;   // rows of dw start 4-byte aligned
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dc = r + 8 * h;
          if (dc >= a.d) continue;
          bf16* orow = a.out + ((long long)g * a.d + dc) * a.V + a.c0;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int v = cl + 8 * j;
            if (even && v < a.cw) {      // then v + 1 < cw too: cw is even
              *reinterpret_cast<__nv_bfloat162*>(orow + v) =
                  __floats2bfloat162_rn(d[4 * j + 2 * h],
                                        d[4 * j + 2 * h + 1]);
            } else {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (v + i < a.cw)
                  orow[v + i] = __float2bfloat16(d[4 * j + 2 * h + i]);
            }
          }
        }
      }
    }

    if (MODE == CE_F) {
      // the split's partial (m, l, picked) of rows r, r + 8: l and picked
      // summed over the row's quad
      const long long plane = (long long)gridDim.z * a.nsplit * a.Tn;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = fl[h], pk = fp[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        pk += __shfl_xor_sync(0xffffffffu, pk, 1);
        pk += __shfl_xor_sync(0xffffffffu, pk, 2);
        const int t = r + 8 * h;
        if (lane % 4 != 0 || t >= a.Tn) continue;
        const long long at = ((long long)g * a.nsplit + blockIdx.y) * a.Tn + t;
        a.part[at] = fm[h];
        a.part[plane + at] = l;
        a.part[2 * plane + at] = pk;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// A bf16 [groups, rows, inner] tensor (row stride ld elements, groups
// dense) in 64 x 64 boxes.
bool tensor_map(CUtensorMap* m, const void* base, long long inner,
                long long rows, long long groups, long long ld) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * 2),
                                 (cuuint64_t)(ld * rows * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  return tensor_map_bf16(m, base, 3, dims, strides, box);
}

template <int MODE>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                        const GemmArgs& a, int mtiles, int ntiles, int G,
                        cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  ce_gemm_kernel<MODE><<<dim3(mtiles, ntiles, G), G_THREADS, G_SMEM, st>>>(
      ma, mb, a);
  return cudaGetLastError();
}

// K3: the partials of every (row tile, split, group), then the combine
// pass.  bf16: w's rows are ldw >= V elements apart (a multiple of 8).
cudaError_t launch_fwd(const void* x, const void* w, const int* labels,
                       float* part, float* lse, float* picked, int G, int Tn,
                       int d, int V, int ldw, long long xg, long long wg,
                       int nsplit, int tps, bool bf16_in, cudaStream_t st) {
  cudaError_t err;
  if (bf16_in) {
    if (d % 8 || ldw % 8 || ldw < V || !aligned16(x) || !aligned16(w))
      return cudaErrorInvalidValue;
    CUtensorMap mx, mw;
    if (!tensor_map(&mx, x, d, Tn, xg ? G : 1, d) ||
        !tensor_map(&mw, w, V, d, wg ? G : 1, ldw))
      return cudaErrorInvalidValue;
    GemmArgs a{labels, nullptr, nullptr, nullptr, nullptr, nullptr, part,
               Tn, d, V, 0, 0, V, 0, 0, xg != 0, wg != 0,
               (d + G_BK - 1) / G_BK, nsplit, tps};
    err = launch_gemm<CE_F>(mx, mw, a, (Tn + G_BM - 1) / G_BM, nsplit, G, st);
  } else {
    if (ldw != V) return cudaErrorInvalidValue;
    ce_fwd_kernel<float><<<dim3((Tn + F_BT - 1) / F_BT, nsplit, G), NT, 0,
                           st>>>(static_cast<const float*>(x),
                                 static_cast<const float*>(w), labels, part,
                                 G, Tn, d, V, xg, wg, nsplit, tps);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const long long rows = (long long)G * Tn;
  ce_combine_kernel<<<(unsigned)((rows + NT - 1) / NT), NT, 0, st>>>(
      part, lse, picked, G, Tn, nsplit);
  return cudaGetLastError();
}

// The fp32 K4a or K4b; N is the instance's number of CH-wide d chunks per
// 1024-column d slice.
template <int N>
cudaError_t launch_fp32_one(bool dx_not_dw, const float* x, const float* w,
                            const int* labels, const float* lse,
                            const float* gsc, float* out, int G, int Tn,
                            int d, int V, long long xg, long long wg,
                            cudaStream_t st) {
  const int nds = (d + DSW - 1) / DSW;
  if (dx_not_dw)
    ce_dx_kernel<float, N><<<dim3((Tn + X_BT - 1) / X_BT, G, nds), NT, 0,
                             st>>>(x, w, labels, lse, gsc, out, Tn, d, V, xg,
                                   wg);
  else
    ce_dw_kernel<float, N><<<dim3((V + W_BV - 1) / W_BV, G, nds), NT, 0,
                             st>>>(x, w, labels, lse, gsc, out, Tn, d, V, xg,
                                   wg);
  return cudaGetLastError();
}

cudaError_t launch_fp32(bool dx_not_dw, const float* x, const float* w,
                        const int* labels, const float* lse, const float* gsc,
                        float* out, int G, int Tn, int d, int V, long long xg,
                        long long wg, cudaStream_t st) {
  const int width = d < DSW ? d : DSW;        // columns of the widest slice
  const int nch = (width + CH - 1) / CH;
#define CE_CASE(N)                                                          \
  if (nch <= N)                                                             \
    return launch_fp32_one<N>(dx_not_dw, x, w, labels, lse, gsc, out, G, Tn, \
                              d, V, xg, wg, st);
  CE_CASE(1) CE_CASE(2) CE_CASE(4) CE_CASE(8) CE_CASE(16)
#undef CE_CASE
  return cudaErrorInvalidValue;
}

// The bf16 backward, chunk by chunk (see the head of this file).
cudaError_t launch_bwd_bf16(const bf16* x, const bf16* w, const int* labels,
                            const float* lse, const float* gsc, bf16* p,
                            float* dx_acc, bf16* dx, bf16* dw, int G, int Tn,
                            int d, int V, int ldw, long long xg, long long wg,
                            int vc, cudaStream_t st) {
  const long long nvc = ((long long)V + vc - 1) / vc;
  if (d % 8 || ldw % 8 || ldw < V || vc % G_BN || !aligned16(x) ||
      !aligned16(w) || !aligned16(p) || (dx && nvc > 1 && !dx_acc))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw, mp;
  if (!tensor_map(&mx, x, d, Tn, xg ? G : 1, d) ||
      !tensor_map(&mw, w, V, d, wg ? G : 1, ldw) ||
      !tensor_map(&mp, p, vc, Tn, G, vc))
    return cudaErrorInvalidValue;
  const int ttiles = (Tn + G_BM - 1) / G_BM, dtiles = (d + G_BM - 1) / G_BM;
  GemmArgs a{labels, lse, gsc, p, dx_acc, nullptr, nullptr, Tn, d, V, vc,
             0, 0, 0, 0, xg != 0, wg != 0, 0, 0, 0};
  for (int c0 = 0; c0 < V; c0 += vc) {
    a.c0 = c0;
    a.cw = V - c0 < vc ? V - c0 : vc;
    const int vtiles = (a.cw + G_BN - 1) / G_BN;
    a.out = nullptr;
    a.nk = (d + G_BK - 1) / G_BK;
    cudaError_t err = launch_gemm<CE_P>(mx, mw, a, ttiles, vtiles, G, st);
    if (err != cudaSuccess) return err;
    if (dx) {
      a.out = dx;
      a.first = c0 == 0;
      a.last = c0 + vc >= V;
      a.nk = (a.cw + G_BK - 1) / G_BK;
      err = launch_gemm<CE_DX>(mp, mw, a, ttiles, dtiles, G, st);
      if (err != cudaSuccess) return err;
    }
    if (dw) {
      a.out = dw;
      a.nk = (Tn + G_BK - 1) / G_BK;
      err = launch_gemm<CE_DW>(mx, mp, a, dtiles, vtiles, G, st);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  part: scratch fp32 [3, G, nsplit, T];
// bf16: w's rows are ldw >= V elements apart (ldw % 8 == 0), splits of tps
// 128-column tiles over 128-row tiles; fp32: ldw == V, 64-wide tiles over
// 64-row tiles.
extern "C" int fused_ce_fwd(const void* x, const void* w, const int* labels,
                            float* part, float* lse, float* picked, int G,
                            int Tn, int d, int V, int ldw, long long xg,
                            long long wg, int nsplit, int tiles_per_split,
                            int dtype, void* stream) {
  return (int)launch_fwd(x, w, labels, part, lse, picked, G, Tn, d, V, ldw,
                         xg, wg, nsplit, tiles_per_split, dtype == 1,
                         static_cast<cudaStream_t>(stream));
}

// dx [G, T, d] and / or dw [G, d, V] (either may be null).  bf16: w's rows
// are ldw >= V elements apart; p is the P scratch [G, T, vc] (vc a multiple
// of 128); dx_acc the fp32 dx partial sums [G, T, d], needed for dx when
// V > vc.  fp32: ldw == V, and p, dx_acc and vc are unused.
extern "C" int fused_ce_bwd(const void* x, const void* w, const int* labels,
                            const float* lse, const float* g, void* p,
                            float* dx_acc, void* dx, void* dw, int G, int Tn,
                            int d, int V, int ldw, long long xg, long long wg,
                            int vc, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bwd_bf16(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), labels, lse,
        g, static_cast<bf16*>(p), dx_acc, static_cast<bf16*>(dx),
        static_cast<bf16*>(dw), G, Tn, d, V, ldw, xg, wg, vc, st);
  if (ldw != V) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  if (dx) {
    const cudaError_t err = launch_fp32(true, xf, wf, labels, lse, g,
                                        static_cast<float*>(dx), G, Tn, d, V,
                                        xg, wg, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (dw)
    return (int)launch_fp32(false, xf, wf, labels, lse, g,
                            static_cast<float*>(dw), G, Tn, d, V, xg, wg, st);
  return 0;
}
