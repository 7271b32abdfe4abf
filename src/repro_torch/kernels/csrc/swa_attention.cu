// Causal sliding-window flash attention, forward.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/swa_attention.py swa_attention -> _swa_kernel (K6).
// q [B, S, H, hd], k/v [B, S, KH, hd] -> o [B, S, H, hd] in q's dtype,
// o = softmax(q k^T / sqrt(hd), causal, kv within the trailing `window`) v.
// GQA by index: q head h reads kv head h / (H / KH); kv are never repeated
// in memory.  The layouts are the model's own (no transposes around it).
// On the TPU the kv blocks of the window were a sequential grid axis
// carrying (m, l, acc) in scratch; here a block loops over only the kv
// tiles that meet its band, from max(0, q0 - W + 1) to its last row, with
// the online softmax state (m, l) and the accumulator in registers.  The
// output is acc / (l + 1e-30), as the reference.
//
// What bounds it on an H100: operations.  At S = 4096, W = 4096, H = 16,
// hd = 128 a sequence needs 68.7 GFLOP of products against 34 MB of q, k,
// v and o in bf16 (69.5 us at 989 TFLOP/s), and 134 M exps.
//
// Two hand-written kernels; the wrapper picks one from dtype and hd
// (swa_attention.kernel_for):
//
// * bf16, hd in {64, 128}: swa_tc_kernel, the main path, on the tensor
//   cores.  One block per (128-row q tile, q head, sequence), launched
//   one sequence after another (its k and v, 16 MB at S = 4096, stay in
//   the 50 MB L2 while its blocks run) and within a sequence longest
//   first (the last q tiles, with the most kv tiles under the causal
//   mask, take the lowest block indices), with 3 warpgroups:
//   warpgroup 0 is the producer, one thread of which loads the q tile once
//   and then walks a 2-stage ring of k and v tiles of 128 keys x hd with
//   TMA (4D tensor maps over the model's layout: hd, heads, S, B; boxes of
//   64 hd x 1 head x 128 rows, 128-byte swizzle; zero fill past S, so a
//   ragged S never reads the next sequence and needs no edge masks);
//   warpgroups 1 and 2 are consumers of 64 q rows each.  A consumer runs
//   S = q k^T as wgmma m64n128k16 from shared memory (both K-major), the
//   online softmax in registers (a row's 128 columns lie on the 4 lanes of
//   a quad: two shuffles give its max), rounds P to bf16 in registers (the
//   accumulator layout of m64n128 is the A fragment layout of its k16
//   slices) and runs O += P v as wgmma with A from registers and v an
//   MN-major B (transpose bit).  l sums the rounded P, so o stays a convex
//   combination of the rows of v.  The causal and window masks are applied
//   element by element only on tiles that cross the warpgroup's diagonal or
//   the window's lower edge.  A consumer issues a tile's q k^T, then the
//   previous tile's P v, and runs the softmax while the tensor cores do
//   that P v; the two consumers take turns to issue (named barriers), so
//   one's softmax also runs under the other's products.  The exps run as
//   ex2.approx on the special-function units.  Shared memory at hd = 128:
//   32 KB of q plus 2 x 64 KB of k and v.
// * fp32, and bf16 at hd in {16, 32, 112}: swa_fwd_kernel on the fp32
//   CUDA cores (the tests' fidelity path, the fp32 CPU-vs-card run and
//   zamba2's hd = 112): one block per (64-row q tile, q head, sequence),
//   S = q k^T as a 4x4 register micro-tile per thread, P through shared
//   memory for P v; a thread owns hd / 16 output columns (7 at hd = 112,
//   with 75 KB of dynamic shared memory).
//
// Plain C interface (ctypes); the launchers return cudaGetLastError().

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
    case 112:                            // zamba2-7b: 3584 / 32 heads
      return launch<T, 112>(q, k, v, o, B, S, H, KH, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KH, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, hd in {64, 128}: tensor cores (TMA + wgmma)
// ---------------------------------------------------------------------------

constexpr int A_BQ = 128, A_BK = 128;        // q rows, keys of a tile
constexpr int A_ST = 2;                      // stages of the k / v ring
constexpr int A_THREADS = 384;               // 3 warpgroups
constexpr int A_BOX = 128 * 64;              // elements of a box: 128 x 64 hd

template <int HD>
struct TcShape {
  static constexpr int NB = HD / 64;                  // boxes of a tile
  static constexpr uint32_t TILE = NB * A_BOX * 2;    // bytes of a tile
  // q, then k[s] and v[s] of each stage; then the barriers
  static constexpr int SMEM =
      (1 + 2 * A_ST) * TILE + 1024 + (1 + 4 * A_ST) * 8;
};

// S[64 x 128 keys] = q k^T for consumer wc: q's rows 64 wc .. +63 and the
// k tile at sk, both K-major (hd contiguous), hd / 16 k16 steps.
template <int HD>
__device__ __forceinline__ void qk_mma(float (&sacc)[64], const bf16* sq,
                                       int wc, const uint8_t* sk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n128k16<0, 0>(
        sacc,
        gdesc(sq + (kk / 4) * A_BOX + wc * 64 * 64 + (kk % 4) * 16, 16, 1024),
        gdesc(sk + (kk / 4) * A_BOX * 2 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// The scores of kv tile jt for this thread's rows r, r + 8 (columns
// 8 j + cq + {0, 1}): masked where the tile crosses the warpgroup's causal
// diagonal or the window's lower edge (its rows start at qa), then the
// online softmax: the row max m (over the row's quad) updated, alpha the
// factor that rescales the old sums, and the scores replaced by
// exp((s - m) / sqrt(hd)) = 2^((s - m) sl2), sl2 = log2(e) / sqrt(hd).
__device__ __forceinline__ void tile_softmax(float (&sacc)[64], int jt,
                                             int jt0, int qa, int r, int cq,
                                             int window, float sl2,
                                             float (&m)[2],
                                             float (&alpha)[2]) {
  const int k0 = jt * A_BK;
  const bool edge = k0 + A_BK - 1 > qa || k0 <= qa + 63 - window;
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = k0 + 8 * j + cq + (q & 1), row = r + 8 * (q >> 1);
        const bool ok = key <= row && key > row - window;
        if (!ok) sacc[4 * j + q] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = ex2((m[h] - mx) * sl2);
    const float mb = mx * sl2;
    m[h] = mx;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sacc[4 * j + 2 * h + i] =
            ex2(fmaf(sacc[4 * j + 2 * h + i], sl2, -mb));
  }
}

// O rescaled by alpha; P rounded to bf16 into the A fragments pa (the
// accumulator layout of m64n128 is the A layout of its k16 slices), and l
// updated with the sum of the rounded values this lane holds.
template <int NO>
__device__ __forceinline__ void round_p(const float (&sacc)[64],
                                        uint32_t (&pa)[8][4], float (&l)[2],
                                        float (&oacc)[NO],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const __nv_bfloat162 pb = __floats2bfloat162_rn(
          sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]);
      sum += __low2float(pb) + __high2float(pb);
      pa[j / 2][h + 2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&pb);
    }
    l[h] = l[h] * alpha[h] + sum;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      oacc[4 * j + 2 * h] *= alpha[h];
      oacc[4 * j + 2 * h + 1] *= alpha[h];
    }
  }
}

// O[64 x HD] += P[64 x 128 keys] v[128 keys x HD]: P from registers (its
// 8 k16 slices), v an MN-major tile at sv (hd contiguous; the next 64
// columns of hd one box on).
template <int HD>
__device__ __forceinline__ void pv_mma(float (&oacc)[HD / 2],
                                       uint32_t (&pa)[8][4],
                                       const uint8_t* sv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = gdesc(sv + kk * 16 * 128, A_BOX * 2, 1024);
    if constexpr (HD == 128)
      wgmma_m64n128k16_rs<1>(oacc, pa[kk], dv);
    else
      wgmma_m64n64k16_rs<1>(oacc, pa[kk], dv);
  }
}

template <int HD>
__global__ void __launch_bounds__(A_THREADS, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
              int B, int S, int H, int KH, int window, float sl2) {
  using Sh = TcShape<HD>;
  constexpr int NO = HD / 2;                 // O accumulators of a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  uint64_t* full_q =
      reinterpret_cast<uint64_t*>(smem + (1 + 2 * A_ST) * Sh::TILE);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + A_ST;
  uint64_t* empty_k = full_v + A_ST;
  uint64_t* empty_v = empty_k + A_ST;

  const int nqt = (S + A_BQ - 1) / A_BQ;
  const int head = blockIdx.x % H, b = blockIdx.x / (H * nqt);
  const int q0 = (nqt - 1 - (blockIdx.x / H) % nqt) * A_BQ;
  const int kvh = head / (H / KH);
  const int qlast = min(q0 + A_BQ, S) - 1;
  const int jt0 = max(0, q0 - window + 1) / A_BK, jt1 = qlast / A_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < A_ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);             // the 8 consumer warps
      mbar_init(&empty_v[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, Sh::TILE);
#pragma unroll
      for (int c = 0; c < Sh::NB; ++c)
        tma_box4(sq + c * A_BOX, &mq, full_q, 64 * c, head, q0, b);
      for (int jt = jt0; jt <= jt1; ++jt) {
        const int n = jt - jt0, s = n % A_ST;
        const uint32_t ph = ((n / A_ST) - 1) & 1;
        bf16* sk = reinterpret_cast<bf16*>(smem + (1 + 2 * s) * Sh::TILE);
        bf16* sv = reinterpret_cast<bf16*>(smem + (2 + 2 * s) * Sh::TILE);
        if (n >= A_ST) mbar_wait(&empty_k[s], ph);
        mbar_expect_tx(&full_k[s], Sh::TILE);
#pragma unroll
        for (int c = 0; c < Sh::NB; ++c)
          tma_box4(sk + c * A_BOX, &mk, &full_k[s], 64 * c, kvh, jt * A_BK, b);
        if (n >= A_ST) mbar_wait(&empty_v[s], ph);
        mbar_expect_tx(&full_v[s], Sh::TILE);
#pragma unroll
        for (int c = 0; c < Sh::NB; ++c)
          tma_box4(sv + c * A_BOX, &mv, &full_v[s], 64 * c, kvh, jt * A_BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows q0 .. +63, warpgroup 2 the next 64 --
    setmaxnreg_inc<232>();
    const int wc = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
    const int qa = q0 + 64 * wc;                 // the warpgroup's first row
    // sacc[4j + 2h + i] is S[r + 8h][8j + cq + i] of the tile, as oacc of O
    const int r = qa + 16 * warp + lane / 4, cq = 2 * (lane % 4);
    float sacc[64], oacc[NO];
    uint32_t pa[8][4];       // P in bf16: A fragments of its 8 k16 slices
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] = 0.f;

    // Tile n: S_n = q k_n^T is issued, then O += P_{n-1} v_{n-1}; the
    // softmax of S_n runs while the tensor cores do P_{n-1} v_{n-1}; O is
    // rescaled and P_n rounded into pa once that product has completed.
    // The first tile is peeled off, so that no branch lies between a
    // wgmma and the wait that retires it (ptxas would serialise them).
    // The consumers issue their products in turns (named barriers 1 and
    // 2: warpgroup 1 first, each hands the turn on after issuing), so the
    // tensor cores run one's products while the other does its softmax.
    float alpha[2];
    const int turn = 1 + wc, next = 2 - wc;
    if (wc == 1) bar_arrive(1, 256);
    mbar_wait(full_q, 0);
    mbar_wait(&full_k[0], 0);
    bar_sync(turn, 256);
    fence_regs(sacc);
    wgmma_fence();
    qk_mma<HD>(sacc, sq, wc, smem + Sh::TILE);
    wgmma_commit();
    bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(sacc);
    if (lane == 0) mbar_arrive(&empty_k[0]);
    tile_softmax(sacc, jt0, jt0, qa, r, cq, window, sl2, m, alpha);
    round_p(sacc, pa, l, oacc, alpha);

    for (int jt = jt0 + 1; jt <= jt1; ++jt) {
      const int n = jt - jt0, s = n % A_ST, sp = (n - 1) % A_ST;
      mbar_wait(&full_k[s], (n / A_ST) & 1);
      mbar_wait(&full_v[sp], ((n - 1) / A_ST) & 1);
      bar_sync(turn, 256);
      fence_regs(sacc);
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      qk_mma<HD>(sacc, sq, wc, smem + (1 + 2 * s) * Sh::TILE);
      wgmma_commit();
      pv_mma<HD>(oacc, pa, smem + (2 + 2 * sp) * Sh::TILE);
      wgmma_commit();
      bar_arrive(next, 256);
      wgmma_wait<1>();                   // S done; P v may still run
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(&empty_k[s]);
      tile_softmax(sacc, jt, jt0, qa, r, cq, window, sl2, m, alpha);
      wgmma_wait<0>();                   // the previous P v has completed
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
      if (lane == 0) mbar_arrive(&empty_v[sp]);
      round_p(sacc, pa, l, oacc, alpha);
    }

    // ---- the last tile's O += P v -------------------------------------------
    const int sl = (jt1 - jt0) % A_ST;
    mbar_wait(&full_v[sl], ((jt1 - jt0) / A_ST) & 1);
    bar_sync(turn, 256);
    fence_regs(oacc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
    pv_mma<HD>(oacc, pa, smem + (2 + 2 * sl) * Sh::TILE);
    wgmma_commit();
    bar_arrive(next, 256);
    if (wc == 0) bar_sync(1, 256);       // warpgroup 2's last arrival
    wgmma_wait<0>();
    fence_regs(oacc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);

    // ---- o = acc / (l + 1e-30) in bf16 --------------------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / (lt + 1e-30f);
      const int row = r + 8 * h;
      if (row >= S) continue;
      bf16* orow = o + (((long long)b * S + row) * H + head) * HD + cq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * h] * inv,
                                  oacc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// A [B, S, heads, hd] bf16 tensor in boxes of 64 hd x 1 head x 128 rows x
// 1 sequence.
bool head_map(CUtensorMap* m, const void* base, int B, int S, int heads,
              int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, A_BK, 1};
  return tensor_map_bf16(m, base, 4, dims, strides, box);
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KH, int window, float scale,
                      cudaStream_t st) {
  using Sh = TcShape<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)((S + A_BQ - 1) / A_BQ) * H * B;
  CUtensorMap mq, mk, mv;
  if (blocks > INT_MAX || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !head_map(&mq, q, B, S, H, HD) || !head_map(&mk, k, B, S, KH, HD) ||
      !head_map(&mv, v, B, S, KH, HD))
    return cudaErrorInvalidValue;
  swa_tc_kernel<HD><<<(unsigned)blocks, A_THREADS, Sh::SMEM, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), B, S, H, KH, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel.  dtype: 0 float32, 1 bfloat16.  window >= 1 (the
// caller maps "no window" to S).
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

// The tensor-core kernel: bf16, hd in {64, 128}, 16-byte aligned bases.
extern "C" int swa_attention_tc(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int H, int KH, int hd,
                                int window, float scale, void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch_tc<64>(q, k, v, o, B, S, H, KH, window, scale,
                                       st);
    case 128: return (int)launch_tc<128>(q, k, v, o, B, S, H, KH, window,
                                         scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
