// Causal sliding-window flash attention, forward and backward.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/swa_attention.py swa_attention -> _swa_kernel (K6),
// and computes its gradient, which the JAX package takes as jax.vjp of
// its reference (src/repro/kernels/ops.py _swa_bwd; no TPU kernel).
// q [B, S, H, hd], k/v [B, S, KH, hd] -> o [B, S, H, hd] in q's dtype,
// o = softmax(q k^T / sqrt(hd), causal, kv within the trailing `window`) v,
// and the row's log-sum-exp lse [B, H, S] fp32 in base 2 of the scaled
// scores: lse = log2 sum_k 2^(s_k sl2), sl2 = log2(e) / sqrt(hd) (the
// kernels work in log2 units), so that p_k = 2^(s_k sl2 - lse).
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
// v and o in bf16 (69.5 us at 989 TFLOP/s), and 134 M exps; the backward
// 5 products (171.8 GFLOP, 173.7 us).
//
// Forward: two hand-written kernels; the wrapper picks one from dtype and
// hd (swa_attention.kernel_for):
//
// * bf16, hd in {64, 112, 128}: swa_tc_kernel, the main path, on the
//   tensor cores.  One block per (128-row q tile, q head, sequence),
//   launched one sequence after another (its k and v, 16 MB at S = 4096,
//   stay in the 50 MB L2 while its blocks run) and within a sequence
//   longest first (the last q tiles, with the most kv tiles under the
//   causal mask, take the lowest block indices), with 3 warpgroups:
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
//   hd = 112 (zamba2-7b: 3584 / 32 heads) runs the hd-128 layout: a row of
//   224 bytes is a legal TMA stride (a multiple of 16), and the second
//   64-wide box of each row reads past hd, which TMA fills with zeros.  So
//   q k^T takes 7 k16 steps (the 8th would add zeros and is not issued),
//   P v runs as m64n128 with 16 zero columns of v (128/112 of its
//   products), and the epilogue stores 112 columns.  A true n112 P v would
//   save those products, but its B tile ends 48 columns into a 128-byte
//   swizzle atom; the zero-filled box keeps one layout for all widths.
// * fp32, and bf16 at hd in {16, 32}: swa_fwd_kernel on the fp32 CUDA
//   cores (the tests' fidelity path and the fp32 CPU-vs-card run): one
//   block per (64-row q tile, q head, sequence), S = q k^T as a 4x4
//   register micro-tile per thread, P through shared memory for P v; a
//   thread owns hd / 16 output columns.  It keeps an hd-112 instance
//   for fp32.
// Both write lse.
//
// Backward (bf16, hd in {64, 112, 128}; swa_attention.bwd_kernel_for):
// dV = P^T g, dP = g V^T, dS = P (dP - delta) with delta = rowsum(g o),
// dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd), P recomputed per tile from
// q, k and the forward's lse.  Three kernels in one stream, no atomics
// (every output element has one owner and a fixed order of summation, so
// the bits repeat from call to call):
// * swa_bwd_delta_kernel: delta [B, H, S] fp32 from the saved o and g
//   (16 lanes a row, 16 bytes a lane); the saved o is the forward kernel's
//   bf16 output, as FlashAttention-2 takes it.
// * swa_bwd_dkdv_kernel: one block per (128-key kv tile, kv head,
//   sequence), the longest first (the first kv tiles meet the most q
//   tiles).  k and v of the tile stay in shared memory; the producer
//   warpgroup streams a 3-stage ring of (q, g) tiles of 64 rows by TMA
//   (all 128 producer threads also copy the tile's 64 lse and delta values
//   into the stage, and every one of them arrives on its barrier), walking
//   the rep q heads of the kv head and, for each, the q tiles whose band
//   meets the kv tile, in order: the GQA groups are summed in order inside
//   the block.  Each consumer warpgroup owns 64 keys and runs
//   S^T = k q^T and dP^T = v g^T (m64n64k16, both K-major from shared
//   memory), P^T = 2^(S^T sl2 - lse) and dS^T = P^T (dP^T - delta) in
//   registers, then dV += P^T g and dK += dS^T q with P^T and dS^T as
//   register A fragments and g, q MN-major B tiles: 4 products a tile.
//   The two consumers take turns to issue (named barriers), so one's P and
//   dS run under the other's products.  dK and dV (128 fp32 a thread at
//   hd 128), S^T and dP^T (64) and the fragments fill the 232 registers a
//   consumer has; issuing a tile's S^T with the last tile's dV, as the dQ
//   kernel does, would need more, and ptxas then serialises the wgmmas.
// * swa_bwd_dq_kernel: one block per (128-row q tile, q head, sequence),
//   longest first, as the forward; each consumer warpgroup (64 rows) keeps
//   its rows of q and g in registers as A fragments (read once from device
//   memory), so S = q k^T and dP = g v^T read only the k and v tiles that
//   the producer streams over the band (a 3-stage ring of 64 keys); dS in
//   registers, then dQ += dS k: 3 products a tile.  A consumer issues the
//   last tile's dQ product with this tile's S and dP in one turn (the
//   consumers alternating, as above) and computes dS while they run: 240
//   registers a consumer, 24 for the producer's one thread.
// The two kernels recompute q k^T and g v^T twice: 7 products where 5 is
// the least.  The alternative, an ordered second pass over per-kv-tile dQ
// partials, would hold B H S hd fp32 per kv tile of a row's band: 32 x 8.4
// MB = 268 MB at [1, 4096, 16, 128], for 2 products less.
// P is rounded to bf16 before dV += P^T g and dS before dK and dQ, as the
// forward rounds P before P v; the accumulators are fp32 and the outputs
// bf16.  Shared memory at hd = 128: dK/dV 64 KB of k and v plus 3 x 32 KB
// of ring; dQ 3 x 32 KB.

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
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int S, int H, int KH, int window,
               float scale) {
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
    if (tx == 0)                 // m, l of the scaled scores: base e -> 2
      lse[((long long)b * H + h) * S + r] = (m[i] + logf(l[i])) * LOG2E;
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
                   float* lse, int B, int S, int H, int KH, int window,
                   float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_fwd_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KH, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int H, int KH, int hd,
                      int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, S, H, KH, window, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, S, H, KH, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, S, H, KH, window, scale, st);
    case 112:                            // zamba2-7b: 3584 / 32 heads
      return launch<T, 112>(q, k, v, o, lse, B, S, H, KH, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, S, H, KH, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, hd in {64, 112, 128}: tensor cores (TMA + wgmma)
// ---------------------------------------------------------------------------

constexpr int A_BQ = 128, A_BK = 128;        // q rows, keys of a tile
constexpr int A_ST = 2;                      // stages of the k / v ring
constexpr int A_THREADS = 384;               // 3 warpgroups
constexpr int A_BOX = 128 * 64;              // elements of a box: 128 x 64 hd

template <int HD>
struct TcShape {
  static constexpr int NB = (HD + 63) / 64;           // boxes of a tile
  static constexpr uint32_t TILE = NB * A_BOX * 2;    // bytes of a tile
  // q, then k[s] and v[s] of each stage; then the barriers
  static constexpr int SMEM =
      (1 + 2 * A_ST) * TILE + 1024 + (1 + 4 * A_ST) * 8;
};

// S[64 x 128 keys] = q k^T for consumer wc: q's rows 64 wc .. +63 and the
// k tile at sk, both K-major (hd contiguous), hd / 16 k16 steps (7 at
// hd = 112: the zero-filled columns 112 .. 127 are not multiplied).
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

// O[64 x 64 NB] += P[64 x 128 keys] v[128 keys x 64 NB]: P from
// registers (its 8 k16 slices), v an MN-major tile at sv (hd contiguous;
// the next 64 columns of hd one box on; at hd = 112 its last 16 columns
// are TMA's zeros).
template <int NB>
__device__ __forceinline__ void pv_mma(float (&oacc)[NB * 32],
                                       uint32_t (&pa)[8][4],
                                       const uint8_t* sv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = gdesc(sv + kk * 16 * 128, A_BOX * 2, 1024);
    if constexpr (NB == 2)
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
              float* __restrict__ lse, int B, int S, int H, int KH,
              int window, float sl2) {
  using Sh = TcShape<HD>;
  constexpr int NO = Sh::NB * 32;            // O accumulators of a thread
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
      pv_mma<Sh::NB>(oacc, pa, smem + (2 + 2 * sp) * Sh::TILE);
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
    pv_mma<Sh::NB>(oacc, pa, smem + (2 + 2 * sl) * Sh::TILE);
    wgmma_commit();
    bar_arrive(next, 256);
    if (wc == 0) bar_sync(1, 256);       // warpgroup 2's last arrival
    wgmma_wait<0>();
    fence_regs(oacc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);

    // ---- o = acc / (l + 1e-30) in bf16; lse = m sl2 + log2(l) -------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / (lt + 1e-30f);
      const int row = r + 8 * h;
      if (row >= S) continue;
      if (cq == 0)                 // m is the quad's, after its shuffles
        lse[((long long)b * H + head) * S + row] = fmaf(m[h], sl2, log2f(lt));
      bf16* orow = o + (((long long)b * S + row) * H + head) * HD + cq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * h] * inv,
                                  oacc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// A [B, S, heads, hd] bf16 tensor in boxes of 64 hd x 1 head x `rows` rows
// x 1 sequence (zeros past hd and past S).
bool head_map(CUtensorMap* m, const void* base, int B, int S, int heads,
              int hd, int rows = A_BK) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return tensor_map_bf16(m, base, 4, dims, strides, box);
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int H, int KH, int window,
                      float scale, cudaStream_t st) {
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
      mq, mk, mv, static_cast<bf16*>(o), lse, B, S, H, KH, window,
      scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, bf16, hd in {64, 112, 128}: delta, dK/dV, dQ
// ---------------------------------------------------------------------------

constexpr int B_ROWS = 64;                   // rows of a streamed tile
constexpr int B_ST = 3;                      // stages of the ring
constexpr int B_BOX = B_ROWS * 64;           // elements of a 64-row box

// delta[b, h, s] = sum_d g[b, s, h, d] o[b, s, h, d] in fp32: 16 lanes a
// (b, s, h) row, 8 elements (16 bytes) a lane, a fixed tree over the lanes.
__global__ void __launch_bounds__(256)
swa_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                     float* __restrict__ delta, long long rows, int S, int H,
                     int hd) {
  const long long row = (long long)blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows && lane * 8 < hd) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * hd + lane * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(g + row * hd + lane * 8);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pc[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    const long long bs = row / H;
    delta[((bs / S) * H + row % H) * S + bs % S] = acc;
  }
}

// Shared memory of the dK/dV kernel: the resident 128-row k and v tiles,
// B_ST stages of the streamed 64-row q and g tiles, each stage's 64 lse
// and 64 delta values, the barriers.  The dQ kernel's: B_ST stages of the
// streamed 64-row k and v tiles, the barriers.
template <int HD>
struct BwdShape {
  static constexpr int NB = (HD + 63) / 64;             // boxes of a row
  static constexpr uint32_t BIG = NB * A_BOX * 2;       // a 128-row tile
  static constexpr uint32_t SMALL = NB * B_BOX * 2;     // a 64-row tile
  static constexpr uint32_t STAGE = 2 * SMALL;
  static constexpr int RING = 2 * BIG;
  static constexpr int ROWS = RING + B_ST * STAGE;
  static constexpr int BARS = ROWS + B_ST * 2 * B_ROWS * 4;
  static constexpr int SMEM = BARS + (1 + 2 * B_ST) * 8 + 1024;
  static constexpr int DQ_BARS = B_ST * STAGE;
  static constexpr int DQ_SMEM = DQ_BARS + 2 * B_ST * 8 + 1024;
};

// dS = P (dP - delta): the softmax's Jacobian applied to dP.
__device__ __forceinline__ float ds_of(float p, float dp, float delta) {
  return p * (dp - delta);
}

// acc[64 x 64] = A[64 x hd] B[64 x hd]^T, A rows at sa (elements; a
// 128-row resident tile, this warpgroup's 64 rows), B a 64-row streamed
// tile at sb (bytes), both K-major: hd / 16 k16 steps.
template <int HD>
__device__ __forceinline__ void nt_mma(float (&acc)[32], const bf16* sa,
                                       const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16<0, 0>(
        acc, gdesc(sa + (kk / 4) * A_BOX + (kk % 4) * 16, 16, 1024),
        gdesc(sb + (kk / 4) * B_BOX * 2 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc[64 x 64] = A[64 x hd] B[64 x hd]^T, A from registers (its hd / 16
// k16 slices, ``load_a``), B a 64-row streamed tile at sb, K-major.
template <int HD>
__device__ __forceinline__ void nt_mma_rs(float (&acc)[32],
                                          uint32_t (&a)[HD / 16][4],
                                          const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16_rs<0>(
        acc, a[kk], gdesc(sb + (kk / 4) * B_BOX * 2 + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// The A fragments of this thread's rows r, r + 8 of a [B, S, heads, HD]
// bf16 tensor for the hd / 16 k16 slices of hd (columns 16 kk + cq + {0,
// 1} and 8 more, as mma.sync m16n8k16's A), read once from device memory;
// zeros past S.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const bf16* base, int b, int r,
                                       int cq, int S, int heads, int head) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        base + (((long long)b * S + min(row, S - 1)) * heads + head) * HD +
        cq);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      a[kk][h] = row < S ? p[8 * kk] : 0u;
      a[kk][h + 2] = row < S ? p[8 * kk + 4] : 0u;
    }
  }
}

// acc[64 x 64 NB] += A[64 x 64] B[64 x 64 NB]: A from registers (the 4 k16
// slices of a rounded m64n64 accumulator), B a 64-row streamed tile at sb
// read MN-major (hd contiguous; the next 64 columns one box on).
template <int NB>
__device__ __forceinline__ void rs_mma(float (&acc)[NB * 32],
                                       uint32_t (&a)[4][4],
                                       const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = gdesc(sb + kk * 16 * 128, B_BOX * 2, 1024);
    if constexpr (NB == 2)
      wgmma_m64n128k16_rs<1>(acc, a[kk], db);
    else
      wgmma_m64n64k16_rs<1>(acc, a[kk], db);
  }
}

// Two fp32 values as the bf16 pair of an A fragment (the accumulator
// layout of m64n64, d[4 j + 2 h + i], is the A layout of its k16 slices:
// slice j / 2, register h + 2 (j % 2)).
__device__ __forceinline__ void put_pair(uint32_t (&a)[4][4], int j, int h,
                                         float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  a[j / 2][h + 2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&v);
}

// The rows of a [B, S, heads, HD] bf16 output from an m64nN accumulator
// (this thread's rows r, r + 8 at column 8 j + cq + i), times `mul`; rows
// past S are not written.
template <int HD, int NO>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NO],
                                           int b, int r, int cq, int S,
                                           int heads, int head, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= S) continue;
    bf16* orow = out + (((long long)b * S + row) * heads + head) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                acc[4 * j + 2 * h + 1] * mul);
  }
}

// P^T = 2^(S^T sl2 - lse) and dS^T = P^T (dP^T - delta) of a dK/dV tile
// (this thread's keys kr, kr + 8 of the warpgroup's ka .. ka + 63 against
// q columns q0 + 8 j + cq + {0, 1}, whose lse and delta are at lrow and
// drow), rounded to bf16 A fragments; masked where the tile crosses a
// key's diagonal or its window's far edge.
__device__ __forceinline__ void kv_tile_p(const float (&sacc)[32],
                                          const float (&dpacc)[32],
                                          uint32_t (&pa)[4][4],
                                          uint32_t (&dsa)[4][4],
                                          const float* lrow,
                                          const float* drow, int q0, int ka,
                                          int kr, int cq, int window,
                                          float sl2) {
  const bool cut = ka + 63 > q0 || ka <= q0 + 63 - window;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // the thread's two q columns 8 j + cq + {0, 1}: one 8-byte read each
    const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j + cq);
    const float2 e2 = *reinterpret_cast<const float2*>(drow + 8 * j + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p2[2], d2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * h + i, qc = q0 + 8 * j + cq + i;
        const int kv = kr + 8 * h;
        float p = ex2(fmaf(sacc[e], sl2, -(i ? l2.y : l2.x)));
        if (cut && !(kv <= qc && kv > qc - window)) p = 0.f;
        p2[i] = p;
        d2[i] = ds_of(p, dpacc[e], i ? e2.y : e2.x);
      }
      put_pair(pa, j, h, p2[0], p2[1]);
      put_pair(dsa, j, h, d2[0], d2[1]);
    }
  }
}

// dS = P (dP - delta) of a dQ tile (this thread's rows r, r + 8 of the
// warpgroup's qa .. qa + 63, with their lse and delta, against keys c0 +
// 8 j + cq + {0, 1}), rounded to bf16 A fragments, masked as above.
__device__ __forceinline__ void q_tile_ds(const float (&sacc)[32],
                                          const float (&dpacc)[32],
                                          uint32_t (&dsa)[4][4],
                                          const float (&lrow)[2],
                                          const float (&drow)[2], int c0,
                                          int qa, int r, int cq, int window,
                                          float sl2) {
  const bool cut = c0 + 63 > qa || c0 <= qa + 63 - window;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * h + i, key = c0 + 8 * j + cq + i;
        const int row = r + 8 * h;
        float p = ex2(fmaf(sacc[e], sl2, -lrow[h]));
        if (cut && !(key <= row && key > row - window)) p = 0.f;
        d2[i] = ds_of(p, dpacc[e], drow[h]);
      }
      put_pair(dsa, j, h, d2[0], d2[1]);
    }
}

template <int HD>
__global__ void __launch_bounds__(A_THREADS, 1)
swa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,   // 64-row boxes
                    const __grid_constant__ CUtensorMap mk,   // 128-row
                    const __grid_constant__ CUtensorMap mv,   // 128-row
                    const __grid_constant__ CUtensorMap mg,   // 64-row
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, int KH, int window,
                    float sl2, float scale) {
  using Sh = BwdShape<HD>;
  constexpr int NB = Sh::NB, NO = NB * 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + Sh::BIG);
  float* srow = reinterpret_cast<float*>(smem + Sh::ROWS);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + Sh::BARS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + B_ST;

  const int nkt = (S + A_BK - 1) / A_BK, nqt = (S + B_ROWS - 1) / B_ROWS;
  const int kvh = blockIdx.x % KH, b = blockIdx.x / (KH * nkt);
  const int k0 = (blockIdx.x / KH) % nkt * A_BK, rep = H / KH;
  // the q tiles that see a key of k0 .. k0 + 127: q >= k0, q < key + W
  const int it0 = k0 / B_ROWS;
  const int it1 = min(nqt - 1, (k0 + A_BK - 2 + window) / B_ROWS);
  const int nqi = it1 - it0 + 1, niter = rep * nqi;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < B_ST; ++s) {
      mbar_init(&full[s], 128);              // every producer thread
      mbar_init(&empty[s], 8);               // the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues the copies, all 128 copy lse / delta --
    setmaxnreg_dec<40>();
    const int t = threadIdx.x;
    if (t == 0) {
      mbar_expect_tx(full_kv, 2 * Sh::BIG);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_box4(sk + c * A_BOX, &mk, full_kv, 64 * c, kvh, k0, b);
        tma_box4(sv + c * A_BOX, &mv, full_kv, 64 * c, kvh, k0, b);
      }
    }
    for (int n = 0; n < niter; ++n) {
      const int s = n % B_ST, hq = kvh * rep + n / nqi;
      const int q0 = (it0 + n % nqi) * B_ROWS, qi = q0 + t % B_ROWS;
      if (n >= B_ST) mbar_wait(&empty[s], ((n / B_ST) - 1) & 1);
      const long long at = ((long long)b * H + hq) * S + qi;
      // past S: lse +inf makes P (and so dS) 0
      float x = t < B_ROWS ? INFINITY : 0.f;
      if (qi < S) x = t < B_ROWS ? lse[at] : delta[at];
      srow[s * 2 * B_ROWS + t] = x;
      if (t == 0) {
        uint8_t* st = smem + Sh::RING + s * Sh::STAGE;
        mbar_expect_tx(&full[s], Sh::STAGE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_box4(st + c * B_BOX * 2, &mq, &full[s], 64 * c, hq, q0, b);
          tma_box4(st + Sh::SMALL + c * B_BOX * 2, &mg, &full[s], 64 * c,
                   hq, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 keys k0 .. +63, warpgroup 2 the next 64 --
    setmaxnreg_inc<232>();
    const int wc = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
    const int ka = k0 + 64 * wc;                 // the warpgroup's first key
    // sacc[4j + 2h + i] is S^T[key kr + 8h][q 8j + cq + i] of the tile
    const int kr = ka + 16 * warp + lane / 4, cq = 2 * (lane % 4);
    const bf16* kw = sk + wc * 64 * 64;
    const bf16* vw = sv + wc * 64 * 64;
    const uint8_t* ring = smem + Sh::RING;
    float sacc[32], dpacc[32], dka[NO], dva[NO];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
    // The consumers issue their products in turns (named barriers 1 and 2,
    // warpgroup 1 first), so one's P and dS run under the other's products.
    // (Issuing a tile's S^T and dP^T with the last tile's dV and dK, as the
    // forward and the dQ kernel do, needs 64 registers more than the 232 a
    // consumer has here: ptxas then serialises the wgmmas.)
    const int turn = 1 + wc, next = 2 - wc;
    if (wc == 1) bar_arrive(1, 256);
    mbar_wait(full_kv, 0);

    for (int n = 0; n < niter; ++n) {
      const int s = n % B_ST, q0 = (it0 + n % nqi) * B_ROWS;
      const uint8_t* sq = ring + s * Sh::STAGE;      // q, then g, of tile n
      const float* lrow = srow + s * 2 * B_ROWS;
      // zeros, not the last tile's values, are what the products overwrite
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
      mbar_wait(&full[s], (n / B_ST) & 1);
      bar_sync(turn, 256);
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
      nt_mma<HD>(sacc, kw, sq);                    // S^T = k q^T
      nt_mma<HD>(dpacc, vw, sq + Sh::SMALL);       // dP^T = v g^T
      wgmma_commit();
      bar_arrive(next, 256);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      kv_tile_p(sacc, dpacc, pa, dsa, lrow, lrow + B_ROWS, q0, ka, kr, cq,
                window, sl2);

      fence_regs(dka);
      fence_regs(dva);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(dsa[kk]);
      }
      bar_sync(turn, 256);
      wgmma_fence();
      rs_mma<NB>(dva, pa, sq + Sh::SMALL);         // dV += P^T g
      rs_mma<NB>(dka, dsa, sq);                    // dK += dS^T q
      wgmma_commit();
      bar_arrive(next, 256);
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(dsa[kk]);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (wc == 0) bar_sync(1, 256);               // warpgroup 2's last turn
    store_rows<HD>(dk, dka, b, kr, cq, S, KH, kvh, scale);
    store_rows<HD>(dv, dva, b, kr, cq, S, KH, kvh, 1.f);
  }
}

template <int HD>
__global__ void __launch_bounds__(A_THREADS, 1)
swa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
                  const __grid_constant__ CUtensorMap mk,     // 64-row
                  const __grid_constant__ CUtensorMap mv,     // 64-row
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int S, int H, int KH, int window, float sl2, float scale) {
  using Sh = BwdShape<HD>;
  constexpr int NB = Sh::NB, NO = NB * 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::DQ_BARS);
  uint64_t* empty = full + B_ST;

  const int nqt = (S + A_BQ - 1) / A_BQ;
  const int head = blockIdx.x % H, b = blockIdx.x / (H * nqt);
  const int q0 = (nqt - 1 - (blockIdx.x / H) % nqt) * A_BQ;
  const int kvh = head / (H / KH);
  const int qend = min(q0 + A_BQ, S) - 1;
  const int lt0 = max(0, q0 - window + 1) / B_ROWS, lt1 = qend / B_ROWS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int lt = lt0; lt <= lt1; ++lt) {
        const int n = lt - lt0, s = n % B_ST;
        uint8_t* st = smem + s * Sh::STAGE;
        if (n >= B_ST) mbar_wait(&empty[s], ((n / B_ST) - 1) & 1);
        mbar_expect_tx(&full[s], Sh::STAGE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_box4(st + c * B_BOX * 2, &mk, &full[s], 64 * c, kvh,
                   lt * B_ROWS, b);
          tma_box4(st + Sh::SMALL + c * B_BOX * 2, &mv, &full[s], 64 * c,
                   kvh, lt * B_ROWS, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows q0 .. +63, warpgroup 2 the next 64 --
    setmaxnreg_inc<240>();
    const int wc = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
    const int qa = q0 + 64 * wc;                 // the warpgroup's first row
    // sacc[4j + 2h + i] is S[row r + 8h][key 8j + cq + i] of the tile
    const int r = qa + 16 * warp + lane / 4, cq = 2 * (lane % 4);
    // q and g of the warpgroup's rows stay in registers as A fragments, so
    // S and dP read only k and v from shared memory
    uint32_t qf[HD / 16][4], gf[HD / 16][4];
    load_a<HD>(qf, q, b, r, cq, S, H, head);
    load_a<HD>(gf, g, b, r, cq, S, H, head);
    float lrow[2], drow[2];                      // past S: P and dS are 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long at = ((long long)b * H + head) * S + r + 8 * h;
      lrow[h] = r + 8 * h < S ? lse[at] : INFINITY;
      drow[h] = r + 8 * h < S ? delta[at] : 0.f;
    }
    float sacc[32], dpacc[32], dqa[NO];
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

    // Tile n: dQ += dS k of tile n - 1 is issued, then S = q k^T and dP =
    // g v^T of tile n, in one turn; dS of tile n is computed once those
    // have completed.  The consumers take turns to issue (named barriers 1
    // and 2, warpgroup 1 first), so one's dS runs under the other's
    // products.  The first tile's S and dP and the last tile's dQ are
    // peeled off, so that no branch lies between a wgmma and the wait that
    // retires it.
    const int turn = 1 + wc, next = 2 - wc;
    if (wc == 1) bar_arrive(1, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
    mbar_wait(&full[0], 0);
    bar_sync(turn, 256);
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
    nt_mma_rs<HD>(sacc, qf, smem);
    nt_mma_rs<HD>(dpacc, gf, smem + Sh::SMALL);
    wgmma_commit();
    bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    q_tile_ds(sacc, dpacc, dsa, lrow, drow, lt0 * B_ROWS, qa, r, cq, window,
              sl2);

    for (int lt = lt0 + 1; lt <= lt1; ++lt) {
      const int n = lt - lt0, s = n % B_ST, sp = (n - 1) % B_ST;
      const uint8_t* skt = smem + s * Sh::STAGE;     // k, then v, of tile n
      const uint8_t* skp = smem + sp * Sh::STAGE;    // of tile n - 1
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
      mbar_wait(&full[s], (n / B_ST) & 1);
      bar_sync(turn, 256);
      fence_regs(sacc);
      fence_regs(dpacc);
      fence_regs(dqa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
      wgmma_fence();
      rs_mma<NB>(dqa, dsa, skp);                   // dQ += dS k
      wgmma_commit();
      nt_mma_rs<HD>(sacc, qf, skt);                // S = q k^T
      nt_mma_rs<HD>(dpacc, gf, skt + Sh::SMALL);   // dP = g v^T
      wgmma_commit();
      bar_arrive(next, 256);
      wgmma_wait<1>();                             // tile n - 1's is done
      fence_regs(dqa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
      if (lane == 0) mbar_arrive(&empty[sp]);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      q_tile_ds(sacc, dpacc, dsa, lrow, drow, lt * B_ROWS, qa, r, cq, window,
                sl2);
    }

    // ---- the last tile's dQ ----------------------------------------------
    bar_sync(turn, 256);
    fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
    wgmma_fence();
    rs_mma<NB>(dqa, dsa, smem + (lt1 - lt0) % B_ST * Sh::STAGE);
    wgmma_commit();
    bar_arrive(next, 256);
    if (wc == 0) bar_sync(1, 256);               // warpgroup 2's last turn
    wgmma_wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
    store_rows<HD>(dq, dqa, b, r, cq, S, H, head, scale);
  }
}

// The two backward kernels' launchers: tensor maps of q, k, v, g in the
// boxes each kernel streams (64 rows) or keeps (128 rows).
template <int HD>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* delta,
                        void* dk, void* dv, int B, int S, int H, int KH,
                        int window, float scale, cudaStream_t st) {
  using Sh = BwdShape<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)((S + A_BK - 1) / A_BK) * KH * B;
  CUtensorMap mq, mk, mv, mg;
  if (blocks > INT_MAX || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(g) || !head_map(&mq, q, B, S, H, HD, B_ROWS) ||
      !head_map(&mk, k, B, S, KH, HD) || !head_map(&mv, v, B, S, KH, HD) ||
      !head_map(&mg, g, B, S, H, HD, B_ROWS))
    return cudaErrorInvalidValue;
  swa_bwd_dkdv_kernel<HD><<<(unsigned)blocks, A_THREADS, Sh::SMEM, st>>>(
      mq, mk, mv, mg, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KH, window, scale * LOG2E, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, int KH, int window,
                      float scale, cudaStream_t st) {
  using Sh = BwdShape<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::DQ_SMEM);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)((S + A_BQ - 1) / A_BQ) * H * B;
  CUtensorMap mk, mv;
  if (blocks > INT_MAX || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(g) || !head_map(&mk, k, B, S, KH, HD, B_ROWS) ||
      !head_map(&mv, v, B, S, KH, HD, B_ROWS))
    return cudaErrorInvalidValue;
  swa_bwd_dq_kernel<HD><<<(unsigned)blocks, A_THREADS, Sh::DQ_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(g), mk, mv, lse,
      delta, static_cast<bf16*>(dq), S, H, KH, window, scale * LOG2E, scale);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel.  dtype: 0 float32, 1 bfloat16.  window >= 1 (the
// caller maps "no window" to S).  lse: [B, H, S] fp32, base 2.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int H,
                                 int KH, int hd, int window, float scale,
                                 int dtype, void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)(dtype == 1
                   ? launch_hd<__nv_bfloat16>(q, k, v, o, l, B, S, H, KH, hd,
                                              window, scale, st)
                   : launch_hd<float>(q, k, v, o, l, B, S, H, KH, hd, window,
                                      scale, st));
}

// The tensor-core kernel: bf16, hd in {64, 112, 128}, 16-byte aligned
// bases.
extern "C" int swa_attention_tc(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int KH, int hd, int window, float scale,
                                void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64:
      return (int)launch_tc<64>(q, k, v, o, l, B, S, H, KH, window, scale, st);
    case 112:                            // zamba2-7b: 3584 / 32 heads
      return (int)launch_tc<112>(q, k, v, o, l, B, S, H, KH, window, scale,
                                 st);
    case 128:
      return (int)launch_tc<128>(q, k, v, o, l, B, S, H, KH, window, scale,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's first step: delta [B, H, S] fp32 = rowsum(g o), bf16 o and
// g [B, S, H, hd], hd in {64, 112, 128}, 16-byte aligned.
extern "C" int swa_bwd_delta(const void* o, const void* g, void* delta, int B,
                             int S, int H, int hd, void* stream) {
  if ((hd != 64 && hd != 112 && hd != 128) || !hopper::aligned16(o) ||
      !hopper::aligned16(g))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * H, blocks = (rows + 15) / 16;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  swa_bwd_delta_kernel<<<(unsigned)blocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(delta), rows, S, H, hd);
  return (int)cudaGetLastError();
}

// dK and dV (bf16 [B, S, KH, hd]) from q, k, v, the output cotangent g, the
// forward's lse and delta; window >= 1 (no pair is farther apart than S).
extern "C" int swa_bwd_dkdv(const void* q, const void* k, const void* v,
                            const void* g, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int S, int H, int KH, int hd, int window,
                            float scale, void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  window = window < S ? window : S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  switch (hd) {
    case 64:
      return (int)launch_dkdv<64>(q, k, v, g, l, d, dk, dv, B, S, H, KH,
                                  window, scale, st);
    case 112:
      return (int)launch_dkdv<112>(q, k, v, g, l, d, dk, dv, B, S, H, KH,
                                   window, scale, st);
    case 128:
      return (int)launch_dkdv<128>(q, k, v, g, l, d, dk, dv, B, S, H, KH,
                                   window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dQ (bf16 [B, S, H, hd]), from the same inputs.
extern "C" int swa_bwd_dq(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dq, int B, int S, int H, int KH, int hd,
                          int window, float scale, void* stream) {
  if (window < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  window = window < S ? window : S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  switch (hd) {
    case 64:
      return (int)launch_dq<64>(q, k, v, g, l, d, dq, B, S, H, KH, window,
                                scale, st);
    case 112:
      return (int)launch_dq<112>(q, k, v, g, l, d, dq, B, S, H, KH, window,
                                 scale, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, g, l, d, dq, B, S, H, KH, window,
                                 scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
