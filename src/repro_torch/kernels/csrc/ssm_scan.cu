// Mamba-1 selective scan: forward (K5) and backward.
//
// The forward replaces the JAX package's Pallas kernel
// src/repro/kernels/ssm_scan.py ssm_scan -> _scan_kernel (K5); the
// backward computes what the JAX package gets from jax.vjp of
// models/layers.py selective_scan (src/repro/kernels/ops.py _ssm_bwd).
// u, dt [B, S, D], b, c [B, S, N] (fp32 or bf16), a [G, D, N] and
// d [G, D] fp32 -> y [B, S, D] in u's dtype:
//   h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) b_t,   y_t = c_t . h_t + d u_t,
// with h in fp32 from h_{-1} = 0.  Batch row i takes a and d of group
// i / bpg (bpg = B / G): the client vmap folds its clients into the batch,
// each with its own a and d; the server has G = 1.  Any N >= 1.
//
// What bounds them on an H100.  The forward: operations, the exponentials.
// Each (b, t, channel, state) needs one exp on the special-function units
// (16 per clock per SM): at B = 1, S = 2048, D = 8192, N = 16 that is 268 M
// exps, 64.2 us at 1.98 GHz on 132 SMs, against 6 fp32 flops (24 us at 67
// TFLOP/s) and about 110 MB of inputs, outputs and saved states in bf16
// (33 us at 3.35 TB/s).  The backward: operations, the fp32 flops.  It
// recomputes the exps (64.2 us) and does 19 fp32 flops an element (the
// recurrence 4, the adjoint 3, the five gradient terms 12: 76.1 us),
// against about 177 MB (53 us).
//
// Layout of the work.  A block owns a slab of 32 channels of one batch row
// (lane = channel: a warp's load of one time step reads 32 consecutive
// channels, 64 contiguous bytes in bf16) and walks time in tiles of
// TT = 128 steps.  Its W = 8 warps split a tile's time: a thread holds
// K = 16 consecutive steps of its channel in registers.  States are looped
// over inside a tile (in groups of at most NG, whose b and c rows are
// staged in shared memory as fp32 [state][step]), so y and the per-step
// gradient sums accumulate in registers and no lane reduction is needed
// for y.  Per (tile, state) a thread computes its K exps once (ex2.approx
// of dt (a log2 e), a log2 e scaled once per channel and state; relative
// error about 2^-22), folds its run into the pair (prod exp(dt a), local
// h) of the associative operator (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2),
// and the warps exchange the pairs through shared memory: each thread
// combines the pairs of the warps before it with the carry from the
// previous tile, then reruns its K steps from that state with the exps it
// kept.  The forward takes two states between barriers (two independent
// chains a pass; an odd state count is paired with a null state).  The
// last warp's final state is the carry into the next tile, and it is
// written out as the tile's boundary state: hs [B, ceil(S/TT), D, N] fp32
// holds h after min((i + 1) TT, S) steps, which the backward starts its
// tiles from.  Both kernels are bound by latency more than by the SFUs (a
// probe on the card that replaced the exps by an FMA barely moved the
// forward): two blocks run on an SM, the backward at 128 registers with a
// small spill, which beat one block of 220 registers in the same probe.
//
// The backward walks each block's tiles from last to first.  Per (tile,
// state) it recomputes the exps and h from the saved state before the
// tile, and runs the adjoint g_t = c_t gy_t + exp(dt_{t+1} a) g_{t+1} by
// the same operator in reverse, carried across tiles; one exchange through
// shared memory serves both directions (three arrays, so a warp reads only
// what it combines: shared memory traffic is a large part of the
// backward's time).  The state before each tile is staged from hs with
// coalesced reads.  du and ddt accumulate over states in registers, da
// over time in shared memory per warp (summed over the warps in order at
// the end), dd = sum_t gy u needs no scan.  db and dc are sums over all D
// channels: a warp sums its 32 channels through a small shared buffer
// (each lane adds 16 of them for one step, two lanes a step), the block
// writes per-slab partials [D/32, B, N, S] fp32 (time innermost, so a
// warp's 16 steps are one 64-byte write), and a second kernel adds them in
// slab order, and da and dd over a group's batch rows in row order.  No
// atomics: every output has one owner and a fixed order of summation, so
// the bits repeat run to run.
//
// Plain C interface (ctypes); the launchers return cudaGetLastError().

#include <algorithm>

#include "hopper.cuh"

namespace {

using hopper::ex2;
using hopper::LOG2E;

constexpr int W = 8;                 // warps of a block, splitting time
constexpr int K = 16;                // consecutive steps a thread holds
constexpr int TT = W * K;            // steps of a tile (128)
constexpr int NT = W * 32;           // threads of a block
constexpr int SLAB = 32;             // channels of a block (lane = channel)
constexpr int NG = 32;               // states staged at a time
constexpr int LDT = TT + 4;          // staged b, c rows: 16-byte aligned
constexpr int LDR = 36;              // a warp's reduction rows (conflict-free)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Element r (0..3, a constant after unrolling) of v.
__device__ __forceinline__ float el(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 quad(const float* p, int q) {
  return reinterpret_cast<const float4*>(p)[q];
}

// b and c of steps t0 .. t0 + TT - 1 and states n0 .. n0 + ng - 1 of the
// batch row starting at `row` (= b S) into Bs, Cs [state][LDT] as fp32, 0
// past S.
template <typename T>
__device__ __forceinline__ void stage_bc(const T* bm, const T* cm, float* Bs,
                                         float* Cs, long long row, int t0,
                                         int S, int N, int n0, int ng) {
  for (int e = threadIdx.x; e < TT * ng; e += NT) {
    const int tt = e / ng, n = e - tt * ng;
    const bool in = t0 + tt < S;
    const long long at = (row + t0 + tt) * N + n0 + n;
    Bs[n * LDT + tt] = in ? ld(bm, at) : 0.f;
    Cs[n * LDT + tt] = in ? ld(cm, at) : 0.f;
  }
}

// Writes v at `at` of `out` when the states come in one group; otherwise
// group gi of ng adds it up in `acc` (fp32) and the last writes the sum.
template <typename T>
__device__ __forceinline__ void put(T* out, float* acc, long long at, float v,
                                    int gi, int ngroups) {
  if (ngroups == 1) st(out, at, v);
  else if (gi == 0) acc[at] = v;
  else if (gi < ngroups - 1) acc[at] += v;
  else st(out, at, acc[at] + v);
}

// States a group stages, rounded up to even: the forward takes its states
// two at a time, the odd one out paired with a null state (a = b = c = 0:
// exp 1, input 0, no output).
__host__ __device__ __forceinline__ int even(int n) { return n + (n & 1); }

size_t fwd_smem(int ngm) {
  // exchange float4 [2][W][32], Bs, Cs [even ngm][LDT], As
  // [even ngm][32], carries [2][even ngm][32]
  return sizeof(float) * (2 * W * 32 * 4 + 2 * even(ngm) * LDT +
                          3 * even(ngm) * 32);
}

// Pass 1 of one state over a thread's run: its K exps, kept, and the run's
// pair (product of the exps, h from 0 at its end).
__device__ __forceinline__ void run_pair(const float* br,
                                         const float (&dtv)[K],
                                         const float (&dtu)[K], float a2,
                                         float (&da)[K], float& p,
                                         float& hl) {
  p = 1.f;
  hl = 0.f;
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 bq = quad(br, q);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      da[j] = ex2(dtv[j] * a2);
      hl = fmaf(da[j], hl, dtu[j] * el(bq, r));
      p *= da[j];
    }
  }
}

// Pass 2 of one state: h through the run from the state before it, y += c h;
// returns h after the run.
__device__ __forceinline__ float run_y(const float* br, const float* cr,
                                       const float (&dtu)[K],
                                       const float (&da)[K], float h,
                                       float (&yv)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 bq = quad(br, q), cq = quad(cr, q);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      h = fmaf(da[j], h, dtu[j] * el(bq, r));
      yv[j] = fmaf(el(cq, r), h, yv[j]);
    }
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssm_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dsk,
               T* __restrict__ y, float* __restrict__ yacc,
               float* __restrict__ hs, int S, int D, int N, int bpg) {
  extern __shared__ __align__(16) float sm[];
  const int ngp = even(min(N, NG));
  float4* Xg = reinterpret_cast<float4*>(sm);      // [2][W][32]
  float* Bs = sm + 2 * W * 32 * 4;                 // [ngp][LDT]
  float* Cs = Bs + ngp * LDT;                      // [ngp][LDT]
  float* As = Cs + ngp * LDT;                      // [ngp][32]: a log2 e
  float* Hc = As + ngp * 32;                       // [2][ngp][32]: carries

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.y, c = blockIdx.x * SLAB + lane;
  const bool cok = c < D;
  const int grp = b / bpg;
  const long long row = (long long)b * S;
  const int nt = (S + TT - 1) / TT, ngroups = (N + NG - 1) / NG;
  const float dv = cok ? dsk[(long long)grp * D + c] : 0.f;

  for (int gi = 0; gi < ngroups; ++gi) {
    const int n0 = gi * NG, ng = min(NG, N - n0);
    __syncthreads();                     // the last group's reads are done
    for (int e = threadIdx.x; e < even(ng) * 32; e += NT) {
      const int n = e >> 5, cc = blockIdx.x * SLAB + (e & 31);
      As[e] = cc < D && n < ng
                  ? a[((long long)grp * D + cc) * N + n0 + n] * LOG2E
                  : 0.f;
      Hc[e] = 0.f;                       // the carry into tile 0
    }
    for (int i = 0; i < nt; ++i) {
      const int ts = i * TT + w * K;     // this thread's first step
      float dtv[K], dtu[K], yv[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool in = cok && ts + j < S;
        const long long at = (row + ts + j) * D + c;
        const float uu = in ? ld(u, at) : 0.f;
        dtv[j] = in ? ld(dt, at) : 0.f;  // 0: exp 1, input 0 (identity)
        dtu[j] = dtv[j] * uu;
        yv[j] = gi == 0 ? dv * uu : 0.f;
      }
      __syncthreads();                   // Bs, Cs of the last tile read
      stage_bc(bm, cm, Bs, Cs, row, i * TT, S, N, n0, ng);
      if (ng & 1)                        // the null state's rows
        for (int e = threadIdx.x; e < TT; e += NT)
          Bs[ng * LDT + e] = Cs[ng * LDT + e] = 0.f;
      __syncthreads();
      const float* hin = Hc + (i & 1) * ngp * 32;
      float* hout = Hc + ((i + 1) & 1) * ngp * 32;
      // two states at a time: two independent chains a pass, one barrier
      for (int n = 0; n < ng; n += 2) {
        const float* br0 = Bs + n * LDT + w * K;
        const float* cr0 = Cs + n * LDT + w * K;
        float da0[K], da1[K], p0, hl0, p1, hl1;
        run_pair(br0, dtv, dtu, As[n * 32 + lane], da0, p0, hl0);
        run_pair(br0 + LDT, dtv, dtu, As[(n + 1) * 32 + lane], da1, p1, hl1);
        float4* x = Xg + ((n >> 1) & 1) * W * 32;
        x[w * 32 + lane] = make_float4(p0, hl0, p1, hl1);
        __syncthreads();
        float h0 = hin[n * 32 + lane], h1 = hin[(n + 1) * 32 + lane];
#pragma unroll
        for (int v = 0; v < W - 1; ++v)
          if (v < w) {
            const float4 e = x[v * 32 + lane];
            h0 = fmaf(e.x, h0, e.y);
            h1 = fmaf(e.z, h1, e.w);
          }
        h0 = run_y(br0, cr0, dtu, da0, h0, yv);
        h1 = run_y(br0 + LDT, cr0 + LDT, dtu, da1, h1, yv);
        if (w == W - 1) {                // h after the tile's last step
          hout[n * 32 + lane] = h0;
          hout[(n + 1) * 32 + lane] = h1;
          if (cok) {
            float* hp = hs + (((long long)b * nt + i) * D + c) * N + n0 + n;
            hp[0] = h0;
            if (n + 1 < ng) hp[1] = h1;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (cok && ts + j < S)
          put(y, yacc, (row + ts + j) * D + c, yv[j], gi, ngroups);
    }
  }
}

size_t bwd_smem(int ngm) {
  // exchange 3 x [2][W][32], reduction [W][2][K][LDR], Bs, Cs
  // [ngm][LDT], As, Ar [ngm][32], carries [2][ngm][32], da partials
  // [W][ngm][32], dd partials [W][32], the state before the tile
  // [ngm][33]
  return sizeof(float) * (3 * 2 * W * 32 + W * 2 * K * LDR + 2 * ngm * LDT +
                          4 * ngm * 32 + W * ngm * 32 + W * 32 + ngm * 33);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssm_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dsk,
               const T* __restrict__ gy, const float* __restrict__ hs,
               T* __restrict__ du, T* __restrict__ ddt,
               float* __restrict__ acc, float* __restrict__ pdb,
               float* __restrict__ pdc, float* __restrict__ pda,
               float* __restrict__ pdd, int S, int D, int N, int bpg) {
  extern __shared__ __align__(16) float sm[];
  const int ngm = min(N, NG);
  float* Xp = sm;                                  // [2][W][32] each:
  float* Xh = Xp + 2 * W * 32;                     // the runs' products,
  float* Xr = Xh + 2 * W * 32;                     // h, adjoints
  float* Rd = Xr + 2 * W * 32;                     // [W][2][K][LDR]
  float* Bs = Rd + W * 2 * K * LDR;                // [ngm][LDT]
  float* Cs = Bs + ngm * LDT;
  float* As = Cs + ngm * LDT;                      // [ngm][32]: a log2 e
  float* Ar = As + ngm * 32;                       // [ngm][32]: a
  float* Gc = Ar + ngm * 32;                       // [2][ngm][32]: carries
  float* Das = Gc + 2 * ngm * 32;                  // [W][ngm][32]
  float* Dds = Das + W * ngm * 32;                 // [W][32]
  float* Hs = Dds + W * 32;                        // [ngm][33]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int B = gridDim.y, b = blockIdx.y, slab = blockIdx.x;
  const int c = slab * SLAB + lane;
  const bool cok = c < D;
  const int grp = b / bpg;
  const long long row = (long long)b * S, bsd = (long long)B * S * D;
  const int nt = (S + TT - 1) / TT, ngroups = (N + NG - 1) / NG;
  const float dv = cok ? dsk[(long long)grp * D + c] : 0.f;
  float* rdb = Rd + (w * 2) * K * LDR;             // this warp's g dt u
  float* rdc = rdb + K * LDR;                      // and gy h
  float ddp = 0.f;                                 // sum of gy u

  for (int gi = 0; gi < ngroups; ++gi) {
    const int n0 = gi * NG, ng = min(NG, N - n0);
    __syncthreads();                     // the last group's reads are done
    for (int e = threadIdx.x; e < ng * 32; e += NT) {
      const int n = e >> 5, cc = slab * SLAB + (e & 31);
      const float av = cc < D ? a[((long long)grp * D + cc) * N + n0 + n]
                              : 0.f;
      As[e] = av * LOG2E;
      Ar[e] = av;
      Gc[((nt - 1) & 1) * ngm * 32 + e] = 0.f;   // the carry from past S
    }
    for (int n = 0; n < ng; ++n) Das[(w * ngm + n) * 32 + lane] = 0.f;
    for (int i = nt - 1; i >= 0; --i) {
      const int ts = i * TT + w * K;
      float dtv[K], dtu[K], gv[K], sgb[K], sgh[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool in = cok && ts + j < S;
        const long long at = (row + ts + j) * D + c;
        const float uu = in ? ld(u, at) : 0.f;
        dtv[j] = in ? ld(dt, at) : 0.f;
        dtu[j] = dtv[j] * uu;
        gv[j] = in ? ld(gy, at) : 0.f;
        if (gi == 0) ddp = fmaf(gv[j], uu, ddp);
        sgb[j] = 0.f;                    // sum_n g b
        sgh[j] = 0.f;                    // sum_n g h_{t-1} exp(dt a) a
      }
      __syncthreads();
      stage_bc(bm, cm, Bs, Cs, row, i * TT, S, N, n0, ng);
      for (int e = threadIdx.x; e < 32 * ng; e += NT) {   // coalesced
        const int l = e / ng, n = e - l * ng, cc = slab * SLAB + l;
        Hs[n * 33 + l] =
            i > 0 && cc < D
                ? hs[(((long long)b * nt + i - 1) * D + cc) * N + n0 + n]
                : 0.f;
      }
      __syncthreads();
      const float* gin = Gc + (i & 1) * ngm * 32;
      float* gout = Gc + ((i + 1) & 1) * ngm * 32;
      for (int n = 0; n < ng; ++n) {
        const float a2 = As[n * 32 + lane], an = Ar[n * 32 + lane];
        const float h0 = Hs[n * 33 + lane];
        const float* br = Bs + n * LDT + w * K;
        const float* cr = Cs + n * LDT + w * K;
        float da[K], p = 1.f, hl = 0.f;
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 bq = quad(br, q);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 4 * q + r;
            da[j] = ex2(dtv[j] * a2);
            hl = fmaf(da[j], hl, dtu[j] * el(bq, r));
            p *= da[j];
          }
        }
        float rl = 0.f;                  // the run's adjoint from 0
#pragma unroll
        for (int q = K / 4 - 1; q >= 0; --q) {
          const float4 cq = quad(cr, q);
#pragma unroll
          for (int r = 3; r >= 0; --r) {
            const int j = 4 * q + r;
            rl = da[j] * fmaf(el(cq, r), gv[j], rl);
          }
        }
        const int xo = (n & 1) * W * 32 + lane;
        Xp[xo + w * 32] = p;
        Xh[xo + w * 32] = hl;
        Xr[xo + w * 32] = rl;
        __syncthreads();
        float h = h0, g = gin[n * 32 + lane];
#pragma unroll
        for (int v = 0; v < W - 1; ++v)
          if (v < w) h = fmaf(Xp[xo + v * 32], h, Xh[xo + v * 32]);
#pragma unroll
        for (int v = W - 1; v > 0; --v)
          if (v > w) g = fmaf(Xp[xo + v * 32], g, Xr[xo + v * 32]);
        // forward: h_{t-1} kept, gy h_t for dc
        float hp[K];
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 bq = quad(br, q);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 4 * q + r;
            hp[j] = h;
            h = fmaf(da[j], h, dtu[j] * el(bq, r));
            rdc[j * LDR + lane] = gv[j] * h;
          }
        }
        // reverse: g_t, and every term that needs it
        float dan = 0.f;
#pragma unroll
        for (int q = K / 4 - 1; q >= 0; --q) {
          const float4 bq = quad(br, q), cq = quad(cr, q);
#pragma unroll
          for (int r = 3; r >= 0; --r) {
            const int j = 4 * q + r;
            const float gt = fmaf(el(cq, r), gv[j], g);
            g = da[j] * gt;
            sgb[j] = fmaf(gt, el(bq, r), sgb[j]);
            const float wv = gt * hp[j] * da[j];
            sgh[j] = fmaf(wv, an, sgh[j]);
            dan = fmaf(wv, dtv[j], dan);
            rdb[j * LDR + lane] = gt * dtu[j];
          }
        }
        if (w == 0) gout[n * 32 + lane] = g;     // into the tile before
        Das[(w * ngm + n) * 32 + lane] += dan;
        __syncwarp();
        // this warp's 32 channels summed for each of its K steps: lanes
        // 2j and 2j + 1 add 16 channels each of step j, then swap
        const int jj = lane >> 1, half = lane & 1;
        const float* pb = rdb + jj * LDR + half * 16;
        const float* pc = rdc + jj * LDR + half * 16;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 vb = quad(pb, q), vc = quad(pc, q);
          sb += (vb.x + vb.y) + (vb.z + vb.w);
          sc += (vc.x + vc.y) + (vc.z + vc.w);
        }
        const float ob = __shfl_xor_sync(FULL, sb, 1);
        const float oc = __shfl_xor_sync(FULL, sc, 1);
        sb = half ? ob + sb : sb + ob;   // the same order on both lanes
        sc = half ? oc + sc : sc + oc;
        if (ts + jj < S) {
          const long long at =
              (((long long)slab * B + b) * N + n0 + n) * S + ts + jj;
          if (half) pdc[at] = sc;
          else pdb[at] = sb;
        }
        __syncwarp();                    // the buffers are free again
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!cok || ts + j >= S) continue;
        const long long at = (row + ts + j) * D + c;
        const float gdu = fmaf(dtv[j], sgb[j], gi == 0 ? dv * gv[j] : 0.f);
        const float gdt = fmaf(ld(u, at), sgb[j], sgh[j]);
        put(du, acc, at, gdu, gi, ngroups);
        put(ddt, acc == nullptr ? nullptr : acc + bsd, at, gdt, gi,
            ngroups);
      }
    }
    __syncthreads();                     // every warp's da partials added
    for (int e = threadIdx.x; e < ng * 32; e += NT) {
      const int n = e >> 5, l = e & 31, cc = slab * SLAB + l;
      float s = 0.f;
      for (int v = 0; v < W; ++v) s += Das[(v * ngm + n) * 32 + l];
      if (cc < D) pda[((long long)b * D + cc) * N + n0 + n] = s;
    }
  }
  Dds[w * 32 + lane] = ddp;
  __syncthreads();
  if (w == 0 && cok) {
    float s = 0.f;
    for (int v = 0; v < W; ++v) s += Dds[v * 32 + lane];
    pdd[(long long)b * D + c] = s;
  }
}

// db, dc [B, S, N] = the slab partials [slabs, B, N, S] summed in slab
// order; da [G, D, N] and dd [G, D] = the row partials of each group
// summed in row order.
template <typename T>
__global__ void __launch_bounds__(256)
ssm_bwd_sum_kernel(const float* __restrict__ pdb,
                   const float* __restrict__ pdc,
                   const float* __restrict__ pda,
                   const float* __restrict__ pdd, T* __restrict__ db,
                   T* __restrict__ dc, float* __restrict__ da,
                   float* __restrict__ dd, int B, int S, int D, int N,
                   int bpg, int nslab) {
  const long long bsn = (long long)B * S * N, dn = (long long)D * N;
  const long long G = B / bpg, total = 2 * bsn + G * dn + G * D;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < 2 * bsn) {
      const bool isc = e >= bsn;
      const long long f = isc ? e - bsn : e;   // (b, n, t): reads coalesce
      const float* p = isc ? pdc : pdb;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < nslab; ++k) s += p[k * bsn + f];
      const long long bn = f / S, t = f - bn * S, bb = bn / N;
      st(isc ? dc : db, (bb * S + t) * N + (bn - bb * N), s);
    } else if (e < 2 * bsn + G * dn) {
      const long long f = e - 2 * bsn, g = f / dn, r = f - g * dn;
      float s = 0.f;
      for (int k = 0; k < bpg; ++k) s += pda[(g * bpg + k) * dn + r];
      da[f] = s;
    } else {
      const long long f = e - 2 * bsn - G * dn, g = f / D, r = f - g * D;
      float s = 0.f;
      for (int k = 0; k < bpg; ++k) s += pdd[(g * bpg + k) * D + r];
      dd[f] = s;
    }
  }
}

// The dynamic shared memory limit is raised once per instance, before any
// graph capture.
template <typename T>
cudaError_t fwd(const void* u, const void* dt, const float* a, const void* b,
                const void* c, const float* d, void* y, float* yacc,
                float* hs, int B, int S, int D, int N, int bpg,
                cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_smem(NG));
  if (attr != cudaSuccess) return attr;
  dim3 grid((D + SLAB - 1) / SLAB, B);
  ssm_fwd_kernel<T><<<grid, NT, fwd_smem(std::min(N, NG)), st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d,
      static_cast<T*>(y), yacc, hs, S, D, N, bpg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* u, const void* dt, const float* a, const void* b,
                const void* c, const float* d, const void* gy,
                const float* hs, void* du, void* ddt, float* acc, float* pdb,
                float* pdc, float* pda, float* pdd, int B, int S, int D,
                int N, int bpg, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem(NG));
  if (attr != cudaSuccess) return attr;
  const size_t smem = bwd_smem(std::min(N, NG));
  ssm_bwd_kernel<T><<<dim3((D + SLAB - 1) / SLAB, B), NT, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d,
      static_cast<const T*>(gy), hs, static_cast<T*>(du),
      static_cast<T*>(ddt), acc, pdb, pdc, pda, pdd, S, D, N, bpg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_sum(const float* pdb, const float* pdc, const float* pda,
                    const float* pdd, void* db, void* dc, float* da,
                    float* dd, int B, int S, int D, int N, int bpg,
                    cudaStream_t st) {
  const long long total =
      2LL * B * S * N + (long long)(B / bpg) * D * (N + 1);
  // one element a thread; the loop in the kernel covers a grid past its
  // x limit
  const int blocks = (int)std::min<long long>((total + 255) / 256, 0x7fffffff);
  ssm_bwd_sum_kernel<T><<<blocks, 256, 0, st>>>(
      pdb, pdc, pda, pdd, static_cast<T*>(db), static_cast<T*>(dc), da, dd,
      B, S, D, N, bpg, (D + SLAB - 1) / SLAB);
  return cudaGetLastError();
}

bool shapes_ok(int B, int S, int D, int N, int bpg) {
  return B >= 1 && B <= 65535 && S >= 1 && D >= 1 && N >= 1 && bpg >= 1 &&
         B % bpg == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (u, dt, b, c and y); a, d float32.  yacc
// [B, S, D] fp32 is needed where N > 32 (else null); hs [B, ceil(S/128),
// D, N] fp32 receives the boundary states.
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const float* a,
                            const void* b, const void* c, const float* d,
                            void* y, float* yacc, float* hs, int B, int S,
                            int D, int N, int bpg, int dtype, void* stream) {
  if (!shapes_ok(B, S, D, N, bpg) || hs == nullptr ||
      (N > NG && yacc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? fwd<__nv_bfloat16>(u, dt, a, b, c, d, y, yacc, hs, B, S,
                                        D, N, bpg, st)
                   : fwd<float>(u, dt, a, b, c, d, y, yacc, hs, B, S, D, N,
                                bpg, st));
}

// The backward's scan kernel: du, ddt [B, S, D] in u's dtype from the
// cotangent gy and the forward's boundary states hs, and the partials the
// second kernel adds: pdb, pdc [ceil(D/32), B, N, S] (db and dc of each
// 32-channel slab), pda [B, D, N] and pdd [B, D] (da and dd of each batch
// row), fp32.  acc [2, B, S, D] fp32 is needed where N > 32 (else null).
extern "C" int ssm_scan_bwd(const void* u, const void* dt, const float* a,
                            const void* b, const void* c, const float* d,
                            const void* gy, const float* hs, void* du,
                            void* ddt, float* acc, float* pdb, float* pdc,
                            float* pda, float* pdd, int B, int S, int D,
                            int N, int bpg, int dtype, void* stream) {
  if (!shapes_ok(B, S, D, N, bpg) || hs == nullptr ||
      (N > NG && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? bwd<__nv_bfloat16>(u, dt, a, b, c, d, gy, hs, du, ddt,
                                        acc, pdb, pdc, pda, pdd, B, S, D, N,
                                        bpg, st)
                   : bwd<float>(u, dt, a, b, c, d, gy, hs, du, ddt, acc, pdb,
                                pdc, pda, pdd, B, S, D, N, bpg, st));
}

// The backward's second kernel: db, dc [B, S, N] in the dtype (0 float32,
// 1 bfloat16) from the slab partials, summed in slab order; da [G, D, N]
// and dd [G, D] fp32 from the row partials, each group's rows in order.
extern "C" int ssm_scan_bwd_sum(const float* pdb, const float* pdc,
                                const float* pda, const float* pdd, void* db,
                                void* dc, float* da, float* dd, int B, int S,
                                int D, int N, int bpg, int dtype,
                                void* stream) {
  if (!shapes_ok(B, S, D, N, bpg)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? bwd_sum<__nv_bfloat16>(pdb, pdc, pda, pdd, db, dc, da,
                                            dd, B, S, D, N, bpg, st)
                   : bwd_sum<float>(pdb, pdc, pda, pdd, db, dc, da, dd, B, S,
                                    D, N, bpg, st));
}
