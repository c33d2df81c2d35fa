// Reverse-time VJP of the channel-wise rollout in one launch, plus a small
// kernel that sums the blocks' partial weight gradients.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_channelwise.py:_bwd_kernel
// (:370), launched by _vjp_bwd (pallas_call at :580). It computes the same
// function in float32 with float32 accumulation (no TF32, no tensor cores),
// without the TPU's grid, time blocking or bf16 mode. Per batch row, for
// t = T-2 down to 0, with x_t = sol[t] and the carry gx_c (zero at first):
//
//   gX1 = cot[t+1] + gx_c
//   recompute the stage points of the Euler / Midpoint / RK4-3/8 step, then
//   for each stage in the cotangent order of fused_channelwise.py:434-471
//   recompute its evaluation right before its VJP (as _cw_bwd_eval :290),
//   g_fz[t] = sum over stages of the z-channels' cotangents,
//   g_s_constV += sum over stages of the folded first layer's cotangent,
//   gx_c = dL/dx_t
//
// and the gradients of every weight and bias accumulate over all rows and
// steps. g_x0 is the carry after step 0 (the wrapper adds cot[0]).
//
// Where the residuals live. A stage's activations a1 and a2 ([h, h] each)
// stay in the two shared-memory tiles of the forward evaluation; the
// backward overwrites each activation tile with the cotangent of its
// pre-activation (elu' is computed from the activation: 1 above 0, a + 1
// below), and recomputes a0 = elu(V A + s_constV) from the small ft when it
// needs it, so no third tile is kept. Per-channel activations ([xd, h]) stay
// in shared memory. The block's partial gradients are one row in global
// memory (L2): 2 (h^2 + h) + C h + (h + 1) xd + 4 xd (h^2 + h) floats, 0.66
// MB at h=128, xd=2 and 0.93 MB at xd=3 (59 MB at B=64, more than the 50
// MB L2, so part of it goes to device memory). The dense weights' grads are
// added per stage from the register tiles of a^T g products; the per-channel
// nets' grads, rank-one per stage, are added once per step for all its
// stages from the vectors kept in a per-block scratch in global memory. The
// row's s_constV cotangent [h, h] is the block's own, so it needs no
// reduction. reduce_partials sums the blocks' rows in block order: each
// accumulator is only touched by one thread, in step order, so the result is
// bit-identical from run to run, with no atomics.
//
// Bound on an H100 SXM: a stage's VJP recomputes its evaluation (2 h^3
// multiply-adds in the two big products, plus a0 again) and backpropagates
// it (four h^3 products: two weight grads, two cotangents), about 6 h^3 +
// O(xd h^2) multiply-adds, 26 MFLOP at h=128; RK4 adds three forward-only
// evaluations a step. At B=64 over 1000 steps: Euler 1.7, Midpoint 4.0, RK4
// 8.5 TFLOP, 25 / 59 / 127 ms at the card's 67 TFLOP/s of float32, against
// well under a millisecond for the bytes that must move. Bound by
// arithmetic, like the forward.
//
// Design: one block of 256 threads per batch row walks all steps (csrc/
// cw_tile.cuh for the tiles and the per-channel products).

#include "cw_tile.cuh"

namespace {

constexpr int kStages = 4;  // RK4's; Euler uses 1, Midpoint 2
constexpr int kPairs = 4;   // rank-one gradient pairs of the per-channel nets

// Offsets of each gradient in one block's row of partials, in the order of
// flatten_weights (ops/fused_channelwise.py).
struct GradOffsets {
  long long a, w1, b1, w2, b2, w3, b3, ew0, eb0, ew1, eb1, hw0, hb0, hw1, hb1, total;
};

GradOffsets grad_offsets(int h, int xd, int zd) {
  GradOffsets o{};
  const long long hh = static_cast<long long>(h) * h, C = xd + zd;
  long long off = 0;
  auto take = [&](long long n) {
    const long long at = off;
    off += n;
    return at;
  };
  o.a = take(C * h);
  o.w1 = take(hh);
  o.b1 = take(h);
  o.w2 = take(hh);
  o.b2 = take(h);
  o.w3 = take(static_cast<long long>(h) * xd);
  o.b3 = take(xd);
  o.ew0 = take(xd * hh);
  o.eb0 = take(static_cast<long long>(xd) * h);
  o.ew1 = take(xd * hh);
  o.eb1 = take(static_cast<long long>(xd) * h);
  o.hw0 = take(xd * hh);
  o.hb0 = take(static_cast<long long>(xd) * h);
  o.hw1 = take(xd * hh);
  o.hb1 = take(static_cast<long long>(xd) * h);
  o.total = off;
  return o;
}

// Floats of one block's scratch: per stage, the kPairs (u, v) vector pairs
// of [xd, h] whose outer products are the per-channel nets' weight grads.
long long scratch_floats(int h, int xd) {
  return static_cast<long long>(kStages) * kPairs * 2 * xd * h;
}

// The transposed weights the cotangent products read.
struct NetT {
  const float* w1t;   // [h, h]
  const float* w2t;   // [h, h]
  const float* ew0t;  // [xd, h, h], each channel's matrix transposed
  const float* ew1t;
  const float* hw0t;
  const float* hw1t;
};

struct Args {
  const float* fz;    // [tm1, batch, zd, h]
  const float* dt;    // [tm1, batch]
  const float* sv;    // [batch, h, h]
  const float* sol;   // [tm1 + 1, batch, xd, h]
  const float* cot;   // [tm1 + 1, batch, xd, h]
  Net w;
  NetT wt;
  float* g_fz;        // [tm1, batch, zd, h]
  float* g_sv;        // [batch, h, h]
  float* partial;     // [batch, off.total], zeroed by the caller
  float* g_w;         // [off.total]
  float* g_x0;        // [batch, xd, h]
  float* scratch;     // [batch, scratch_floats]
  GradOffsets off;
  long long scratch_n;
  int tm1, batch, h, xd, zd, solver;
};

// Shared memory of the backward beyond EvalSmem.
struct BwdSmem {
  float* gft;  // [C][h]: cotangent of the channel features
  float* y;    // [xd][h]: a recomputed output (not read)
  float* ghe;  // [xd][h]: cotangent of the head's first pre-activation
  float* go;   // [xd][h]: cotangent of the vertical output
  float* gep;  // [xd][h]: cotangent of ext's first pre-activation
  float* gfz;  // [zd][h]: the step's g_fz, summed over stages
};

// P[k * n + j] += sum_{q < nq} u_q[k] v_q[j] (K x n), or with u null
// P[j] += sum_q v_q[j]. Thread e owns entries e, e + kThreads, ...: the
// same thread every step.
__device__ void accumulate(float* __restrict__ P, int K, int n, const float* const* u,
                           const float* const* v, int nq) {
  constexpr int kU = 8;  // accumulators in flight per thread
  const int KN = u ? K * n : n;
  for (int e0 = threadIdx.x; e0 < KN; e0 += kU * kThreads) {
    float acc[kU];
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * kThreads;
      acc[s] = e < KN ? P[e] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * kThreads;
      if (e < KN) {
        const int k = u ? e / n : 0, j = e - k * n;
        float inc = 0.f;  // the step's sum, added to the partial once
        for (int q = 0; q < nq; ++q) inc = u ? fmaf(u[q][k], v[q][j], inc) : inc + v[q][j];
        acc[s] += inc;
      }
    }
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * kThreads;
      if (e < KN) P[e] = acc[s];
    }
  }
}

// P += ta^T tb over the positions, P a dense weight's partial gradient
// [h, h] (row k = input). The stage's product is summed from zero and added
// to P once: summed on top of P, each of its h products would round at P's
// magnitude, which grows over the 1000-4000 stages a row adds.
__device__ __forceinline__ void add_weight_grad(float* __restrict__ P, int h, const float* ta,
                                                const float* tb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
  gemm_tt(ta, tb, h, acc);
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int m = ty + 16 * i, col = tx + 16 * j;
      if (m < h && col < h) P[m * h + col] += acc[i][j];
    }
}

// db[j] += sum_{l < h} t[j * kLdt + l]: a bias grad from a cotangent tile.
__device__ __forceinline__ void add_bias_grad(float* __restrict__ db, int h, const float* t) {
  for (int j = threadIdx.x; j < h; j += kThreads) {
    float sum = 0.f;
    for (int l = 0; l < h; ++l) sum += t[j * kLdt + l];
    db[j] += sum;
  }
}

// The VJP of one evaluation at xs with output cotangent gy (both [xd][h],
// published): recomputes the evaluation, adds the vertical net's and a's
// weight grads into the block's partials Pb, the row's s_constV cotangent
// into gsv, this stage's z cotangent into b.gfz, writes g_x = dL/dxs into gx
// and the stage's per-channel (u, v) pairs into scr. Ends with a barrier.
__device__ __noinline__ void eval_bwd(const Args& a, const EvalSmem& s, const BwdSmem& b,
                                      const float* xs, const float* gy, const float* fz_t,
                                      const float* sv, float* __restrict__ gsv,
                                      float* __restrict__ Pb, float* __restrict__ scr, float* gx) {
  const int h = a.h, xd = a.xd, zd = a.zd, C = xd + zd, n = xd * h, tid = threadIdx.x;
  const Net& w = a.w;
  const NetT& wt = a.wt;
  float acc[kR][kR];
  eval_fwd(w, s, h, xd, zd, xs, fz_t, sv, b.y);  // t1 = a2, t2 = a1

  // head: ghe = (gy H1^T) * elu'(HE), go = ghe H0^T
  gemv_ch(gy, h, xd, h, wt.hw1t, nullptr, b.ghe, h, h, false, s.he);
  __syncthreads();
  gemv_ch(b.ghe, h, xd, h, wt.hw0t, nullptr, b.go, h, h, false, nullptr);
  __syncthreads();

  // last vertical layer: dW3[k][c] += sum_l a2[l][k] go[c][l], db3
  for (int o = tid; o < h * xd; o += kThreads) {
    const int k = o / xd, c = o - k * xd;
    float sum = 0.f;
    for (int l = 0; l < h; ++l) sum = fmaf(s.t1[k * kLdt + l], b.go[c * h + l], sum);
    Pb[a.off.w3 + o] += sum;
  }
  for (int c = tid; c < xd; c += kThreads) {
    float sum = 0.f;
    for (int l = 0; l < h; ++l) sum += b.go[c * h + l];
    Pb[a.off.b3 + c] += sum;
  }
  __syncthreads();
  // t1: a2 -> g_P2 = (go W3^T) * elu'(a2), in place
  for (int o = tid; o < h * h; o += kThreads) {
    const int k = o / h, l = o - k * h;
    float g = 0.f;
    for (int c = 0; c < xd; ++c) g = fmaf(b.go[c * h + l], __ldg(w.w3 + k * xd + c), g);
    float* p = s.t1 + k * kLdt + l;
    *p = g * delu_act(*p);
  }
  __syncthreads();
  add_weight_grad(Pb + a.off.w2, h, s.t2, s.t1);  // dW2 += a1^T g_P2
  add_bias_grad(Pb + a.off.b2, h, s.t1);
  __syncthreads();
  gemm_tw(s.t1, h, wt.w2t, h, s.wbuf, acc);  // t2: a1 -> g_P1
  store_bwd(acc, h, s.t2);
  __syncthreads();
  gemm_tw(s.ft, C, w.a, h, s.wbuf, acc);  // t1 = a0 again
  store_fwd(acc, h, nullptr, sv, s.t1);
  __syncthreads();
  add_weight_grad(Pb + a.off.w1, h, s.t1, s.t2);  // dW1 += a0^T g_P1
  add_bias_grad(Pb + a.off.b1, h, s.t2);
  __syncthreads();
  gemm_tw(s.t2, h, wt.w1t, h, s.wbuf, acc);  // t1: a0 -> g_P0
  store_bwd(acc, h, s.t1);
  __syncthreads();

  // the folded first layer: g_s_constV[l][j] += g_P0[l][j],
  // dA[c][j] += sum_l ft[c][l] g_P0[l][j], gft[c][l] = sum_j g_P0[l][j] A[c][j]
  for (int o = tid; o < h * h; o += kThreads) {
    const int l = o / h, j = o - l * h;
    gsv[o] += s.t1[j * kLdt + l];
  }
  for (int o = tid; o < C * h; o += kThreads) {
    const int c = o / h, j = o - c * h;
    float da = 0.f, g = 0.f;
    for (int l = 0; l < h; ++l) da = fmaf(s.ft[c * kLdt + l], s.t1[j * kLdt + l], da);
    // here j is the position l of gft and l the feature j of g_P0
    for (int f = 0; f < h; ++f) g = fmaf(s.t1[f * kLdt + j], __ldg(w.a + c * h + f), g);
    Pb[a.off.a + o] += da;
    b.gft[o] = g;
  }
  __syncthreads();
  for (int o = tid; o < zd * h; o += kThreads) b.gfz[o] += b.gft[n + o];

  // ext: gep = (gft[:xd] E1^T) * elu'(E), gx = gep E0^T
  gemv_ch(b.gft, h, xd, h, wt.ew1t, nullptr, b.gep, h, h, false, s.e);
  __syncthreads();
  gemv_ch(b.gep, h, xd, h, wt.ew0t, nullptr, gx, h, h, false, nullptr);

  // the per-channel nets' rank-one pairs (u, v): head W1, head W0, ext W1,
  // ext W0, in the order of the partial row's offsets
  const float* pairs[kPairs][2] = {{s.he, gy}, {s.ot, b.ghe}, {s.e, b.gft}, {xs, b.gep}};
  for (int q = 0; q < kPairs; ++q)
    for (int r = 0; r < 2; ++r)
      for (int e = tid; e < n; e += kThreads) scr[(2 * q + r) * n + e] = pairs[q][r][e];
  __syncthreads();
}

// Adds the per-channel nets' weight and bias grads of a step's nq stages
// from the scratch pairs into the block's partials.
__device__ void add_channel_grads(const Args& a, float* __restrict__ Pb, const float* scr,
                                  int nq) {
  const int h = a.h, xd = a.xd, n = xd * h;
  const long long hh = static_cast<long long>(h) * h;
  // pair q's (W offset, b offset), in the order eval_bwd writes the pairs
  const long long wo[kPairs] = {a.off.hw1, a.off.hw0, a.off.ew1, a.off.ew0};
  const long long bo[kPairs] = {a.off.hb1, a.off.hb0, a.off.eb1, a.off.eb0};
  for (int q = 0; q < kPairs; ++q) {
    for (int c = 0; c < xd; ++c) {
      const float* u[kStages];
      const float* v[kStages];
      for (int st = 0; st < nq; ++st) {
        const float* base = scr + static_cast<long long>(st) * kPairs * 2 * n;
        u[st] = base + (2 * q) * n + c * h;
        v[st] = base + (2 * q + 1) * n + c * h;
      }
      accumulate(Pb + wo[q] + c * hh, h, h, u, v, nq);
      accumulate(Pb + bo[q] + c * h, 1, h, nullptr, v, nq);
    }
  }
}

size_t smem_floats(int h, int xd, int zd) {
  const size_t xdh = static_cast<size_t>(xd) * h, C = xd + zd;
  // t1, t2, wbuf, ft; e, ot, he; gft, gfz; y, ghe, go, gep;
  // xc, x2, x3, x4, k1, k2, k3, gX1, gxc, gk1, gk2, gk3, gy, tx
  return 2 * static_cast<size_t>(kTile) + 2 * kChunk + C * kLdt + 3 * xdh + C * h +
         static_cast<size_t>(zd) * h + 4 * xdh + 14 * xdh;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_cw_rollout_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x, tid = threadIdx.x;
  const int n = xd * h, C = xd + zd;
  EvalSmem s;
  BwdSmem b;
  float* p = smem;
  s.t1 = p;    p += kTile;
  s.t2 = p;    p += kTile;
  s.wbuf = p;  p += 2 * kChunk;
  s.ft = p;    p += C * kLdt;
  s.e = p;     p += n;
  s.ot = p;    p += n;
  s.he = p;    p += n;
  b.gft = p;   p += C * h;
  b.gfz = p;   p += zd * h;
  b.y = p;     p += n;
  b.ghe = p;   p += n;
  b.go = p;    p += n;
  b.gep = p;   p += n;
  float* xc = p;   p += n;  // x_t, the first stage's input
  float* x2 = p;   p += n;  // RK4's (Midpoint's) further stage inputs
  float* x3 = p;   p += n;
  float* x4 = p;   p += n;
  float* k1 = p;   p += n;  // stage outputs
  float* k2 = p;   p += n;
  float* k3 = p;   p += n;
  float* gX1 = p;  p += n;  // cotangent of x_{t+1}
  float* gxc = p;  p += n;  // the carry, then dL/dx_t of the step
  float* gk1 = p;  p += n;
  float* gk2 = p;  p += n;
  float* gk3 = p;  p += n;
  float* gy = p;   p += n;  // the next stage's output cotangent
  float* tx = p;            // g_x of one stage's VJP

  for (int e = tid; e < 2 * kTile; e += kThreads) smem[e] = 0.f;
  for (int e = tid; e < n; e += kThreads) gxc[e] = 0.f;
  const size_t hh = static_cast<size_t>(h) * h;
  const float* sv = a.sv + row * hh;
  float* gsv = a.g_sv + row * hh;
  for (size_t e = tid; e < hh; e += kThreads) gsv[e] = 0.f;
  float* Pb = a.partial + static_cast<size_t>(row) * a.off.total;
  float* scr = a.scratch + static_cast<size_t>(row) * a.scratch_n;
  const long long slot = static_cast<long long>(kPairs) * 2 * n;  // one stage's pairs
  const int S = a.solver == 0 ? 1 : (a.solver == 1 ? 2 : 4);
  __syncthreads();

  for (int t = a.tm1 - 1; t >= 0; --t) {
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
    for (int e = tid; e < n; e += kThreads) {
      xc[e] = a.sol[step * n + e];
      gX1[e] = a.cot[(step + B) * n + e] + gxc[e];
    }
    for (int e = tid; e < zd * h; e += kThreads) b.gfz[e] = 0.f;
    __syncthreads();

    if (a.solver == 0) {  // Euler: x1 = x + dt f(x)
      for (int e = tid; e < n; e += kThreads) gy[e] = dt * gX1[e];
      __syncthreads();
      eval_bwd(a, s, b, xc, gy, fz_t, sv, gsv, Pb, scr, tx);
      for (int e = tid; e < n; e += kThreads) gxc[e] = gX1[e] + tx[e];
    } else if (a.solver == 1) {  // Midpoint: x1 = x + dt f(x + (dt/2) f(x))
      eval_fwd(a.w, s, h, xd, zd, xc, fz_t, sv, k1);
      for (int e = tid; e < n; e += kThreads) {
        x2[e] = xc[e] + k1[e] * (0.5f * dt);
        gy[e] = dt * gX1[e];
      }
      __syncthreads();
      eval_bwd(a, s, b, x2, gy, fz_t, sv, gsv, Pb, scr, tx);  // tx = g_xmid
      for (int e = tid; e < n; e += kThreads) {
        gy[e] = (0.5f * dt) * tx[e];
        gxc[e] = gX1[e] + tx[e];
      }
      __syncthreads();
      eval_bwd(a, s, b, xc, gy, fz_t, sv, gsv, Pb, scr + slot, tx);
      for (int e = tid; e < n; e += kThreads) gxc[e] += tx[e];
    } else {  // RK4, Kutta's 3/8 rule
      eval_fwd(a.w, s, h, xd, zd, xc, fz_t, sv, k1);
      for (int e = tid; e < n; e += kThreads) x2[e] = xc[e] + dt * k1[e] * kOneThird;
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, x2, fz_t, sv, k2);
      for (int e = tid; e < n; e += kThreads) x3[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, x3, fz_t, sv, k3);
      const float c = dt * 0.125f;
      for (int e = tid; e < n; e += kThreads) {
        x4[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
        gk1[e] = gX1[e] * c;
        gk2[e] = 3.0f * gX1[e] * c;
        gk3[e] = 3.0f * gX1[e] * c;
        gy[e] = gX1[e] * c;  // g_k4
        gxc[e] = gX1[e];
      }
      __syncthreads();
      eval_bwd(a, s, b, x4, gy, fz_t, sv, gsv, Pb, scr, tx);  // g_a4
      for (int e = tid; e < n; e += kThreads) {
        const float g = tx[e];
        gxc[e] += g;
        gk1[e] += dt * g;
        gk2[e] -= dt * g;
        gy[e] = gk3[e] + dt * g;  // final g_k3
      }
      __syncthreads();
      eval_bwd(a, s, b, x3, gy, fz_t, sv, gsv, Pb, scr + slot, tx);  // g_a3
      for (int e = tid; e < n; e += kThreads) {
        const float g = tx[e];
        gxc[e] += g;
        gy[e] = gk2[e] + dt * g;  // final g_k2
        gk1[e] -= dt * g * kOneThird;
      }
      __syncthreads();
      eval_bwd(a, s, b, x2, gy, fz_t, sv, gsv, Pb, scr + 2 * slot, tx);  // g_a2
      for (int e = tid; e < n; e += kThreads) {
        const float g = tx[e];
        gxc[e] += g;
        gy[e] = gk1[e] + dt * g * kOneThird;  // final g_k1
      }
      __syncthreads();
      eval_bwd(a, s, b, xc, gy, fz_t, sv, gsv, Pb, scr + 3 * slot, tx);  // g_a1
      for (int e = tid; e < n; e += kThreads) gxc[e] += tx[e];
    }
    for (int e = tid; e < zd * h; e += kThreads) a.g_fz[step * zd * h + e] = b.gfz[e];
    add_channel_grads(a, Pb, scr, S);
    __syncthreads();
  }

  for (int e = tid; e < n; e += kThreads) a.g_x0[static_cast<size_t>(row) * n + e] = gxc[e];
}

// g_w[e] = sum over blocks b, in order, of partial[b, e].
__global__ void reduce_partials(const float* __restrict__ partial, int blocks, long long total,
                                float* __restrict__ g_w) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<size_t>(b) * total + e];
  g_w[e] = acc;
}

}  // namespace

// sizes[0]: floats in one row of partial gradients (and in g_w); sizes[1]:
// floats of one block's scratch.
extern "C" void psn_fused_cw_bwd_sizes(int h, int xd, int zd, long long* sizes) {
  sizes[0] = grad_offsets(h, xd, zd).total;
  sizes[1] = scratch_floats(h, xd);
}

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; w is a host array of the 15 weight pointers in
// the order of flatten_weights, wt one of the 6 transposes of
// transposed_weights (ops/fused_channelwise_vjp.py). `partial` is [batch,
// sizes[0]] and must be zero; g_w receives the summed gradients in the same
// layout; scratch is [batch, sizes[1]]. solver: 0 Euler, 1 Midpoint, 2 RK4
// (3/8 rule). Launches both kernels on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int psn_fused_cw_rollout_bwd_f32(
    const void* fz, const void* dt, const void* sv, const void* sol, const void* cot,
    const void* const* w, const void* const* wt, void* g_fz, void* g_sv, void* partial,
    void* g_w, void* g_x0, void* scratch, int tm1, int batch, int h, int xd, int zd, int solver,
    void* stream) {
  if (tm1 < 1 || batch < 1 || h < 1 || h > kMaxH || xd < 1 || zd < 0 || solver < 0 || solver > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.fz = static_cast<const float*>(fz);
  a.dt = static_cast<const float*>(dt);
  a.sv = static_cast<const float*>(sv);
  a.sol = static_cast<const float*>(sol);
  a.cot = static_cast<const float*>(cot);
  a.w = net_from(w);
  const float* const* t = reinterpret_cast<const float* const*>(wt);
  a.wt = NetT{t[0], t[1], t[2], t[3], t[4], t[5]};
  a.g_fz = static_cast<float*>(g_fz);
  a.g_sv = static_cast<float*>(g_sv);
  a.partial = static_cast<float*>(partial);
  a.g_w = static_cast<float*>(g_w);
  a.g_x0 = static_cast<float*>(g_x0);
  a.scratch = static_cast<float*>(scratch);
  a.off = grad_offsets(h, xd, zd);
  a.scratch_n = scratch_floats(h, xd);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.zd = zd;
  a.solver = solver;
  const size_t smem = smem_floats(h, xd, zd) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_cw_rollout_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_cw_rollout_bwd_kernel<<<batch, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>((a.off.total + 255) / 256);
  reduce_partials<<<grid, 256, 0, st>>>(a.partial, batch, a.off.total, a.g_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
