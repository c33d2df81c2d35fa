// Reverse-time VJP of the fused DAE rollout in one launch, plus a small
// kernel that sums the blocks' partial weight gradients.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_dae_vjp.py:_bwd_kernel
// (:147), launched by _run_backward (pallas_call at :562). It computes the
// same function in float32 with float32 accumulation (no TF32, no tensor
// cores), without the TPU's grid, time padding, lanes, bf16 mode or teacher
// forcing. Per batch row, for t = T-2 down to 0, with x_t, i_t, x_{t+1} read
// from the saved packed solution and the carries gx_c, gi_c (zero at the
// start):
//
//   gX1 = cot_x[t+1] + gx_c,  gI1 = cot_i[t+1] + gi_c
//   i_in = ev[t] > 0 ? AE(x_t, s_ae_ev[t]) : i_t          (recomputed)
//   AE at t+1:  backprop gI1 through AE(x_{t+1}, s_ae[t]) -> g_s_ae[t],
//               gX1 += g_pre0 @ gx_ae^T
//   DE stages:  recompute the Euler / Midpoint / RK4-3/8 stages of
//               f(x) = DE(s_de[t] + x @ wx_de + i_in @ wi_de), backprop
//               the step -> g_s_de[t] (sum over stages), g_x, g_i_in
//   events:     rows with ev > 0 send g_i_in through the AE_ev VJP into
//               g_s_ae_ev[t] and the x carry; the other rows keep it in
//               the i carry (g_s_ae_ev[t] = 0 there)
//
// and every weight and bias gradient accumulates over all rows and steps.
// g_x0 / g_i0 are the carries after step 0 (the wrapper adds cot[0]).
//
// The TPU grid runs its batch blocks one after another, so the TPU kernel
// accumulates the weight gradients in one output block. Here the blocks run
// in parallel and in no order: each block owns disjoint batch rows and adds
// into its OWN row of partial gradients in global memory (about 270 KB per
// block at h=128: 65 k accumulators fit neither a block's registers nor its
// shared memory, so they live in L2), and reduce_partials sums the rows in
// block order. Each accumulator is only ever touched by the one thread that
// owns its index, in step order, so the result is bit-identical from run to
// run, with no atomics.
//
// Bound on an H100 SXM at the main training shape (B=64, T=1001, h=128,
// xd=3, id=2, RK4): a row-step recomputes the forward (four DE evaluations
// and one AE evaluation, 3.3e5 FLOP) and runs the backward, two products
// per layer (the cotangent through W^T and the weight-gradient outer
// product), 6.6e5 FLOP: about 1e6 FLOP per row-step, 6.4e10 for the call,
// 0.95 ms at the card's 67 TFLOP/s of float32 on the CUDA cores. Its bytes
// (three h-wide streams in, three out: 6 x 1000 x 64 x 128 x 4 B = 197 MB)
// take 0.06 ms at 3.35 TB/s. So it is compute-bound on paper and
// latency-bound in practice, as the forward is: each step is a serial chain
// of about twice the forward's dependent 128-wide layers (30 with RK4),
// each closed by a block barrier, and B=64 gives 64 blocks.
//
// Design: each block owns one batch row and loops over all steps inside
// the block; as in the forward (csrc/fused_dae_rollout.cu), KS=4 threads share each output column of a
// wide layer and combine with warp shuffles. The step's residuals
// (pre-activations and activations of every evaluation, stage inputs,
// output cotangents) live in shared memory; the backward overwrites each
// pre-activation with its cotangent. The backward products read transposed
// copies of the weights that the wrapper makes, so that neighbouring
// threads read neighbouring addresses. After the chain, one pass per step
// adds every evaluation's outer products into the block's partial
// gradients: each accumulator is read and written once per step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTail = 8;        // tail layers per net
constexpr int kColThreads = 128;   // output columns a block covers at once
constexpr int kKS = 4;             // threads per output column of a wide layer
constexpr int kThreads = kColThreads * kKS;
constexpr int kEvals = 6;          // DE stages 0..3, AE at t+1, AE at the event
constexpr int kAeNext = 4;
constexpr int kAeEv = 5;
constexpr float kOneThird = 1.0f / 3.0f;

struct Tail {
  const float* w[kMaxTail];   // [in, out] row-major (flax kernel layout)
  const float* wt[kMaxTail];  // [out, in]: the transpose, for the backward
  const float* b[kMaxTail];   // [out]
  int n;                      // number of tail layers
  int out;                    // width of the last layer
};

// Offsets of each gradient in one block's row of partials; the order of
// flatten_weights in ops/fused_dae_vjp.py.
struct GradOffsets {
  int wx, wi, gx;
  int de_w[kMaxTail], de_b[kMaxTail];
  int ae_w[kMaxTail], ae_b[kMaxTail];
  int total;
};

struct Args {
  const float* s_de;     // [tm1, batch, h]
  const float* s_ae;     // [tm1, batch, h]
  const float* s_ae_ev;  // [tm1, batch, h]
  const float* aux;      // [tm1, batch, 2]: (dt, ev)
  const float* x0;       // [batch, xd]
  const float* i0;       // [batch, id]
  const float* sol;      // [tm1, batch, xd + id]: (x, i) of steps 1..tm1
  const float* cot;      // [tm1 + 1, batch, xd + id]: cotangents of (x, i)
  const float* wx_de;    // [xd, h]
  const float* wi_de;    // [id, h]
  const float* gx_ae;    // [xd, h]
  const float* wx_t;     // [h, xd]
  const float* wi_t;     // [h, id]
  const float* gx_t;     // [h, xd]
  Tail de;               // hidden layers [h, h], last [h, xd]
  Tail ae;               // hidden layers [h, h], last [h, id]
  float* g_s_de;         // [tm1, batch, h]
  float* g_s_ae;         // [tm1, batch, h]
  float* g_s_ae_ev;      // [tm1, batch, h]
  float* partial;        // [blocks, off.total], zeroed by the caller
  float* g_w;            // [off.total]
  float* g_x0;           // [batch, xd]
  float* g_i0;           // [batch, id]
  GradOffsets off;
  int tm1, batch, h, xd, id, solver, n_max;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

__device__ __forceinline__ float delu(float p) {
  return p > 0.f ? 1.f : expf(fminf(p, 0.f));
}

// What a dense layer does with v = sum_k in[k] w[k, j] (+ b[j]):
enum Epilogue {
  kStore = 0,  // out = v
  kFwd = 1,    // out = v (pre-activation), act = elu(v)
  kBwd = 2,    // out holds pre-activations p: out = v * elu'(p), in place
};

__device__ __forceinline__ void store(int mode, float v, float* out, float* act, int idx) {
  if (mode == kFwd) {
    out[idx] = v;
    act[idx] = elu(v);
  } else if (mode == kBwd) {
    out[idx] = v * delu(out[idx]);
  } else {
    out[idx] = v;
  }
}

// out[j] for j < n_out; KS threads per output column, in/out in shared
// memory, w [k_in, n_out] in global memory, b may be null.
__device__ void dense_wide(const float* in, int k_in, const float* __restrict__ w,
                           const float* __restrict__ b, float* out, float* act, int n_out,
                           int mode) {
  const int ks = threadIdx.x % kKS;
  const int col = threadIdx.x / kKS;
  const int ncol = blockDim.x / kKS;
  // every thread runs the same trip count, so the shuffles below see full warps
  for (int j0 = 0; j0 < n_out; j0 += ncol) {
    const int j = j0 + col;
    const bool live = j < n_out;
    float acc = 0.f;
    if (live) {
#pragma unroll 8
      for (int k = ks; k < k_in; k += kKS)
        acc = fmaf(in[k], __ldg(w + static_cast<size_t>(k) * n_out + j), acc);
    }
#pragma unroll
    for (int o = kKS / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (live && ks == 0) store(mode, acc + (b ? __ldg(b + j) : 0.f), out, act, j);
  }
}

// Narrow layer (n_out < 32): one warp per output, lanes split the reduction.
__device__ void dense_narrow(const float* in, int k_in, const float* __restrict__ w,
                             const float* __restrict__ b, float* out, float* act, int n_out,
                             int mode) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int j = warp; j < n_out; j += nwarp) {
    float acc = 0.f;
    for (int k = lane; k < k_in; k += 32)
      acc = fmaf(in[k], __ldg(w + static_cast<size_t>(k) * n_out + j), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) store(mode, acc + (b ? __ldg(b + j) : 0.f), out, act, j);
  }
}

__device__ __forceinline__ void dense(const float* in, int k_in, const float* w, const float* b,
                                      float* out, float* act, int n_out, int mode) {
  if (n_out >= 32) {
    dense_wide(in, k_in, w, b, out, act, n_out, mode);
  } else {
    dense_narrow(in, k_in, w, b, out, act, n_out, mode);
  }
}

// The residuals of one net evaluation in shared memory: per tail layer l,
// the pre-activation pre[l] (overwritten by its cotangent in the backward)
// and the activation act[l], each [h]; the evaluation's x input [xd], its
// output and the output's cotangent [out].
struct Res {
  float* pre;
  float* act;
  float* x;
  float* y;
  float* gy;
};

// Forward through the tail keeping residuals. pre[0]/act[0] hold the lifted
// first layer; starts after a barrier that published them, ends with one.
__device__ __noinline__ void tail_fwd(const Tail& tl, const Res& rs, int h) {
  for (int l = 0; l + 1 < tl.n; ++l) {
    dense(rs.act + l * h, h, tl.w[l], tl.b[l], rs.pre + (l + 1) * h, rs.act + (l + 1) * h, h,
          kFwd);
    __syncthreads();
  }
  dense(rs.act + (tl.n - 1) * h, h, tl.w[tl.n - 1], tl.b[tl.n - 1], rs.y, nullptr, tl.out,
        kStore);
  __syncthreads();
}

// Backward through the tail from the cotangent rs.gy (published by a
// barrier): leaves the cotangent of every pre-activation in rs.pre, so
// rs.pre[0] is the cotangent of the lifted first layer. Ends with a barrier.
__device__ __noinline__ void tail_bwd(const Tail& tl, const Res& rs, int h) {
  dense(rs.gy, tl.out, tl.wt[tl.n - 1], nullptr, rs.pre + (tl.n - 1) * h, nullptr, h, kBwd);
  __syncthreads();
  for (int l = tl.n - 2; l >= 0; --l) {
    dense(rs.pre + (l + 1) * h, h, tl.wt[l], nullptr, rs.pre + l * h, nullptr, h, kBwd);
    __syncthreads();
  }
}

// First layer of AE(x, s) for the block's row: pre[0] = s[row] + x @ gx_ae.
__device__ void ae_first(const Args& a, const float* s_t, const Res& rs, int row) {
  const int h = a.h, xd = a.xd;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float xp = 0.f;
    for (int k = 0; k < xd; ++k) xp = fmaf(rs.x[k], __ldg(a.gx_ae + k * h + j), xp);
    const float v = __ldg(s_t + static_cast<size_t>(row) * h + j) + xp;
    rs.pre[j] = v;
    rs.act[j] = elu(v);
  }
}

// First layer of f(x): pre[0] = s_de[row] + x @ wx_de + i_in @ wi_de.
__device__ void de_first(const Args& a, const float* s_t, const float* i_in, const Res& rs,
                         int row) {
  const int h = a.h, xd = a.xd, id = a.id;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float xp = 0.f;
    for (int k = 0; k < xd; ++k) xp = fmaf(rs.x[k], __ldg(a.wx_de + k * h + j), xp);
    float ip = 0.f;
    for (int k = 0; k < id; ++k) ip = fmaf(i_in[k], __ldg(a.wi_de + k * h + j), ip);
    const float v = (__ldg(s_t + static_cast<size_t>(row) * h + j) + xp) + ip;
    rs.pre[j] = v;
    rs.act[j] = elu(v);
  }
}

// One DE stage forward: rs.x holds the stage input (published).
__device__ void de_stage_fwd(const Args& a, const float* s_t, const float* i_in, const Res& rs,
                             int row) {
  de_first(a, s_t, i_in, rs, row);
  __syncthreads();
  tail_fwd(a.de, rs, a.h);
}

// One DE stage backward from rs.gy (published): the cotangent of the
// lifted first layer stays in rs.pre[0]; g_x = it @ wx_de^T and
// g_i = it @ wi_de^T go to gxo [xd] and gio [id]. Ends with a barrier.
__device__ void de_stage_bwd(const Args& a, const Res& rs, float* gxo, float* gio) {
  tail_bwd(a.de, rs, a.h);
  dense_narrow(rs.pre, a.h, a.wx_t, nullptr, gxo, nullptr, a.xd, kStore);
  dense_narrow(rs.pre, a.h, a.wi_t, nullptr, gio, nullptr, a.id, kStore);
  __syncthreads();
}

// P[k, j] += sum over evaluations q < nq of u_q[k] * v_q[j] (u_q [K],
// v_q [N]), or with u == null, P[j] += sum v_q[j]. Thread e owns entries
// e, e + blockDim.x, ...: the same thread every step.
__device__ void accumulate(float* __restrict__ P, int K, int N, const float* const* u,
                           const float* const* v, int nq) {
  constexpr int kU = 8;  // accumulators in flight per thread
  const int KN = u ? K * N : N;
  for (int e0 = threadIdx.x; e0 < KN; e0 += kU * blockDim.x) {
    float acc[kU];
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * blockDim.x;
      acc[s] = e < KN ? P[e] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * blockDim.x;
      if (e < KN) {
        const int k = u ? e / N : 0, j = e - k * N;
        float sum = acc[s];
        for (int q = 0; q < nq; ++q) sum = u ? fmaf(u[q][k], v[q][j], sum) : sum + v[q][j];
        acc[s] = sum;
      }
    }
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const int e = e0 + s * blockDim.x;
      if (e < KN) P[e] = acc[s];
    }
  }
}

// Add the step's weight and bias gradients of one net's tail, over the
// evaluations rs[0..nq).
__device__ void accumulate_tail(float* P, const int* w_off, const int* b_off, const Tail& tl,
                                const Res* rs, int nq, int h) {
  const float* u[4];
  const float* v[4];
  for (int l = 0; l < tl.n; ++l) {
    const bool last = l == tl.n - 1;
    const int n_out = last ? tl.out : h;
    for (int q = 0; q < nq; ++q) {
      u[q] = rs[q].act + l * h;
      v[q] = last ? rs[q].gy : rs[q].pre + (l + 1) * h;
    }
    accumulate(P + w_off[l], h, n_out, u, v, nq);
    accumulate(P + b_off[l], 1, n_out, nullptr, v, nq);
  }
}

__global__ void __launch_bounds__(kThreads) fused_dae_rollout_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, id = a.id, B = a.batch, D = xd + id;
  const int ow = xd > id ? xd : id;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row = blockIdx.x;
  float* p = smem;
  Res rs[kEvals];
  for (int q = 0; q < kEvals; ++q) {
    rs[q].pre = p;
    p += a.n_max * h;
    rs[q].act = p;
    p += a.n_max * h;
    rs[q].x = p;
    p += xd;
    rs[q].y = p;
    p += ow;
    rs[q].gy = p;
    p += ow;
  }
  float* gsde = p;  p += h;       // sum of the stages' first-layer cotangents
  float* xc = p;    p += xd;      // x_t
  float* iin = p;   p += id;      // i_in of the step (i_t, or AE_ev's output)
  float* gX1 = p;   p += xd;      // cotangent of x_{t+1}
  float* gxc = p;   p += xd;      // x carry, then g_x0 of the step
  float* gic = p;   p += id;      // i carry
  float* gii = p;   p += id;      // cotangent of i_in
  float* gk = p;    p += 4 * xd;  // stage cotangents g_k1..g_k4
  float* tx = p;    p += xd;      // g_x of one stage backward
  float* ti = p;    p += id;      // g_i of one stage backward

  for (int e = tid; e < xd; e += nt) gxc[e] = 0.f;
  for (int e = tid; e < id; e += nt) gic[e] = 0.f;
  const int S = a.solver == 0 ? 1 : (a.solver == 1 ? 2 : 4);
  float* Pb = a.partial + static_cast<size_t>(row) * a.off.total;
  __syncthreads();

  for (int t = a.tm1 - 1; t >= 0; --t) {
    const size_t step = static_cast<size_t>(t) * B;
    // the step's (dt, ev), the same for every thread of the block
    const float dt = __ldg(a.aux + (step + row) * 2);
    const bool ev = __ldg(a.aux + (step + row) * 2 + 1) > 0.f;
    // x_t, i_t (row t-1 of the packed solution, x0/i0 at t=0), x_{t+1},
    // and the incoming cotangents of x_{t+1}, i_{t+1}
    for (int c = tid; c < D; c += nt) {
      float cur;
      if (t == 0) {
        cur = c < xd ? a.x0[static_cast<size_t>(row) * xd + c]
                     : a.i0[static_cast<size_t>(row) * id + (c - xd)];
      } else {
        cur = a.sol[(step - B + row) * D + c];
      }
      const float nxt = a.sol[(step + row) * D + c];
      const float cn = a.cot[(step + B + row) * D + c];
      if (c < xd) {
        xc[c] = cur;
        rs[kAeEv].x[c] = cur;
        rs[kAeNext].x[c] = nxt;
        gX1[c] = cn + gxc[c];
      } else {
        iin[c - xd] = cur;
        rs[kAeNext].gy[c - xd] = cn + gic[c - xd];  // gI1
      }
    }
    __syncthreads();

    // ---- recompute i_in exactly as the forward did ----
    if (ev) {
      ae_first(a, a.s_ae_ev + step * h, rs[kAeEv], row);
      __syncthreads();
      tail_fwd(a.ae, rs[kAeEv], h);
      for (int e = tid; e < id; e += nt) iin[e] = rs[kAeEv].y[e];
    }

    // ---- AE at t+1: forward with residuals, backward from gI1 ----
    ae_first(a, a.s_ae + step * h, rs[kAeNext], row);
    __syncthreads();
    tail_fwd(a.ae, rs[kAeNext], h);
    tail_bwd(a.ae, rs[kAeNext], h);
    dense_narrow(rs[kAeNext].pre, h, a.gx_t, nullptr, tx, nullptr, xd, kStore);
    for (int e = tid; e < h; e += nt) a.g_s_ae[(step + row) * h + e] = rs[kAeNext].pre[e];
    __syncthreads();
    for (int e = tid; e < xd; e += nt) gX1[e] += tx[e];

    // ---- DE stages: recompute ----
    const float* s_de_t = a.s_de + step * h;
    for (int e = tid; e < xd; e += nt) rs[0].x[e] = xc[e];
    __syncthreads();
    de_stage_fwd(a, s_de_t, iin, rs[0], row);
    if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < xd; e += nt) rs[1].x[e] = xc[e] + rs[0].y[e] * (0.5f * dt);
      __syncthreads();
      de_stage_fwd(a, s_de_t, iin, rs[1], row);
    } else if (a.solver == 2) {  // RK4, Kutta's 3/8 rule
      const float* k1 = rs[0].y;
      for (int e = tid; e < xd; e += nt) rs[1].x[e] = xc[e] + dt * k1[e] * kOneThird;
      __syncthreads();
      de_stage_fwd(a, s_de_t, iin, rs[1], row);
      const float* k2 = rs[1].y;
      for (int e = tid; e < xd; e += nt) rs[2].x[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      de_stage_fwd(a, s_de_t, iin, rs[2], row);
      const float* k3 = rs[2].y;
      for (int e = tid; e < xd; e += nt) rs[3].x[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      __syncthreads();
      de_stage_fwd(a, s_de_t, iin, rs[3], row);
    }

    // ---- differential step backward ----
    if (a.solver == 0) {  // Euler: x1 = x + dt f(x)
      for (int e = tid; e < xd; e += nt) rs[0].gy[e] = dt * gX1[e];
      __syncthreads();
      de_stage_bwd(a, rs[0], tx, gii);
      for (int e = tid; e < xd; e += nt) gxc[e] = gX1[e] + tx[e];
      for (int e = tid; e < h; e += nt) gsde[e] = rs[0].pre[e];
    } else if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < xd; e += nt) rs[1].gy[e] = dt * gX1[e];
      __syncthreads();
      de_stage_bwd(a, rs[1], tx, ti);  // tx = g_xmid, ti = gi_m
      for (int e = tid; e < xd; e += nt) rs[0].gy[e] = (0.5f * dt) * tx[e];
      for (int e = tid; e < xd; e += nt) gxc[e] = gX1[e] + tx[e];
      for (int e = tid; e < id; e += nt) gii[e] = ti[e];
      __syncthreads();
      de_stage_bwd(a, rs[0], tx, ti);
      for (int e = tid; e < xd; e += nt) gxc[e] += tx[e];
      for (int e = tid; e < id; e += nt) gii[e] += ti[e];
      for (int e = tid; e < h; e += nt) gsde[e] = rs[1].pre[e] + rs[0].pre[e];
    } else {  // RK4
      float* gk1 = gk;
      float* gk2 = gk + xd;
      float* gk3 = gk + 2 * xd;
      const float c = dt * 0.125f;
      for (int e = tid; e < xd; e += nt) {
        gk1[e] = gX1[e] * c;
        gk2[e] = 3.0f * gX1[e] * c;
        gk3[e] = 3.0f * gX1[e] * c;
        rs[3].gy[e] = gX1[e] * c;  // g_k4
        gxc[e] = gX1[e];
      }
      for (int e = tid; e < id; e += nt) gii[e] = 0.f;
      for (int e = tid; e < h; e += nt) gsde[e] = 0.f;
      __syncthreads();
      de_stage_bwd(a, rs[3], tx, ti);  // g_a4, gi4
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        gk1[e] += dt * g;
        gk2[e] -= dt * g;
        rs[2].gy[e] = gk3[e] + dt * g;  // final g_k3
      }
      for (int e = tid; e < id; e += nt) gii[e] += ti[e];
      for (int e = tid; e < h; e += nt) gsde[e] += rs[3].pre[e];
      __syncthreads();
      de_stage_bwd(a, rs[2], tx, ti);  // g_a3, gi3
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        rs[1].gy[e] = gk2[e] + dt * g;  // final g_k2
        gk1[e] -= dt * g * kOneThird;
      }
      for (int e = tid; e < id; e += nt) gii[e] += ti[e];
      for (int e = tid; e < h; e += nt) gsde[e] += rs[2].pre[e];
      __syncthreads();
      de_stage_bwd(a, rs[1], tx, ti);  // g_a2, gi2
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        rs[0].gy[e] = gk1[e] + dt * g * kOneThird;  // final g_k1
      }
      for (int e = tid; e < id; e += nt) gii[e] += ti[e];
      for (int e = tid; e < h; e += nt) gsde[e] += rs[1].pre[e];
      __syncthreads();
      de_stage_bwd(a, rs[0], tx, ti);  // g_a1, gi1
      for (int e = tid; e < xd; e += nt) gxc[e] += tx[e];
      for (int e = tid; e < id; e += nt) gii[e] += ti[e];
      for (int e = tid; e < h; e += nt) gsde[e] += rs[0].pre[e];
    }
    __syncthreads();
    for (int e = tid; e < h; e += nt) a.g_s_de[(step + row) * h + e] = gsde[e];

    // ---- route the i_in cotangent: on an event through the AE_ev VJP
    // into the x carry, else to the i carry ----
    if (ev) {
      for (int e = tid; e < id; e += nt) rs[kAeEv].gy[e] = gii[e];
      __syncthreads();
      tail_bwd(a.ae, rs[kAeEv], h);
      dense_narrow(rs[kAeEv].pre, h, a.gx_t, nullptr, tx, nullptr, xd, kStore);
      __syncthreads();
      for (int e = tid; e < xd; e += nt) gxc[e] += tx[e];
      for (int e = tid; e < id; e += nt) gic[e] = 0.f;
    } else {
      for (int e = tid; e < id; e += nt) gic[e] = gii[e];
    }
    for (int e = tid; e < h; e += nt)
      a.g_s_ae_ev[(step + row) * h + e] = ev ? rs[kAeEv].pre[e] : 0.f;

    // ---- add the step's weight and bias gradients ----
    {
      const float* u[4];
      const float* v[4];
      for (int q = 0; q < S; ++q) {
        u[q] = rs[q].x;
        v[q] = rs[q].pre;
      }
      accumulate(Pb + a.off.wx, xd, h, u, v, S);
      for (int q = 0; q < S; ++q) u[q] = iin;
      accumulate(Pb + a.off.wi, id, h, u, v, S);
      accumulate_tail(Pb, a.off.de_w, a.off.de_b, a.de, rs, S, h);
      const int na = ev ? 2 : 1;
      const Res ae_rs[2] = {rs[kAeNext], rs[kAeEv]};
      for (int q = 0; q < na; ++q) {
        u[q] = ae_rs[q].x;
        v[q] = ae_rs[q].pre;
      }
      accumulate(Pb + a.off.gx, xd, h, u, v, na);
      accumulate_tail(Pb, a.off.ae_w, a.off.ae_b, a.ae, ae_rs, na, h);
    }
    __syncthreads();
  }

  for (int e = tid; e < xd; e += nt) a.g_x0[static_cast<size_t>(row) * xd + e] = gxc[e];
  for (int e = tid; e < id; e += nt) a.g_i0[static_cast<size_t>(row) * id + e] = gic[e];
}

// g_w[e] = sum over blocks b, in order, of partial[b, e].
__global__ void reduce_partials(const float* __restrict__ partial, int blocks, int total,
                                float* __restrict__ g_w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<size_t>(b) * total + e];
  g_w[e] = acc;
}

size_t smem_floats(int h, int xd, int id, int n_max) {
  const int ow = xd > id ? xd : id;
  const size_t per_eval = 2 * static_cast<size_t>(n_max) * h + xd + 2 * ow;
  return kEvals * per_eval + h + 8 * xd + 4 * id;
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.h, a.xd, a.id, a.n_max) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_dae_rollout_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_dae_rollout_bwd_kernel<<<a.batch, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_partials<<<(a.off.total + 255) / 256, 256, 0, stream>>>(a.partial, a.batch, a.off.total,
                                                                 a.g_w);
  return cudaGetLastError();
}

bool fill_tail(Tail* tl, const void* const* w, const void* const* wt, const void* const* b, int n,
               int out) {
  if (n < 1 || n > kMaxTail || out < 1) return false;
  for (int l = 0; l < kMaxTail; ++l) {
    tl->w[l] = l < n ? static_cast<const float*>(w[l]) : nullptr;
    tl->wt[l] = l < n ? static_cast<const float*>(wt[l]) : nullptr;
    tl->b[l] = l < n ? static_cast<const float*>(b[l]) : nullptr;
  }
  tl->n = n;
  tl->out = out;
  return true;
}

// Offsets in the order wx_de, wi_de, gx_ae, DE tail (W, b)..., AE tail
// (W, b)...; hidden tail layers are [h, h], the last [h, out].
GradOffsets grad_offsets(int h, int xd, int id, int n_de, int n_ae) {
  GradOffsets o{};
  int off = 0;
  o.wx = off;
  off += xd * h;
  o.wi = off;
  off += id * h;
  o.gx = off;
  off += xd * h;
  for (int l = 0; l < n_de; ++l) {
    const int n_out = l == n_de - 1 ? xd : h;
    o.de_w[l] = off;
    off += h * n_out;
    o.de_b[l] = off;
    off += n_out;
  }
  for (int l = 0; l < n_ae; ++l) {
    const int n_out = l == n_ae - 1 ? id : h;
    o.ae_w[l] = off;
    off += h * n_out;
    o.ae_b[l] = off;
    off += n_out;
  }
  o.total = off;
  return o;
}

}  // namespace

// Number of floats in one row of partial gradients (and in g_w).
extern "C" int psn_fused_dae_bwd_grad_size(int h, int xd, int id, int n_de, int n_ae) {
  return grad_offsets(h, xd, id, n_de, n_ae).total;
}

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; de_*/ae_* are host arrays of them (W, W^T, b
// per tail layer). `partial` is [batch, psn_fused_dae_bwd_grad_size(...)]
// (one row per block, a block per batch row) and must be zero; g_w
// receives the summed gradients in the same layout. solver: 0 Euler, 1
// Midpoint, 2 RK4 (3/8 rule). Launches both kernels on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int psn_fused_dae_rollout_bwd_f32(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux,
    const void* x0, const void* i0, const void* sol, const void* cot,
    const void* wx_de, const void* wi_de, const void* gx_ae,
    const void* wx_t, const void* wi_t, const void* gx_t,
    const void* const* de_w, const void* const* de_wt, const void* const* de_b, int n_de,
    const void* const* ae_w, const void* const* ae_wt, const void* const* ae_b, int n_ae,
    void* g_s_de, void* g_s_ae, void* g_s_ae_ev, void* partial, void* g_w, void* g_x0,
    void* g_i0, int tm1, int batch, int h, int xd, int id, int solver, void* stream) {
  if (tm1 < 1 || batch < 1 || h < 1 || xd < 1 || id < 1 || solver < 0 || solver > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.s_ae = static_cast<const float*>(s_ae);
  a.s_ae_ev = static_cast<const float*>(s_ae_ev);
  a.aux = static_cast<const float*>(aux);
  a.x0 = static_cast<const float*>(x0);
  a.i0 = static_cast<const float*>(i0);
  a.sol = static_cast<const float*>(sol);
  a.cot = static_cast<const float*>(cot);
  a.wx_de = static_cast<const float*>(wx_de);
  a.wi_de = static_cast<const float*>(wi_de);
  a.gx_ae = static_cast<const float*>(gx_ae);
  a.wx_t = static_cast<const float*>(wx_t);
  a.wi_t = static_cast<const float*>(wi_t);
  a.gx_t = static_cast<const float*>(gx_t);
  if (!fill_tail(&a.de, de_w, de_wt, de_b, n_de, xd) ||
      !fill_tail(&a.ae, ae_w, ae_wt, ae_b, n_ae, id))
    return static_cast<int>(cudaErrorInvalidValue);
  a.g_s_de = static_cast<float*>(g_s_de);
  a.g_s_ae = static_cast<float*>(g_s_ae);
  a.g_s_ae_ev = static_cast<float*>(g_s_ae_ev);
  a.partial = static_cast<float*>(partial);
  a.g_w = static_cast<float*>(g_w);
  a.g_x0 = static_cast<float*>(g_x0);
  a.g_i0 = static_cast<float*>(g_i0);
  a.off = grad_offsets(h, xd, id, n_de, n_ae);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.id = id;
  a.solver = solver;
  a.n_max = n_de > n_ae ? n_de : n_ae;
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
