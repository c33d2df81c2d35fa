// Reverse-time VJP of the channel-wise rollout: the reverse walk in one
// launch, then a contraction of the per-channel nets' gradients and two
// small kernels that sum partial gradients in a fixed order.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_channelwise.py:_bwd_kernel
// (:370), launched by _vjp_bwd (pallas_call at :580). It computes the same
// function at float32 accuracy, without the TPU's grid or time blocking;
// its bf16 compute mode (below) is the TPU kernel's precision="bfloat16".
// Per batch row, for t = T-2 down to 0, with x_t = sol[t] and the carry
// gx_c (zero at first):
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
// Where the residuals and the sums live.
// - A stage's activations a1 and a2 ([h, h] each) stay in the two shared
//   tiles of the forward evaluation; the backward overwrites each with the
//   cotangent of its pre-activation (elu' from the activation: 1 above 0,
//   a + 1 below), and recomputes a0 = elu(V A + s_constV) from the small ft
//   when it needs it, so no third tile is kept.
// - The four h x h x h products of a stage's VJP (two cotangents, two
//   dense weight gradients a^T g) run on the tensor cores in 3xTF32, like
//   the forward's (cw_tile.cuh).
// - g_s_constV: each thread owns the same 64 outputs of the g_P0 product
//   every stage, so it sums them in registers over the whole walk and
//   writes the row's [h, h] tile once at the end.
// - The dense weights' gradients (a, W1..W3, b1..b3: 34 k floats, 135 KB a
//   row at h=128, 8.6 MB at B=64, inside the 50 MB L2) go into the batch
//   row's row of partials in global memory: a stage's product is summed
//   from zero and added to the row once (summed on top of the row, each of
//   its h terms would round at the row's magnitude, which grows over the
//   1000-4000 stages a row adds), each entry by one thread only, as a
//   reduction in L2 that it does not wait for. reduce_partials sums the
//   rows in batch order.
// - The per-channel nets' gradients (ext and head, W and b) are sums of
//   rank-one terms u v^T: each stage writes its four (u, v) pairs of [xd,
//   h] to pairs[t, s, b] (coalesced, 8 xd h floats), and contract_pairs
//   multiplies them out after the walk, dW = U^T V and db = sum V over the
//   (T-1) S B rows, on the CUDA cores, in nsplit contiguous row ranges
//   whose partial sums reduce_pair_parts adds in range order.
// Every sum has a fixed order and no atomics, so a relaunch is
// bit-identical.
//
// Bound on an H100 SXM: a stage's VJP is its evaluation plus twice its
// products again (three evaluation-equivalents: the cotangents and the
// weight grads); the kernel's own recomputation (the stage points
// re-evaluated, a0 again) is its design's cost, not the function's. The
// h x h x h products run in three TF32 passes at 495 TFLOP/s, the rest at
// the 67 TFLOP/s of float32: at B=64 over 1000 steps, Euler 11.1, Midpoint
// 22.2, RK4 44.3 ms (xd=2), against well under a millisecond for the bytes
// that must move (the pairs buffer, written and read once, 2-3 GB at RK4,
// is the design's). Bound by arithmetic, like the forward.
//
// Design: a cluster of blocks per batch row walks all steps, the cluster's
// size chosen as in the forward (csrc/fused_cw_rollout.cu): its blocks split
// the products' columns, the folded first layer and the dense weights'
// gradient columns, and the lead block writes the row's own results
// (g_fz, the pairs, g_x0); csrc/cw_tile.cuh holds the tiles and the
// per-channel products.
//
// Above h = 128 (to 572, the JAX package's widest) the walk runs on the wide
// layout of csrc/cw_wide.cuh: fused_cw_rollout_bwd_wide_kernel below, the
// tiles in the row's global scratch, each product's 128 x 128 output blocks
// dealt over a cluster of up to 8 blocks; the contraction takes 128 x 128
// blocks of each [h, h] sum (contract_pairs_wide).
//
// The bf16 compute mode (the TPU kernel's cd = w[1].dtype :386, _dot_t and
// _dot_nt on the _cast_cw weights): the template flag kBf16 of the walks
// and the contraction, in a build of its own (-DPSN_BF16:
// psn_fused_cw_rollout_bwd_bf16 and psn_cw_contract_pairs_bf16 in place of
// the _f32 ones, utils/cuda_build.py). The recomputed evaluations round as
// the forward's (csrc/cw_tile.cuh); every cotangent product rounds its
// cotangent operand, every weight-gradient product both operands, each as
// the product reads it: a tile that feeds both a product and an elu' (a1,
// a2 and their cotangents, a0, g_P0) is stored in float32 and rounded only
// where the product reads it, and the (u, v) pairs are written as they are
// and rounded by the contraction as it multiplies them, their bias sums
// taken from the float32 v. The biases' gradients, g_s_constV, g_fz, the
// carries and every gradient stay float32; a relaunch is bit-identical as
// in float32.

#include "cw_wide.cuh"

namespace {

constexpr int kPairs = 4;  // rank-one gradient pairs of the per-channel nets
constexpr int kNc = 32;    // pair rows a contraction block stages at once
constexpr int kCThreads = 256;  // a contraction block: 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxSplit = 32;  // row ranges of the contraction

// Offsets of each gradient in the flat gradient row, in the order of
// flatten_weights (ops/fused_channelwise.py). The dense ones come first:
// a batch row's row of partials holds [0, ew0).
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

__host__ __device__ inline int n_stages(int solver) { return solver == 0 ? 1 : (solver == 1 ? 2 : 4); }

// Contiguous row ranges of the contraction: a function of the shapes only,
// so that a relaunch sums in the same order.
int n_splits(long long rows) {
  const long long most = (rows + kNc - 1) / kNc;
  return static_cast<int>(most < kMaxSplit ? (most < 1 ? 1 : most) : kMaxSplit);
}

// Where pair q's weight and bias gradients go, per channel c: dW at
// out + wo[q] + c h^2 ([h, h], row k = input), db at out + bo[q] + c h.
struct PairDest {
  long long wo[kPairs], bo[kPairs];
};

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
  float* partial;     // [batch, off.ew0], zeroed by the caller
  float* pairs;       // [tm1, S, batch, kPairs, 2, xd, h]
  GradOffsets off;
  float* g_x0;        // [batch, xd, h]
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

// P[m * h + n] += acc at the thread's outputs (P a dense weight's partial
// gradient [h, h], row m = input), as reductions in L2 that the thread does
// not wait for. Only this thread ever adds to these entries, in program
// order, so the sums are the same from run to run.
template <int KC>
__device__ __forceinline__ void add_partial(float* __restrict__ P, int h, Acc<KC>& acc) {
  for_acc<KC>(acc, h, [&](float& v, int m, int n) { atomicAdd(P + m * h + n, v); });
}

// db[j] += sum_{l < h} t[j][l] for the block's columns j: a bias grad from
// a cotangent tile. Thread j starts at position j, so that a warp's reads
// fall on distinct banks.
template <int KC>
__device__ __forceinline__ void add_bias_grad(float* __restrict__ db, int h, const float* t) {
  constexpr int kSlice = Tiling<KC>::kSlice;
  const int j0 = static_cast<int>(block_rank<KC>()) * kSlice;
  for (int j = j0 + threadIdx.x; j < j0 + kSlice && j < h; j += kThreads) {
    float sum = 0.f;
    for (int i = 0, l = j; i < h; ++i, l = l + 1 == h ? 0 : l + 1) sum += t[j * kLdt + l];
    db[j] += sum;
  }
}

// The VJP of one evaluation at xs with output cotangent gy (both [xd][h],
// published): recomputes the evaluation, adds the vertical net's and a's
// weight grads into the row's partials Pb, this stage's g_P0 into the
// thread's g_s_constV sums gsv, this stage's z cotangent into b.gfz, writes
// g_x = dL/dxs into gx and, in the lead block, the stage's per-channel (u,
// v) pairs into pr. The blocks of a cluster split the products, the folded
// first layer and the sums over the dense weights' columns (and the lead
// adds W3's and b3's); each computes the rest itself. Ends with a barrier
// of the block and with this block's arrival at the cluster barrier that
// the next a0 store waits at. kBf16: the bf16 compute mode. Inlined at its
// one call site, so that gsv stays in registers.
template <int KC, bool kBf16 = false>
__device__ __forceinline__ void eval_bwd(const Args& a, const EvalSmem& s, const BwdSmem& b,
                                         const float* xs, const float* gy, const float* fz_t,
                                         const float* sv, Acc<KC>& gsv, float* __restrict__ Pb,
                                         float* __restrict__ pr, float* gx) {
  const int h = a.h, xd = a.xd, zd = a.zd, C = xd + zd, n = xd * h, tid = threadIdx.x;
  const bool lead = block_rank<KC>() == 0;
  const Net& w = a.w;
  const NetT& wt = a.wt;
  Acc<KC> acc;
  CW_PHASE(16);
  eval_fwd<KC, false, kBf16>(w, s, h, xd, zd, xs, fz_t, sv, b.y);  // t1 = a2, t2 = a1
  CW_PHASE(17);

  // head: ghe = (gy H1^T) * elu'(HE), go = ghe H0^T
  gemv_ch<kBf16>(gy, h, xd, h, wt.hw1t, nullptr, b.ghe, h, h, false, s.he);
  __syncthreads();
  gemv_ch<kBf16>(b.ghe, h, xd, h, wt.hw0t, nullptr, b.go, h, h, false, nullptr);
  __syncthreads();
  CW_PHASE(18);

  // last vertical layer: dW3[k][c] += sum_l a2[l][k] go[c][l], db3
  if (lead) {
    for (int o = tid; o < h * xd; o += kThreads) {
      const int k = o / xd, c = o - k * xd;
      float sum = 0.f;
      for (int i = 0, l = k; i < h; ++i, l = l + 1 == h ? 0 : l + 1)
        sum = fmaf(rnd<kBf16>(s.t1[k * kLdt + l]), rnd<kBf16>(b.go[c * h + l]), sum);
      Pb[a.off.w3 + o] += sum;
    }
    for (int c = tid; c < xd; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < h; ++l) sum += b.go[c * h + l];
      Pb[a.off.b3 + c] += sum;
    }
  }
  __syncthreads();
  // t1: a2 -> g_P2 = (go W3^T) * elu'(a2), in place
  for (int o = tid; o < h * h; o += kThreads) {
    const int k = o / h, l = o - k * h;
    float g = 0.f;
    for (int c = 0; c < xd; ++c) g = fmaf(rnd<kBf16>(b.go[c * h + l]), s.w3[k * xd + c], g);
    float* p = s.t1 + k * kLdt + l;
    *p = g * delu_act(*p);
  }
  __syncthreads();
  CW_PHASE(19);
  mma_tile_tile<KC, kBf16>(s.t2, s.t1, h, acc);  // dW2 += a1^T g_P2
  add_partial<KC>(Pb + a.off.w2, h, acc);
  add_bias_grad<KC>(Pb + a.off.b2, h, s.t1);
  CW_PHASE(20);
  mma_tile_weight<KC, kBf16>(s.t1, h, wt.w2t, h, s.wbuf, acc);  // g_P1 = g_P2 W2^T ...
  cl_sync<KC>();  // ... into t2, which no block reads any more (a1 for dW2)
  store_bwd<KC>(acc, h, s.t2);
  CW_PHASE(21);
  first_layer<KC, kBf16>(s.ft, s.as, C, h, sv, acc);  // t1 = a0 again (g_P2 no longer read)
  store_act<KC>(acc, h, nullptr, s.t1);
  cl_sync<KC>();
  CW_PHASE(22);
  mma_tile_tile<KC, kBf16>(s.t1, s.t2, h, acc);  // dW1 += a0^T g_P1
  add_partial<KC>(Pb + a.off.w1, h, acc);
  add_bias_grad<KC>(Pb + a.off.b1, h, s.t2);
  CW_PHASE(23);
  mma_tile_weight<KC, kBf16>(s.t2, h, wt.w1t, h, s.wbuf, acc);  // g_P0 = g_P1 W1^T ...
  cl_sync<KC>();  // ... into t1, which no block reads any more (a0 for dW1)
  store_bwd<KC>(acc, h, s.t1);
#pragma unroll
  for (int i = 0; i < Tiling<KC>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<KC>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) gsv[i][j][r] += acc[i][j][r];  // g_s_constV; 0 beyond h
  cl_sync<KC>();
  CW_PHASE(24);

  // the folded first layer: dA[c][j] += sum_l ft[c][l] g_P0[l][j] (the
  // block's columns j), gft[c][l] = sum_j g_P0[l][j] A[c][j] (all)
  constexpr int kSlice = Tiling<KC>::kSlice;
  const int j0 = static_cast<int>(block_rank<KC>()) * kSlice;
  for (int o = tid; o < C * h; o += kThreads) {
    const int c = o / h, j = o - c * h;
    float g = 0.f;
    // here j is the position l of gft and f the feature j of g_P0
    for (int f = 0; f < h; ++f) g = fmaf(rnd<kBf16>(s.t1[f * kLdt + j]), s.as[c * kMaxH + f], g);
    b.gft[o] = g;
    if (j >= j0 && j < j0 + kSlice) {
      float da = 0.f;
      for (int i = 0, l = j; i < h; ++i, l = l + 1 == h ? 0 : l + 1)
        da = fmaf(rnd<kBf16>(s.ft[c * kLdt + l]), rnd<kBf16>(s.t1[j * kLdt + l]), da);
      Pb[a.off.a + o] += da;
    }
  }
  __syncthreads();
  CW_PHASE(25);
  cl_arrive<KC>();  // done with t1 until the next evaluation's a0 store
  for (int o = tid; o < zd * h; o += kThreads) b.gfz[o] += b.gft[n + o];

  // ext: gep = (gft[:xd] E1^T) * elu'(E), gx = gep E0^T
  gemv_ch<kBf16>(b.gft, h, xd, h, wt.ew1t, nullptr, b.gep, h, h, false, s.e);
  __syncthreads();
  gemv_ch<kBf16>(b.gep, h, xd, h, wt.ew0t, nullptr, gx, h, h, false, nullptr);

  // the per-channel nets' rank-one pairs (u, v): head W1, head W0, ext W1,
  // ext W0 (PairDest's order)
  if (lead) {
    const float* pairs[kPairs][2] = {{s.he, gy}, {s.ot, b.ghe}, {s.e, b.gft}, {xs, b.gep}};
    for (int q = 0; q < kPairs; ++q)
      for (int r = 0; r < 2; ++r)
        for (int e = tid; e < n; e += kThreads) pr[(2 * q + r) * n + e] = pairs[q][r][e];
  }
  __syncthreads();
  CW_PHASE(26);
}

size_t smem_floats(int h, int xd, int zd) {
  const size_t xdh = static_cast<size_t>(xd) * h, C = xd + zd;
  // EvalSmem; gft, gfz; y, ghe, go, gep;
  // xc, x2, x3, x4, k1, k2, k3, gX1, gxc, gk1, gk2, gk3, gy, tx
  return eval_floats(h, xd, zd) + C * h + static_cast<size_t>(zd) * h + 4 * xdh + 14 * xdh;
}

template <int KC, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1)
    fused_cw_rollout_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x / KC, tid = threadIdx.x;
  const int n = xd * h, C = xd + zd;
  const bool lead = block_rank<KC>() == 0;  // the block that writes the row's own results
  EvalSmem s;
  BwdSmem b;
  float* p = carve_eval(s, smem, h, xd, zd);
  b.gft = p;   p += C * h;
  b.gfz = p;   p += zd * h;
  b.y = p;     p += n;
  b.ghe = p;   p += n;
  b.go = p;    p += n;
  b.gep = p;   p += n;
  float* xc = p;   p += n;  // x_t, the first stage's input
  float* x2 = p;   p += n;  // RK4's (Midpoint's) further stage inputs, consecutive
  float* x3 = p;   p += n;
  float* x4 = p;   p += n;
  float* k1 = p;   p += n;  // stage outputs, consecutive
  float* k2 = p;   p += n;
  float* k3 = p;   p += n;
  float* gX1 = p;  p += n;  // cotangent of x_{t+1}
  float* gxc = p;  p += n;  // the carry, then dL/dx_t of the step
  float* gk1 = p;  p += n;
  float* gk2 = p;  p += n;
  float* gk3 = p;  p += n;
  float* gy = p;   p += n;  // the next stage's output cotangent
  float* tx = p;            // g_x of one stage's VJP

  init_eval(a.w, s, h, xd, zd);
  for (int e = tid; e < n; e += kThreads) gxc[e] = 0.f;
  const size_t hh = static_cast<size_t>(h) * h;
  const float* sv = a.sv + row * hh;
  float* Pb = a.partial + static_cast<size_t>(row) * a.off.ew0;
  const int S = n_stages(a.solver);
  // the stage inputs in the order their VJPs are taken
  const float* xs_of[4] = {xc, nullptr, nullptr, nullptr};
  if (a.solver == 1) {
    xs_of[0] = x2;
    xs_of[1] = xc;
  } else if (a.solver == 2) {
    xs_of[0] = x4;
    xs_of[1] = x3;
    xs_of[2] = x2;
    xs_of[3] = xc;
  }
  Acc<KC> gsv;
  zero<KC>(gsv);
  __syncthreads();
  cl_arrive<KC>();  // t1 is free: the first evaluation's a0 store waits for this

  for (int t = a.tm1 - 1; t >= 0; --t) {
#ifdef CW_PHASE_CLOCK
    if (blockIdx.x == 0 && tid == 0) g_phase_on = t == a.tm1 / 2;  // the middle step (its last stage's marks stay)
#endif
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
    for (int e = tid; e < n; e += kThreads) {
      xc[e] = a.sol[step * n + e];
      gX1[e] = a.cot[(step + B) * n + e] + gxc[e];
    }
    for (int e = tid; e < zd * h; e += kThreads) b.gfz[e] = 0.f;
    __syncthreads();

    // the stage points x2 (Midpoint), x2..x4 (RK4) from their evaluations
    for (int st = 0; st + 1 < S; ++st) {
      eval_fwd<KC, true, kBf16>(a.w, s, h, xd, zd, st == 0 ? xc : x2 + (st - 1) * n, fz_t, sv, k1 + st * n);
      float* xn = x2 + st * n;
      for (int e = tid; e < n; e += kThreads) {
        if (a.solver == 1) xn[e] = xc[e] + k1[e] * (0.5f * dt);  // x + (dt/2) f(x)
        else if (st == 0) xn[e] = xc[e] + dt * k1[e] * kOneThird;  // RK4, Kutta's 3/8 rule
        else if (st == 1) xn[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
        else xn[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      }
      __syncthreads();
    }
    // the first stage's output cotangent gy, and RK4's stage cotangents
    const float c8 = dt * 0.125f;
    for (int e = tid; e < n; e += kThreads) {
      gxc[e] = gX1[e];
      if (a.solver == 2) {
        gk1[e] = gX1[e] * c8;
        gk2[e] = 3.0f * gX1[e] * c8;
        gk3[e] = 3.0f * gX1[e] * c8;
        gy[e] = gX1[e] * c8;  // g_k4
      } else {
        gy[e] = dt * gX1[e];
      }
    }
    __syncthreads();

    for (int st = 0; st < S; ++st) {
      float* pr = a.pairs + ((static_cast<size_t>(t) * S + st) * B + row) * (2 * kPairs * n);
      eval_bwd<KC, kBf16>(a, s, b, xs_of[st], gy, fz_t, sv, gsv, Pb, pr, tx);  // tx = g_a of the stage
      for (int e = tid; e < n; e += kThreads) {
        const float g = tx[e];
        gxc[e] += g;
        if (a.solver == 1 && st == 0) {
          gy[e] = (0.5f * dt) * g;
        } else if (a.solver == 2) {
          if (st == 0) {
            gk1[e] += dt * g;
            gk2[e] -= dt * g;
            gy[e] = gk3[e] + dt * g;  // final g_k3
          } else if (st == 1) {
            gy[e] = gk2[e] + dt * g;  // final g_k2
            gk1[e] -= dt * g * kOneThird;
          } else if (st == 2) {
            gy[e] = gk1[e] + dt * g * kOneThird;  // final g_k1
          }
        }
      }
      __syncthreads();
    }
    if (lead)
      for (int e = tid; e < zd * h; e += kThreads) a.g_fz[step * zd * h + e] = b.gfz[e];
  }

  float* gs = a.g_sv + row * hh;  // each block its columns
  for_acc<KC>(gsv, h, [&](float& v, int m, int nn) { gs[m * h + nn] = v; });
  if (lead)
    for (int e = tid; e < n; e += kThreads) a.g_x0[static_cast<size_t>(row) * n + e] = gxc[e];
  cl_wait<KC>();  // no block leaves while another may still write its memory
}

// g_w[e] = sum over batch rows b, in order, of partial[b, e] (e < total).
__global__ void reduce_partials(const float* __restrict__ partial, int blocks, long long total,
                                float* __restrict__ g_w) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<size_t>(b) * total + e];
  g_w[e] = acc;
}

// One block per (row range blockIdx.x, pair and channel blockIdx.y = q xd +
// c): over the pair rows of its range, in order, the sums
//   part[k][j] = sum u[q][c][k] v[q][c][j],  part[h h + j] = sum v[q][c][j]
// (pairs rows of 2 kPairs xd h floats, u then v per pair), into its slot
// of `parts` [nsplit, kPairs xd, h h + h]. 256 threads, each an 8 x 8
// register tile of the [h, h] sum; kNc rows staged at once in shared
// memory (u then v, [kNc][kMaxH] each). kBf16: the bf16 compute mode, u and
// v rounded to bf16 where the products read them, the bias sums of v as it
// is.
template <bool kBf16 = false>
__global__ void __launch_bounds__(kCThreads)
    contract_pairs(const float* __restrict__ pairs, long long rows, int xd, int h,
                   float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;
  float* vs = smem + kNc * kMaxH;
  const int split = blockIdx.x, nsplit = gridDim.x, qc = blockIdx.y;
  const int q = qc / xd, c = qc - q * xd, n = xd * h, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r0 = rows * split / nsplit, r1 = rows * (split + 1) / nsplit;
  const long long stride = 2LL * kPairs * n;
  const float* u0 = pairs + (2 * q) * n + c * h;
  const float* v0 = u0 + n;
  float acc[8][8], bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (long long rb = r0; rb < r1; rb += kNc) {
    const int nr = r1 - rb < kNc ? static_cast<int>(r1 - rb) : kNc;
    for (int e = tid; e < kNc * kMaxH; e += kCThreads) {
      const int r = e / kMaxH, k = e % kMaxH;
      const bool ok = r < nr && k < h;
      us[e] = ok ? rnd<kBf16>(__ldg(u0 + (rb + r) * stride + k)) : 0.f;
      vs[e] = ok ? __ldg(v0 + (rb + r) * stride + k) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = us[r * kMaxH + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = vs[r * kMaxH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], rnd<kBf16>(bv[j]), acc[i][j]);
      if (ty == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bsum[j] += bv[j];
      }
    }
    __syncthreads();
  }
  const long long slot = static_cast<long long>(h) * h + h;
  float* out = parts + (static_cast<long long>(split) * gridDim.y + qc) * slot;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = ty + 16 * i, col = tx + 16 * j;
      if (k < h && col < h) out[k * h + col] = acc[i][j];
    }
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < h) out[static_cast<long long>(h) * h + col] = bsum[j];
    }
  }
}

// out[dest(e)] = sum over the row ranges, in order, of parts[., e] for
// every entry e of the kPairs xd slots (PairDest maps a slot's [h, h] and
// [h] into out).
__global__ void reduce_pair_parts(const float* __restrict__ parts, int nsplit, int xd, int h,
                                  PairDest dest, float* __restrict__ out) {
  const long long slot = static_cast<long long>(h) * h + h;
  const long long per = slot * kPairs * xd;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const int qc = static_cast<int>(e / slot);
  const long long r = e - qc * slot;
  const int q = qc / xd, c = qc - q * xd;
  const long long hh = static_cast<long long>(h) * h;
  const long long at = r < hh ? dest.wo[q] + c * hh + r : dest.bo[q] + c * h + (r - hh);
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += parts[sp * per + e];
  out[at] = acc;
}


// ---------------------------------------------------------------------------
// The wide walk (h > kMaxH, to kMaxHBwd): the kernel above on the wide layout
// of csrc/cw_wide.cuh. A stage's a1, a2 and their cotangents live in the
// row's two tiles in global memory, the four h x h x h products of its VJP
// are dealt in 128 x 128 output blocks over the cluster, as the forward's,
// staged 16 values of k at a time (the walk's vectors fill the rest of
// shared memory). g_s_constV is summed in place in the row's g_sv, each
// entry by the one thread that owns it in the g_P0 product, from zero.

constexpr int kWideKw = 16;  // values of k a wide product stages at once

struct WideArgs {
  Args a;
  float* tiles;  // [batch][2][hp][hp]
  int kc;        // blocks a row: the cluster's size
};

// fn(l, j) for each entry (l, j < h) of an [h, h] output that this thread
// owns in the wide products.
template <class F>
__device__ __forceinline__ void for_owned(const WideSmem& s, int h, F fn) {
  const int nbk = s.hp / kWb, nb2 = nbk * nbk;
  const Frag f = frag<1>();
  for (int q = s.rank; q < nb2; q += s.kc) {
    const int l0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
#pragma unroll
    for (int i = 0; i < Tiling<1>::kMi; ++i)
#pragma unroll
      for (int j = 0; j < Tiling<1>::kNi; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int l = l0 + acc_row(f, i, r), c = j0 + acc_col(f, j, r);
          if (l < h && c < h) fn(l, c);
        }
  }
}

// db[j] += sum_{l < h} t[j][l] for the columns j this thread owns: a bias
// grad from a cotangent tile (global, stride hp).
__device__ __forceinline__ void add_bias_grad_wide(const WideSmem& s, float* __restrict__ db, int h,
                                                   const float* t) {
  for (int j = s.rank + s.kc * threadIdx.x; j < h; j += s.kc * kThreads) {
    float sum = 0.f;
    for (int l = 0; l < h; ++l) sum += __ldcg(t + static_cast<size_t>(j) * s.hp + l);
    db[j] += sum;
  }
}

// The VJP of one evaluation, as eval_bwd above, on the wide layout; gs is the
// row's g_s_constV [h, h] in global memory. kBf16: the bf16 compute mode.
template <bool kBf16 = false>
__device__ __forceinline__ void eval_bwd_wide(const Args& a, const WideSmem& s, const BwdSmem& b,
                                              const float* xs, const float* gy, const float* fz_t,
                                              const float* sv, float* __restrict__ gs,
                                              float* __restrict__ Pb, float* __restrict__ pr, float* gx) {
  const int h = a.h, xd = a.xd, zd = a.zd, C = xd + zd, n = xd * h, tid = threadIdx.x, hp = s.hp;
  const int nbk = hp / kWb, nb2 = nbk * nbk, rank = s.rank, kc = s.kc;
  const bool lead = rank == 0;
  const Net& w = a.w;
  const NetT& wt = a.wt;
  const WOp wt1 = tile_op(s.t1, hp), wt2 = tile_op(s.t2, hp);
  Acc<1> acc;
  CW_PHASE(16);
  wide_eval_fwd<false, kWideKw, kBf16>(w, s, h, xd, zd, xs, fz_t, sv, gx);  // t1 = a2, t2 = a1 (gx not read)
  CW_PHASE(17);

  // head: ghe = (gy H1^T) * elu'(HE), go = ghe H0^T
  gemv_ch<kBf16>(gy, h, xd, h, wt.hw1t, nullptr, b.ghe, h, h, false, s.he);
  __syncthreads();
  gemv_ch<kBf16>(b.ghe, h, xd, h, wt.hw0t, nullptr, b.go, h, h, false, nullptr);
  __syncthreads();
  CW_PHASE(18);
  // last vertical layer: dW3[k][c] += sum_l a2[l][k] go[c][l], db3
  if (lead) {
    for (int o = tid; o < h * xd; o += kThreads) {
      const int k = o / xd, c = o - k * xd;
      float sum = 0.f;
      for (int l = 0; l < h; ++l)
        sum = fmaf(rnd<kBf16>(__ldcg(s.t1 + static_cast<size_t>(k) * hp + l)), rnd<kBf16>(b.go[c * h + l]), sum);
      Pb[a.off.w3 + o] += sum;
    }
    for (int c = tid; c < xd; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < h; ++l) sum += b.go[c * h + l];
      Pb[a.off.b3 + c] += sum;
    }
  }
  wide_sync();  // no block reads a2 any more
  // t1: a2 -> g_P2 = (go W3^T) * elu'(a2), in place, over the owned blocks
  for (int q = rank; q < nb2; q += kc) {
    const int l0 = (q / nbk) * kWb, k0 = (q % nbk) * kWb;
    for (int e = tid; e < kWb * kWb; e += kThreads) {
      const int k = k0 + e / kWb, l = l0 + e % kWb;
      if (k >= h || l >= h) continue;
      float g = 0.f;
      for (int c = 0; c < xd; ++c) g = fmaf(rnd<kBf16>(b.go[c * h + l]), s.w3[k * xd + c], g);
      float* p = s.t1 + static_cast<size_t>(k) * hp + l;
      *p = g * delu_act(__ldcg(p));
    }
  }
  wide_sync();
  CW_PHASE(19);
  // dW2 += a1^T g_P2, db2
  for (int q = rank; q < nb2; q += kc) {
    const int k0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
    wide_mma<kWideKw, true, true, kBf16>(wt2, k0, wt1, j0, h, s.sa, s.sb, acc);
    for_wide(acc, [&](float& v, int m, int nn) {
      if (k0 + m < h && j0 + nn < h) atomicAdd(Pb + a.off.w2 + (k0 + m) * h + j0 + nn, v);
    });
  }
  add_bias_grad_wide(s, Pb + a.off.b2, h, s.t1);
  CW_PHASE(20);
  wide_sync();  // no block reads a1 any more
  // t2: g_P1 = (g_P2 W2^T) * elu'(a1)
  for (int q = rank; q < nb2; q += kc) {
    const int l0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
    wide_mma<kWideKw, false, true, kBf16>(wt1, l0, weight_op(w.w2, h), j0, h, s.sa, s.sb, acc);
    for_wide(acc, [&](float& v, int m, int nn) {
      const int l = l0 + m, j = j0 + nn;
      float* p = s.t2 + static_cast<size_t>(j) * hp + l;
      *p = l < h && j < h ? v * delu_act(__ldcg(p)) : 0.f;
    });
  }
  wide_sync();
  CW_PHASE(21);
  for (int q = rank; q < nb2; q += kc) wide_first_layer<kBf16>(s, C, h, q, sv, s.t1);  // t1 = a0 again
  wide_sync();
  CW_PHASE(22);
  // dW1 += a0^T g_P1, db1
  for (int q = rank; q < nb2; q += kc) {
    const int k0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
    wide_mma<kWideKw, true, true, kBf16>(wt1, k0, wt2, j0, h, s.sa, s.sb, acc);
    for_wide(acc, [&](float& v, int m, int nn) {
      if (k0 + m < h && j0 + nn < h) atomicAdd(Pb + a.off.w1 + (k0 + m) * h + j0 + nn, v);
    });
  }
  add_bias_grad_wide(s, Pb + a.off.b1, h, s.t2);
  CW_PHASE(23);
  wide_sync();  // no block reads a0 any more
  // t1: g_P0 = (g_P1 W1^T) * elu'(a0); g_s_constV += g_P0
  for (int q = rank; q < nb2; q += kc) {
    const int l0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
    wide_mma<kWideKw, false, true, kBf16>(wt2, l0, weight_op(w.w1, h), j0, h, s.sa, s.sb, acc);
    for_wide(acc, [&](float& v, int m, int nn) {
      const int l = l0 + m, j = j0 + nn;
      float* p = s.t1 + static_cast<size_t>(j) * hp + l;
      const float g = l < h && j < h ? v * delu_act(__ldcg(p)) : 0.f;
      *p = g;
      if (l < h && j < h) gs[l * h + j] += g;
    });
  }
  wide_sync();
  CW_PHASE(24);
  // the folded first layer: gft[c][l] = sum_j g_P0[l][j] A[c][j] (all),
  // dA[c][j] += sum_l ft[c][l] g_P0[l][j] (the owned columns j)
  for (int o = tid; o < C * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    float g = 0.f;
    for (int j = 0; j < h; ++j)
      g = fmaf(rnd<kBf16>(__ldcg(s.t1 + static_cast<size_t>(j) * hp + l)), s.as[c * h + j], g);
    b.gft[o] = g;
  }
  for (int j = rank + kc * tid; j < h; j += kc * kThreads)
    for (int c = 0; c < C; ++c) {
      float da = 0.f;
      for (int l = 0; l < h; ++l)
        da = fmaf(rnd<kBf16>(s.ft[c * h + l]), rnd<kBf16>(__ldcg(s.t1 + static_cast<size_t>(j) * hp + l)), da);
      Pb[a.off.a + c * h + j] += da;
    }
  __syncthreads();
  CW_PHASE(25);
  cluster_arrive();  // done with t1 until the next evaluation's a0 store
  for (int o = tid; o < zd * h; o += kThreads) b.gfz[o] += b.gft[n + o];

  // ext: gep = (gft[:xd] E1^T) * elu'(E), gx = gep E0^T
  gemv_ch<kBf16>(b.gft, h, xd, h, wt.ew1t, nullptr, b.gep, h, h, false, s.e);
  __syncthreads();
  gemv_ch<kBf16>(b.gep, h, xd, h, wt.ew0t, nullptr, gx, h, h, false, nullptr);

  if (lead) {
    const float* pairs[kPairs][2] = {{s.he, gy}, {s.ot, b.ghe}, {s.e, b.gft}, {xs, b.gep}};
    for (int q = 0; q < kPairs; ++q)
      for (int r = 0; r < 2; ++r)
        for (int e = tid; e < n; e += kThreads) pr[(2 * q + r) * n + e] = pairs[q][r][e];
  }
  __syncthreads();
  CW_PHASE(26);
}

size_t wide_smem_floats(int h, int xd, int zd) {
  const size_t xdh = static_cast<size_t>(xd) * h, C = xd + zd;
  // WideSmem; gft, gfz; ghe, go, gep; the 14 vectors of the walk
  return wide_eval_floats<kWideKw>(h, xd, zd) + C * h + static_cast<size_t>(zd) * h + 3 * xdh + 14 * xdh;
}

template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1)
    fused_cw_rollout_bwd_wide_kernel(const __grid_constant__ WideArgs wa) {
  extern __shared__ __align__(16) float smem[];
  const Args& a = wa.a;
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x / wa.kc, tid = threadIdx.x;
  const int n = xd * h, C = xd + zd;
  WideSmem s;
  BwdSmem b;
  float* p = carve_wide<kWideKw>(s, smem, h, xd, zd);
  s.hp = wide_pad(h);
  s.kc = wa.kc;
  s.rank = static_cast<int>(cluster_rank());
  const bool lead = s.rank == 0;
  s.t1 = wa.tiles + static_cast<size_t>(row) * 2 * s.hp * s.hp;
  s.t2 = s.t1 + static_cast<size_t>(s.hp) * s.hp;
  b.gft = p;   p += C * h;
  b.gfz = p;   p += zd * h;
  b.y = nullptr;
  b.ghe = p;   p += n;
  b.go = p;    p += n;
  b.gep = p;   p += n;
  float* xc = p;   p += n;
  float* x2 = p;   p += n;
  float* x3 = p;   p += n;
  float* x4 = p;   p += n;
  float* k1 = p;   p += n;
  float* k2 = p;   p += n;
  float* k3 = p;   p += n;
  float* gX1 = p;  p += n;
  float* gxc = p;  p += n;
  float* gk1 = p;  p += n;
  float* gk2 = p;  p += n;
  float* gk3 = p;  p += n;
  float* gy = p;   p += n;
  float* tx = p;

  init_wide(a.w, s, h, xd, zd);
  for (int e = tid; e < n; e += kThreads) gxc[e] = 0.f;
  const size_t hh = static_cast<size_t>(h) * h;
  const float* sv = a.sv + row * hh;
  float* gs = a.g_sv + row * hh;
  for_owned(s, h, [&](int l, int j) { gs[l * h + j] = 0.f; });
  float* Pb = a.partial + static_cast<size_t>(row) * a.off.ew0;
  const int S = n_stages(a.solver);
  const float* xs_of[4] = {xc, nullptr, nullptr, nullptr};
  if (a.solver == 1) {
    xs_of[0] = x2;
    xs_of[1] = xc;
  } else if (a.solver == 2) {
    xs_of[0] = x4;
    xs_of[1] = x3;
    xs_of[2] = x2;
    xs_of[3] = xc;
  }
  __syncthreads();
  cluster_arrive();  // t1 is free: the first evaluation's a0 store waits for this

  for (int t = a.tm1 - 1; t >= 0; --t) {
#ifdef CW_PHASE_CLOCK
    if (blockIdx.x == 0 && tid == 0) g_phase_on = t == a.tm1 / 2;
#endif
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
    for (int e = tid; e < n; e += kThreads) {
      xc[e] = a.sol[step * n + e];
      gX1[e] = a.cot[(step + B) * n + e] + gxc[e];
    }
    for (int e = tid; e < zd * h; e += kThreads) b.gfz[e] = 0.f;
    __syncthreads();
    for (int st = 0; st + 1 < S; ++st) {
      wide_eval_fwd<true, kWideKw, kBf16>(a.w, s, h, xd, zd, st == 0 ? xc : x2 + (st - 1) * n, fz_t, sv,
                                          k1 + st * n);
      float* xn = x2 + st * n;
      for (int e = tid; e < n; e += kThreads) {
        if (a.solver == 1) xn[e] = xc[e] + k1[e] * (0.5f * dt);
        else if (st == 0) xn[e] = xc[e] + dt * k1[e] * kOneThird;
        else if (st == 1) xn[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
        else xn[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      }
      __syncthreads();
    }
    const float c8 = dt * 0.125f;
    for (int e = tid; e < n; e += kThreads) {
      gxc[e] = gX1[e];
      if (a.solver == 2) {
        gk1[e] = gX1[e] * c8;
        gk2[e] = 3.0f * gX1[e] * c8;
        gk3[e] = 3.0f * gX1[e] * c8;
        gy[e] = gX1[e] * c8;
      } else {
        gy[e] = dt * gX1[e];
      }
    }
    __syncthreads();
    for (int st = 0; st < S; ++st) {
      float* pr = a.pairs + ((static_cast<size_t>(t) * S + st) * B + row) * (2 * kPairs * n);
      eval_bwd_wide<kBf16>(a, s, b, xs_of[st], gy, fz_t, sv, gs, Pb, pr, tx);
      for (int e = tid; e < n; e += kThreads) {
        const float g = tx[e];
        gxc[e] += g;
        if (a.solver == 1 && st == 0) {
          gy[e] = (0.5f * dt) * g;
        } else if (a.solver == 2) {
          if (st == 0) {
            gk1[e] += dt * g;
            gk2[e] -= dt * g;
            gy[e] = gk3[e] + dt * g;
          } else if (st == 1) {
            gy[e] = gk2[e] + dt * g;
            gk1[e] -= dt * g * kOneThird;
          } else if (st == 2) {
            gy[e] = gk1[e] + dt * g * kOneThird;
          }
        }
      }
      __syncthreads();
    }
    if (lead)
      for (int e = tid; e < zd * h; e += kThreads) a.g_fz[step * zd * h + e] = b.gfz[e];
  }
  if (lead)
    for (int e = tid; e < n; e += kThreads) a.g_x0[static_cast<size_t>(row) * n + e] = gxc[e];
  cluster_wait();  // no block leaves while another may still read the tiles
}

int wide_cluster(int batch, int h, int xd, int zd) {
  return pick_wide_cluster(fused_cw_rollout_bwd_wide_kernel<kBuildBf16>, batch, wide_pad(h),
                           wide_smem_floats(h, xd, zd) * sizeof(float));
}

// contract_pairs for h > kMaxH: block z of the grid's third dimension takes
// the 128 x 128 block (z / nbk, z % nbk) of each [h, h] sum, and the bias
// sums where z / nbk is 0; otherwise the same.
template <bool kBf16 = false>
__global__ void __launch_bounds__(kCThreads)
    contract_pairs_wide(const float* __restrict__ pairs, long long rows, int xd, int h,
                        float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;
  float* vs = smem + kNc * kWb;
  const int split = blockIdx.x, nsplit = gridDim.x, qc = blockIdx.y, nbk = wide_pad(h) / kWb;
  const int k0 = (blockIdx.z / nbk) * kWb, c0 = (blockIdx.z % nbk) * kWb;
  const int q = qc / xd, c = qc - q * xd, n = xd * h, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r0 = rows * split / nsplit, r1 = rows * (split + 1) / nsplit;
  const long long stride = 2LL * kPairs * n;
  const float* u0 = pairs + (2 * q) * n + c * h;
  const float* v0 = u0 + n;
  float acc[8][8], bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (long long rb = r0; rb < r1; rb += kNc) {
    const int nr = r1 - rb < kNc ? static_cast<int>(r1 - rb) : kNc;
    for (int e = tid; e < kNc * kWb; e += kCThreads) {
      const int r = e / kWb, k = e % kWb;
      us[e] = r < nr && k0 + k < h ? rnd<kBf16>(__ldg(u0 + (rb + r) * stride + k0 + k)) : 0.f;
      vs[e] = r < nr && c0 + k < h ? __ldg(v0 + (rb + r) * stride + c0 + k) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = us[r * kWb + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = vs[r * kWb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], rnd<kBf16>(bv[j]), acc[i][j]);
      if (ty == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bsum[j] += bv[j];
      }
    }
    __syncthreads();
  }
  const long long slot = static_cast<long long>(h) * h + h;
  float* out = parts + (static_cast<long long>(split) * gridDim.y + qc) * slot;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + ty + 16 * i, col = c0 + tx + 16 * j;
      if (k < h && col < h) out[static_cast<long long>(k) * h + col] = acc[i][j];
    }
  if (ty == 0 && k0 == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < h) out[static_cast<long long>(h) * h + col] = bsum[j];
    }
  }
}

// The contraction of `rows` pair rows into out at dest, in this build's
// compute mode: both kernels on stream st (above kMaxH,
// contract_pairs_wide in place of contract_pairs).
// parts holds nsplit x kPairs xd (h^2 + h) floats.
cudaError_t launch_contraction(const float* pairs, long long rows, int xd, int h,
                               const PairDest& dest, float* parts, float* out,
                               cudaStream_t st) {
  const int nsplit = n_splits(rows);
  const size_t smem = 2 * kNc * kMaxH * sizeof(float);
  if (h > kMaxH) {
    const int nbk = wide_pad(h) / kWb;
    const dim3 wgrid(nsplit, kPairs * xd, nbk * nbk);
    contract_pairs_wide<kBuildBf16><<<wgrid, kCThreads, smem, st>>>(pairs, rows, xd, h, parts);
  } else {
    const dim3 grid(nsplit, kPairs * xd);
    contract_pairs<kBuildBf16><<<grid, kCThreads, smem, st>>>(pairs, rows, xd, h, parts);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long per = (static_cast<long long>(h) * h + h) * kPairs * xd;
  const int blocks = static_cast<int>((per + 255) / 256);
  reduce_pair_parts<<<blocks, 256, 0, st>>>(parts, nsplit, xd, h, dest, out);
  return cudaGetLastError();
}

}  // namespace

// sizes[0]: floats of the flat gradient row g_w; sizes[1]: floats of one
// block's row of dense partials; sizes[2]: floats of the pairs buffer;
// sizes[3]: floats of the contraction's partial sums; sizes[4]: floats of
// the wide walk's tiles ([batch][2][hp][hp] above kMaxH, else 0).
extern "C" void psn_fused_cw_bwd_sizes(int tm1, int batch, int h, int xd, int zd, int solver,
                                       long long* sizes) {
  const GradOffsets o = grad_offsets(h, xd, zd);
  const long long rows = static_cast<long long>(tm1) * n_stages(solver) * batch;
  const long long hp = wide_pad(h);
  sizes[0] = o.total;
  sizes[1] = o.ew0;
  sizes[2] = rows * 2 * kPairs * xd * h;
  sizes[3] = static_cast<long long>(n_splits(rows)) * kPairs * xd * (static_cast<long long>(h) * h + h);
  sizes[4] = h > kMaxH ? static_cast<long long>(batch) * 2 * hp * hp : 0;
}

namespace {

// The backward's launches in this build's compute mode
// (psn_fused_cw_rollout_bwd_f32 / _bf16).
int backward(const void* fz, const void* dt, const void* sv, const void* sol, const void* cot,
             const void* const* w, const void* const* wt, void* g_fz, void* g_sv, void* partial,
             void* g_w, void* g_x0, void* pairs, void* parts, void* scratch, int tm1, int batch, int h,
             int xd, int zd, int solver, int cluster, void* stream) {
  const bool wide = h > kMaxH;
  if (tm1 < 1 || batch < 1 || h < 1 || h > kMaxHBwd || xd < 1 || zd < 0 || solver < 0 ||
      solver > 2 || (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4 && !(wide && cluster == 8)))
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
  a.pairs = static_cast<float*>(pairs);
  a.off = grad_offsets(h, xd, zd);
  a.g_x0 = static_cast<float*>(g_x0);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.zd = zd;
  a.solver = solver;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wide) {
    if (cluster == 0) cluster = wide_cluster(batch, h, xd, zd);
    const WideArgs wa{a, static_cast<float*>(scratch), cluster};
    e = launch_clusters(fused_cw_rollout_bwd_wide_kernel<kBuildBf16>, batch, cluster,
                        wide_smem_floats(h, xd, zd) * sizeof(float), st, wa);
  } else {
    const size_t smem = smem_floats(h, xd, zd) * sizeof(float);
    if (cluster == 0)
      cluster = pick_cluster(fused_cw_rollout_bwd_kernel<4, kBuildBf16>, fused_cw_rollout_bwd_kernel<2, kBuildBf16>,
                             batch, smem);
    e = cluster == 4   ? launch_clusters(fused_cw_rollout_bwd_kernel<4, kBuildBf16>, batch, 4, smem, st, a)
        : cluster == 2 ? launch_clusters(fused_cw_rollout_bwd_kernel<2, kBuildBf16>, batch, 2, smem, st, a)
                       : launch_clusters(fused_cw_rollout_bwd_kernel<1, kBuildBf16>, batch, 1, smem, st, a);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* gw = static_cast<float*>(g_w);
  const int grid = static_cast<int>((a.off.ew0 + 255) / 256);
  reduce_partials<<<grid, 256, 0, st>>>(a.partial, batch, a.off.ew0, gw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const PairDest dest{{a.off.hw1, a.off.hw0, a.off.ew1, a.off.ew0},
                      {a.off.hb1, a.off.hb0, a.off.eb1, a.off.eb0}};
  const long long rows = static_cast<long long>(tm1) * n_stages(solver) * batch;
  return static_cast<int>(launch_contraction(a.pairs, rows, xd, h, dest,
                                             static_cast<float*>(parts), gw, st));
}

// The contraction alone in this build's compute mode (psn_cw_contract_pairs_f32 / _bf16).
int contract(const void* pairs, long long rows, int h, int xd, void* parts, void* out, void* stream) {
  if (rows < 1 || h < 1 || h > kMaxHBwd || xd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long hh = static_cast<long long>(h) * h;
  PairDest dest{};
  for (int q = 0; q < kPairs; ++q) {
    dest.wo[q] = q * xd * hh;
    dest.bo[q] = kPairs * xd * hh + static_cast<long long>(q) * xd * h;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_contraction(static_cast<const float*>(pairs), rows, xd, h, dest,
                                             static_cast<float*>(parts), static_cast<float*>(out),
                                             st));
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; w is a host array of the 15 weight pointers in
// the order of flatten_weights, wt one of the 6 transposes of
// transposed_weights (ops/fused_channelwise_vjp.py). `partial` is [batch,
// sizes[1]] and must be zero; g_w receives the summed gradients in the
// flatten_weights layout; pairs and parts are scratch of sizes[2] and
// sizes[3] floats, and above kMaxH scratch the wide walk's tiles of
// sizes[4]. solver: 0 Euler, 1 Midpoint, 2 RK4 (3/8 rule). cluster: blocks
// per batch row of the walk, as for psn_fused_cw_rollout_f32 (the wide
// walk's 1, 2, 4 or 8 above kMaxH). Launches the walk, the dense partials'
// sum and the contraction on `stream` without synchronising and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for h outside
// 1..kMaxHBwd or another cluster size. psn_cw_contract_pairs_f32: the
// contraction alone, for its tests and timing: pairs [rows, kPairs, 2, xd,
// h] into dW [kPairs, xd, h, h] followed by db [kPairs, xd, h] in out;
// parts as sizes[3] of psn_fused_cw_bwd_sizes for these rows (tm1 = rows,
// batch = 1, Euler); launches on `stream` and returns cudaGetLastError().
// psn_fused_cw_rollout_bwd_bf16 and psn_cw_contract_pairs_bf16 (the
// -DPSN_BF16 build, in place of the _f32 ones): the bf16 compute mode, the
// same arguments with the 2-D weights and their transposes holding bf16
// values; every output float32.
#ifdef PSN_BF16
extern "C" int psn_fused_cw_rollout_bwd_bf16(
    const void* fz, const void* dt, const void* sv, const void* sol, const void* cot,
    const void* const* w, const void* const* wt, void* g_fz, void* g_sv, void* partial,
    void* g_w, void* g_x0, void* pairs, void* parts, void* scratch, int tm1, int batch, int h,
    int xd, int zd, int solver, int cluster, void* stream) {
  return backward(fz, dt, sv, sol, cot, w, wt, g_fz, g_sv, partial, g_w, g_x0, pairs, parts, scratch, tm1, batch,
                  h, xd, zd, solver, cluster, stream);
}

extern "C" int psn_cw_contract_pairs_bf16(const void* pairs, long long rows, int h, int xd, void* parts, void* out,
                                          void* stream) {
  return contract(pairs, rows, h, xd, parts, out, stream);
}
#else
extern "C" int psn_fused_cw_rollout_bwd_f32(
    const void* fz, const void* dt, const void* sv, const void* sol, const void* cot,
    const void* const* w, const void* const* wt, void* g_fz, void* g_sv, void* partial,
    void* g_w, void* g_x0, void* pairs, void* parts, void* scratch, int tm1, int batch, int h,
    int xd, int zd, int solver, int cluster, void* stream) {
  return backward(fz, dt, sv, sol, cot, w, wt, g_fz, g_sv, partial, g_w, g_x0, pairs, parts, scratch, tm1, batch,
                  h, xd, zd, solver, cluster, stream);
}

extern "C" int psn_cw_contract_pairs_f32(const void* pairs, long long rows, int h, int xd, void* parts, void* out,
                                         void* stream) {
  return contract(pairs, rows, h, xd, parts, out, stream);
}
#endif

#ifdef CW_PHASE_CLOCK
// The phase clock's kPhaseMarks marks of the last launch (csrc/cw_tile.cuh),
// copied to out after the device is synchronised; returns the error.
extern "C" int psn_cw_phase_clock(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * kPhaseMarks);
  return static_cast<int>(e);
}
#endif

// The blocks per batch row psn_fused_cw_rollout_bwd_f32 (_bf16) takes for
// cluster = 0 at these shapes on the current device.
extern "C" int psn_fused_cw_bwd_cluster(int batch, int h, int xd, int zd) {
  if (h > kMaxH) return wide_cluster(batch, h, xd, zd);
  return pick_cluster(fused_cw_rollout_bwd_kernel<4, kBuildBf16>, fused_cw_rollout_bwd_kernel<2, kBuildBf16>,
                      batch, smem_floats(h, xd, zd) * sizeof(float));
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
