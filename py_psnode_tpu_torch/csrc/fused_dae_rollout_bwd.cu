// Reverse-time VJP of the fused DAE rollout: a time-parallel recompute, the
// reverse walk of the cotangents, and a time-parallel contraction of the
// weight gradients, three kernels launched in order by one call.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_dae_vjp.py:_bwd_kernel
// (:147), launched by _run_backward (pallas_call at :562). It computes the
// same function at float32 accuracy, without the TPU's grid, time padding
// or lanes; its bf16 compute mode (below) is the TPU kernel's
// precision="bfloat16". Per batch row, for t = T-2 down to 0,
// with x_t, i_t, x_{t+1} from the saved packed solution and the carries
// gx_c, gi_c (zero at the start):
//
//   gX1 = cot_x[t+1] + gx_c,  gI1 = cot_i[t+1] + gi_c
//   i_in = ev[t] > 0 ? AE(x_t, s_ae_ev[t]) : i_t          (recomputed)
//   AE at t+1:  backprop gI1 through AE(x_{t+1}, s_ae[t]) -> g_s_ae[t],
//               gX1 += its x cotangent
//   DE stages:  the Euler / Midpoint / RK4-3/8 stages of
//               f(x) = DE(s_de[t] + x @ wx_de + i_in @ wi_de), backprop
//               the step -> g_s_de[t] (sum over stages), g_x, g_i_in
//   events:     rows with ev > 0 send g_i_in through the AE_ev VJP into
//               g_s_ae_ev[t] and the x carry; the other rows keep it in
//               the i carry (g_s_ae_ev[t] = 0 there)
//
// and every weight and bias gradient summed over all rows and steps. g_x0 /
// g_i0 are the carries after step 0 (the wrapper adds cot[0]).
//
// The TF-x mode (teacher forcing of x, the TPU kernel's tf_x; kernels of
// their own, the template flag kTfx of the same bodies): the stages start
// from x_true[t] and the AE at t+1 reads x_true[t+1] (the recompute takes
// them, and the contraction's first-layer operand with them), so the
// stages' x cotangent goes to g_xt[t] and the AE's to g_xt1[t], each
// written only where the caller gives a buffer, and the x carry keeps only
// the event route's part; the AE at the event still reads the rolled x_t.
//
// The bf16 compute mode (the TPU kernel's cdtype :187 and _dot_t :52 on the
// cast residuals of _vjp_forward :596-625; kernels of their own, the
// template flag kBf16 of the same bodies, the TF-x ones too): the streams arrive
// as bfloat16 (the forward's cast ones), the padded weights hold the bf16
// weights' values; the recompute rounds each layer's input tile and the
// walk each cotangent to bf16 as a product reads them, the contraction both
// operands of every weight-gradient product; the recompute's and the
// contraction's products run in one TF32 pass (exact for bf16 operands),
// not three. The stream cotangents, the carries and every gradient stay
// float32; the backward is bit-identical on relaunch as in float32.
//
// Bound on an H100 SXM at the main training shape (B=64, T=1001, h=128,
// xd=3, id=2, three-layer tails, RK4): a row-step evaluates four DE stages
// and the AE at t+1 and backpropagates each, two products a layer (the
// cotangent and the weight gradient): 1.0 MFLOP, 6.5e10 for the call. Its
// h x h products (two hidden layers an evaluation, three times each) are
// 6.3e10, 0.38 ms in three TF32 passes at 495 TFLOP/s; the rest, at
// float32's 67 TFLOP/s, 0.03 ms (all on the CUDA cores: 0.97 ms). Its
// bytes (three h-wide streams in, three out: 197 MB) take 0.06 ms at 3.35
// TB/s. The design's buffers (the residuals and their cotangents, six
// evaluation slots of three layers: 1.2 GB at RK4) are written once and
// read once more.
//
// What the design does about the serial chain: the forward recompute (the
// AE and the stages, 30% of a step of the one-kernel walk this design
// replaces) and the weight-gradient sums (`accumulate`, 40%: the pass over
// 65 k partial gradients a row-step; utils/phase_clock.py) leave the walk
// for two kernels that run over all row-steps at once on the tensor cores.
// The walk keeps the cotangent chain, 15 dependent matrix-vector layers a
// step at RK4 (three for the AE at t+1, twelve for the stages, three more
// on an event), each with its elu' prefetched a step ahead; the DE's two
// hidden weights are resident in shared memory, the AE's come through L1
// and L2 (the four do not fit in one block's 227 KB, and with three
// resident the walk is slower than with two: the L1 left is too small).
// csrc/noencode_bwd.cuh holds the three kernels' building blocks.

#include "noencode_bwd.cuh"

namespace {

// Offsets of each gradient in the flat gradient row, in the order of
// flatten_weights in ops/fused_dae_vjp.py: wx_de, wi_de, gx_ae, the DE tail
// (W, b)..., the AE tail (W, b)...; hidden layers are [h, h], the last [h,
// out].
struct GradOffsets {
  int wx, wi, gx;
  int de_w[kMaxTail], de_b[kMaxTail];
  int ae_w[kMaxTail], ae_b[kMaxTail];
  int total;
};

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

struct Args {
  const float* s_de;     // [tm1, batch, h]
  const float* s_ae;     // [tm1, batch, h]
  const float* s_ae_ev;  // [tm1, batch, h]
  const float* aux;      // [tm1, batch, 2]: (dt, ev)
  const float* x0;       // [batch, xd]
  const float* i0;       // [batch, id]
  const float* sol;      // [tm1, batch, xd + id]: (x, i) of steps 1..tm1
  const float* cot;      // [tm1 + 1, batch, xd + id]: cotangents of (x, i)
  Net de;                // first layer [wx_de; wi_de] (kin = xd + id), out = xd
  Net ae;                // first layer gx_ae (kin = xd), out = id
  Bufs bf;               // slots: the S stages, the AE at t+1, the AE at the event
  float* g_s_de;         // [tm1, batch, h]
  float* g_s_ae;         // [tm1, batch, h]
  float* g_s_ae_ev;      // [tm1, batch, h]
  float* g_x0;           // [batch, xd]
  float* g_i0;           // [batch, id]
  int tm1, batch, xd, id, solver;
  int H;                 // the padded width (kMaxH: the 128-wide kernels)
  float* scratch;        // the wide kernels' global scratch (the contraction's partial sums)
  const float* xt;       // the TF-x mode: x_true[:-1] [tm1, batch, xd]
  const float* xt1;      // and x_true[1:]
  float* g_xt;           // their cotangents [tm1, batch, xd] (null: not written)
  float* g_xt1;
};

// The wide walk's vectors of H floats.
constexpr int kDaeWalkVecs = 11;

// ---- kernel 1: every evaluation of every row-step, a tile of kRows at a time ----
template <bool kWide, bool kTfx = false, bool kBf16 = false>
__device__ __forceinline__ void dae_recompute_body(const Args& a, float* smem) {
  using ST = Stream<kBf16>;
  const ST* s_de = reinterpret_cast<const ST*>(a.s_de);
  const ST* s_ae = reinterpret_cast<const ST*>(a.s_ae);
  const ST* s_ae_ev = reinterpret_cast<const ST*>(a.s_ae_ev);
  const RcSmem s = kWide ? carve_rc_wide(smem, a.scratch + blockIdx.x * rc_wide_tile_floats(a.H), a.H)
                         : carve_rc(smem);
  const Bufs& bf = a.bf;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows, B = a.batch;
  const int xd = a.xd, id = a.id, D = xd + id, S = n_stages(a.solver);
  const int eN = S, eV = S + 1;  // the AE at t+1, the AE at the event
  rc_begin(s, r0, bf.R, [&](long long r) { return __ldg(a.aux + 2 * r); },
           [&](long long r) { return __ldg(a.aux + 2 * r + 1); }, kWide ? a.H * kLdt : kTile);
  __syncthreads();
  rc_any_event(s);
  __syncthreads();
  auto eval = [&](const Net& net, int e, const ST* st, auto keep, float* y) {
    if constexpr (kWide) {
      rc_eval_wide<kBf16>(net, bf, e, r0, st, s, keep, y, bf.ow, a.H);
    } else {
      rc_eval<kBf16>(net, bf, e, r0, st, s, keep, y, bf.ow);
    }
  };
  // x_t, i_t (row t-1 of the packed solution, x0 / i0 at t = 0), x_{t+1}
  auto x_t = [&](long long r, int c) {
    return r < B ? __ldg(a.x0 + r * xd + c) : __ldg(a.sol + (r - B) * D + c);
  };
  auto i_t = [&](long long r, int c) {
    return r < B ? __ldg(a.i0 + r * id + c) : __ldg(a.sol + (r - B) * D + xd + c);
  };
  if (s.flag[0] > 0.f) {  // i_in exactly as the forward computed it, on event rows
    rc_input(s, bf, eV, r0, xd, [&](int m, int c) { return x_t(r0 + m, c); });
    eval(a.ae, eV, s_ae_ev, [&](int m) { return s.ev[m] > 0.f; }, bf.gy_row(eV, 0));
  }
  rc_input(s, bf, eN, r0, xd, [&](int m, int c) {  // x_{t+1}, or x_true[t+1]
    return kTfx ? __ldg(a.xt1 + (r0 + m) * xd + c) : __ldg(a.sol + (r0 + m) * D + c);
  });
  eval(a.ae, eN, s_ae, [](int) { return true; }, nullptr);
  // stage q's output k_q waits in gy slot q, the AE at the event's in slot
  // eV (the walk overwrites both)
  auto k = [&](int q, long long r, int c) { return bf.gy_row(q, r)[c]; };
  for (int q = 0; q < S; ++q) {
    rc_input(s, bf, q, r0, D, [&](int m, int c) {
      const long long r = r0 + m;
      if (c >= xd) return s.ev[m] > 0.f ? bf.gy_row(eV, r)[c - xd] : i_t(r, c - xd);
      const float x = kTfx ? __ldg(a.xt + r * xd + c) : x_t(r, c), dt = s.dt[m];  // the step's start
      if (q == 0) return x;
      if (a.solver == 1) return x + k(0, r, c) * (0.5f * dt);  // Midpoint
      if (q == 1) return x + dt * k(0, r, c) * kOneThird;     // RK4, Kutta's 3/8 rule
      if (q == 2) return x + dt * (k(1, r, c) - k(0, r, c) * kOneThird);
      return x + dt * (k(0, r, c) - k(1, r, c) + k(2, r, c));
    });
    eval(a.de, q, s_de, [](int) { return true; }, q + 1 < S ? bf.gy_row(q, 0) : nullptr);
  }
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<false>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_wide(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_tfx(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<false, true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_wide_tfx(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<true, true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_bf16(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<false, false, true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_wide_bf16(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<true, false, true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_tfx_bf16(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<false, true, true>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_recompute_wide_tfx_bf16(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  dae_recompute_body<true, true, true>(a, smem);
}

// ---- kernel 2: the reverse walk, one block per batch row ----
// kWide: the walk at a padded width H > kMaxH (no resident weight, no
// prefetch; the vectors H long, in shared memory or, without vec_smem, in
// the block's share of the scratch). kTfx: the TF-x mode. kBf16: the bf16
// mode.
template <bool kWide, bool kTfx = false, bool kBf16 = false>
__device__ __forceinline__ void dae_walk_body(const Args& a, int slots, bool vec_smem, float* smem) {
  const Bufs& bf = a.bf;
  const int xd = a.xd, id = a.id, D = xd + id, B = a.batch, h = bf.h, tid = threadIdx.x;
  const int S = n_stages(a.solver), eN = S, eV = S + 1;
  const int row = blockIdx.x, k = walk_k();
  const int step_f = walk_step_floats(bf.E, bf.L), slot_f = bf.L * kMaxH;
  const int V = kWide ? a.H : kMaxH;  // floats of a vector
  float* wres = smem;
  float* pf = wres + static_cast<size_t>(slots) * kMat;  // two steps
  float* va = kWide ? (vec_smem ? smem : a.scratch + static_cast<size_t>(row) * kDaeWalkVecs * V) : pf + 2 * step_f;
  float* vb = va + V;
  float* gyv = vb + V;   // the output cotangent of the next evaluation
  float* gX1 = gyv + V;  // cotangent of x_{t+1}
  float* gxc = gX1 + V;  // x carry, then dL/dx_t of the step
  float* gic = gxc + V;  // i carry
  float* gii = gic + V;  // cotangent of i_in
  float* gk1 = gii + V;  // RK4 stage cotangents
  float* gk2 = gk1 + V;
  float* gk3 = gk2 + V;
  float* gsv = gk3 + V;  // the wide walk's sum of the stages' first-layer cotangents

  if constexpr (!kWide) {
    load_resident(a.de, wres);
    load_resident(a.ae, wres);
  }
  for (int e = tid; e < V; e += kThreads) {
    gxc[e] = 0.f;
    gic[e] = 0.f;
  }
  auto prefetch = [&](int t, float* dst) {
    const long long r = static_cast<long long>(t) * B + row;
    walk_prefetch(bf, dst, r, a.cot + (r + B) * D, D, a.aux + 2 * r, 2);
    cp_async_commit();
  };
  if constexpr (!kWide) prefetch(a.tm1 - 1, pf + ((a.tm1 - 1) & 1) * step_f);
  for (int t = a.tm1 - 1; t >= 0; --t) {
    const long long r = static_cast<long long>(t) * B + row;
    const float* P = nullptr;  // slot q's layers at P + q slot_f (the 128-wide walk)
    const float* cot;
    float dt;
    bool ev;
    if constexpr (kWide) {
      __syncthreads();  // the last step's carries visible to every thread
      cot = a.cot + (r + B) * D;
      dt = __ldg(a.aux + 2 * r);
      ev = __ldg(a.aux + 2 * r + 1) > 0.f;
    } else {
      cp_async_wait<0>();
      __syncthreads();  // step t landed; every thread is done with the other buffer
      if (t > 0) prefetch(t - 1, pf + ((t - 1) & 1) * step_f);
      P = pf + (t & 1) * step_f;
      cot = P + bf.E * slot_f;
      dt = cot[kMaxH];
      ev = cot[kMaxH + 1] > 0.f;
    }
    auto eval = [&](const Net& net, int e) {
      if constexpr (kWide) {
        return walk_eval_wide<kBf16>(net, bf, e, r, gyv, va, vb, V);
      } else {
        return walk_eval<kBf16>(net, bf, e, r, P + e * slot_f, gyv, va, vb, wres);
      }
    };
    auto inputs = [&](const Net& net, const float* v, auto fn) {
      if constexpr (kWide) {
        walk_inputs_wide<kBf16>(net, v, V, fn);
      } else {
        walk_inputs<kBf16>(net, v, fn);
      }
    };
    // row r of a stream cotangent: fn(j) at each of the thread's outputs j < h
    auto put = [&](float* dst, auto fn) {
      if constexpr (kWide) {
        if (walk_ks() == 0)
          for (int j = k; j < h; j += kMaxH) dst[r * h + j] = fn(j);
      } else {
        if (walk_ks() == 0 && k < h) dst[r * h + k] = fn(k);
      }
    };
    NE_PHASE(0);
    for (int c = tid; c < xd; c += kThreads) gX1[c] = cot[c] + gxc[c];
    for (int c = tid; c < id; c += kThreads) {
      gyv[c] = cot[xd + c] + gic[c];  // gI1
      gii[c] = 0.f;
    }
    __syncthreads();

    // ---- the AE at t+1, from gI1; its x cotangent to gX1, or in the
    // TF-x mode to g_xt1 (x_true[t+1] was its input) ----
    const float* v = eval(a.ae, eN);
    put(a.g_s_ae, [&](int j) { return v[j]; });
    if constexpr (kTfx) {
      if (a.g_xt1) inputs(a.ae, v, [&](int c, float g) { a.g_xt1[r * xd + c] = g; });
    } else {
      inputs(a.ae, v, [&](int c, float g) { gX1[c] += g; });
    }
    __syncthreads();
    NE_PHASE(1);

    // ---- the DE stages' VJPs, last stage first; gsde, the sum of their
    // first layers' cotangents, is kept by the threads of output k (wide:
    // in gsv, each element by the thread of its output) ----
    float gsde = 0.f;
    if constexpr (kWide) {
      if (walk_ks() == 0)
        for (int j = k; j < V; j += kMaxH) gsv[j] = 0.f;
    }
    auto stage = [&](int q, auto glue) {
      const float* u = eval(a.de, q);
      if constexpr (kWide) {
        if (walk_ks() == 0)
          for (int j = k; j < V; j += kMaxH) gsv[j] += u[j];
      } else {
        gsde += u[k];
      }
      inputs(a.de, u, [&](int c, float g) {
        if (c < xd) {
          glue(c, g);
        } else {
          gii[c - xd] += g;
        }
      });
      __syncthreads();
    };
    if (a.solver == 0) {  // Euler: x1 = x + dt f(x)
      for (int c = tid; c < xd; c += kThreads) gyv[c] = dt * gX1[c];
      __syncthreads();
      stage(0, [&](int c, float g) { gxc[c] = gX1[c] + g; });
    } else if (a.solver == 1) {  // Midpoint
      for (int c = tid; c < xd; c += kThreads) gyv[c] = dt * gX1[c];
      __syncthreads();
      stage(1, [&](int c, float g) {  // g = g_xmid
        gyv[c] = (0.5f * dt) * g;
        gxc[c] = gX1[c] + g;
      });
      stage(0, [&](int c, float g) { gxc[c] += g; });
    } else {  // RK4, Kutta's 3/8 rule
      const float cc = dt * 0.125f;
      for (int c = tid; c < xd; c += kThreads) {
        gk1[c] = gX1[c] * cc;
        gk2[c] = 3.0f * gX1[c] * cc;
        gk3[c] = 3.0f * gX1[c] * cc;
        gyv[c] = gX1[c] * cc;  // g_k4
        gxc[c] = gX1[c];
      }
      __syncthreads();
      stage(3, [&](int c, float g) {  // g_a4
        gxc[c] += g;
        gk1[c] += dt * g;
        gk2[c] -= dt * g;
        gyv[c] = gk3[c] + dt * g;  // final g_k3
      });
      stage(2, [&](int c, float g) {  // g_a3
        gxc[c] += g;
        gyv[c] = gk2[c] + dt * g;  // final g_k2
        gk1[c] -= dt * g * kOneThird;
      });
      stage(1, [&](int c, float g) {  // g_a2
        gxc[c] += g;
        gyv[c] = gk1[c] + dt * g * kOneThird;  // final g_k1
      });
      stage(0, [&](int c, float g) { gxc[c] += g; });  // g_a1
    }
    if constexpr (kWide) {
      put(a.g_s_de, [&](int j) { return gsv[j]; });
    } else {
      if (walk_ks() == 0 && k < h) a.g_s_de[r * h + k] = gsde;
    }
    if constexpr (kTfx) {  // the step started from x_true[t]: its cotangent leaves the x carry
      for (int c = tid; c < xd; c += kThreads) {
        if (a.g_xt) a.g_xt[r * xd + c] = gxc[c];
        gxc[c] = 0.f;
      }
    }
    NE_PHASE(2);

    // ---- route the i_in cotangent: on an event through the AE_ev VJP
    // into the x carry, else to the i carry ----
    if (ev) {
      for (int c = tid; c < id; c += kThreads) gyv[c] = gii[c];
      __syncthreads();
      const float* u = eval(a.ae, eV);
      put(a.g_s_ae_ev, [&](int j) { return u[j]; });
      inputs(a.ae, u, [&](int c, float g) { gxc[c] += g; });
      for (int c = tid; c < id; c += kThreads) gic[c] = 0.f;
    } else {
      for (int c = tid; c < id; c += kThreads) gic[c] = gii[c];
      put(a.g_s_ae_ev, [](int) { return 0.f; });
    }
    NE_PHASE(3);
  }
  __syncthreads();
  for (int c = tid; c < xd; c += kThreads) a.g_x0[static_cast<size_t>(row) * xd + c] = gxc[c];
  for (int c = tid; c < id; c += kThreads) a.g_i0[static_cast<size_t>(row) * id + c] = gic[c];
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<false>(a, slots, true, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_wide(const __grid_constant__ Args a, int vec_smem) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<true>(a, 0, vec_smem != 0, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_tfx(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<false, true>(a, slots, true, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_wide_tfx(const __grid_constant__ Args a, int vec_smem) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<true, true>(a, 0, vec_smem != 0, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_bf16(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<false, false, true>(a, slots, true, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_wide_bf16(const __grid_constant__ Args a, int vec_smem) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<true, false, true>(a, 0, vec_smem != 0, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_tfx_bf16(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<false, true, true>(a, slots, true, smem);
}

__global__ void __launch_bounds__(kThreads, 1) dae_walk_wide_tfx_bf16(const __grid_constant__ Args a, int vec_smem) {
  extern __shared__ __align__(16) float smem[];
  dae_walk_body<true, true, true>(a, 0, vec_smem != 0, smem);
}

// The contraction's jobs: the DE over the stages' slots ([wx; wi] from
// their inputs, then the tail), the AE over the AE slots, the event slot's
// rows counted only on events.
Jobs dae_jobs(const Net& de, const Net& ae, int h, int xd, int id, int S) {
  const GradOffsets o = grad_offsets(h, xd, id, de.n, ae.n);
  Jobs jobs{};
  add_net_jobs(&jobs, de, h, 0, S, 0, o.wx, o.de_w, o.de_b);  // wx_de and wi_de are adjacent
  add_net_jobs(&jobs, ae, h, S, 2, 1, o.gx, o.ae_w, o.ae_b);
  return jobs;
}

}  // namespace

// sizes[0]: floats of the flat gradient row g_w; sizes[1]: of the residual
// buffer (and of its cotangents); sizes[2]: of gy; sizes[3]: of xin;
// sizes[4]: of the contraction's partial sums; sizes[5]: the padded width H
// of the weights the launcher takes (the one place its rule is kept).
extern "C" void psn_fused_dae_bwd_sizes(int tm1, int batch, int h, int xd, int id, int n_de,
                                        int n_ae, int solver, long long* sizes) {
  const long long R = static_cast<long long>(tm1) * batch;
  const int S = n_stages(solver), E = S + 2, L = n_de > n_ae ? n_de : n_ae;
  const Jobs jobs = dae_jobs(make_net(nullptr, nullptr, n_de, xd + id, xd),
                             make_net(nullptr, nullptr, n_ae, xd, id), h, xd, id, S);
  sizes[0] = grad_offsets(h, xd, id, n_de, n_ae).total;
  sizes[1] = static_cast<long long>(E) * L * R * h;
  sizes[2] = E * R * (xd > id ? xd : id);
  sizes[3] = E * R * (xd + id);
  sizes[4] = n_splits(max_rows(jobs, R)) * jobs.per_split;
  const int H = fwd_width(h > xd + id ? h : xd + id);
  sizes[5] = H;
  if (H > kMaxH) {  // the wide kernels' scratch shares the partial sums' buffer
    const long long tiles = (R + kRows - 1) / kRows;
    long long wide = tiles * static_cast<long long>(rc_wide_tile_floats(H));
    if (!walk_wide_in_smem(kDaeWalkVecs, H)) {
      const long long vecs = static_cast<long long>(batch) * kDaeWalkVecs * H;
      wide = wide > vecs ? wide : vecs;
    }
    sizes[4] = sizes[4] > wide ? sizes[4] : wide;
  }
}

namespace {

// The backward's launches (the TF-x kernels where xt is not null, the bf16
// ones where bf16).
int backward(const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0,
             const void* i0, const void* sol, const void* cot, const void* w_de, const void* b_de, int n_de,
             const void* w_ae, const void* b_ae, int n_ae, void* g_s_de, void* g_s_ae, void* g_s_ae_ev,
             void* g_w, void* g_x0, void* g_i0, void* res, void* gres, void* gy, void* xin, void* parts,
             int tm1, int batch, int h, int xd, int id, int solver, int stages, int max_slots, const void* xt,
             const void* xt1, void* g_xt, void* g_xt1, bool bf16, void* stream) {
  const bool tf = xt != nullptr;
  if (tm1 < 1 || batch < 1 || h < 1 || xd < 1 || id < 1 || solver < 0 || solver > 2 || n_de < 1 ||
      n_de > kMaxTail || n_ae < 1 || n_ae > kMaxTail || (tf && !xt1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = n_stages(solver), E = S + 2, L = n_de > n_ae ? n_de : n_ae;
  const int H = fwd_width(h > xd + id ? h : xd + id);
  const long long R = static_cast<long long>(tm1) * batch;
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.s_ae = static_cast<const float*>(s_ae);
  a.s_ae_ev = static_cast<const float*>(s_ae_ev);
  a.aux = static_cast<const float*>(aux);
  a.x0 = static_cast<const float*>(x0);
  a.i0 = static_cast<const float*>(i0);
  a.sol = static_cast<const float*>(sol);
  a.cot = static_cast<const float*>(cot);
  a.de = make_net(static_cast<const float*>(w_de), static_cast<const float*>(b_de), n_de, xd + id, xd, H);
  a.ae = make_net(static_cast<const float*>(w_ae), static_cast<const float*>(b_ae), n_ae, xd, id, H);
  a.bf = make_bufs(static_cast<float*>(res), static_cast<float*>(gres), static_cast<float*>(gy),
                   static_cast<float*>(xin), R, E, L, h, xd > id ? xd : id, xd + id);
  a.g_s_de = static_cast<float*>(g_s_de);
  a.g_s_ae = static_cast<float*>(g_s_ae);
  a.g_s_ae_ev = static_cast<float*>(g_s_ae_ev);
  a.g_x0 = static_cast<float*>(g_x0);
  a.g_i0 = static_cast<float*>(g_i0);
  a.tm1 = tm1;
  a.batch = batch;
  a.xd = xd;
  a.id = id;
  a.solver = solver;
  a.H = H;
  a.scratch = static_cast<float*>(parts);
  a.xt = static_cast<const float*>(xt);
  a.xt1 = static_cast<const float*>(xt1);
  a.g_xt = static_cast<float*>(g_xt);
  a.g_xt1 = static_cast<float*>(g_xt1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const int tiles = static_cast<int>((R + kRows - 1) / kRows);
  if ((stages & 1) && H > kMaxH) {
    const size_t smem = rc_wide_smem_bytes();
    auto kernel = tf ? (bf16 ? dae_recompute_wide_tfx_bf16 : dae_recompute_wide_tfx)
                     : (bf16 ? dae_recompute_wide_bf16 : dae_recompute_wide);
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<tiles, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (stages & 1) {
    const size_t smem = rc_smem_bytes();
    auto kernel = tf ? (bf16 ? dae_recompute_tfx_bf16 : dae_recompute_tfx)
                     : (bf16 ? dae_recompute_bf16 : dae_recompute);
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<tiles, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((stages & 2) && H > kMaxH) {
    const int in_smem = walk_wide_in_smem(kDaeWalkVecs, H);
    const size_t smem = in_smem ? static_cast<size_t>(kDaeWalkVecs) * H * sizeof(float) : 0;
    auto kernel = tf ? (bf16 ? dae_walk_wide_tfx_bf16 : dae_walk_wide_tfx)
                     : (bf16 ? dae_walk_wide_bf16 : dae_walk_wide);
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<batch, kThreads, smem, st>>>(a, in_smem);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (stages & 2) {
    Net* nets[2] = {&a.de, &a.ae};
    // by default the DE's hidden weights, used S times a step; the AE's,
    // used once, read through L1 and L2 (phase_clock's [ne-slots] sweep:
    // the AE's first one resident too leaves L1 too small for the second)
    const int fit = walk_fit(E, L), cap = max_slots >= 0 ? max_slots : n_de - 1;
    const int slots = place(nets, 2, cap < fit ? cap : fit);
    const size_t smem = walk_floats(slots, E, L) * sizeof(float);
    auto kernel = tf ? (bf16 ? dae_walk_tfx_bf16 : dae_walk_tfx) : (bf16 ? dae_walk_bf16 : dae_walk);
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<batch, kThreads, smem, st>>>(a, slots);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stages & 4) {
    CtArgs c{};
    c.jobs = dae_jobs(a.de, a.ae, h, xd, id, S);
    c.bf = a.bf;
    c.ev = a.aux + 1;
    c.ev_stride = 2;
    c.parts = static_cast<float*>(parts);
    c.g_w = static_cast<float*>(g_w);
    c.nt = H / kMaxH;
    e = launch_contraction(c, n_splits(max_rows(c.jobs, R)), st, bf16);
  }
  return static_cast<int>(e);
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays: w_de the DE's padded weights [n_de + 1][H][H]
// in 128 x 128 blocks (csrc/noencode_bwd.cuh; [wx_de; wi_de], then the tail
// layers), H the multiple of 128 at or above h and xd + id, b_de its padded
// biases [n_de][H], w_ae / b_ae the AE's (gx_ae first); res, gres, gy, xin and
// parts scratch of the sizes psn_fused_dae_bwd_sizes gives. solver: 0 Euler,
// 1 Midpoint, 2 RK4 (3/8 rule). stages: the kernels to launch, 1 the
// recompute, 2 the walk, 4 the contraction (7 for the backward; one alone
// times it, or runs the contraction on given buffers). max_slots: the
// walk's weights resident in shared memory, in the order DE, AE (negative:
// the DE's hidden ones; the others come from L2). Launches on `stream` without synchronising and returns the first launch error (0 on success). psn_fused_dae_rollout_bwd_tfx_f32: the same in the
// TF-x mode, with the true states xt = x_true[:-1] and xt1 = x_true[1:]
// ([tm1][batch][xd] each) and their cotangents g_xt and g_xt1 (null: not
// written). psn_fused_dae_rollout_bwd_bf16 (_tfx_bf16): the bf16 compute
// mode, the f32 (_tfx_f32) function's arguments with s_de, s_ae and s_ae_ev
// bfloat16 arrays and the padded weights holding bf16 values (every output
// float32).
extern "C" int psn_fused_dae_rollout_bwd_f32(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0,
    const void* i0, const void* sol, const void* cot, const void* w_de, const void* b_de, int n_de,
    const void* w_ae, const void* b_ae, int n_ae, void* g_s_de, void* g_s_ae, void* g_s_ae_ev,
    void* g_w, void* g_x0, void* g_i0, void* res, void* gres, void* gy, void* xin, void* parts,
    int tm1, int batch, int h, int xd, int id, int solver, int stages, int max_slots, void* stream) {
  return backward(s_de, s_ae, s_ae_ev, aux, x0, i0, sol, cot, w_de, b_de, n_de, w_ae, b_ae, n_ae, g_s_de, g_s_ae,
                  g_s_ae_ev, g_w, g_x0, g_i0, res, gres, gy, xin, parts, tm1, batch, h, xd, id, solver, stages,
                  max_slots, nullptr, nullptr, nullptr, nullptr, false, stream);
}

extern "C" int psn_fused_dae_rollout_bwd_bf16(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0,
    const void* i0, const void* sol, const void* cot, const void* w_de, const void* b_de, int n_de,
    const void* w_ae, const void* b_ae, int n_ae, void* g_s_de, void* g_s_ae, void* g_s_ae_ev,
    void* g_w, void* g_x0, void* g_i0, void* res, void* gres, void* gy, void* xin, void* parts,
    int tm1, int batch, int h, int xd, int id, int solver, int stages, int max_slots, void* stream) {
  return backward(s_de, s_ae, s_ae_ev, aux, x0, i0, sol, cot, w_de, b_de, n_de, w_ae, b_ae, n_ae, g_s_de, g_s_ae,
                  g_s_ae_ev, g_w, g_x0, g_i0, res, gres, gy, xin, parts, tm1, batch, h, xd, id, solver, stages,
                  max_slots, nullptr, nullptr, nullptr, nullptr, true, stream);
}

extern "C" int psn_fused_dae_rollout_bwd_tfx_f32(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0,
    const void* i0, const void* sol, const void* cot, const void* w_de, const void* b_de, int n_de,
    const void* w_ae, const void* b_ae, int n_ae, void* g_s_de, void* g_s_ae, void* g_s_ae_ev,
    void* g_w, void* g_x0, void* g_i0, void* res, void* gres, void* gy, void* xin, void* parts,
    int tm1, int batch, int h, int xd, int id, int solver, int stages, int max_slots, const void* xt,
    const void* xt1, void* g_xt, void* g_xt1, void* stream) {
  if (!xt) return static_cast<int>(cudaErrorInvalidValue);
  return backward(s_de, s_ae, s_ae_ev, aux, x0, i0, sol, cot, w_de, b_de, n_de, w_ae, b_ae, n_ae, g_s_de, g_s_ae,
                  g_s_ae_ev, g_w, g_x0, g_i0, res, gres, gy, xin, parts, tm1, batch, h, xd, id, solver, stages,
                  max_slots, xt, xt1, g_xt, g_xt1, false, stream);
}

extern "C" int psn_fused_dae_rollout_bwd_tfx_bf16(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0,
    const void* i0, const void* sol, const void* cot, const void* w_de, const void* b_de, int n_de,
    const void* w_ae, const void* b_ae, int n_ae, void* g_s_de, void* g_s_ae, void* g_s_ae_ev,
    void* g_w, void* g_x0, void* g_i0, void* res, void* gres, void* gy, void* xin, void* parts,
    int tm1, int batch, int h, int xd, int id, int solver, int stages, int max_slots, const void* xt,
    const void* xt1, void* g_xt, void* g_xt1, void* stream) {
  if (!xt) return static_cast<int>(cudaErrorInvalidValue);
  return backward(s_de, s_ae, s_ae_ev, aux, x0, i0, sol, cot, w_de, b_de, n_de, w_ae, b_ae, n_ae, g_s_de, g_s_ae,
                  g_s_ae_ev, g_w, g_x0, g_i0, res, gres, gy, xin, parts, tm1, batch, h, xd, id, solver, stages,
                  max_slots, xt, xt1, g_xt, g_xt1, true, stream);
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
