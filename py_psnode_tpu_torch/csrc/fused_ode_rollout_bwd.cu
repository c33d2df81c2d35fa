// Reverse-time VJP of the fused ODE rollout: a time-parallel recompute, the
// reverse walk of the cotangents, and a time-parallel contraction of the
// weight gradients, three kernels launched in order by one call.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_ode.py:_bwd_kernel (:171),
// launched by _bwd (pallas_call at :356). It computes the same function at
// float32 accuracy, without the TPU's grid, time blocking, dt == 0 padding or
// bf16 mode. Per batch row, for t = T-2 down to 0, with x_t = sol[t] and the
// carry gx_c (zero at the start):
//
//   gX1 = cot[t+1] + gx_c
//   the Euler / Midpoint / RK4-3/8 stages of f(x) = tail(elu(s_de[t] +
//   x @ wx)) at x_t, backpropagated in the cotangent order of
//   fused_ode.py:226-264: g_s_de[t] = sum over stages of the lifted first
//   layer's cotangent, gx_c = dL/dx_t
//
// and the gradients of wx and of every tail weight and bias summed over all
// rows and steps. g_x0 is the carry after step 0 (the wrapper adds cot[0]).
//
// Bound on an H100 SXM at the no-encode training shape (B=64, T=1001,
// h=128, xd=2, three tail layers, RK4): a row-step evaluates f at four
// stage points and backpropagates each, two products a layer (the
// cotangent and the weight gradient): 0.8 MFLOP, 51 GFLOP for the call.
// Its h x h products (two hidden layers, three times each) are 50 GFLOP,
// 0.31 ms in three TF32 passes at 495 TFLOP/s; the rest, at float32's 67
// TFLOP/s, 0.01 ms (all on the CUDA cores: 0.76 ms). Its bytes (s_de in,
// g_s_de out: 2 x 33 MB) take 0.02 ms at 3.35 TB/s. The design's buffers
// (the residuals and their cotangents, 0.8 GB at RK4) are written once and
// read once more.
//
// What the design does about the serial chain: the stages' recompute and
// the weight-gradient sums, 29% and 43% of a step of the one-kernel walk
// this design replaces (utils/phase_clock.py), leave the walk for two
// kernels that run over all row-steps at once on the tensor cores. The walk
// keeps the cotangent chain, 12 dependent matrix-vector layers a step at
// RK4 (three a stage's VJP and its input cotangent), each from shared
// memory with its elu' prefetched a step ahead. csrc/noencode_bwd.cuh holds
// the three kernels' building blocks.

#include "noencode_bwd.cuh"

namespace {

// Offsets of each gradient in the flat gradient row, in the order of
// flatten_weights in ops/fused_ode_vjp.py: wx, then (W, b) per tail layer.
struct GradOffsets {
  int wx;
  int w[kMaxTail], b[kMaxTail];
  int total;
};

GradOffsets grad_offsets(int h, int xd, int n_tail) {
  GradOffsets o{};
  int off = 0;
  o.wx = off;
  off += xd * h;
  for (int l = 0; l < n_tail; ++l) {
    const int n_out = l == n_tail - 1 ? xd : h;
    o.w[l] = off;
    off += h * n_out;
    o.b[l] = off;
    off += n_out;
  }
  o.total = off;
  return o;
}

struct Args {
  const float* s_de;  // [tm1, batch, h]
  const float* dt;    // [tm1, batch]
  const float* sol;   // [tm1 + 1, batch, xd]: x_0 .. x_{tm1}
  const float* cot;   // [tm1 + 1, batch, xd]: cotangent of sol
  Net net;            // kin = out = xd
  Bufs bf;            // E = S slots
  float* g_s_de;      // [tm1, batch, h]
  float* g_x0;        // [batch, xd]
  int tm1, batch, xd, solver;
  int H;              // the padded width (kMaxH: the 128-wide kernels)
  float* scratch;     // the wide kernels' global scratch (the contraction's partial sums)
};

// The wide walk's vectors of H floats.
constexpr int kOdeWalkVecs = 9;

// ---- kernel 1: the stages of every row-step, a tile of kRows at a time ----
template <bool kWide>
__device__ __forceinline__ void ode_recompute_body(const Args& a, float* smem) {
  const RcSmem s = kWide ? carve_rc_wide(smem, a.scratch + blockIdx.x * rc_wide_tile_floats(a.H), a.H)
                         : carve_rc(smem);
  const Bufs& bf = a.bf;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int xd = a.xd, S = n_stages(a.solver);
  rc_begin(s, r0, bf.R, [&](long long r) { return __ldg(a.dt + r); }, [](long long) { return 0.f; },
           kWide ? a.H * kLdt : kTile);
  __syncthreads();
  // stage q's output k_q waits in gy slot q (the walk overwrites it)
  auto k = [&](int q, long long r, int c) { return bf.gy_row(q, r)[c]; };
  for (int q = 0; q < S; ++q) {
    rc_input(s, bf, q, r0, xd, [&](int m, int c) {
      const long long r = r0 + m;
      const float x = __ldg(a.sol + r * xd + c), dt = s.dt[m];
      if (q == 0) return x;
      if (a.solver == 1) return x + k(0, r, c) * (0.5f * dt);  // Midpoint
      if (q == 1) return x + dt * k(0, r, c) * kOneThird;     // RK4, Kutta's 3/8 rule
      if (q == 2) return x + dt * (k(1, r, c) - k(0, r, c) * kOneThird);
      return x + dt * (k(0, r, c) - k(1, r, c) + k(2, r, c));
    });
    float* y = q + 1 < S ? bf.gy_row(q, 0) : nullptr;
    if constexpr (kWide) {
      rc_eval_wide(a.net, bf, q, r0, a.s_de, s, [](int) { return true; }, y, bf.ow, a.H);
    } else {
      rc_eval(a.net, bf, q, r0, a.s_de, s, [](int) { return true; }, y, bf.ow);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) ode_recompute(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  ode_recompute_body<false>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) ode_recompute_wide(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  ode_recompute_body<true>(a, smem);
}

// ---- kernel 2: the reverse walk, one block per batch row ----
// kWide: the walk at a padded width H > kMaxH (no resident weight, no
// prefetch; the vectors H long, in shared memory or, without vec_smem, in
// the block's share of the scratch).
template <bool kWide>
__device__ __forceinline__ void ode_walk_body(const Args& a, int slots, bool vec_smem, float* smem) {
  const Bufs& bf = a.bf;
  const int xd = a.xd, B = a.batch, h = bf.h, tid = threadIdx.x;
  const int row = blockIdx.x, k = walk_k();
  const int step_f = walk_step_floats(bf.E, bf.L);
  const int V = kWide ? a.H : kMaxH;  // floats of a vector
  float* wres = smem;
  float* pf = wres + static_cast<size_t>(slots) * kMat;  // two steps
  float* va = kWide ? (vec_smem ? smem : a.scratch + static_cast<size_t>(row) * kOdeWalkVecs * V) : pf + 2 * step_f;
  float* vb = va + V;
  float* gyv = vb + V;    // the output cotangent of the next evaluation
  float* gX1 = gyv + V;   // cotangent of x_{t+1}
  float* gxc = gX1 + V;   // x carry, then dL/dx_t of the step
  float* gk1 = gxc + V;   // RK4 stage cotangents
  float* gk2 = gk1 + V;
  float* gk3 = gk2 + V;
  float* gsv = gk3 + V;   // the wide walk's sum of the stages' first-layer cotangents

  if constexpr (!kWide) load_resident(a.net, wres);
  for (int e = tid; e < V; e += kThreads) {
    gyv[e] = 0.f;  // beyond the evaluation's outputs it stays 0
    gxc[e] = 0.f;
  }
  auto prefetch = [&](int t, float* dst) {
    const long long r = static_cast<long long>(t) * B + row;
    walk_prefetch(bf, dst, r, a.cot + (r + B) * xd, xd, a.dt + r, 1);
    cp_async_commit();
  };
  if constexpr (!kWide) prefetch(a.tm1 - 1, pf + ((a.tm1 - 1) & 1) * step_f);
  for (int t = a.tm1 - 1; t >= 0; --t) {
    const long long r = static_cast<long long>(t) * B + row;
    const float* P = nullptr;  // slot q's layers at P + q L kMaxH (the 128-wide walk)
    const float* cot;
    float dt;
    if constexpr (kWide) {
      __syncthreads();  // the last step's carry visible to every thread
      cot = a.cot + (r + B) * xd;
      dt = __ldg(a.dt + r);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // step t landed; every thread is done with the other buffer
      if (t > 0) prefetch(t - 1, pf + ((t - 1) & 1) * step_f);
      P = pf + (t & 1) * step_f;
      cot = P + bf.E * bf.L * kMaxH;
      dt = cot[kMaxH];
    }
    NE_PHASE(0);
    for (int c = tid; c < xd; c += kThreads) gX1[c] = cot[c] + gxc[c];
    __syncthreads();
    // the stages' VJPs, last stage first; gsde, the sum of their first
    // layers' cotangents, is kept by the threads of output k (wide: in gsv,
    // each element by the thread of its output)
    float gsde = 0.f;
    if constexpr (kWide) {
      if (walk_ks() == 0)
        for (int j = k; j < V; j += kMaxH) gsv[j] = 0.f;
    }
    auto stage = [&](int q, auto glue) {
      if constexpr (kWide) {
        const float* v = walk_eval_wide(a.net, bf, q, r, gyv, va, vb, V);
        if (walk_ks() == 0)
          for (int j = k; j < V; j += kMaxH) gsv[j] += v[j];
        walk_inputs_wide(a.net, v, V, glue);
      } else {
        const float* v = walk_eval(a.net, bf, q, r, P + q * bf.L * kMaxH, gyv, va, vb, wres);
        gsde += v[k];
        walk_inputs(a.net, v, glue);
      }
      __syncthreads();
    };
    if (a.solver == 0) {  // Euler: x1 = x + dt f(x)
      for (int c = tid; c < xd; c += kThreads) gyv[c] = dt * gX1[c];
      __syncthreads();
      stage(0, [&](int c, float g) { gxc[c] = gX1[c] + g; });
    } else if (a.solver == 1) {  // Midpoint: x1 = x + dt f(x + (dt/2) f(x))
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
      if (walk_ks() == 0)
        for (int j = k; j < h; j += kMaxH) a.g_s_de[r * h + j] = gsv[j];
    } else {
      if (walk_ks() == 0 && k < h) a.g_s_de[r * h + k] = gsde;
    }
    NE_PHASE(1);
  }
  for (int c = tid; c < xd; c += kThreads) a.g_x0[static_cast<size_t>(row) * xd + c] = gxc[c];
}

__global__ void __launch_bounds__(kThreads, 1) ode_walk(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  ode_walk_body<false>(a, slots, true, smem);
}

__global__ void __launch_bounds__(kThreads, 1) ode_walk_wide(const __grid_constant__ Args a, int vec_smem) {
  extern __shared__ __align__(16) float smem[];
  ode_walk_body<true>(a, 0, vec_smem != 0, smem);
}

// The contraction's jobs: wx from the stage inputs, then each tail layer.
Jobs ode_jobs(const Net& net, int h, int xd, int S) {
  const GradOffsets o = grad_offsets(h, xd, net.n);
  Jobs jobs{};
  add_net_jobs(&jobs, net, h, 0, S, 0, o.wx, o.w, o.b);
  return jobs;
}

}  // namespace

// sizes[0]: floats of the flat gradient row g_w; sizes[1]: of the residual
// buffer (and of its cotangents); sizes[2]: of gy; sizes[3]: of xin;
// sizes[4]: of the contraction's partial sums; sizes[5]: the padded width H
// of the weights the launcher takes (the one place its rule is kept).
extern "C" void psn_fused_ode_bwd_sizes(int tm1, int batch, int h, int xd, int n_tail, int solver,
                                        long long* sizes) {
  const long long R = static_cast<long long>(tm1) * batch;
  const int S = n_stages(solver);
  const Jobs jobs = ode_jobs(make_net(nullptr, nullptr, n_tail, xd, xd), h, xd, S);
  sizes[0] = grad_offsets(h, xd, n_tail).total;
  sizes[1] = static_cast<long long>(S) * n_tail * R * h;
  sizes[2] = S * R * xd;
  sizes[3] = S * R * xd;
  sizes[4] = n_splits(max_rows(jobs, R)) * jobs.per_split;
  const int H = fwd_width(h > xd ? h : xd);
  sizes[5] = H;
  if (H > kMaxH) {  // the wide kernels' scratch shares the partial sums' buffer
    const long long tiles = (R + kRows - 1) / kRows;
    long long wide = tiles * static_cast<long long>(rc_wide_tile_floats(H));
    if (!walk_wide_in_smem(kOdeWalkVecs, H)) {
      const long long vecs = static_cast<long long>(batch) * kOdeWalkVecs * H;
      wide = wide > vecs ? wide : vecs;
    }
    sizes[4] = sizes[4] > wide ? sizes[4] : wide;
  }
}

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays: w the padded weights [n_tail + 1][H][H] in 128
// x 128 blocks (csrc/noencode_bwd.cuh; wx, then the tail layers), H the
// multiple of 128 at or above h and xd, b the padded biases [n_tail][H]; res, gres,
// gy, xin and parts scratch of the sizes psn_fused_ode_bwd_sizes gives.
// solver: 0 Euler, 1 Midpoint, 2 RK4 (3/8 rule). stages: the kernels to
// launch, 1 the recompute, 2 the walk, 4 the contraction (7 for the
// backward; one alone times it, or runs the contraction on given buffers).
// max_slots caps the walk's weights resident in shared memory (negative: as
// many as fit; the others come from L2). Launches on `stream` without synchronising and returns the first launch
// error (0 on success).
extern "C" int psn_fused_ode_rollout_bwd_f32(
    const void* s_de, const void* dt, const void* sol, const void* cot, const void* w,
    const void* b, int n_tail, void* g_s_de, void* g_w, void* g_x0, void* res, void* gres, void* gy,
    void* xin, void* parts, int tm1, int batch, int h, int xd, int solver, int stages,
    int max_slots, void* stream) {
  if (tm1 < 1 || batch < 1 || h < 1 || xd < 1 || solver < 0 || solver > 2 || n_tail < 1 ||
      n_tail > kMaxTail)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = n_stages(solver);
  const int H = fwd_width(h > xd ? h : xd);
  const long long R = static_cast<long long>(tm1) * batch;
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.dt = static_cast<const float*>(dt);
  a.sol = static_cast<const float*>(sol);
  a.cot = static_cast<const float*>(cot);
  a.net = make_net(static_cast<const float*>(w), static_cast<const float*>(b), n_tail, xd, xd, H);
  a.bf = make_bufs(static_cast<float*>(res), static_cast<float*>(gres), static_cast<float*>(gy),
                   static_cast<float*>(xin), R, S, n_tail, h, xd, xd);
  a.g_s_de = static_cast<float*>(g_s_de);
  a.g_x0 = static_cast<float*>(g_x0);
  a.tm1 = tm1;
  a.batch = batch;
  a.xd = xd;
  a.solver = solver;
  a.H = H;
  a.scratch = static_cast<float*>(parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const int tiles = static_cast<int>((R + kRows - 1) / kRows);
  if ((stages & 1) && H > kMaxH) {
    const size_t smem = rc_wide_smem_bytes();
    e = allow_smem(ode_recompute_wide, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ode_recompute_wide<<<tiles, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (stages & 1) {
    const size_t smem = rc_smem_bytes();
    e = allow_smem(ode_recompute, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ode_recompute<<<tiles, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((stages & 2) && H > kMaxH) {
    const int in_smem = walk_wide_in_smem(kOdeWalkVecs, H);
    const size_t smem = in_smem ? static_cast<size_t>(kOdeWalkVecs) * H * sizeof(float) : 0;
    e = allow_smem(ode_walk_wide, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ode_walk_wide<<<batch, kThreads, smem, st>>>(a, in_smem);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (stages & 2) {
    Net* nets[1] = {&a.net};
    const int fit = walk_fit(S, n_tail);
    const int slots = place(nets, 1, max_slots >= 0 && max_slots < fit ? max_slots : fit);
    const size_t smem = walk_floats(slots, S, n_tail) * sizeof(float);
    e = allow_smem(ode_walk, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ode_walk<<<batch, kThreads, smem, st>>>(a, slots);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stages & 4) {
    CtArgs c{};
    c.jobs = ode_jobs(a.net, h, xd, S);
    c.bf = a.bf;
    c.parts = static_cast<float*>(parts);
    c.g_w = static_cast<float*>(g_w);
    c.nt = H / kMaxH;
    e = launch_contraction(c, n_splits(max_rows(c.jobs, R)), st);
  }
  return static_cast<int>(e);
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
