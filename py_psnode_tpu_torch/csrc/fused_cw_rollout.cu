// Forward rollout of the channel-wise dynamics in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_channelwise.py:_fwd_kernel
// (:258), launched by _forward (pallas_call at :515). It computes the same
// function at float32 accuracy, without the TPU's grid, time blocking,
// dt == 0 padding or sublane relayouts; its bf16 compute mode (below) is the
// TPU kernel's precision="bfloat16". Per step t and batch row
// b, with the z-features fz and the constant part of the folded first layer
// s_constV lifted out of the loop (ops/fused_channelwise.py:
// precompute_cw_streams):
//
//   xh1 = Euler / Midpoint / RK4-3/8 step of f from xh_c with dt[t, b]
//   sol[t, b] = xh1;  xh_c = xh1
//
// where f is one evaluation of the dynamics (csrc/cw_tile.cuh) on the
// latent state [xd, h].
//
// Bound on an H100 SXM: an evaluation costs 2 (2 h^3 + (5 xd + C) h^2)
// FLOP per batch row, 8.8 MFLOP at h=128, xd=2, C=4; the two h x h x h
// products are 95% of it. They run on the tensor cores in three TF32
// passes (3xTF32, float32 accuracy), so their least time is 3 x their
// FLOP at 495 TFLOP/s; the rest runs at the 67 TFLOP/s of float32 on the
// CUDA cores. At B=64 with RK4 over 1000 steps that is 14.8 ms, against
// 0.05 ms for its bytes (fz, s_constV and the solution): bound by
// arithmetic, unlike the no-encode rollouts of the port.
//
// Design: a cluster of blocks (512 threads each) per batch row runs the
// whole loop; the rows are independent, a row's evaluation a chain of
// dependent [h, h] layers. The two [h, h] activation tiles (2 x 68 KB) and
// the state live in shared memory; the vertical weights stream from L2 by
// cp.async into a double-buffered staging area, and the products run as
// warp-level mma.sync (cw_tile.cuh). One block per row would leave SMs idle
// at the batches the trainer and the evaluation run (B=64, B=32 on 132
// SMs), so the launcher gives each row a cluster of 4 blocks when the card
// runs B such clusters at once, else 2 when it runs B of those, else 1:
// the blocks of a cluster split each product's columns and share the
// results through distributed shared memory.
//
// Above h = 128 (to 724, the JAX package's widest) the tiles outgrow shared
// memory: fused_cw_rollout_wide_kernel runs the same loop on the wide
// layout of csrc/cw_wide.cuh (tiles in the row's global scratch, 128 x 128
// output blocks dealt over a cluster of up to 8 blocks).
//
// The bf16 compute mode (the TPU kernel's _cast_cw :161 and _dot): the
// template flag kBf16 of both kernels (csrc/cw_tile.cuh says where it
// rounds), in a build of its own (-DPSN_BF16: psn_fused_cw_rollout_bf16 in
// place of _f32, utils/cuda_build.py), so that nvcc compiles the two modes
// at once. Its least time counts every operation at the card's 989 TFLOP/s
// of bf16 tensor-core products (2.3 ms at B=64, RK4, h=128, xd=2): this
// simple mode runs its products as one TF32 pass on the float32 kernel's
// fragments, and its chain of layers as the float32 kernel's.

#include "cw_wide.cuh"

namespace {

struct Args {
  const float* fz;   // [tm1, batch, zd, h]
  const float* dt;   // [tm1, batch]
  const float* sv;   // [batch, h, h]
  const float* x0;   // [batch, xd, h]
  Net w;
  float* sol;        // [tm1, batch, xd, h]
  int tm1, batch, h, xd, zd, solver;
};

size_t smem_floats(int h, int xd, int zd) {
  // EvalSmem; xc, xs, k1..k4
  return eval_floats(h, xd, zd) + 6 * static_cast<size_t>(xd) * h;
}

template <int KC, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1) fused_cw_rollout_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x / KC, tid = threadIdx.x;
  const int n = xd * h;
  const bool lead = block_rank<KC>() == 0;  // the block that writes the row's results
  EvalSmem s;
  float* p = carve_eval(s, smem, h, xd, zd);
  float* xc = p;  p += n;  // the rolled state
  float* xs = p;  p += n;  // a stage input
  float* k1 = p;  p += n;  // stage derivatives, consecutive
  float* k2 = p;  p += n;
  float* k3 = p;  p += n;
  float* k4 = p;
  init_eval(a.w, s, h, xd, zd);
  for (int e = tid; e < n; e += kThreads) xc[e] = a.x0[static_cast<size_t>(row) * n + e];
  const float* sv = a.sv + static_cast<size_t>(row) * h * h;
  cl_arrive<KC>();  // t1 is free: the first evaluation's a0 store waits for this

  const int S = a.solver == 0 ? 1 : (a.solver == 1 ? 2 : 4);
  for (int t = 0; t < a.tm1; ++t) {
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
#ifdef CW_PHASE_CLOCK
    if (blockIdx.x == 0 && tid == 0) g_phase_on = t == a.tm1 / 2;  // the middle step (its last stage's marks stay)
#endif
    for (int st = 0; st < S; ++st) {
      __syncthreads();  // publishes xc or xs
      eval_fwd<KC, true, kBf16>(a.w, s, h, xd, zd, st == 0 ? xc : xs, fz_t, sv, k1 + st * n);
      if (st + 1 < S) {  // the next stage point
        for (int e = tid; e < n; e += kThreads) {
          if (a.solver == 1) xs[e] = xc[e] + k1[e] * (0.5f * dt);  // Midpoint
          else if (st == 0) xs[e] = xc[e] + dt * k1[e] * kOneThird;  // RK4, Kutta's 3/8 rule
          else if (st == 1) xs[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
          else xs[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
        }
      }
    }
    // the step (every block of the cluster keeps the state; the lead writes it out)
    for (int e = tid; e < n; e += kThreads) {
      if (a.solver == 0) xc[e] = xc[e] + dt * k1[e];
      else if (a.solver == 1) xc[e] = xc[e] + dt * k2[e];
      else xc[e] = xc[e] + (k1[e] + 3.0f * (k2[e] + k3[e]) + k4[e]) * dt * 0.125f;
      if (lead) a.sol[step * n + e] = xc[e];
    }
  }
  cl_wait<KC>();  // no block leaves while another may still write its memory
}

// The wide rollout (h > kMaxH, csrc/cw_wide.cuh): the kernel above with its
// activations in the row's two tiles of `tiles` [batch][2][hp][hp].
struct WideArgs {
  Args a;
  float* tiles;
  int kc;  // blocks a row: the cluster's size
};

size_t wide_smem_floats(int h, int xd, int zd) {
  return wide_eval_floats<kKc>(h, xd, zd) + 6 * static_cast<size_t>(xd) * h;  // xc, xs, k1..k4
}

template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1) fused_cw_rollout_wide_kernel(const __grid_constant__ WideArgs wa) {
  extern __shared__ __align__(16) float smem[];
  const Args& a = wa.a;
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x / wa.kc, tid = threadIdx.x;
  const int n = xd * h;
  WideSmem s;
  float* p = carve_wide<kKc>(s, smem, h, xd, zd);
  s.hp = wide_pad(h);
  s.kc = wa.kc;
  s.rank = static_cast<int>(cluster_rank());
  const bool lead = s.rank == 0;
  s.t1 = wa.tiles + static_cast<size_t>(row) * 2 * s.hp * s.hp;
  s.t2 = s.t1 + static_cast<size_t>(s.hp) * s.hp;
  float* xc = p;  p += n;
  float* xs = p;  p += n;
  float* k1 = p;  p += n;
  float* k2 = p;  p += n;
  float* k3 = p;  p += n;
  float* k4 = p;
  init_wide(a.w, s, h, xd, zd);
  for (int e = tid; e < n; e += kThreads) xc[e] = a.x0[static_cast<size_t>(row) * n + e];
  const float* sv = a.sv + static_cast<size_t>(row) * h * h;
  cluster_arrive();  // t1 is free: the first evaluation's a0 store waits for this

  const int S = a.solver == 0 ? 1 : (a.solver == 1 ? 2 : 4);
  for (int t = 0; t < a.tm1; ++t) {
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
#ifdef CW_PHASE_CLOCK
    if (blockIdx.x == 0 && tid == 0) g_phase_on = t == a.tm1 / 2;
#endif
    for (int st = 0; st < S; ++st) {
      __syncthreads();  // publishes xc or xs
      wide_eval_fwd<true, kKc, kBf16>(a.w, s, h, xd, zd, st == 0 ? xc : xs, fz_t, sv, k1 + st * n);
      if (st + 1 < S) {
        for (int e = tid; e < n; e += kThreads) {
          if (a.solver == 1) xs[e] = xc[e] + k1[e] * (0.5f * dt);
          else if (st == 0) xs[e] = xc[e] + dt * k1[e] * kOneThird;
          else if (st == 1) xs[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
          else xs[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
        }
      }
    }
    for (int e = tid; e < n; e += kThreads) {
      if (a.solver == 0) xc[e] = xc[e] + dt * k1[e];
      else if (a.solver == 1) xc[e] = xc[e] + dt * k2[e];
      else xc[e] = xc[e] + (k1[e] + 3.0f * (k2[e] + k3[e]) + k4[e]) * dt * 0.125f;
      if (lead) a.sol[step * n + e] = xc[e];
    }
  }
  cluster_wait();  // no block leaves while another may still read the tiles
}

int wide_cluster(int batch, int h, int xd, int zd) {
  return pick_wide_cluster(fused_cw_rollout_wide_kernel<kBuildBf16>, batch, wide_pad(h),
                           wide_smem_floats(h, xd, zd) * sizeof(float));
}

// A launch of the rollout in this build's compute mode (psn_fused_cw_rollout_f32 / _bf16).
int rollout(const void* fz, const void* dt, const void* sv, const void* x0, const void* const* w, void* sol,
            void* scratch, int tm1, int batch, int h, int xd, int zd, int solver, int cluster, void* stream) {
  const bool wide = h > kMaxH;
  if (tm1 < 0 || batch < 1 || h < 1 || h > kMaxHFwd || xd < 1 || zd < 0 || solver < 0 ||
      solver > 2 || (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4 && !(wide && cluster == 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.fz = static_cast<const float*>(fz);
  a.dt = static_cast<const float*>(dt);
  a.sv = static_cast<const float*>(sv);
  a.x0 = static_cast<const float*>(x0);
  a.w = net_from(w);
  a.sol = static_cast<float*>(sol);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.zd = zd;
  a.solver = solver;
  if (tm1 == 0) return static_cast<int>(cudaSuccess);
  if (wide) {
    if (cluster == 0) cluster = wide_cluster(batch, h, xd, zd);
    const WideArgs wa{a, static_cast<float*>(scratch), cluster};
    const cudaError_t e = launch_clusters(fused_cw_rollout_wide_kernel<kBuildBf16>, batch, cluster,
                                          wide_smem_floats(h, xd, zd) * sizeof(float),
                                          static_cast<cudaStream_t>(stream), wa);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  const size_t smem = smem_floats(h, xd, zd) * sizeof(float);
  if (cluster == 0)
    cluster = pick_cluster(fused_cw_rollout_kernel<4, kBuildBf16>, fused_cw_rollout_kernel<2, kBuildBf16>, batch,
                           smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cluster == 4   ? launch_clusters(fused_cw_rollout_kernel<4, kBuildBf16>, batch, 4, smem, st, a)
      : cluster == 2 ? launch_clusters(fused_cw_rollout_kernel<2, kBuildBf16>, batch, 2, smem, st, a)
                     : launch_clusters(fused_cw_rollout_kernel<1, kBuildBf16>, batch, 1, smem, st, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Floats of the scratch psn_fused_cw_rollout_f32 takes at these shapes: the
// wide kernels' tiles, [batch][2][hp][hp] above kMaxH, none below.
extern "C" long long psn_fused_cw_scratch_floats(int batch, int h) {
  if (h <= kMaxH) return 0;
  const long long hp = wide_pad(h);
  return static_cast<long long>(batch) * 2 * hp * hp;
}

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; w is a host array of the 15 weight pointers in
// the order of flatten_weights (ops/fused_channelwise.py). solver: 0 Euler,
// 1 Midpoint, 2 RK4 (3/8 rule). cluster: blocks per batch row, 1, 2 or 4,
// or 0 to take 4 when the card runs batch clusters of 4 at once, else 2
// when it runs batch clusters of 2, else 1; above kMaxH the wide kernel
// (csrc/cw_wide.cuh) on `scratch` (psn_fused_cw_scratch_floats), 1, 2, 4
// or 8 blocks a row, 0 for pick_wide_cluster's choice. Launches on
// `stream` without synchronising and returns the launch's error (0 on
// success); cudaErrorInvalidValue for h outside 1..kMaxHFwd or another
// cluster size. psn_fused_cw_rollout_bf16 (the -DPSN_BF16 build, in place
// of _f32): the bf16 compute mode, the same arguments with the 2-D weights
// (a, W1, W2, W3 and the per-channel w0, w1) holding bf16 values.
#ifdef PSN_BF16
extern "C" int psn_fused_cw_rollout_bf16(const void* fz, const void* dt, const void* sv,
                                         const void* x0, const void* const* w, void* sol, void* scratch,
                                         int tm1, int batch, int h, int xd, int zd, int solver, int cluster,
                                         void* stream) {
  return rollout(fz, dt, sv, x0, w, sol, scratch, tm1, batch, h, xd, zd, solver, cluster, stream);
}
#else
extern "C" int psn_fused_cw_rollout_f32(const void* fz, const void* dt, const void* sv,
                                        const void* x0, const void* const* w, void* sol, void* scratch,
                                        int tm1, int batch, int h, int xd, int zd, int solver, int cluster,
                                        void* stream) {
  return rollout(fz, dt, sv, x0, w, sol, scratch, tm1, batch, h, xd, zd, solver, cluster, stream);
}
#endif

// The blocks per batch row psn_fused_cw_rollout_f32 (_bf16) takes for
// cluster = 0 at these shapes on the current device.
extern "C" int psn_fused_cw_cluster(int batch, int h, int xd, int zd) {
  if (h > kMaxH) return wide_cluster(batch, h, xd, zd);
  return pick_cluster(fused_cw_rollout_kernel<4, kBuildBf16>, fused_cw_rollout_kernel<2, kBuildBf16>, batch,
                      smem_floats(h, xd, zd) * sizeof(float));
}

#ifdef CW_PHASE_CLOCK
// The phase clock's kPhaseMarks marks of the last launch (csrc/cw_tile.cuh),
// copied to out after the device is synchronised; returns the error.
extern "C" int psn_cw_phase_clock(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * kPhaseMarks);
  return static_cast<int>(e);
}
#endif

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
