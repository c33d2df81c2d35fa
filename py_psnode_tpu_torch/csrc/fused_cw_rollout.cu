// Forward rollout of the channel-wise dynamics in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_channelwise.py:_fwd_kernel
// (:258), launched by _forward (pallas_call at :515). It computes the same
// function in float32 with float32 accumulation (no TF32, no tensor cores),
// without the TPU's grid, time blocking, dt == 0 padding, sublane relayouts
// or bf16 mode. Per step t and batch row b, with the z-features fz and the
// constant part of the folded first layer s_constV lifted out of the loop
// (ops/fused_channelwise.py:precompute_cw_streams):
//
//   xh1 = Euler / Midpoint / RK4-3/8 step of f from xh_c with dt[t, b]
//   sol[t, b] = xh1;  xh_c = xh1
//
// where f is one evaluation of the dynamics (csrc/cw_tile.cuh) on the
// latent state [xd, h].
//
// Bound on an H100 SXM: an evaluation costs 2 (2 h^3 + (5 xd + C) h^2)
// FLOP per batch row, 8.8 MFLOP at h=128, xd=2, C=4; the two h x h x h
// products are 95% of it. At B=64 with RK4 over 1000 steps that is 2.3
// TFLOP, 34 ms at the card's 67 TFLOP/s of float32 on the CUDA cores,
// against 0.05 ms for its bytes (fz, s_constV and the solution). So, unlike
// the other rollouts of the port, it is bound by arithmetic.
//
// Design: one block of 256 threads per batch row runs the whole loop (the
// rows are independent; a row's evaluation is a chain of dependent [h, h]
// layers). The two [h, h] activation tiles (2 x 66 KB) and the state live
// in shared memory; the vertical weights stream from L2 through a
// double-buffered staging area, and each thread holds an 8 x 8 register
// tile of every product. B blocks use min(B, 132) SMs: at B=64 half the
// card idles, which a later design that splits a row's 128 positions over
// a cluster of blocks would use.

#include "cw_tile.cuh"

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
  const size_t xdh = static_cast<size_t>(xd) * h;
  // t1, t2, wbuf, ft; e, ot, he; xc, xs, k1..k4
  return 2 * static_cast<size_t>(kTile) + 2 * kChunk + static_cast<size_t>(xd + zd) * kLdt +
         3 * xdh + 6 * xdh;
}

__global__ void __launch_bounds__(kThreads, 1) fused_cw_rollout_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, zd = a.zd, B = a.batch, row = blockIdx.x, tid = threadIdx.x;
  const int n = xd * h;
  EvalSmem s;
  float* p = smem;
  s.t1 = p;    p += kTile;
  s.t2 = p;    p += kTile;
  s.wbuf = p;  p += 2 * kChunk;
  s.ft = p;    p += (xd + zd) * kLdt;
  s.e = p;     p += n;
  s.ot = p;    p += n;
  s.he = p;    p += n;
  float* xc = p;  p += n;  // the rolled state
  float* xs = p;  p += n;  // a stage input
  float* k1 = p;  p += n;  // stage derivatives
  float* k2 = p;  p += n;
  float* k3 = p;  p += n;
  float* k4 = p;
  // zero the tiles once: their rows and columns beyond h are read, never used
  for (int e = tid; e < 2 * kTile; e += kThreads) smem[e] = 0.f;
  for (int e = tid; e < n; e += kThreads) xc[e] = a.x0[static_cast<size_t>(row) * n + e];
  const float* sv = a.sv + static_cast<size_t>(row) * h * h;

  for (int t = 0; t < a.tm1; ++t) {
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    const float* fz_t = a.fz + step * zd * h;
    __syncthreads();  // publishes xc
    eval_fwd(a.w, s, h, xd, zd, xc, fz_t, sv, k1);
    if (a.solver == 0) {  // Euler
      for (int e = tid; e < n; e += kThreads) xc[e] = xc[e] + dt * k1[e];
    } else if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < n; e += kThreads) xs[e] = xc[e] + k1[e] * (0.5f * dt);
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, xs, fz_t, sv, k2);
      for (int e = tid; e < n; e += kThreads) xc[e] = xc[e] + dt * k2[e];
    } else {  // RK4, Kutta's 3/8 rule
      for (int e = tid; e < n; e += kThreads) xs[e] = xc[e] + dt * k1[e] * kOneThird;
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, xs, fz_t, sv, k2);
      for (int e = tid; e < n; e += kThreads) xs[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, xs, fz_t, sv, k3);
      for (int e = tid; e < n; e += kThreads) xs[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      __syncthreads();
      eval_fwd(a.w, s, h, xd, zd, xs, fz_t, sv, k4);
      for (int e = tid; e < n; e += kThreads)
        xc[e] = xc[e] + (k1[e] + 3.0f * (k2[e] + k3[e]) + k4[e]) * dt * 0.125f;
    }
    // the thread that updated xc[e] writes it out
    for (int e = tid; e < n; e += kThreads) a.sol[step * n + e] = xc[e];
  }
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; w is a host array of the 15 weight pointers in
// the order of flatten_weights (ops/fused_channelwise.py). solver: 0 Euler,
// 1 Midpoint, 2 RK4 (3/8 rule). Launches one block per batch row on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch (0 on success); cudaErrorInvalidValue for h outside 1..128.
extern "C" int psn_fused_cw_rollout_f32(const void* fz, const void* dt, const void* sv,
                                        const void* x0, const void* const* w, void* sol, int tm1,
                                        int batch, int h, int xd, int zd, int solver,
                                        void* stream) {
  if (tm1 < 0 || batch < 1 || h < 1 || h > kMaxH || xd < 1 || zd < 0 || solver < 0 ||
      solver > 2)
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
  const size_t smem = smem_floats(h, xd, zd) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_cw_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_cw_rollout_kernel<<<batch, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
