// Forward rollout of the neural ODE in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_ode.py:_fwd_kernel (:125),
// launched by _forward (pallas_call at :307). It computes the same function,
// in float32 with float32 accumulation (no TF32, no tensor cores), without
// the TPU's grid, time blocking, dt == 0 padding, lanes or bf16 mode. Per
// step t and batch row b, with the layer-1 stream s_de (the initial-state
// contribution and the event-adjusted z projection, lifted out of the loop):
//
//   f(x) = tail(elu(s_de[t,b] + x @ wx))
//   x1   = Euler / Midpoint / RK4-3/8 step of f from x_c with dt[t,b]
//   sol[t,b] = x1;  x_c = x1
//
// where tail applies n_tail - 1 Dense->ELU layers [h, h] and a last Dense
// [h, xd] without activation. n_tail (1..kMaxTail) and xd are runtime
// values: the no-encode dynamics run with n_tail = 3 and xd the state
// width, the direct-encode latent dynamics with n_tail = 1 and xd = h.
//
// Bound on an H100 SXM at the no-encode training shape (B=64, T=1001,
// h=128, xd=2, RK4): an evaluation of f costs 2 (xd h + 2 h^2 + h xd) =
// 66.6 kFLOP, four per step, so the rollout is 64 x 1000 x 4 x 66.6 k =
// 17 GFLOP: 0.25 ms at the card's 67 TFLOP/s of float32 on the CUDA
// cores. Its bytes (s_de in, 33 MB, the solution out) take 0.01 ms at
// 3.35 TB/s. So it is compute-bound on paper and latency-bound in
// practice: each step is a serial chain of dependent layers (3 per
// evaluation, 12 with RK4), each closed by a block barrier, and B=64 gives
// few blocks.
//
// Design: one block per batch row (rows are independent, so no reduction
// crosses blocks) runs the whole T-1-step loop. The carry, the stage
// values and the activations live in shared memory. Weights are read from
// global memory through the read-only cache, as in
// csrc/fused_dae_rollout.cu, not staged in shared memory: the no-encode
// tail at h=128 (two 128x128 matrices and 128x2, 129 KB) would fit in a
// block's 227 KB, but staging would cap h and n_tail at what fits, and
// with the block's shared memory at a few KB the SM gives the rest of its
// 256 KB to L1, which can hold the same weights. A wide layer gives each
// output column kSplit threads that split the reduction and combine it
// with warp shuffles; a narrow layer (the xd-wide readout) gives each
// output a warp. The first layer's input projection x @ wx runs as a
// dense layer too, so xd = h costs no more than a tail layer.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTail = 8;       // tail layers
constexpr int kColThreads = 128;  // output columns a block covers at once
constexpr int kSplit = 4;         // threads per output column of a wide layer
constexpr int kThreads = kColThreads * kSplit;
constexpr float kOneThird = 1.0f / 3.0f;

struct Args {
  const float* s_de;         // [tm1, batch, h]
  const float* dt;           // [tm1, batch]
  const float* x0;           // [batch, xd]
  const float* wx;           // [xd, h]
  const float* w[kMaxTail];  // tail [in, out] row-major (flax kernel layout)
  const float* b[kMaxTail];  // [out]
  int n_tail;
  float* sol;                // [tm1, batch, xd]
  int tm1, batch, h, xd, solver;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// The term added to output j after the reduction: the bias b[j] or, for the
// first layer, the stream row s[j].
__device__ __forceinline__ float addend(const float* __restrict__ b, const float* __restrict__ s,
                                        int j) {
  return b ? __ldg(b + j) : __ldg(s + j);
}

// out[j] = act(sum_k in[k] * w[k, j] + addend) for j < n_out; kSplit
// threads per output column, in/out in shared memory.
__device__ void dense_wide(const float* in, int k_in, const float* __restrict__ w,
                           const float* b, const float* s, float* out, int n_out, bool act) {
  const int ks = threadIdx.x % kSplit;
  const int col = threadIdx.x / kSplit;
  constexpr int ncol = kThreads / kSplit;
  // every thread runs the same trip count, so the shuffles below see full warps
  for (int j0 = 0; j0 < n_out; j0 += ncol) {
    const int j = j0 + col;
    const bool live = j < n_out;
    float acc = 0.f;
    if (live) {
#pragma unroll 8
      for (int k = ks; k < k_in; k += kSplit)
        acc = fmaf(in[k], __ldg(w + static_cast<size_t>(k) * n_out + j), acc);
    }
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && ks == 0) {
      const float v = acc + addend(b, s, j);
      out[j] = act ? elu(v) : v;
    }
  }
}

// Narrow layer (n_out < 32): one warp per output, lanes split the reduction.
__device__ void dense_narrow(const float* in, int k_in, const float* __restrict__ w,
                             const float* b, const float* s, float* out, int n_out, bool act) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nwarp = kThreads >> 5;
  for (int j = warp; j < n_out; j += nwarp) {
    float acc = 0.f;
    for (int k = lane; k < k_in; k += 32)
      acc = fmaf(in[k], __ldg(w + static_cast<size_t>(k) * n_out + j), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float v = acc + addend(b, s, j);
      out[j] = act ? elu(v) : v;
    }
  }
}

__device__ __forceinline__ void dense(const float* in, int k_in, const float* w, const float* b,
                                      const float* s, float* out, int n_out, bool act) {
  if (n_out >= 32) {
    dense_wide(in, k_in, w, b, s, out, n_out, act);
  } else {
    dense_narrow(in, k_in, w, b, s, out, n_out, act);
  }
}

// f(x) for the block's row into res [xd]: the lifted first layer
// elu(s + x @ wx) into bufa, then the tail, ping-ponging between bufa and
// bufb [h]. Starts after a barrier that published x, ends with one.
// Not inlined: the solvers reach it from four places.
__device__ __noinline__ void eval_f(const Args& a, const float* s_t, const float* x, float* bufa,
                                    float* bufb, float* res) {
  const int h = a.h;
  dense(x, a.xd, a.wx, nullptr, s_t, bufa, h, true);
  __syncthreads();
  float* cur = bufa;
  float* nxt = bufb;
  for (int l = 0; l + 1 < a.n_tail; ++l) {
    dense(cur, h, a.w[l], a.b[l], nullptr, nxt, h, true);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  dense(cur, h, a.w[a.n_tail - 1], a.b[a.n_tail - 1], nullptr, res, a.xd, false);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_ode_rollout_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, B = a.batch;
  float* bufa = smem;      // [h]
  float* bufb = bufa + h;  // [h]
  float* xc = bufb + h;    // [xd] rolled state
  float* xs = xc + xd;     // [xd] stage input
  float* k1 = xs + xd;     // [xd] stage derivatives
  float* k2 = k1 + xd;
  float* k3 = k2 + xd;
  float* k4 = k3 + xd;

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  for (int e = tid; e < xd; e += kThreads) xc[e] = a.x0[static_cast<size_t>(row) * xd + e];

  for (int t = 0; t < a.tm1; ++t) {
    const size_t step = static_cast<size_t>(t) * B + row;
    const float dt = __ldg(a.dt + step);
    __syncthreads();  // publishes xc
    const float* s_t = a.s_de + step * h;
    eval_f(a, s_t, xc, bufa, bufb, k1);
    if (a.solver == 0) {  // Euler
      for (int e = tid; e < xd; e += kThreads) xc[e] = xc[e] + dt * k1[e];
    } else if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < xd; e += kThreads) xs[e] = xc[e] + k1[e] * (0.5f * dt);
      __syncthreads();
      eval_f(a, s_t, xs, bufa, bufb, k2);
      for (int e = tid; e < xd; e += kThreads) xc[e] = xc[e] + dt * k2[e];
    } else {  // RK4, Kutta's 3/8 rule
      for (int e = tid; e < xd; e += kThreads) xs[e] = xc[e] + dt * k1[e] * kOneThird;
      __syncthreads();
      eval_f(a, s_t, xs, bufa, bufb, k2);
      for (int e = tid; e < xd; e += kThreads) xs[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      eval_f(a, s_t, xs, bufa, bufb, k3);
      for (int e = tid; e < xd; e += kThreads) xs[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      __syncthreads();
      eval_f(a, s_t, xs, bufa, bufb, k4);
      for (int e = tid; e < xd; e += kThreads)
        xc[e] = xc[e] + (k1[e] + 3.0f * (k2[e] + k3[e]) + k4[e]) * dt * 0.125f;
    }
    // the thread that updated xc[e] writes it out
    for (int e = tid; e < xd; e += kThreads) a.sol[step * xd + e] = xc[e];
  }
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; tail_w/tail_b are host arrays of them. solver:
// 0 Euler, 1 Midpoint, 2 RK4 (3/8 rule). Launches one block per batch row
// on `stream` without synchronising and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int psn_fused_ode_rollout_f32(const void* s_de, const void* dt, const void* x0,
                                         const void* wx, const void* const* tail_w,
                                         const void* const* tail_b, int n_tail, void* sol,
                                         int tm1, int batch, int h, int xd, int solver,
                                         void* stream) {
  if (tm1 < 0 || batch < 1 || h < 1 || xd < 1 || solver < 0 || solver > 2 || n_tail < 1 ||
      n_tail > kMaxTail)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.dt = static_cast<const float*>(dt);
  a.x0 = static_cast<const float*>(x0);
  a.wx = static_cast<const float*>(wx);
  for (int l = 0; l < kMaxTail; ++l) {
    a.w[l] = l < n_tail ? static_cast<const float*>(tail_w[l]) : nullptr;
    a.b[l] = l < n_tail ? static_cast<const float*>(tail_b[l]) : nullptr;
  }
  a.n_tail = n_tail;
  a.sol = static_cast<float*>(sol);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.solver = solver;
  if (tm1 == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = (2 * static_cast<size_t>(h) + 6 * static_cast<size_t>(xd)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ode_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_ode_rollout_kernel<<<batch, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
