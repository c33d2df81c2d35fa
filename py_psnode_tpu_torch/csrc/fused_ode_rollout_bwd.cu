// Reverse-time VJP of the fused ODE rollout in one launch, plus a small
// kernel that sums the blocks' partial weight gradients.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_ode.py:_bwd_kernel (:171),
// launched by _bwd (pallas_call at :356). It computes the same function in
// float32 with float32 accumulation (no TF32, no tensor cores), without the
// TPU's grid, time blocking, dt == 0 padding or bf16 mode. Per batch row,
// for t = T-2 down to 0, with x_t = sol[t] read from the saved solution and
// the carry gx_c (zero at the start):
//
//   gX1 = cot[t+1] + gx_c
//   recompute the Euler / Midpoint / RK4-3/8 stages of
//   f(x) = tail(elu(s_de[t] + x @ wx)) from x_t, then backprop the step:
//   g_s_de[t] = sum over stages of the lifted first layer's cotangent,
//   gx_c = dL/dx_t (the RK4 cotangent order of fused_ode.py:226-264)
//
// and the gradients of wx and of every tail weight and bias accumulate over
// all rows and steps. g_x0 is the carry after step 0 (the wrapper adds
// cot[0]).
//
// The TPU grid runs its batch blocks one after another, so the TPU kernel
// accumulates the weight gradients in one output block. Here the blocks run
// in parallel and in no order: each block owns one batch row and adds into
// its OWN row of partial gradients in global memory (33.5 k floats, 134 KB
// per block at h=128, xd=2; that row would fit beside the residuals in a
// block's shared memory at this shape, but not for a wider h or more tail
// layers, so it lives in L2 as in the DAE backward), and
// reduce_partials sums the rows in block order. Each accumulator is only
// ever touched by the one thread that owns its index, in step order, so the
// result is bit-identical from run to run, with no atomics.
//
// Bound on an H100 SXM at the no-encode training shape (B=64, T=1001,
// h=128, xd=2, RK4): a row-step recomputes four evaluations of f (4 x 66.6
// kFLOP) and backprops each, two products per layer (the cotangent through
// W^T and the weight-gradient outer product, 2 x 66.6 kFLOP): 0.8 MFLOP,
// 51 GFLOP for the call, 0.76 ms at the card's 67 TFLOP/s of float32 on the
// CUDA cores. Its bytes (s_de in, g_s_de out: 2 x 33 MB) take 0.02 ms at
// 3.35 TB/s. So it is compute-bound on paper and latency-bound in practice:
// each step is a serial chain of about twice the forward's dependent layers,
// each closed by a block barrier, and B=64 gives 64 blocks.
//
// Design: as csrc/fused_dae_rollout_bwd.cu. Each block owns one batch row
// and loops over all steps inside the block; KS=4 threads share each output
// column of a wide layer and combine with warp shuffles. The step's
// residuals (pre-activations and activations of every stage, stage inputs,
// output cotangents) live in shared memory; the backward overwrites each
// pre-activation with its cotangent. The backward products read transposed
// copies of the weights that the wrapper makes, so that neighbouring
// threads read neighbouring addresses. After the chain, one pass per step
// adds every stage's outer products into the block's partial gradients:
// each accumulator is read and written once per step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTail = 8;        // tail layers
constexpr int kColThreads = 128;   // output columns a block covers at once
constexpr int kKS = 4;             // threads per output column of a wide layer
constexpr int kThreads = kColThreads * kKS;
constexpr int kStages = 4;         // RK4's; Euler uses 1, Midpoint 2
constexpr float kOneThird = 1.0f / 3.0f;

// Offsets of each gradient in one block's row of partials; the order of
// flatten_weights in ops/fused_ode_vjp.py: wx, then (W, b) per tail layer.
struct GradOffsets {
  int wx;
  int w[kMaxTail], b[kMaxTail];
  int total;
};

struct Args {
  const float* s_de;          // [tm1, batch, h]
  const float* dt;            // [tm1, batch]
  const float* sol;           // [tm1 + 1, batch, xd]: x_0 .. x_{tm1}
  const float* cot;           // [tm1 + 1, batch, xd]: cotangent of sol
  const float* wx;            // [xd, h]
  const float* wx_t;          // [h, xd]
  const float* w[kMaxTail];   // tail [in, out] row-major (flax kernel layout)
  const float* wt[kMaxTail];  // [out, in]: the transpose, for the backward
  const float* b[kMaxTail];   // [out]
  int n_tail;
  float* g_s_de;              // [tm1, batch, h]
  float* partial;             // [batch, off.total], zeroed by the caller
  float* g_w;                 // [off.total]
  float* g_x0;                // [batch, xd]
  GradOffsets off;
  int tm1, batch, h, xd, solver;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

__device__ __forceinline__ float delu(float p) {
  return p > 0.f ? 1.f : expf(fminf(p, 0.f));
}

// What a dense layer does with v = sum_k in[k] w[k, j] + add[j]:
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
// memory, w [k_in, n_out] and add [n_out] (bias or stream row, may be null)
// in global memory.
__device__ void dense_wide(const float* in, int k_in, const float* __restrict__ w,
                           const float* __restrict__ add, float* out, float* act, int n_out,
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
    if (live && ks == 0) store(mode, acc + (add ? __ldg(add + j) : 0.f), out, act, j);
  }
}

// Narrow layer (n_out < 32): one warp per output, lanes split the reduction.
__device__ void dense_narrow(const float* in, int k_in, const float* __restrict__ w,
                             const float* __restrict__ add, float* out, float* act, int n_out,
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
    if (lane == 0) store(mode, acc + (add ? __ldg(add + j) : 0.f), out, act, j);
  }
}

__device__ __forceinline__ void dense(const float* in, int k_in, const float* w,
                                      const float* add, float* out, float* act, int n_out,
                                      int mode) {
  if (n_out >= 32) {
    dense_wide(in, k_in, w, add, out, act, n_out, mode);
  } else {
    dense_narrow(in, k_in, w, add, out, act, n_out, mode);
  }
}

// The residuals of one stage in shared memory: per layer l < n_tail, the
// pre-activation pre[l] (overwritten by its cotangent in the backward) and
// the activation act[l], each [h] (l = 0 is the lifted first layer); the
// stage input x, its output y = f(x) and the output's cotangent gy, [xd].
struct Res {
  float* pre;
  float* act;
  float* x;
  float* y;
  float* gy;
};

// One stage forward keeping residuals: rs.x holds the stage input
// (published by a barrier). Ends with a barrier.
__device__ __noinline__ void stage_fwd(const Args& a, const float* s_row, const Res& rs) {
  const int h = a.h;
  dense(rs.x, a.xd, a.wx, s_row, rs.pre, rs.act, h, kFwd);
  __syncthreads();
  for (int l = 0; l + 1 < a.n_tail; ++l) {
    dense(rs.act + l * h, h, a.w[l], a.b[l], rs.pre + (l + 1) * h, rs.act + (l + 1) * h, h, kFwd);
    __syncthreads();
  }
  const int n = a.n_tail - 1;
  dense(rs.act + n * h, h, a.w[n], a.b[n], rs.y, nullptr, a.xd, kStore);
  __syncthreads();
}

// One stage backward from rs.gy (published by a barrier): leaves the
// cotangent of every pre-activation in rs.pre, so rs.pre[0..h) is the
// lifted first layer's (this stage's part of g_s_de), and writes
// g_x = rs.pre[0..h) @ wx^T to gx [xd]. Ends with a barrier.
__device__ __noinline__ void stage_bwd(const Args& a, const Res& rs, float* gx) {
  const int h = a.h, n = a.n_tail - 1;
  dense(rs.gy, a.xd, a.wt[n], nullptr, rs.pre + n * h, nullptr, h, kBwd);
  __syncthreads();
  for (int l = n - 1; l >= 0; --l) {
    dense(rs.pre + (l + 1) * h, h, a.wt[l], nullptr, rs.pre + l * h, nullptr, h, kBwd);
    __syncthreads();
  }
  dense(rs.pre, h, a.wx_t, nullptr, gx, nullptr, a.xd, kStore);
  __syncthreads();
}

// P[k, j] += sum over stages q < nq of u_q[k] * v_q[j] (u_q [K], v_q [N]),
// or with u == null, P[j] += sum v_q[j]. Thread e owns entries e,
// e + blockDim.x, ...: the same thread every step.
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

__global__ void __launch_bounds__(kThreads)
    fused_ode_rollout_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, B = a.batch, n = a.n_tail;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row = blockIdx.x;
  float* p = smem;
  Res rs[kStages];
  for (int q = 0; q < kStages; ++q) {
    rs[q].pre = p;
    p += n * h;
    rs[q].act = p;
    p += n * h;
    rs[q].x = p;
    p += xd;
    rs[q].y = p;
    p += xd;
    rs[q].gy = p;
    p += xd;
  }
  float* gsde = p;  p += h;       // sum of the stages' first-layer cotangents
  float* xc = p;    p += xd;      // x_t
  float* gX1 = p;   p += xd;      // cotangent of x_{t+1}
  float* gxc = p;   p += xd;      // x carry, then g_x0 of the step
  float* gk = p;    p += 3 * xd;  // stage cotangents g_k1..g_k3
  float* tx = p;    p += xd;      // g_x of one stage backward

  for (int e = tid; e < xd; e += nt) gxc[e] = 0.f;
  const int S = a.solver == 0 ? 1 : (a.solver == 1 ? 2 : 4);
  float* Pb = a.partial + static_cast<size_t>(row) * a.off.total;
  __syncthreads();

  for (int t = a.tm1 - 1; t >= 0; --t) {
    const size_t step = static_cast<size_t>(t) * B;
    const float dt = __ldg(a.dt + step + row);  // the same for every thread
    const float* s_row = a.s_de + (step + row) * h;
    for (int c = tid; c < xd; c += nt) {
      xc[c] = a.sol[(step + row) * xd + c];
      rs[0].x[c] = xc[c];
      gX1[c] = a.cot[(step + B + row) * xd + c] + gxc[c];
    }
    __syncthreads();

    // ---- recompute the stages ----
    stage_fwd(a, s_row, rs[0]);
    if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < xd; e += nt) rs[1].x[e] = xc[e] + rs[0].y[e] * (0.5f * dt);
      __syncthreads();
      stage_fwd(a, s_row, rs[1]);
    } else if (a.solver == 2) {  // RK4, Kutta's 3/8 rule
      const float* k1 = rs[0].y;
      for (int e = tid; e < xd; e += nt) rs[1].x[e] = xc[e] + dt * k1[e] * kOneThird;
      __syncthreads();
      stage_fwd(a, s_row, rs[1]);
      const float* k2 = rs[1].y;
      for (int e = tid; e < xd; e += nt) rs[2].x[e] = xc[e] + dt * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      stage_fwd(a, s_row, rs[2]);
      const float* k3 = rs[2].y;
      for (int e = tid; e < xd; e += nt) rs[3].x[e] = xc[e] + dt * (k1[e] - k2[e] + k3[e]);
      __syncthreads();
      stage_fwd(a, s_row, rs[3]);
    }

    // ---- the step backward ----
    if (a.solver == 0) {  // Euler: x1 = x + dt f(x)
      for (int e = tid; e < xd; e += nt) rs[0].gy[e] = dt * gX1[e];
      __syncthreads();
      stage_bwd(a, rs[0], tx);
      for (int e = tid; e < xd; e += nt) gxc[e] = gX1[e] + tx[e];
      for (int e = tid; e < h; e += nt) gsde[e] = rs[0].pre[e];
    } else if (a.solver == 1) {  // Midpoint: x1 = x + dt f(x + (dt/2) f(x))
      for (int e = tid; e < xd; e += nt) rs[1].gy[e] = dt * gX1[e];
      __syncthreads();
      stage_bwd(a, rs[1], tx);  // tx = g_xmid
      for (int e = tid; e < xd; e += nt) {
        rs[0].gy[e] = (0.5f * dt) * tx[e];
        gxc[e] = gX1[e] + tx[e];
      }
      __syncthreads();
      stage_bwd(a, rs[0], tx);
      for (int e = tid; e < xd; e += nt) gxc[e] += tx[e];
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
      for (int e = tid; e < h; e += nt) gsde[e] = 0.f;
      __syncthreads();
      stage_bwd(a, rs[3], tx);  // g_a4
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        gk1[e] += dt * g;
        gk2[e] -= dt * g;
        rs[2].gy[e] = gk3[e] + dt * g;  // final g_k3
      }
      for (int e = tid; e < h; e += nt) gsde[e] += rs[3].pre[e];
      __syncthreads();
      stage_bwd(a, rs[2], tx);  // g_a3
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        rs[1].gy[e] = gk2[e] + dt * g;  // final g_k2
        gk1[e] -= dt * g * kOneThird;
      }
      for (int e = tid; e < h; e += nt) gsde[e] += rs[2].pre[e];
      __syncthreads();
      stage_bwd(a, rs[1], tx);  // g_a2
      for (int e = tid; e < xd; e += nt) {
        const float g = tx[e];
        gxc[e] += g;
        rs[0].gy[e] = gk1[e] + dt * g * kOneThird;  // final g_k1
      }
      for (int e = tid; e < h; e += nt) gsde[e] += rs[1].pre[e];
      __syncthreads();
      stage_bwd(a, rs[0], tx);  // g_a1
      for (int e = tid; e < xd; e += nt) gxc[e] += tx[e];
      for (int e = tid; e < h; e += nt) gsde[e] += rs[0].pre[e];
    }
    // gsde[e] and gxc[e] are read below only by the thread that wrote them
    for (int e = tid; e < h; e += nt) a.g_s_de[(step + row) * h + e] = gsde[e];

    // ---- add the step's weight and bias gradients ----
    {
      const float* u[kStages];
      const float* v[kStages];
      for (int q = 0; q < S; ++q) {
        u[q] = rs[q].x;
        v[q] = rs[q].pre;
      }
      accumulate(Pb + a.off.wx, xd, h, u, v, S);
      for (int l = 0; l < n; ++l) {
        const bool last = l == n - 1;
        for (int q = 0; q < S; ++q) {
          u[q] = rs[q].act + l * h;
          v[q] = last ? rs[q].gy : rs[q].pre + (l + 1) * h;
        }
        accumulate(Pb + a.off.w[l], h, last ? xd : h, u, v, S);
        accumulate(Pb + a.off.b[l], 1, last ? xd : h, nullptr, v, S);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < xd; e += nt) a.g_x0[static_cast<size_t>(row) * xd + e] = gxc[e];
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

size_t smem_floats(int h, int xd, int n_tail) {
  return kStages * (2 * static_cast<size_t>(n_tail) * h + 3 * xd) + h + 7 * xd;
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.h, a.xd, a.n_tail) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ode_rollout_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_ode_rollout_bwd_kernel<<<a.batch, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_partials<<<(a.off.total + 255) / 256, 256, 0, stream>>>(a.partial, a.batch, a.off.total,
                                                                 a.g_w);
  return cudaGetLastError();
}

// Offsets in the order wx, (W, b) per tail layer; hidden tail layers are
// [h, h], the last [h, xd].
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

}  // namespace

// Number of floats in one row of partial gradients (and in g_w).
extern "C" int psn_fused_ode_bwd_grad_size(int h, int xd, int n_tail) {
  return grad_offsets(h, xd, n_tail).total;
}

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; tail_w/tail_wt/tail_b are host arrays of them
// (W, W^T, b per tail layer). `partial` is [batch,
// psn_fused_ode_bwd_grad_size(...)] (a block per batch row) and must be
// zero; g_w receives the summed gradients in the same layout. solver: 0
// Euler, 1 Midpoint, 2 RK4 (3/8 rule). Launches both kernels on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int psn_fused_ode_rollout_bwd_f32(
    const void* s_de, const void* dt, const void* sol, const void* cot, const void* wx,
    const void* wx_t, const void* const* tail_w, const void* const* tail_wt,
    const void* const* tail_b, int n_tail, void* g_s_de, void* partial, void* g_w, void* g_x0,
    int tm1, int batch, int h, int xd, int solver, void* stream) {
  if (tm1 < 1 || batch < 1 || h < 1 || xd < 1 || solver < 0 || solver > 2 || n_tail < 1 ||
      n_tail > kMaxTail)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.dt = static_cast<const float*>(dt);
  a.sol = static_cast<const float*>(sol);
  a.cot = static_cast<const float*>(cot);
  a.wx = static_cast<const float*>(wx);
  a.wx_t = static_cast<const float*>(wx_t);
  for (int l = 0; l < kMaxTail; ++l) {
    a.w[l] = l < n_tail ? static_cast<const float*>(tail_w[l]) : nullptr;
    a.wt[l] = l < n_tail ? static_cast<const float*>(tail_wt[l]) : nullptr;
    a.b[l] = l < n_tail ? static_cast<const float*>(tail_b[l]) : nullptr;
  }
  a.n_tail = n_tail;
  a.g_s_de = static_cast<float*>(g_s_de);
  a.partial = static_cast<float*>(partial);
  a.g_w = static_cast<float*>(g_w);
  a.g_x0 = static_cast<float*>(g_x0);
  a.off = grad_offsets(h, xd, n_tail);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.solver = solver;
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
