// Forward rollout of the semi-explicit neural DAE in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_dae.py:_kernel (:371),
// launched by fused_dae_rollout_packed (pallas_call at :588). It computes
// the same function, in float32 with float32 accumulation (no TF32, no
// tensor cores), without the TPU's grid, time blocking, lanes, bf16 mode or
// teacher forcing. Per step t and batch row b:
//
//   i_in = ev[t,b] > 0 ? AE(x_c, s_ae_ev[t]) : i_c      (event recompute)
//   f(x) = DE_tail(s_de[t] + x @ wx_de + i_in @ wi_de)
//   x1   = Euler / Midpoint / RK4-3/8 step of f from x_c with dt[t,b]
//   i1   = AE(x1, s_ae[t]),  AE(x, s) = AE_tail(s + x @ gx_ae)
//   sol[t,b] = cat(x1, i1);  x_c, i_c = x1, i1
//
// where *_tail applies ELU to the lifted first layer, then Dense->ELU
// layers and a last Dense without activation.
//
// Bound on an H100 SXM at the motor evaluation shape (B=32, T=1001, h=128,
// xd=3, id=2): a row-step costs about 1.3e5 FLOP with Euler (one DE and one
// AE evaluation, two 128x128 layers each) and 3.3e5 with RK4 (four DE
// evaluations), so a rollout is 4e9 / 1.1e10 FLOP: 0.06 / 0.16 ms at the
// card's 67 TFLOP/s of float32 on the CUDA cores. The three h-wide streams
// are 3 x 1000 x 32 x 128 x 4 B = 49 MB of reads, 15 us at 3.35 TB/s. So the
// kernel is compute-bound on paper and latency-bound in practice: each step
// is a serial chain of dependent 128-wide layers (6 with Euler, 15 with
// RK4), each closed by a block barrier, and B=32 gives little parallelism.
//
// Design: blocks own disjoint tiles of R batch rows (rows are independent,
// so no reduction crosses blocks) and run the whole T-1-step loop inside
// the block. Carries, stage values and activations live in shared memory.
// Weights are read from global memory through the read-only cache: the four
// 128x128 float32 tail matrices are 256 KB, more than a block's 227 KB of
// shared memory, and they stay in L2. Each weight a thread loads serves all
// R rows of its block. A wide layer gives each output column KS threads
// that split the reduction and combine it with warp shuffles, which
// shortens the dependent chain of each layer; a narrow layer (the xd- or
// id-wide readout) gives each output a warp.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTail = 8;        // tail layers per net
constexpr int kColThreads = 128;   // output columns a block covers at once
constexpr float kOneThird = 1.0f / 3.0f;

struct Tail {
  const float* w[kMaxTail];  // [in, out] row-major (flax kernel layout)
  const float* b[kMaxTail];  // [out]
  int n;                     // number of tail layers
  int out;                   // width of the last layer
};

struct Args {
  const float* s_de;     // [tm1, batch, h]
  const float* s_ae;     // [tm1, batch, h]
  const float* s_ae_ev;  // [tm1, batch, h]
  const float* aux;      // [tm1, batch, 2]: (dt, ev)
  const float* x0;       // [batch, xd]
  const float* i0;       // [batch, id]
  const float* wx_de;    // [xd, h]
  const float* wi_de;    // [id, h]
  const float* gx_ae;    // [xd, h]
  Tail de;               // hidden layers [h, h], last [h, xd]
  Tail ae;               // hidden layers [h, h], last [h, id]
  float* sol;            // [tm1, batch, xd + id]
  int tm1, batch, h, xd, id, solver;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// out[r, j] = act(sum_k in[r, k] * w[k, j] + b[j]) for r < R, j < n_out;
// KS threads per output column, in/out in shared memory.
template <int R, int KS>
__device__ void dense_wide(const float* in, int k_in, const float* __restrict__ w,
                           const float* __restrict__ b, float* out, int n_out, bool act) {
  const int ks = threadIdx.x % KS;
  const int col = threadIdx.x / KS;
  const int ncol = blockDim.x / KS;
  // every thread runs the same trip count, so the shuffles below see full warps
  for (int j0 = 0; j0 < n_out; j0 += ncol) {
    const int j = j0 + col;
    const bool live = j < n_out;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (live) {
#pragma unroll 8
      for (int k = ks; k < k_in; k += KS) {
        const float wk = __ldg(w + static_cast<size_t>(k) * n_out + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * k_in + k], wk, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = KS / 2; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (live && ks == 0) {
      const float bj = __ldg(b + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = acc[r] + bj;
        out[r * n_out + j] = act ? elu(v) : v;
      }
    }
  }
}

// Narrow layer (n_out < 32): one warp per output, lanes split the reduction.
template <int R>
__device__ void dense_narrow(const float* in, int k_in, const float* __restrict__ w,
                             const float* __restrict__ b, float* out, int n_out, bool act) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int j = warp; j < n_out; j += nwarp) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = lane; k < k_in; k += 32) {
      const float wk = __ldg(w + static_cast<size_t>(k) * n_out + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * k_in + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
      const float bj = __ldg(b + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = acc[r] + bj;
        out[r * n_out + j] = act ? elu(v) : v;
      }
    }
  }
}

template <int R, int KS>
__device__ __forceinline__ void dense(const float* in, int k_in, const float* w,
                                      const float* b, float* out, int n_out, bool act) {
  if (n_out >= 32) {
    dense_wide<R, KS>(in, k_in, w, b, out, n_out, act);
  } else {
    dense_narrow<R>(in, k_in, w, b, out, n_out, act);
  }
}

// Tail of a net: `a` holds the first layer's pre-activations [R, h] (it is
// overwritten), `scratch` is [R, h], the result [R, tl.out] goes to `res`.
// Starts after a barrier that published `a`, ends with a barrier. Not
// inlined: the solvers reach it from nine places, and inlining all nine
// copies in every launch-shape instantiation made the build take a minute.
template <int R, int KS>
__device__ __noinline__ void mlp_tail(const Tail& tl, float* a, float* scratch, float* res, int h) {
  for (int e = threadIdx.x; e < R * h; e += blockDim.x) a[e] = elu(a[e]);
  __syncthreads();
  float* cur = a;
  float* nxt = scratch;
  for (int l = 0; l + 1 < tl.n; ++l) {
    dense<R, KS>(cur, h, tl.w[l], tl.b[l], nxt, h, true);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  dense<R, KS>(cur, h, tl.w[tl.n - 1], tl.b[tl.n - 1], res, tl.out, false);
  __syncthreads();
}

// AE(x, s) for the block's rows: pre = s[row] + x @ gx_ae, then the AE tail.
template <int R, int KS>
__device__ void ae_eval(const Args& a, const float* s_t, const float* x, float* pre,
                        float* scratch, float* res, int row0) {
  const int h = a.h, xd = a.xd;
  for (int e = threadIdx.x; e < R * h; e += blockDim.x) {
    const int r = e / h, j = e - r * h, g = row0 + r;
    float xp = 0.f;
    for (int k = 0; k < xd; ++k) xp = fmaf(x[r * xd + k], __ldg(a.gx_ae + k * h + j), xp);
    const float s = g < a.batch ? __ldg(s_t + static_cast<size_t>(g) * h + j) : 0.f;
    pre[e] = s + xp;
  }
  __syncthreads();
  mlp_tail<R, KS>(a.ae, pre, scratch, res, h);
}

// f(x) for the block's rows: pre = s_de[row] + x @ wx_de + i_in @ wi_de,
// then the DE tail.
template <int R, int KS>
__device__ void de_eval(const Args& a, const float* s_t, const float* x, const float* i_in,
                        float* pre, float* scratch, float* res, int row0) {
  const int h = a.h, xd = a.xd, id = a.id;
  for (int e = threadIdx.x; e < R * h; e += blockDim.x) {
    const int r = e / h, j = e - r * h, g = row0 + r;
    float xp = 0.f;
    for (int k = 0; k < xd; ++k) xp = fmaf(x[r * xd + k], __ldg(a.wx_de + k * h + j), xp);
    float ip = 0.f;
    for (int k = 0; k < id; ++k) ip = fmaf(i_in[r * id + k], __ldg(a.wi_de + k * h + j), ip);
    const float s = g < a.batch ? __ldg(s_t + static_cast<size_t>(g) * h + j) : 0.f;
    pre[e] = (s + xp) + ip;
  }
  __syncthreads();
  mlp_tail<R, KS>(a.de, pre, scratch, res, h);
}

template <int R, int KS>
__global__ void __launch_bounds__(kColThreads * KS)
    fused_dae_rollout_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int h = a.h, xd = a.xd, id = a.id, B = a.batch;
  const int nx = R * xd, ni = R * id;
  float* pre = smem;            // [R, h]
  float* scratch = pre + R * h; // [R, h]
  float* xc = scratch + R * h;  // [R, xd] rolled state
  float* xs = xc + nx;          // [R, xd] stage input
  float* k1 = xs + nx;          // [R, xd] stage derivatives
  float* k2 = k1 + nx;
  float* k3 = k2 + nx;
  float* k4 = k3 + nx;
  float* xn = k4 + nx;          // [R, xd] next state
  float* ic = xn + nx;          // [R, id] lagged algebraic output
  float* iin = ic + ni;         // [R, id] algebraic input of this step
  float* iv = iin + ni;         // [R, id] AE result
  float* dts = iv + ni;         // [R] step sizes
  float* evs = dts + R;         // [R] event flags

  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * R;
  for (int e = tid; e < nx; e += nt) {
    const int g = row0 + e / xd;
    xc[e] = g < B ? a.x0[static_cast<size_t>(g) * xd + e % xd] : 0.f;
  }
  for (int e = tid; e < ni; e += nt) {
    const int g = row0 + e / id;
    ic[e] = g < B ? a.i0[static_cast<size_t>(g) * id + e % id] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < a.tm1; ++t) {
    const size_t step = static_cast<size_t>(t) * B;
    const float* s_de_t = a.s_de + step * h;
    int my_ev = 0;
    if (tid < R) {
      const int g = row0 + tid;
      float dtv = 0.f, evv = 0.f;
      if (g < B) {
        dtv = a.aux[(step + g) * 2];
        evv = a.aux[(step + g) * 2 + 1];
      }
      dts[tid] = dtv;
      evs[tid] = evv;
      my_ev = evv > 0.f;
    }
    for (int e = tid; e < ni; e += nt) iin[e] = ic[e];
    // publishes dts, evs and iin as well
    if (__syncthreads_or(my_ev)) {
      ae_eval<R, KS>(a, a.s_ae_ev + step * h, xc, pre, scratch, iv, row0);
      for (int e = tid; e < ni; e += nt)
        if (evs[e / id] > 0.f) iin[e] = iv[e];
      __syncthreads();
    }

    de_eval<R, KS>(a, s_de_t, xc, iin, pre, scratch, k1, row0);
    if (a.solver == 0) {  // Euler
      for (int e = tid; e < nx; e += nt) xn[e] = xc[e] + dts[e / xd] * k1[e];
    } else if (a.solver == 1) {  // Midpoint
      for (int e = tid; e < nx; e += nt) xs[e] = xc[e] + k1[e] * (0.5f * dts[e / xd]);
      __syncthreads();
      de_eval<R, KS>(a, s_de_t, xs, iin, pre, scratch, k2, row0);
      for (int e = tid; e < nx; e += nt) xn[e] = xc[e] + dts[e / xd] * k2[e];
    } else {  // RK4, Kutta's 3/8 rule
      for (int e = tid; e < nx; e += nt) xs[e] = xc[e] + dts[e / xd] * k1[e] * kOneThird;
      __syncthreads();
      de_eval<R, KS>(a, s_de_t, xs, iin, pre, scratch, k2, row0);
      for (int e = tid; e < nx; e += nt)
        xs[e] = xc[e] + dts[e / xd] * (k2[e] - k1[e] * kOneThird);
      __syncthreads();
      de_eval<R, KS>(a, s_de_t, xs, iin, pre, scratch, k3, row0);
      for (int e = tid; e < nx; e += nt) xs[e] = xc[e] + dts[e / xd] * (k1[e] - k2[e] + k3[e]);
      __syncthreads();
      de_eval<R, KS>(a, s_de_t, xs, iin, pre, scratch, k4, row0);
      for (int e = tid; e < nx; e += nt)
        xn[e] = xc[e] + (k1[e] + 3.0f * (k2[e] + k3[e]) + k4[e]) * dts[e / xd] * 0.125f;
    }
    __syncthreads();

    ae_eval<R, KS>(a, a.s_ae + step * h, xn, pre, scratch, iv, row0);
    const int w = xd + id;
    for (int e = tid; e < R * w; e += nt) {
      const int r = e / w, c = e - r * w, g = row0 + r;
      const float val = c < xd ? xn[r * xd + c] : iv[r * id + (c - xd)];
      if (g < B) a.sol[(step + g) * w + c] = val;
    }
    for (int e = tid; e < nx; e += nt) xc[e] = xn[e];
    for (int e = tid; e < ni; e += nt) ic[e] = iv[e];
    __syncthreads();
  }
}

template <int R, int KS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t floats = 2 * static_cast<size_t>(R) * a.h +
                        static_cast<size_t>(R) * (7 * a.xd + 3 * a.id + 2);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_dae_rollout_kernel<R, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.batch + R - 1) / R;
  fused_dae_rollout_kernel<R, KS><<<blocks, kColThreads * KS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_rows(const Args& a, int k_split, cudaStream_t stream) {
  switch (k_split) {
    case 2: return launch<R, 2>(a, stream);
    case 4: return launch<R, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool fill_tail(Tail* tl, const void* const* w, const void* const* b, int n, int out) {
  if (n < 1 || n > kMaxTail || out < 1) return false;
  for (int l = 0; l < kMaxTail; ++l) {
    tl->w[l] = l < n ? static_cast<const float*>(w[l]) : nullptr;
    tl->b[l] = l < n ? static_cast<const float*>(b[l]) : nullptr;
  }
  tl->n = n;
  tl->out = out;
  return true;
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; de_w/de_b/ae_w/ae_b are host arrays of them.
// solver: 0 Euler, 1 Midpoint, 2 RK4 (3/8 rule). rows_per_block: 1, 2, 4
// or 8; k_split: 2 or 4. Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int psn_fused_dae_rollout_f32(
    const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux,
    const void* x0, const void* i0, const void* wx_de, const void* wi_de, const void* gx_ae,
    const void* const* de_w, const void* const* de_b, int n_de,
    const void* const* ae_w, const void* const* ae_b, int n_ae,
    void* sol, int tm1, int batch, int h, int xd, int id,
    int solver, int rows_per_block, int k_split, void* stream) {
  if (tm1 < 0 || batch < 1 || h < 1 || xd < 1 || id < 1 || solver < 0 || solver > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.s_ae = static_cast<const float*>(s_ae);
  a.s_ae_ev = static_cast<const float*>(s_ae_ev);
  a.aux = static_cast<const float*>(aux);
  a.x0 = static_cast<const float*>(x0);
  a.i0 = static_cast<const float*>(i0);
  a.wx_de = static_cast<const float*>(wx_de);
  a.wi_de = static_cast<const float*>(wi_de);
  a.gx_ae = static_cast<const float*>(gx_ae);
  if (!fill_tail(&a.de, de_w, de_b, n_de, xd) || !fill_tail(&a.ae, ae_w, ae_b, n_ae, id))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sol = static_cast<float*>(sol);
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.xd = xd;
  a.id = id;
  a.solver = solver;
  if (tm1 == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return static_cast<int>(launch_rows<1>(a, k_split, st));
    case 2: return static_cast<int>(launch_rows<2>(a, k_split, st));
    case 4: return static_cast<int>(launch_rows<4>(a, k_split, st));
    case 8: return static_cast<int>(launch_rows<8>(a, k_split, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
