// Building blocks of the channel-wise kernels (csrc/fused_cw_rollout.cu and
// csrc/fused_cw_rollout_bwd.cu): a cluster of KC = 1, 2 or 4 blocks of
// kThreads threads evaluates the channel-wise dynamics of one batch row.
//
// One evaluation at the latent state xs [xd, h] (ops/fused_channelwise.py):
//
//   E  = elu(xs[c] @ E0[c] + e0[c]);  ft[c] = E[c] @ E1[c] + e1[c]   (c < xd)
//   ft[xd + c] = fz[t, b, c]                                          (c < zd)
//   a0 = elu(V A + s_constV[b]),  V[l, c] = ft[c, l]                  [h, h]
//   a1 = elu(a0 W1 + b1),  a2 = elu(a1 W2 + b2)                       [h, h]
//   O  = a2 W3 + b3                                                    [h, xd]
//   HE = elu(O[:, c] @ H0[c] + h0[c]);  y[c] = HE[c] @ H1[c] + h1[c]
//
// The two h x h x h products are nearly all of the arithmetic (2 h^3 of
// 2 h^3 + (5 xd + C) h^2 multiply-adds). They run on the tensor cores in
// 3xTF32 through csrc/mma_tile.cuh, whose tiles hold the [h, h]
// activations in shared memory.
//
// A cluster of KC blocks shares a row: every block keeps the whole tiles
// and state, and computes the column slice [rank, rank + 1) * kMaxH / KC of
// each product (and of the folded first layer, K = C = xd + zd, float32 on
// the CUDA cores); the epilogue (bias, s_constV, elu, elu', the gradient
// sums) writes its slice into the tile of every block of the cluster
// through distributed shared memory, and a cluster barrier publishes it.
// The per-channel nets (matrix-vector products read from L2, one thread per
// output) and the state updates are small: every block computes them all.
//
// h is a runtime value up to kMaxH; the tiles are sized for kMaxH, their
// rows and columns beyond h are zero (set once, never written), and the
// staged weight rows and columns beyond h are zero-filled by cp.async.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_tile.cuh"

namespace {

constexpr float kOneThird = 1.0f / 3.0f;

// The phase clock, for measuring where an evaluation's time goes: built
// with -DCW_PHASE_CLOCK, thread 0 of block 0 notes clock64() at each phase
// boundary (CW_PHASE) while g_phase_on is set, into g_phase: marks 0-9 in
// eval_fwd, 16-26 in the backward's eval_bwd; otherwise the marks compile
// to nothing.
constexpr int kPhaseMarks = 32;
#ifdef CW_PHASE_CLOCK
__device__ long long g_phase[kPhaseMarks];
__device__ int g_phase_on;
#define CW_PHASE(i)                                               \
  do {                                                            \
    if (g_phase_on && threadIdx.x == 0 && blockIdx.x == 0)        \
      g_phase[i] = clock64();                                     \
  } while (0)
#else
#define CW_PHASE(i) \
  do {              \
  } while (0)
#endif

// A barrier of the cluster's threads (of the block's when KC = 1), and its
// two halves: arrive when done reading what the other blocks write next,
// wait before writing it. A KC = 1 block needs no split barrier: its
// evaluation has barriers of its own in between.
template <int KC>
__device__ __forceinline__ void cl_sync() {
  if constexpr (KC == 1) {
    __syncthreads();
  } else {
    cluster_arrive();
    cluster_wait();
  }
}

template <int KC>
__device__ __forceinline__ void cl_arrive() {
  if constexpr (KC > 1) cluster_arrive();
}

template <int KC>
__device__ __forceinline__ void cl_wait() {
  if constexpr (KC > 1) cluster_wait();
}

// The same shared-memory location in every block of the cluster.
template <int KC>
struct AllRanks {
  float* p[KC];
};

template <int KC>
__device__ __forceinline__ AllRanks<KC> all_ranks(float* t) {
  AllRanks<KC> d;
#pragma unroll
  for (int r = 0; r < KC; ++r) d.p[r] = KC == 1 ? t : map_rank(t, r);
  return d;
}

// The epilogues below read every operand without a condition (an index
// beyond h is clamped or lands in a zero-padded row of shared memory) and
// write under m, n < h, so that a thread's loads are all in flight at
// once: under the condition, each global load would wait for the one
// before it.

// acc = V A + s_constV over the block's column slice: acc at (m, n) is
// sum_{c < C} ft[c][m] as[c][n] + sv[m][n], float32 on the CUDA cores (K =
// C is a few channels); as in shared memory, sv the row's [h, h] tile in
// global memory.
template <int KC>
__device__ __forceinline__ void first_layer(const float* ft, const float* as, int C, int h,
                                            const float* __restrict__ sv, Acc<KC>& acc) {
  using T = Tiling<KC>;
  const Frag f = frag<KC>();
  // a thread's outputs come in pairs of neighbouring columns (r, r + 1)
  const bool v2 = h % 2 == 0 && (reinterpret_cast<uintptr_t>(sv) & 7) == 0;
#pragma unroll
  for (int i = 0; i < T::kMi; ++i)
#pragma unroll
    for (int j = 0; j < T::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; r += 2) {
        const int m = min(acc_row(f, i, r), h - 1), n = acc_col(f, j, r);
        if (v2) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(sv + m * h + min(n, h - 2)));
          acc[i][j][r] = v.x;
          acc[i][j][r + 1] = v.y;
        } else {
          acc[i][j][r] = __ldg(sv + m * h + min(n, h - 1));
          acc[i][j][r + 1] = __ldg(sv + m * h + min(n + 1, h - 1));
        }
      }
  for (int c = 0; c < C; ++c) {
    float fr[T::kMi][2], ac[T::kNi][2];  // the rows' features, the columns' coefficients
#pragma unroll
    for (int i = 0; i < T::kMi; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) fr[i][u] = ft[c * kLdt + acc_row(f, i, 2 * u)];
#pragma unroll
    for (int j = 0; j < T::kNi; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) ac[j][u] = as[c * kMaxH + acc_col(f, j, u)];
#pragma unroll
    for (int i = 0; i < T::kMi; ++i)
#pragma unroll
      for (int j = 0; j < T::kNi; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = fmaf(fr[i][r >> 1], ac[j][r & 1], acc[i][j][r]);
  }
}

// tout[n][m] = elu(acc + bias[n]) (bias in shared memory, kMaxH long, or
// none) in every block of the cluster.
template <int KC>
__device__ __forceinline__ void store_act(Acc<KC>& acc, int h, const float* bias, float* tout) {
  const Frag f = frag<KC>();
  const AllRanks<KC> d = all_ranks<KC>(tout);
#pragma unroll
  for (int i = 0; i < Tiling<KC>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<KC>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = acc_row(f, i, r), n = acc_col(f, j, r);
        const float v = elu(acc[i][j][r] + (bias ? bias[n] : 0.f));
        if (m < h && n < h)
#pragma unroll
          for (int k = 0; k < KC; ++k) d.p[k][n * kLdt + m] = v;
      }
}

// t[n][m] = acc * elu'(t[n][m]) in every block of the cluster, from this
// block's t: the cotangent of a pre-activation from that of its
// activation, over the activation tile; acc becomes it too.
template <int KC>
__device__ __forceinline__ void store_bwd(Acc<KC>& acc, int h, float* t) {
  const Frag f = frag<KC>();
  const AllRanks<KC> d = all_ranks<KC>(t);
#pragma unroll
  for (int i = 0; i < Tiling<KC>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<KC>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = acc_row(f, i, r), n = acc_col(f, j, r);
        const float g = acc[i][j][r] * delu_act(t[n * kLdt + m]);
        acc[i][j][r] = g;
        if (m < h && n < h)
#pragma unroll
          for (int k = 0; k < KC; ++k) d.p[k][n * kLdt + m] = g;
      }
}

// The weights of the channel-wise dynamics, device pointers, in the order of
// flatten_weights in ops/fused_channelwise.py. Dense kernels are [in, out]
// row-major (the flax layout), per-channel stacks [xd, in, out].
struct Net {
  const float* a;    // [C, h]: the folded first layer's coefficient on ft
  const float* w1;   // [h, h]
  const float* b1;   // [h]
  const float* w2;   // [h, h]
  const float* b2;   // [h]
  const float* w3;   // [h, xd]
  const float* b3;   // [xd]
  const float* ew0;  // ext: [xd, h, h], [xd, h], [xd, h, h], [xd, h]
  const float* eb0;
  const float* ew1;
  const float* eb1;
  const float* hw0;  // head: the same shapes
  const float* hb0;
  const float* hw1;
  const float* hb1;
};

__host__ inline Net net_from(const void* const* w) {
  const float* const* f = reinterpret_cast<const float* const*>(w);
  return Net{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
             f[8], f[9], f[10], f[11], f[12], f[13], f[14]};
}

// Shared memory of one evaluation.
struct EvalSmem {
  float* t1;    // [kMaxH][kLdt] tile
  float* t2;    // [kMaxH][kLdt] tile
  float* wbuf;  // 2 x kChunk: the staged weight rows
  float* ft;    // [C][kLdt]: the channel features (V transposed)
  float* e;     // [xd][h]: ext activations
  float* ot;    // [xd][h]: the vertical net's output, per channel
  float* he;    // [xd][h]: head activations
  float* as;    // [C][kMaxH]: a, zero beyond h
  float* b1;    // [kMaxH]: b1, zero beyond h
  float* b2;    // [kMaxH]: b2, zero beyond h
  float* w3;    // [h][xd]: W3
  float* b3;    // [xd]: b3
};

// Floats of EvalSmem's constants (as, b1, b2, w3, b3).
__host__ inline size_t consts_floats(int h, int xd, int zd) {
  return static_cast<size_t>(xd + zd + 2) * kMaxH + static_cast<size_t>(h + 1) * xd;
}

// Carves EvalSmem out of p (t1, t2, wbuf, ft, the constants, e, ot, he);
// returns the first float after it.
__device__ __forceinline__ float* carve_eval(EvalSmem& s, float* p, int h, int xd, int zd) {
  const int n = xd * h;
  s.t1 = p;    p += kTile;
  s.t2 = p;    p += kTile;
  s.wbuf = p;  p += 2 * kChunk;
  s.ft = p;    p += (xd + zd) * kLdt;
  s.as = p;    p += (xd + zd) * kMaxH;
  s.b1 = p;    p += kMaxH;
  s.b2 = p;    p += kMaxH;
  s.w3 = p;    p += h * xd;
  s.b3 = p;    p += xd;
  s.e = p;     p += n;
  s.ot = p;    p += n;
  s.he = p;    p += n;
  return p;
}

// Floats of carve_eval's share.
__host__ inline size_t eval_floats(int h, int xd, int zd) {
  return 2 * static_cast<size_t>(kTile) + 2 * kChunk + static_cast<size_t>(xd + zd) * kLdt +
         consts_floats(h, xd, zd) + 3 * static_cast<size_t>(xd) * h;
}

// Zeroes the tiles (their rows and columns beyond h are read, never
// written) and copies the small weights into shared memory; the caller
// publishes them with a barrier.
__device__ __forceinline__ void init_eval(const Net& w, const EvalSmem& s, int h, int xd, int zd) {
  for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) s.t1[e] = 0.f;  // t2 follows t1
  for (int e = threadIdx.x; e < (xd + zd) * kMaxH; e += kThreads) {
    const int c = e / kMaxH, n = e % kMaxH;
    s.as[e] = n < h ? __ldg(w.a + c * h + n) : 0.f;
  }
  for (int n = threadIdx.x; n < kMaxH; n += kThreads) {
    s.b1[n] = n < h ? __ldg(w.b1 + n) : 0.f;
    s.b2[n] = n < h ? __ldg(w.b2 + n) : 0.f;
  }
  for (int e = threadIdx.x; e < h * xd; e += kThreads) s.w3[e] = __ldg(w.w3 + e);
  for (int c = threadIdx.x; c < xd; c += kThreads) s.b3[c] = __ldg(w.b3 + c);
}

// Per-channel matrix-vector products: out[c][j] = sum_{k < K} in[c][k]
// w[c][k][j] (+ b[c][j]) for c < nc, j < n, then elu when act, or times
// elu'(dact[c][j]) when dact is set. in/out/dact in shared memory with row
// strides ld_in/ld_out/n, w [nc, K, n] and b [nc, n] in global memory. One
// thread per output; neighbouring threads read neighbouring weights.
__device__ __forceinline__ void gemv_ch(const float* in, int ld_in, int nc, int K,
                                        const float* __restrict__ w, const float* __restrict__ b,
                                        float* out, int ld_out, int n, bool act,
                                        const float* dact) {
  for (int o = threadIdx.x; o < nc * n; o += kThreads) {
    const int c = o / n, j = o - c * n;
    const float* x = in + c * ld_in;
    const float* wc = w + static_cast<size_t>(c) * K * n + j;
    float acc = 0.f;
#pragma unroll 16
    for (int k = 0; k < K; ++k) acc = fmaf(x[k], __ldg(wc + static_cast<size_t>(k) * n), acc);
    if (b) acc += __ldg(b + c * n + j);
    if (act) acc = elu(acc);
    if (dact) acc *= delu_act(dact[c * n + j]);
    out[c * ld_out + j] = acc;
  }
}

// One evaluation of the dynamics for batch row b at xs [xd][h] (shared
// memory, published by a barrier) into y [xd][h]. Leaves the residuals the
// backward reads: e, ft, ot, he, a1 in t2 and a2 in t1. fz_t: this step's
// row of z-features [zd][h], sv: the row's s_constV tile [h][h]. Ends with
// a barrier of the block. The a0 store waits at the cluster barrier whose
// arrival the caller made once done reading t1; with kArrive, the
// evaluation makes the next one itself, after its readout. Inlined (the
// steppers call it from one place each), so that no register state of the
// caller is saved around a call.
template <int KC, bool kArrive>
__device__ __forceinline__ void eval_fwd(const Net& w, const EvalSmem& s, int h, int xd, int zd,
                                         const float* xs, const float* __restrict__ fz_t,
                                         const float* __restrict__ sv, float* y) {
  const int C = xd + zd;
  Acc<KC> acc;
  CW_PHASE(0);
  gemv_ch(xs, h, xd, h, w.ew0, w.eb0, s.e, h, h, true, nullptr);
  for (int o = threadIdx.x; o < zd * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    s.ft[(xd + c) * kLdt + l] = __ldg(fz_t + o);
  }
  __syncthreads();
  CW_PHASE(1);
  gemv_ch(s.e, h, xd, h, w.ew1, w.eb1, s.ft, kLdt, h, false, nullptr);
  __syncthreads();
  CW_PHASE(2);
  first_layer<KC>(s.ft, s.as, C, h, sv, acc);  // a0 = elu(V A + s_constV)
  CW_PHASE(3);
  cl_wait<KC>();  // no block of the cluster reads its t1 any more
  store_act<KC>(acc, h, nullptr, s.t1);
  cl_sync<KC>();
  CW_PHASE(4);
  mma_tile_weight<KC>(s.t1, h, w.w1, h, s.wbuf, acc);  // a1
  store_act<KC>(acc, h, s.b1, s.t2);
  cl_sync<KC>();
  CW_PHASE(5);
  mma_tile_weight<KC>(s.t2, h, w.w2, h, s.wbuf, acc);  // a2
  store_act<KC>(acc, h, s.b2, s.t1);
  cl_sync<KC>();
  CW_PHASE(6);
  // O = a2 W3 + b3 as ot[c][l]: one thread per output
  for (int o = threadIdx.x; o < xd * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < h; ++k) v = fmaf(s.t1[k * kLdt + l], s.w3[k * xd + c], v);
    s.ot[o] = v + s.b3[c];
  }
  __syncthreads();
  CW_PHASE(7);
  if constexpr (kArrive) cl_arrive<KC>();
  gemv_ch(s.ot, h, xd, h, w.hw0, w.hb0, s.he, h, h, true, nullptr);
  __syncthreads();
  CW_PHASE(8);
  gemv_ch(s.he, h, xd, h, w.hw1, w.hb1, y, h, h, false, nullptr);
  __syncthreads();
  CW_PHASE(9);
}

// The launch configuration of `clusters` clusters of kc blocks.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int clusters, int kc, size_t smem, cudaStream_t st) : cfg{}, attr{} {
    cfg.gridDim = dim3(clusters * kc);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kc;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// Sets the kernel's dynamic shared memory to smem bytes; returns the
// error of that.
template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// How many clusters of kc blocks of the kernel the card runs at once (0 if
// none, or if the query fails).
template <class K>
int active_clusters(K kernel, int kc, size_t smem) {
  if (set_smem(kernel, smem) != cudaSuccess) return 0;
  ClusterLaunch l(1, kc, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// Blocks per batch row: 4 when the card runs `rows` clusters of 4 at once,
// else 2 when it runs `rows` clusters of 2, else 1 (a row per block).
template <class K4, class K2>
int pick_cluster(K4 k4, K2 k2, int rows, size_t smem) {
  if (rows <= active_clusters(k4, 4, smem)) return 4;
  if (rows <= active_clusters(k2, 2, smem)) return 2;
  return 1;
}

// Launches `rows` clusters of kc blocks of the kernel on st.
template <class K, class... A>
cudaError_t launch_clusters(K kernel, int rows, int kc, size_t smem, cudaStream_t st,
                            const A&... args) {
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  ClusterLaunch l(rows, kc, smem, st);
  return cudaLaunchKernelEx(&l.cfg, kernel, args...);
}

}  // namespace
