// Building blocks of the no-encode backward pair (csrc/fused_dae_rollout_bwd.cu
// and csrc/fused_ode_rollout_bwd.cu). Each backward is three kernels in
// order, over R = (T-1) B row-steps r = t B + b:
//
// 1. The recompute, time-parallel. A block takes a tile of kRows row-steps
//    and evaluates, from the saved solution, every net evaluation of those
//    row-steps in the forward's order (the DAE's AE at the event, the AE at
//    t+1, the S stages of the step, each stage's input from the ones before
//    it). Each h x h layer is a [kRows, h] x [h, h] product on the tensor
//    cores in 3xTF32 (csrc/mma_tile.cuh), the first layer too (its K is the
//    few inputs, or h for the encode shape xd = h); the narrow last layer
//    runs on the CUDA cores. Every layer's pre-activation goes to the
//    residual buffer `res`, every evaluation's first-layer input to `xin`.
// 2. The walk, one block per batch row, in reverse time: only the serial
//    chain of cotangents. A layer is a matrix-vector product of 128 outputs
//    by 4 threads each (float4 loads, a quad shuffle), its weight resident
//    in shared memory (swizzled, conflict-free) or read through L1 and L2
//    (the launchers keep the DE's resident); elu' comes from the step's
//    residuals, which cp.async brought into shared memory a step ahead.
//    The walk writes each layer's pre-activation cotangent to `gres` and
//    each evaluation's output cotangent to `gy`, the stream cotangents and
//    the carries.
// 3. The contraction, time-parallel: every weight gradient is a sum over
//    the walk's rows of u^T v (dW = act^T g_pre of the next layer, act =
//    elu(pre) formed on load; the first layer's from its inputs `xin`; the
//    last layer's against `gy`), and every bias gradient a column sum. A
//    block sums a fixed range of a job's rows, an h x h job on the tensor
//    cores through the same 3xTF32 routine, a narrow one on the CUDA
//    cores, and a second kernel adds the ranges' partial sums in range
//    order: the gradients are bit-identical on relaunch, with no atomics.
//
// h <= kMaxH. The weights arrive zero-padded to [kMaxH][kMaxH] (row =
// input, column = output, the flax layout) and the biases to [kMaxH], so
// every vector is kMaxH long with zeros beyond h.

#pragma once

#include "mma_tile.cuh"

namespace {

constexpr int kMaxTail = 8;         // tail layers a net may have
constexpr int kRows = kMaxH;        // row-steps a recompute tile holds (the M of its products)
constexpr int kNarrow = 32;         // a last layer this narrow runs on the CUDA cores
constexpr int kMaxJobs = 2 * (kMaxTail + 1);
constexpr int kMaxSplit = 64;       // row ranges of the contraction
constexpr int kSplitRows = 4096;    // rows a range should hold at least
constexpr int kSmallVec = 8;        // the walk's small vectors, kMaxH floats each
constexpr int kNarrowOut = 2;       // a contraction job of at most kNarrowOut kThreads outputs
                                    // runs on the CUDA cores, kNarrowOut outputs a thread
constexpr float kOneThird = 1.0f / 3.0f;
constexpr int kMat = kMaxH * kMaxH;  // floats of a padded weight
constexpr size_t kSmemMax = 232448;  // bytes of shared memory an H100 block may have

__device__ __forceinline__ float delu(float p) { return p > 0.f ? 1.f : expf(fminf(p, 0.f)); }

__host__ __device__ inline int n_stages(int solver) { return solver == 0 ? 1 : (solver == 1 ? 2 : 4); }

__host__ __device__ inline int round8(int k) { return (k + 7) / 8 * 8; }

// One net as the kernels read it: w[0] the first layer (its kin inputs),
// w[1 + l] tail layer l, each [kMaxH][kMaxH]; b[l] tail layer l's bias,
// [kMaxH]; res_slot[l] the shared-memory slot of tail layer l < n - 1 in
// the walk (-1: read from L2).
struct Net {
  const float* w[kMaxTail + 1];
  const float* b[kMaxTail];
  int res_slot[kMaxTail];
  int n;    // tail layers
  int kin;  // the first layer's inputs
  int out;  // the last layer's outputs
};

// The buffers between the kernels, for E evaluation slots (the S stages,
// then the DAE's AE at t+1 and AE at the event) of L layers:
//   res  [E][L][R][h]  each layer's pre-activation (the recompute writes)
//   gres [E][L][R][h]  its cotangent (the walk writes)
//   gy   [E][R][ow]    each evaluation's output cotangent (the walk writes;
//                      before it, the recompute keeps the stages' outputs
//                      and the AE at the event's there)
//   xin  [E][R][kx]    each evaluation's first-layer input (the recompute)
struct Bufs {
  float* res;
  float* gres;
  float* gy;
  float* xin;
  long long R;
  int E, L, h, ow, kx;
  __host__ __device__ long long at(int e, int l, long long r) const {
    return ((static_cast<long long>(e) * L + l) * R + r) * h;
  }
  __host__ __device__ float* gy_row(int e, long long r) const {
    return gy + (static_cast<long long>(e) * R + r) * ow;
  }
  __host__ __device__ float* xin_row(int e, long long r) const {
    return xin + (static_cast<long long>(e) * R + r) * kx;
  }
};

__host__ inline Bufs make_bufs(float* res, float* gres, float* gy, float* xin, long long R, int E,
                               int L, int h, int ow, int kx) {
  Bufs b;
  b.res = res;
  b.gres = gres;
  b.gy = gy;
  b.xin = xin;
  b.R = R;
  b.E = E;
  b.L = L;
  b.h = h;
  b.ow = ow;
  b.kx = kx;
  return b;
}

// The net of a padded weight block w [n + 1][kMaxH][kMaxH] and bias block b
// [n][kMaxH].
__host__ inline Net make_net(const float* w, const float* b, int n, int kin, int out) {
  Net net{};
  for (int l = 0; l <= kMaxTail; ++l) net.w[l] = l <= n ? w + static_cast<size_t>(l) * kMat : nullptr;
  for (int l = 0; l < kMaxTail; ++l) {
    net.b[l] = l < n ? b + static_cast<size_t>(l) * kMaxH : nullptr;
    net.res_slot[l] = -1;
  }
  net.n = n;
  net.kin = kin;
  net.out = out;
  return net;
}

// Gives the hidden layers of the nets, in order, the shared-memory slots
// [0, slots); returns the slots taken.
__host__ inline int place(Net* const* nets, int count, int slots) {
  int q = 0;
  for (int i = 0; i < count; ++i)
    for (int l = 0; l + 1 < nets[i]->n; ++l) nets[i]->res_slot[l] = q < slots ? q++ : -1;
  return q;
}

// ---------------------------------------------------------------- recompute

// Shared memory of a recompute block: two tiles, the weight staging area,
// and the tile's step sizes and event flags.
struct RcSmem {
  float* ta;
  float* tb;
  float* wbuf;
  float* dt;  // [kRows]
  float* ev;  // [kRows]
  float* flag;
};

__device__ __forceinline__ RcSmem carve_rc(float* p) {
  RcSmem s;
  s.ta = p;    p += kTile;
  s.tb = p;    p += kTile;
  s.wbuf = p;  p += 2 * kChunk;
  s.dt = p;    p += kRows;
  s.ev = p;    p += kRows;
  s.flag = p;
  return s;
}

__host__ inline size_t rc_smem_bytes() {
  return (2 * static_cast<size_t>(kTile) + 2 * kChunk + 2 * kRows + 4) * sizeof(float);
}

// Zeroes both tiles (rows beyond what a product writes must read as zero)
// and loads the tile's step sizes (and, with ev_of, event flags). The
// caller publishes them with a barrier.
template <class Dt, class Ev>
__device__ __forceinline__ void rc_begin(const RcSmem& s, long long r0, long long R, Dt dt_of, Ev ev_of) {
  for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) s.ta[e] = 0.f;  // tb follows ta
  for (int m = threadIdx.x; m < kRows; m += kThreads) {
    const long long r = r0 + m;
    s.dt[m] = r < R ? dt_of(r) : 0.f;
    s.ev[m] = r < R ? ev_of(r) : 0.f;
  }
}

// Sets s.flag[0] to 1 when any row-step of the tile has an event, else 0
// (warp 0 reduces; the caller publishes it with a barrier). Starts after a
// barrier that published s.ev.
__device__ __forceinline__ void rc_any_event(const RcSmem& s) {
  if (threadIdx.x < 32) {
    float v = 0.f;
    for (int m = threadIdx.x; m < kRows; m += 32) v = fmaxf(v, s.ev[m] > 0.f ? 1.f : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) s.flag[0] = v;
  }
}

// The first-layer input of an evaluation: x(m, c) for c < kin, feature-major
// into s.tb (rows up to round8(kin), zero beyond kin and beyond the last
// row-step), and into xin slot e of the buffers (rows r < R). x(m, c) is
// called only for rows r < R. Ends with a barrier.
template <class X>
__device__ __forceinline__ void rc_input(const RcSmem& s, const Bufs& bf, int e, long long r0, int kin,
                                         X x) {
  const int k8 = round8(kin);
  for (int o = threadIdx.x; o < k8 * kRows; o += kThreads) {
    const int c = o / kRows, m = o - c * kRows;  // neighbouring threads, neighbouring positions
    const long long r = r0 + m;
    float v = 0.f;
    if (c < kin && r < bf.R) {
      v = x(m, c);
      bf.xin_row(e, r)[c] = v;
    }
    s.tb[c * kLdt + m] = v;
  }
  __syncthreads();
}

// One evaluation of `net` for the tile's row-steps r0 + m, m < kRows: the
// first-layer input in s.tb (rc_input), the first layer's added stream st
// ([R][h]). Writes layer l's pre-activation to res slot e (rows r < R with
// keep(m)) and, unless y is null, the last layer's output to y (row r at
// y + r ldy). Starts after rc_input's barrier; ends with a barrier.
template <class Keep>
__device__ __noinline__ void rc_eval(const Net& net, const Bufs& bf, int e, long long r0,
                                     const float* __restrict__ st, const RcSmem& s, Keep keep,
                                     float* y, int ldy) {
  const int h = bf.h;
  const long long R = bf.R;
  Acc<1> acc;
  float* cur = s.tb;
  float* nxt = s.ta;
  for (int l = 0; l < net.n; ++l) {
    mma_tile_weight<1>(cur, l == 0 ? net.kin : h, net.w[l], kMaxH, s.wbuf, acc);
    const float* bias = l == 0 ? nullptr : net.b[l - 1];
    float* pre = bf.res + bf.at(e, l, 0);
    // every feature n < kMaxH is written: beyond h, acc and the padded bias
    // are 0, so the tile keeps its zeros there
    for_acc_mn<1>(acc, kRows, kMaxH, [&](float& v, int m, int n) {
      const long long r = r0 + m;
      const bool live = n < h && r < R;
      const float add = bias ? bias[n] : (live ? __ldg(st + r * h + n) : 0.f);
      const float p = v + add;
      nxt[n * kLdt + m] = elu(p);
      if (live && keep(m)) pre[r * h + n] = p;
    });
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (y == nullptr) return;
  const float* wl = net.w[net.n];
  const float* bl = net.b[net.n - 1];
  if (net.out <= kNarrow) {  // one thread an output, on the CUDA cores
    for (int o = threadIdx.x; o < kRows * net.out; o += kThreads) {
      const int c = o / kRows, m = o - c * kRows;
      float v = 0.f;
#pragma unroll 8
      for (int k = 0; k < h; ++k) v = fmaf(cur[k * kLdt + m], __ldg(wl + k * kMaxH + c), v);
      if (r0 + m < R) y[(r0 + m) * ldy + c] = v + bl[c];
    }
  } else {
    mma_tile_weight<1>(cur, h, wl, kMaxH, s.wbuf, acc);
    for_acc_mn<1>(acc, kRows, net.out, [&](float& v, int m, int c) {
      if (r0 + m < R) y[(r0 + m) * ldy + c] = v + bl[c];
    });
  }
  __syncthreads();  // y (global) visible to the block
}

// ------------------------------------------------------------------- walk

// The phase clock (utils/phase_clock.py): built with -DNE_PHASE_CLOCK,
// thread 0 of block 0 notes clock64() at each phase boundary of the middle
// step of a walk (a kernel whose step is t and arguments a) into
// g_ne_phase; otherwise the marks compile to nothing.
#ifdef NE_PHASE_CLOCK
__device__ long long g_ne_phase[16];
#define NE_PHASE(i)                                                     \
  do {                                                                  \
    if (t == a.tm1 / 2 && threadIdx.x == 0 && blockIdx.x == 0)          \
      g_ne_phase[i] = clock64();                                        \
  } while (0)
#else
#define NE_PHASE(i) \
  do {              \
  } while (0)
#endif

// A layer's 128 outputs take 4 threads each: output k = tid / 4, quarter
// ks = tid % 4 of the reduction.
__device__ __forceinline__ int walk_k() { return threadIdx.x >> 2; }
__device__ __forceinline__ int walk_ks() { return threadIdx.x & 3; }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// A resident weight in shared memory: row k's float4 j4 at k (kMaxH / 4) +
// (j4 ^ 4 (k & 1)), so that a quarter warp (two rows, four quarters) reads
// eight distinct groups of banks.
__device__ __forceinline__ int swz(int k, int j4) { return k * (kMaxH / 4) + (j4 ^ ((k & 1) << 2)); }

// Copies the nets' resident weights into their slots (caller publishes).
__device__ __forceinline__ void load_resident(const Net& net, float* wres) {
  for (int l = 0; l + 1 < net.n; ++l) {
    const int q = net.res_slot[l];
    if (q < 0) continue;
    const float4* src = reinterpret_cast<const float4*>(net.w[1 + l]);
    float4* dst = reinterpret_cast<float4*>(wres + static_cast<size_t>(q) * kMat);
    for (int e = threadIdx.x; e < kMat / 4; e += kThreads) {
      const int k = e / (kMaxH / 4), j4 = e - k * (kMaxH / 4);
      dst[swz(k, j4)] = __ldg(src + e);
    }
  }
}

// sum_j W[k][j] v[j] for the thread's output k, summed over its quad: W a
// weight [kMaxH][kMaxH], resident (swizzled) or in global memory; v in
// shared memory.
template <bool kResident>
__device__ __forceinline__ float matvec(const float* W, const float* v) {
  const int k = walk_k(), ks = walk_ks();
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* w4 = reinterpret_cast<const float4*>(W);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxH / 16; ++i) {
    const int j4 = ks + 4 * i;
    const float4 w = kResident ? w4[swz(k, j4)] : __ldg(w4 + k * (kMaxH / 4) + j4);
    const float4 x = v4[j4];
    a0 = fmaf(w.x, x.x, a0);
    a1 = fmaf(w.y, x.y, a1);
    a0 = fmaf(w.z, x.z, a0);
    a1 = fmaf(w.w, x.w, a1);
  }
  return quad_sum(a0 + a1);
}

// The VJP of evaluation slot e of `net` at row-step r, from its output
// cotangent gyv ([kMaxH] in shared memory, published): P holds the step's
// pre-activations of the slot ([L][kMaxH], zero beyond h), wres the
// resident weights. Writes gy and each layer's pre-activation cotangent to
// the buffers; leaves the first layer's in va or vb and returns it. Every
// layer ends with a barrier.
__device__ __noinline__ const float* walk_eval(const Net& net, const Bufs& bf, int e, long long r,
                                               const float* P, const float* gyv, float* va, float* vb,
                                               const float* wres) {
  const int k = walk_k(), ks = walk_ks(), h = bf.h;
  if (static_cast<int>(threadIdx.x) < net.out) bf.gy_row(e, r)[threadIdx.x] = gyv[threadIdx.x];
  // the last layer: sum_c W[k][c] gy[c] over its few (or, for xd = h, h) outputs
  const float* wl = net.w[net.n] + k * kMaxH;
  float acc = 0.f;
  for (int c = ks; c < net.out; c += 4) acc = fmaf(__ldg(wl + c), gyv[c], acc);
  acc = quad_sum(acc);
  float* cur = va;
  float* nxt = vb;
  int l = net.n - 1;
  for (;;) {
    const float g = acc * delu(P[l * kMaxH + k]);
    if (ks == 0) cur[k] = g;
    if (ks == 1 && k < h) bf.gres[bf.at(e, l, r) + k] = g;
    __syncthreads();
    if (l == 0) return cur;
    --l;
    const int q = net.res_slot[l];
    acc = q >= 0 ? matvec<true>(wres + static_cast<size_t>(q) * kMat, cur)
                 : matvec<false>(net.w[1 + l], cur);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// fn(c, sum_k w0[c][k] v[k]) in lane 0 of a warp, for each first-layer
// input c < kin: the cotangent of the evaluation's inputs.
template <class F>
__device__ __forceinline__ void walk_inputs(const Net& net, const float* v, F fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < net.kin; c += kThreads / 32) {
    const float* row = net.w[0] + c * kMaxH;
    float acc = 0.f;
#pragma unroll
    for (int k = lane; k < kMaxH; k += 32) acc = fmaf(__ldg(row + k), v[k], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) fn(c, acc);
  }
}

// Floats of a walk's prefetched step: E L pre-activation rows of kMaxH,
// the cotangent row (kMaxH) and the step's (dt, ev).
__host__ __device__ inline int walk_step_floats(int E, int L) { return (E * L + 1) * kMaxH + 4; }

// Shared memory of a walk block, in floats: the resident weights, two
// prefetched steps, and the vectors.
__host__ inline size_t walk_floats(int slots, int E, int L) {
  return static_cast<size_t>(slots) * kMat + 2 * static_cast<size_t>(walk_step_floats(E, L)) +
         (3 + kSmallVec) * kMaxH;
}

// The most weights a walk block can hold resident beside the rest.
__host__ inline int walk_fit(int E, int L) {
  return static_cast<int>((kSmemMax / sizeof(float) - walk_floats(0, E, L)) / kMat);
}

// Starts the copies of row-step r's residuals, its cotangent row cot_row
// (d floats) and aux (na floats) into dst; the caller commits.
__device__ __forceinline__ void walk_prefetch(const Bufs& bf, float* dst, long long r, const float* cot_row,
                                              int d, const float* aux, int na) {
  const int h = bf.h, n = bf.E * bf.L;
  if (h % 4 == 0) {
    for (int o = threadIdx.x; o < n * (kMaxH / 4); o += kThreads) {
      const int el = o / (kMaxH / 4), j = 4 * (o - el * (kMaxH / 4));
      const bool ok = j < h;
      const float* src = bf.res + (static_cast<long long>(el) * bf.R + r) * h + j;
      cp_async_f32x4(dst + el * kMaxH + j, ok ? src : bf.res, ok);
    }
  } else {
    for (int o = threadIdx.x; o < n * kMaxH; o += kThreads) {
      const int el = o / kMaxH, j = o - el * kMaxH;
      const bool ok = j < h;
      cp_async_f32(dst + o, ok ? bf.res + (static_cast<long long>(el) * bf.R + r) * h + j : bf.res, ok);
    }
  }
  float* tail = dst + n * kMaxH;
  for (int c = threadIdx.x; c < kMaxH; c += kThreads) cp_async_f32(tail + c, c < d ? cot_row + c : cot_row, c < d);
  for (int c = threadIdx.x; c < na; c += kThreads) cp_async_f32(tail + kMaxH + c, aux + c, true);
}

// ------------------------------------------------------------- contraction

// One weight's gradient: the sum over the rows n < ne R (slot e0 + n / R,
// row-step n % R) of U^T V, U [wu] the layer's input (xin, or elu of res
// layer lu), V [wv] its output's cotangent (gres layer lv, or gy), and,
// where b_off >= 0, the column sums of V; rows of the last slot count only
// where ev[r] > 0 when masked.
struct Job {
  int u_act, lu, wu;
  int v_gy, lv, wv;
  int e0, ne, masked;
  long long w_off, b_off;
  long long part;  // the job's offset in a range's partial sums
};

struct Jobs {
  Job j[kMaxJobs];
  int n;
  long long per_split;  // floats of one range's partial sums
};

__host__ inline void add_job(Jobs* jobs, int u_act, int lu, int wu, int v_gy, int lv, int wv, int e0,
                             int ne, int masked, long long w_off, long long b_off) {
  Job& j = jobs->j[jobs->n++];
  j.u_act = u_act;
  j.lu = lu;
  j.wu = wu;
  j.v_gy = v_gy;
  j.lv = lv;
  j.wv = wv;
  j.e0 = e0;
  j.ne = ne;
  j.masked = masked;
  j.w_off = w_off;
  j.b_off = b_off;
  j.part = jobs->per_split;
  jobs->per_split += static_cast<long long>(wu) * wv + wv;
}

// The jobs of one net over slots [e0, e0 + ne): the first layer's weight
// (from the inputs), then each tail layer's weight and bias; w_off[l] and
// b_off[l] where tail layer l's go, first_off the first layer's.
__host__ inline void add_net_jobs(Jobs* jobs, const Net& net, int h, int e0, int ne, int masked,
                                  long long first_off, const int* w_off, const int* b_off) {
  add_job(jobs, 0, 0, net.kin, 0, 0, h, e0, ne, masked, first_off, -1);
  for (int l = 0; l < net.n; ++l) {
    const bool last = l == net.n - 1;
    add_job(jobs, 1, l, h, last ? 1 : 0, l + 1, last ? net.out : h, e0, ne, masked, w_off[l], b_off[l]);
  }
}

// Row ranges of the contraction: a function of the shapes only, so that a
// relaunch sums in the same order.
__host__ inline int n_splits(long long rows) {
  const long long n = (rows + kSplitRows - 1) / kSplitRows;
  return static_cast<int>(n < 1 ? 1 : (n > kMaxSplit ? kMaxSplit : n));
}

struct CtArgs {
  Jobs jobs;
  Bufs bf;
  const float* ev;  // ev[r * ev_stride] > 0 on an event row-step (masked jobs)
  int ev_stride;
  float* parts;     // [nsplit][jobs.per_split]
  float* g_w;
};

// Block (range blockIdx.x, job blockIdx.y): the job's sums over its range
// of rows, in order, kKc rows at a time staged in shared memory (the next
// chunk's loads in flight in registers while the current one is
// multiplied), into the range's partial sums. An h x h job runs on the
// tensor cores; a narrow one (a first layer's few inputs, a last layer's
// few outputs) on the CUDA cores, a thread an output.
__global__ void __launch_bounds__(kThreads, 1) contract_jobs(const __grid_constant__ CtArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;           // [kKc][kLdt]: U, a row per summed row
  float* vs = smem + kChunk;  // [kKc][kLdt]: V
  const Job& jb = a.jobs.j[blockIdx.y];
  const Bufs& bf = a.bf;
  const long long R = bf.R, N = jb.ne * R;
  const long long n0 = N * blockIdx.x / gridDim.x, n1 = N * (blockIdx.x + 1) / gridDim.x;
  constexpr int kPer = kKc * kMaxH / kThreads;  // elements a thread stages per chunk
  float ru[kPer], rv[kPer];
  auto load = [&](long long c0) {
    // the chunk's first row is row r0 of slot e0c; a row past R is in the next slot
    const long long q0 = c0 / R, r0 = c0 - q0 * R;
    const int e0c = jb.e0 + static_cast<int>(q0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int o = threadIdx.x + i * kThreads, row = o / kMaxH, col = o - row * kMaxH;
      bool live = c0 + row < n1;
      int e = e0c;
      long long r = r0 + row;
      while (r >= R) {
        r -= R;
        ++e;
      }
      if (live && jb.masked && e == jb.e0 + jb.ne - 1) live = __ldg(a.ev + r * a.ev_stride) > 0.f;
      ru[i] = live && col < jb.wu
                  ? (jb.u_act ? __ldg(bf.res + bf.at(e, jb.lu, r) + col) : __ldg(bf.xin_row(e, r) + col))
                  : 0.f;
      rv[i] = live && col < jb.wv
                  ? (jb.v_gy ? __ldg(bf.gy_row(e, r) + col) : __ldg(bf.gres + bf.at(e, jb.lv, r) + col))
                  : 0.f;
    }
  };
  // the tensor cores truncate as they accumulate: a chunk's products are
  // summed from zero, and the chunk sums added in float32 (round to nearest)
  Acc<1> acc, part;
  zero<1>(acc);
  const Frag f = frag<1>();
  const int wv = jb.wv, n_out = jb.wu * wv;
  const bool narrow = n_out <= kNarrowOut * kThreads;
  float nacc[kNarrowOut] = {};
  float bsum = 0.f;
  if (n0 < n1) load(n0);
  for (long long c0 = n0; c0 < n1; c0 += kKc) {
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int o = threadIdx.x + i * kThreads, row = o / kMaxH, col = o - row * kMaxH;
      us[row * kLdt + col] = jb.u_act ? elu(ru[i]) : ru[i];
      vs[row * kLdt + col] = rv[i];
    }
    __syncthreads();
    if (c0 + kKc < n1) load(c0 + kKc);
    if (narrow) {
#pragma unroll
      for (int q = 0; q < kNarrowOut; ++q) {
        const int o = threadIdx.x + q * kThreads, j = o / wv, k = o - j * wv;
        if (o < n_out) {
          float sum = 0.f;
#pragma unroll 8
          for (int row = 0; row < kKc; ++row) sum = fmaf(us[row * kLdt + j], vs[row * kLdt + k], sum);
          nacc[q] += sum;
        }
      }
    } else {
      zero<1>(part);
#pragma unroll
      for (int s = 0; s < kKc / 8; ++s)
        mma_k8<1>(
            f, 8 * s, [&](int m, int k) { return us[k * kLdt + m]; },
            [&](int k, int nn) { return vs[k * kLdt + nn]; }, part);
#pragma unroll
      for (int i = 0; i < Tiling<1>::kMi; ++i)
#pragma unroll
        for (int j = 0; j < Tiling<1>::kNi; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    }
    if (threadIdx.x < kMaxH)
      for (int row = 0; row < kKc; ++row) bsum += vs[row * kLdt + threadIdx.x];
  }
  float* out = a.parts + blockIdx.x * a.jobs.per_split + jb.part;
  if (narrow) {
#pragma unroll
    for (int q = 0; q < kNarrowOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_out) out[o] = nacc[q];
    }
  } else {
    for_acc_mn<1>(acc, jb.wu, wv, [&](float& v, int m, int n) { out[m * wv + n] = v; });
  }
  if (static_cast<int>(threadIdx.x) < wv) out[static_cast<long long>(jb.wu) * wv + threadIdx.x] = bsum;
}

// g_w at each job's places = the sum over the ranges, in order, of their
// partial sums.
__global__ void reduce_parts(const __grid_constant__ CtArgs a, int nsplit) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.jobs.per_split) return;
  int q = 0;
  while (q + 1 < a.jobs.n && a.jobs.j[q + 1].part <= e) ++q;
  const Job& jb = a.jobs.j[q];
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += a.parts[s * a.jobs.per_split + e];
  const long long local = e - jb.part, nw = static_cast<long long>(jb.wu) * jb.wv;
  if (local < nw) {
    a.g_w[jb.w_off + local] = acc;
  } else if (jb.b_off >= 0) {
    a.g_w[jb.b_off + local - nw] = acc;
  }
}

// Launches the contraction's two kernels on st.
__host__ inline cudaError_t launch_contraction(const CtArgs& a, int nsplit, cudaStream_t st) {
  const size_t smem = 2 * kChunk * sizeof(float);
  const dim3 grid(nsplit, a.jobs.n);
  contract_jobs<<<grid, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = static_cast<int>((a.jobs.per_split + 255) / 256);
  reduce_parts<<<blocks, 256, 0, st>>>(a, nsplit);
  return cudaGetLastError();
}

// The longest job's rows.
__host__ inline long long max_rows(const Jobs& jobs, long long R) {
  long long most = 1;
  for (int i = 0; i < jobs.n; ++i) most = jobs.j[i].ne * R > most ? jobs.j[i].ne * R : most;
  return most;
}

// Sets the kernel's dynamic shared memory to smem bytes where it needs
// more than the default.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

#ifdef NE_PHASE_CLOCK
// The phase clock's marks of the last launch, copied to out after the
// device is synchronised; returns the error.
extern "C" int psn_ne_phase_clock(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_ne_phase, sizeof(long long) * 16);
  return static_cast<int>(e);
}
#endif
