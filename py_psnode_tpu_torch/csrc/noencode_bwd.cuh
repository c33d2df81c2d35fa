// Building blocks of the no-encode kernels: the backward pair
// (csrc/fused_dae_rollout_bwd.cu and csrc/fused_ode_rollout_bwd.cu) and,
// in the forward section below, the forward pair (csrc/fused_dae_rollout.cu
// and csrc/fused_ode_rollout.cu), which share the walk's matrix-vector
// product, quad sum and cp.async. Each backward is three kernels in
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
// The backward takes every width. Its weights arrive zero-padded to a width
// H = kMaxH nc, H the multiple of kMaxH at or above h and the first layer's
// inputs and the last layer's outputs (row = input, column = output, the
// flax layout), in 128 x 128 blocks: block (kc, oc), rows 128 kc.. and
// columns 128 oc.., at w + (kc nc + oc) kMaxH^2, row-major; the biases to
// [H]. At H = kMaxH (nc = 1) that is the plain padded [kMaxH][kMaxH] layout,
// and the kernels above run as described: every vector kMaxH long with zeros
// beyond h. A wider H takes the wide kernels (`*_wide`), built from the same
// blocks: the recompute sums each [kRows, H] x [H, H] product by 128 x 128
// output chunks, each over 128-wide K chunks, every chunk's product summed
// from zero and the chunk sums added in float32 (the tensor cores truncate
// as they accumulate), its two activation tiles [H][kLdt] in global scratch;
// the walk reads every weight from L2 by 128 x 128 blocks (a hidden weight
// of H > kMaxH does not fit a block's shared memory) and each step's
// residuals from `res` as it goes, its vectors H long in shared memory
// (global scratch where they do not fit); the contraction splits each job
// into 128 x 128 output tiles, each summed over the same row ranges in the
// same order. Nothing wide changes the sums at H = kMaxH.

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
// w[1 + l] tail layer l, each [H][H] with H its padded width (kMaxH in the
// 128-wide backward kernels; in 128 x 128 blocks in the wide ones); b[l]
// tail layer l's bias, [H];
// res_slot[l] the shared-memory slot of tail layer l < n - 1 (-1: read
// from L2).
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

// The net of a padded weight block w [n + 1][ld][ld] and bias block b
// [n][ld] (null blocks: the net's shape alone).
__host__ inline Net make_net(const float* w, const float* b, int n, int kin, int out, int ld = kMaxH) {
  Net net{};
  const size_t mat = static_cast<size_t>(ld) * ld;
  for (int l = 0; l <= kMaxTail; ++l) net.w[l] = w && l <= n ? w + l * mat : nullptr;
  for (int l = 0; l < kMaxTail; ++l) {
    net.b[l] = b && l < n ? b + static_cast<size_t>(l) * ld : nullptr;
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
__device__ __forceinline__ void rc_begin(const RcSmem& s, long long r0, long long R, Dt dt_of, Ev ev_of,
                                         int tile = kTile) {
  for (int e = threadIdx.x; e < 2 * tile; e += kThreads) s.ta[e] = 0.f;  // tb follows ta
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

// A wide recompute block (padded width H > kMaxH): its two tiles, [H][kLdt]
// each, at `tiles` in global scratch, tb after ta; the staging area and
// the small arrays in shared memory.
__device__ __forceinline__ RcSmem carve_rc_wide(float* p, float* tiles, int H) {
  RcSmem s;
  s.ta = tiles;
  s.tb = tiles + static_cast<size_t>(H) * kLdt;
  s.wbuf = p;  p += 2 * kChunk;
  s.dt = p;    p += kRows;
  s.ev = p;    p += kRows;
  s.flag = p;
  return s;
}

__host__ inline size_t rc_wide_smem_bytes() { return (2 * static_cast<size_t>(kChunk) + 2 * kRows + 4) * sizeof(float); }

// Floats of a wide recompute block's tiles in the scratch.
__host__ __device__ inline size_t rc_wide_tile_floats(int H) { return 2 * static_cast<size_t>(H) * kLdt; }

// Block (kc, oc) of a padded weight of width H = kMaxH nc.
__host__ __device__ __forceinline__ const float* wblock(const float* w, int nc, int kc, int oc) {
  return w + (static_cast<size_t>(kc) * nc + oc) * kMat;
}

// acc = the output chunk oc (columns 128 oc..) of tin^T w over K inputs:
// the tile tin (feature-major, rows beyond K zero) times the padded weight
// w of width H, one K chunk of 128 at a time, each summed from zero into
// part and the chunk sums added in float32. Ends with a barrier.
__device__ __forceinline__ void rc_chunk_product(const float* tin, int K, const float* w, int H, int oc,
                                                 float* wbuf, Acc<1>& acc, Acc<1>& part) {
  const int nc = H / kMaxH;
  for (int kc = 0; kc * kMaxH < K; ++kc) {
    const int kr = K - kc * kMaxH;
    mma_tile_weight<1>(tin + static_cast<size_t>(kc) * kMaxH * kLdt, kr < kMaxH ? kr : kMaxH,
                       wblock(w, nc, kc, oc), kMaxH, wbuf, part);
#pragma unroll
    for (int i = 0; i < Tiling<1>::kMi; ++i)
#pragma unroll
      for (int j = 0; j < Tiling<1>::kNi; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = kc == 0 ? part[i][j][q] : acc[i][j][q] + part[i][j][q];
  }
}

// rc_eval at a padded width H > kMaxH (the wide layout; the tiles of
// carve_rc_wide, their features beyond what a layer writes zero): each
// layer by 128-wide output chunks, the first layer's K its kin inputs.
template <class Keep>
__device__ __noinline__ void rc_eval_wide(const Net& net, const Bufs& bf, int e, long long r0,
                                          const float* __restrict__ st, const RcSmem& s, Keep keep,
                                          float* y, int ldy, int H) {
  const int h = bf.h, nc = H / kMaxH;
  const long long R = bf.R;
  Acc<1> acc, part;
  float* cur = s.tb;
  float* nxt = s.ta;
  for (int l = 0; l < net.n; ++l) {
    const float* bias = l == 0 ? nullptr : net.b[l - 1];
    float* pre = bf.res + bf.at(e, l, 0);
    for (int oc = 0; oc * kMaxH < h; ++oc) {
      rc_chunk_product(cur, l == 0 ? net.kin : h, net.w[l], H, oc, s.wbuf, acc, part);
      // beyond h, acc and the padded bias are 0: the tile keeps its zeros
      for_acc_mn<1>(acc, kRows, kMaxH, [&](float& v, int m, int n) {
        const long long r = r0 + m;
        const int j = oc * kMaxH + n;
        const bool live = j < h && r < R;
        const float add = bias ? bias[j] : (live ? __ldg(st + r * h + j) : 0.f);
        const float p = v + add;
        nxt[static_cast<size_t>(j) * kLdt + m] = elu(p);
        if (live && keep(m)) pre[r * h + j] = p;
      });
    }
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
      for (int k = 0; k < h; ++k)
        v = fmaf(cur[static_cast<size_t>(k) * kLdt + m], __ldg(wblock(wl, nc, k / kMaxH, 0) + (k % kMaxH) * kMaxH + c), v);
      if (r0 + m < R) y[(r0 + m) * ldy + c] = v + bl[c];
    }
  } else {
    for (int oc = 0; oc * kMaxH < net.out; ++oc) {
      rc_chunk_product(cur, h, wl, H, oc, s.wbuf, acc, part);
      for_acc_mn<1>(acc, kRows, net.out - oc * kMaxH, [&](float& v, int m, int c) {
        if (r0 + m < R) y[(r0 + m) * ldy + oc * kMaxH + c] = v + bl[oc * kMaxH + c];
      });
    }
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

// out[r] = sum_j W[k][j] v[r][j] for the thread's output k and rows r < R
// (v row r at v + r ldv, in shared memory), summed over its quad: W a
// [kMaxH][kMaxH] block of a weight, resident (swizzled) or in global memory
// with row stride ldw floats. Each weight load serves the R rows.
template <bool kResident, int R>
__device__ __forceinline__ void matvec_rows(const float* W, int ldw, const float* v, int ldv, float (&out)[R]) {
  const int k = walk_k(), ks = walk_ks();
  const float4* w4 = reinterpret_cast<const float4*>(W);
  float a0[R], a1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxH / 16; ++i) {
    const int j4 = ks + 4 * i;
    const float4 w = kResident ? w4[swz(k, j4)] : __ldg(w4 + k * (ldw / 4) + j4);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = reinterpret_cast<const float4*>(v + r * ldv)[j4];
      a0[r] = fmaf(w.x, x.x, a0[r]);
      a1[r] = fmaf(w.y, x.y, a1[r]);
      a0[r] = fmaf(w.z, x.z, a0[r]);
      a1[r] = fmaf(w.w, x.w, a1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = quad_sum(a0[r] + a1[r]);
}

// sum_j W[k][j] v[j] for the thread's output k (one row of matvec_rows).
template <bool kResident>
__device__ __forceinline__ float matvec(const float* W, const float* v) {
  float out[1];
  matvec_rows<kResident, 1>(W, kMaxH, v, 0, out);
  return out[0];
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

// walk_eval at a padded width H > kMaxH (the wide layout): gyv, va and vb
// H long; the step's pre-activations read from `res` as they are needed;
// every weight read from L2 by 128 x 128 blocks, the thread's output k of
// each 128-wide chunk of a layer's inputs summed over the output chunks
// (each chunk's sum from matvec, the chunk sums added in order).
__device__ __noinline__ const float* walk_eval_wide(const Net& net, const Bufs& bf, int e, long long r,
                                                    const float* gyv, float* va, float* vb, int H) {
  const int k = walk_k(), ks = walk_ks(), h = bf.h, nc = H / kMaxH;
  for (int c = threadIdx.x; c < net.out; c += kThreads) bf.gy_row(e, r)[c] = gyv[c];
  auto pre = [&](int l, int j) { return j < h ? bf.res[bf.at(e, l, r) + j] : 0.f; };
  // the last layer: sum_c W[j][c] gy[c] over its outputs
  const float* wl = net.w[net.n];
  for (int kc = 0; kc < nc; ++kc) {
    const int j = kc * kMaxH + k;
    float acc = 0.f;
    for (int c = ks; c < net.out; c += 4) acc = fmaf(__ldg(wblock(wl, nc, kc, c / kMaxH) + k * kMaxH + c % kMaxH), gyv[c], acc);
    acc = quad_sum(acc);
    const float g = acc * delu(pre(net.n - 1, j));
    if (ks == 0) va[j] = g;
    if (ks == 1 && j < h) bf.gres[bf.at(e, net.n - 1, r) + j] = g;
  }
  __syncthreads();
  float* cur = va;
  float* nxt = vb;
  for (int l = net.n - 2; l >= 0; --l) {
    for (int kc = 0; kc < nc; ++kc) {
      const int j = kc * kMaxH + k;
      float acc = 0.f;
      for (int oc = 0; oc < nc; ++oc) {
        const float part = matvec<false>(wblock(net.w[1 + l], nc, kc, oc), cur + oc * kMaxH);
        acc = oc == 0 ? part : acc + part;
      }
      const float g = acc * delu(pre(l, j));
      if (ks == 0) nxt[j] = g;
      if (ks == 1 && j < h) bf.gres[bf.at(e, l, r) + j] = g;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// walk_inputs at a padded width H > kMaxH: v H long, w0's row c read by
// blocks.
template <class F>
__device__ __forceinline__ void walk_inputs_wide(const Net& net, const float* v, int H, F fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nc = H / kMaxH;
  for (int c = warp; c < net.kin; c += kThreads / 32) {
    float acc = 0.f;
    for (int k = lane; k < H; k += 32)
      acc = fmaf(__ldg(wblock(net.w[0], nc, c / kMaxH, k / kMaxH) + (c % kMaxH) * kMaxH + k % kMaxH), v[k], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) fn(c, acc);
  }
}

// Where a wide walk keeps its n vectors of H floats: shared memory when
// they fit a block's (H up to about 5 000), else its share of the global
// scratch (always, in a build with -DNE_WIDE_VEC_GMEM: the tests' way to
// reach that path at a small width).
__host__ inline bool walk_wide_in_smem(int n, int H) {
#ifdef NE_WIDE_VEC_GMEM
  return false;
#else
  return static_cast<size_t>(n) * H * sizeof(float) <= kSmemMax;
#endif
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

// ------------------------------------------------------------------ forward
//
// The forward pair (csrc/fused_dae_rollout.cu, csrc/fused_ode_rollout.cu): a
// block takes R batch rows and runs the whole rollout. The wrappers pass the
// weights as they hold them (row = input); pack_nets writes them on the
// card, transposed (row = output) and zero-padded to [H][H], H = 128 nc
// (nc > 1 only for a width above 128), into a scratch block the launch
// reads. A layer is one pass (product, bias, ELU, store) and one barrier. A
// 128 x 128 hidden layer held in registers or in shared memory runs in the
// M16 mapping: thread t sums outputs 4 (t / 16) + m, m < 4, over inputs 8
// (t % 16) + i, i < 8, from its 8 float4s of the weight (w_i = W[4 (t / 16)
// + 0..3][8 (t % 16) + i]; in shared memory at i kThreads + t,
// conflict-free), reading 8 inputs a row, and 16 lanes reduce by halving (5
// shuffles); each weight load serves the R rows. A weight read from L2 (or
// a wider one) runs through matvec_rows, 128-wide chunks at a time. With
// one row a block and nets whose first-layer input and readout are at most
// kFold wide, the readout folds into the next evaluation's first layer:
// each of the first kFoldWarps warps computes the readout itself, lane l
// summing inputs 4 l + 128 m and a butterfly over the warp (the same
// instructions in the same order, so every copy has the same bits), then in
// registers the stage update or the step's carries, then its share of the
// next first layer, with no barrier until that layer is published; warp 0
// keeps the carries in shared memory for the later steps. Otherwise (R > 1,
// or a wide net) the readout, the carries and the first layer take a
// barrier each. A block's buffers live in shared memory; where even one
// row's do not fit (h above about 1 400 for the DAE, 3 000 for the ODE),
// a kernel instantiated for it (one row, no fold) keeps them in the
// scratch, in global memory, and copies the step's rows at once instead of
// by cp.async.

#ifndef NE_FWD_FOLD_WARPS
#define NE_FWD_FOLD_WARPS 4  // phase_clock's [ne-fwd-fold] sweep builds others
#endif
constexpr int kFold = 5;  // the widest first-layer input and readout that fold: x and i
                          // of every DAE family of the repo (xd + id <= 5), the AVR ODE's x
constexpr int kFoldWarps = NE_FWD_FOLD_WARPS;  // warps that fold
static_assert(kFoldWarps >= 1 && kFoldWarps <= kThreads / 32 && kMaxH % kFoldWarps == 0,
              "the folding warps split a 128-wide layer evenly");

// The phase clock of the forwards (utils/phase_clock.py): built with
// -DNE_PHASE_CLOCK, thread 0 of block 0 notes clock64() and a phase number
// at each phase boundary of the middle step (marks in g_ne_fwd, phases in
// g_ne_fwd_bin, the count in g_ne_fwd_n); otherwise the marks compile to
// nothing. Phases: 0 the step's loads, 1 the AE at the event, 2 + 3 q +
// {0, 1, 2} stage q's first layer, hidden layers and readout, 14 the stage
// updates, 15 the AE at t+1, 16 the solution's write.
#ifdef NE_PHASE_CLOCK
__device__ long long g_ne_fwd[64];
__device__ int g_ne_fwd_bin[64];
__device__ int g_ne_fwd_n;
__shared__ int s_ne_clk[2];  // on (the middle step), marks so far
#define NE_FWD_START(t, tm1)                   \
  do {                                         \
    if (threadIdx.x == 0 && blockIdx.x == 0) { \
      s_ne_clk[0] = (t) == (tm1) / 2;          \
      s_ne_clk[1] = 0;                         \
    }                                          \
    NE_FWD_MARK(-1);                           \
  } while (0)
#define NE_FWD_MARK(bin)                                                              \
  do {                                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0 && s_ne_clk[0] && s_ne_clk[1] < 64) {     \
      const int i_ = s_ne_clk[1]++;                                                   \
      g_ne_fwd[i_] = clock64();                                                       \
      g_ne_fwd_bin[i_] = (bin);                                                       \
      g_ne_fwd_n = i_ + 1;                                                            \
    }                                                                                 \
  } while (0)
#else
#define NE_FWD_START(t, tm1) \
  do {                       \
  } while (0)
#define NE_FWD_MARK(bin) \
  do {                   \
  } while (0)
#endif

__host__ __device__ inline bool narrow_in(const Net& n) { return n.kin <= kFold; }
__host__ __device__ inline bool narrow_out(const Net& n) { return n.out <= kFold; }
__host__ __device__ inline int reg_bank(int slot) { return -2 - slot; }  // res_slot of a weight in registers

// The forward's padded width: w rounded up to a multiple of kMaxH.
__host__ inline int fwd_width(int w) { return (w + kMaxH - 1) / kMaxH * kMaxH; }

// A net's weights as the wrappers hold them (row = input, the flax
// layout): the first layer in two row blocks of k0[0] and k0[1] rows (the
// DAE's DE takes [wx_de; wi_de]; k0[1] may be 0), tail layer l [in][out]
// and its bias [out].
struct SrcNet {
  const float* w0[2];
  int k0[2];
  const float* w[kMaxTail];
  const float* b[kMaxTail];
};

struct PackArgs {
  SrcNet src[2];
  Net dst[2];  // the padded blocks: dst.w[0] [n + 1][H][H], dst.b[0] [n][H]
  int count, h, H;
};

// Writes each net's weights transposed (row = output) and zero-padded to
// [H][H], and its biases zero-padded to [H], into its padded blocks.
__global__ void __launch_bounds__(kThreads) pack_nets(const __grid_constant__ PackArgs a) {
  const size_t H = a.H, HH = H * H, step = static_cast<size_t>(gridDim.x) * kThreads;
  for (int i = 0; i < a.count; ++i) {
    const SrcNet& s = a.src[i];
    const Net& d = a.dst[i];
    const size_t nw = (d.n + 1) * HH, total = nw + d.n * H;
    for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += step) {
      float v = 0.f;
      if (e < nw) {
        const int l = static_cast<int>(e / HH), o = static_cast<int>(e % HH / H), c = static_cast<int>(e % H);
        const int kin = l == 0 ? d.kin : a.h, out = l == d.n ? d.out : a.h;
        if (o < out && c < kin) {
          if (l > 0) {
            v = s.w[l - 1][static_cast<size_t>(c) * out + o];
          } else {
            v = c < s.k0[0] ? s.w0[0][static_cast<size_t>(c) * out + o]
                            : s.w0[1][static_cast<size_t>(c - s.k0[0]) * out + o];
          }
        }
        const_cast<float*>(d.w[0])[e] = v;
      } else {
        const int l = static_cast<int>((e - nw) / H), j = static_cast<int>((e - nw) % H);
        if (j < (l + 1 == d.n ? d.out : a.h)) v = s.b[l][j];
        const_cast<float*>(d.b[0])[e - nw] = v;
      }
    }
  }
}

// What a forward keeps of one net in shared memory for the whole launch:
// w0 [kin][H] the first layer by input (narrow kin), wl [out][H] the
// readout by output (narrow out), b [n][H] every bias; ld = H, the row
// stride of every vector and padded weight.
struct FwdNet {
  float* w0;
  float* wl;
  float* b;
  int ld;
};

__host__ __device__ inline size_t fwd_net_floats(const Net& n, int H) {
  return static_cast<size_t>((narrow_in(n) ? n.kin : 0) + (narrow_out(n) ? n.out : 0) + n.n) * H;
}

__device__ inline FwdNet carve_net(const Net& n, int H, float*& p) {
  FwdNet t;
  t.ld = H;
  t.w0 = p;
  p += narrow_in(n) ? n.kin * H : 0;
  t.wl = p;
  p += narrow_out(n) ? n.out * H : 0;
  t.b = p;
  p += n.n * H;
  return t;
}

// Copies a net's tables from its padded transposed weights (the caller
// publishes them).
__device__ inline void load_tables(const Net& net, const FwdNet& t) {
  const int H = t.ld;
  if (narrow_in(net))
    for (int e = threadIdx.x; e < net.kin * H; e += kThreads) {
      const int c = e / H, j = e - c * H;
      t.w0[e] = __ldg(net.w[0] + static_cast<size_t>(j) * H + c);
    }
  if (narrow_out(net))
    for (int e = threadIdx.x; e < net.out * H; e += kThreads) t.wl[e] = __ldg(net.w[net.n] + e);
  for (int e = threadIdx.x; e < net.n * H; e += kThreads) t.b[e] = __ldg(net.b[0] + e);
}

// Thread tt's float4 i of the M16 mapping of a transposed 128 x 128 weight.
__device__ __forceinline__ float4 m16_gather(const float* wt, int tt, int i) {
  const float* w = wt + 4 * (tt >> 4) * kMaxH + 8 * (tt & 15) + i;
  return float4{__ldg(w), __ldg(w + kMaxH), __ldg(w + 2 * kMaxH), __ldg(w + 3 * kMaxH)};
}

// The M16 copies of the net's hidden weights: those with a shared-memory
// slot into it, those with one of the first NB register banks into wr (the
// caller publishes).
template <int NB, int NA>
__device__ __forceinline__ void load_m16(const Net& net, float* wres, float4 (&wr)[NA][8]) {
  for (int l = 0; l + 1 < net.n; ++l) {
    const int q = net.res_slot[l];
    if (q >= 0) {
      float4* dst = reinterpret_cast<float4*>(wres + static_cast<size_t>(q) * kMat);
      for (int e = threadIdx.x; e < 8 * kThreads; e += kThreads) dst[e] = m16_gather(net.w[1 + l], e % kThreads, e / kThreads);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (q == reg_bank(b))
#pragma unroll
        for (int i = 0; i < 8; ++i) wr[b][i] = m16_gather(net.w[1 + l], threadIdx.x, i);
  }
}

__device__ __forceinline__ float pick4(const float4& a, const float4& b, int i) {
  const float4& v = i < 4 ? a : b;
  const int k = i & 3;
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The lane's output of the M16 mapping, and whether it writes it.
__device__ __forceinline__ int m16_out() { return 4 * (threadIdx.x >> 4) + ((threadIdx.x >> 2) & 3); }
__device__ __forceinline__ bool m16_writer() { return (threadIdx.x & 3) == 0; }

// q[r] = the full sum of the lane's output (m16_out) for rows r < R of x
// (row r at x + r ldx), the weight's float4 i from w(i).
template <int R, class W>
__device__ __forceinline__ void m16_sums(W w, const float* x, int ldx, float (&q)[R]) {
  const int ks = threadIdx.x & 15;
  float4 xa[R], xb[R];
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* x4 = reinterpret_cast<const float4*>(x + r * ldx);
    xa[r] = x4[2 * ks];
    xb[r] = x4[2 * ks + 1];
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 wi = w(i);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xi = pick4(xa[r], xb[r], i);
      acc[r][0] = fmaf(wi.x, xi, acc[r][0]);
      acc[r][1] = fmaf(wi.y, xi, acc[r][1]);
      acc[r][2] = fmaf(wi.z, xi, acc[r][2]);
      acc[r][3] = fmaf(wi.w, xi, acc[r][3]);
    }
  }
  // halve the four outputs over lanes ks ^ 8 and ks ^ 4, then sum over ks ^ 2, ks ^ 1
  const bool b3 = ks & 8, b2 = ks & 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p0 = (b3 ? acc[r][2] : acc[r][0]) + __shfl_xor_sync(0xffffffffu, b3 ? acc[r][0] : acc[r][2], 8);
    const float p1 = (b3 ? acc[r][3] : acc[r][1]) + __shfl_xor_sync(0xffffffffu, b3 ? acc[r][1] : acc[r][3], 8);
    float v = (b2 ? p1 : p0) + __shfl_xor_sync(0xffffffffu, b2 ? p0 : p1, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    q[r] = v;
  }
}

// acc[r] = sum_j W[128 oc + k][j] v[r][j] for the thread's output k of
// chunk oc (walk_k), over every 128-wide chunk of j, summed over its quad:
// W a padded transposed weight [H][H] read from L2, v rows of H floats.
template <int R>
__device__ __forceinline__ void chunk_rows(const float* W, int H, int oc, const float* v, float (&acc)[R]) {
  const int nc = H / kMaxH;
  for (int ic = 0; ic < nc; ++ic) {
    float part[R];
    matvec_rows<false, R>(W + static_cast<size_t>(oc) * kMaxH * H + ic * kMaxH, H, v + ic * kMaxH, H, part);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = ic == 0 ? part[r] : acc[r] + part[r];
  }
}

// The hidden layers of `net` for R rows (row r of an activation at r H):
// from cur, each layer's elu(W a + b) into the other buffer, then a barrier;
// returns the buffer of the last (cur when the net has none). Each weight
// from its place: one of the first NB register banks of wr, a
// shared-memory slot of wres (both M16), or L2. With `wait`, the thread's
// cp.async copies complete before the last barrier.
template <int R, int NB, int NA>
__device__ __forceinline__ float* fwd_hidden(const Net& net, const FwdNet& t, float* cur, float* nxt,
                                             const float* wres, const float4 (&wr)[NA][8], bool wait) {
  const int H = t.ld, nc = H / kMaxH;
  for (int l = 0; l + 1 < net.n; ++l) {
    const int q = net.res_slot[l];
    const float* bl = t.b + l * H;
    if (q != -1) {  // M16 (nc == 1)
      float v[R];
      if (NB > 0 && q == reg_bank(0)) {
        m16_sums<R>([&](int i) { return wr[0][i]; }, cur, H, v);
      } else if (NB > 1 && q == reg_bank(1)) {
        m16_sums<R>([&](int i) { return wr[NA > 1][i]; }, cur, H, v);
      } else {
        const float4* ws = reinterpret_cast<const float4*>(wres + static_cast<size_t>(q) * kMat);
        m16_sums<R>([&](int i) { return ws[i * kThreads + threadIdx.x]; }, cur, H, v);
      }
      const int j = m16_out();
      if (m16_writer())
#pragma unroll
        for (int r = 0; r < R; ++r) nxt[r * H + j] = elu(v[r] + bl[j]);
    } else {
      for (int oc = 0; oc < nc; ++oc) {
        float acc[R];
        chunk_rows<R>(net.w[1 + l], H, oc, cur, acc);
        const int j = oc * kMaxH + walk_k();
        if (walk_ks() == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) nxt[r * H + j] = elu(acc[r] + bl[j]);
      }
    }
    if (wait && l + 2 == net.n) cp_async_wait<0>();
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// y[i] for a runtime i < kFold, without indexing the registers by it.
__device__ __forceinline__ float pick(const float (&y)[kFold], int i) {
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < kFold; ++c) v = c == i ? y[c] : v;
  return v;
}

// The readout of a narrow net for one row in a fold warp: y[c] = sum_j
// wl[c][j] a[j] + b[c] for c < out (0 beyond); lane l sums j = 4 l + 128 m
// and a butterfly gives every lane the same bits.
__device__ __forceinline__ void fold_readout(const Net& net, const FwdNet& t, const float* a, float (&y)[kFold]) {
  const int H = t.ld, lane = threadIdx.x & 31;
  float p[kFold];
#pragma unroll
  for (int c = 0; c < kFold; ++c) p[c] = 0.f;
  for (int m = lane; m < H / 4; m += 32) {
    const float4 x = reinterpret_cast<const float4*>(a)[m];
#pragma unroll
    for (int c = 0; c < kFold; ++c)
      if (c < net.out) {
        const float4 w = reinterpret_cast<const float4*>(t.wl + c * H)[m];
        p[c] = fmaf(w.x, x.x, p[c]);
        p[c] = fmaf(w.y, x.y, p[c]);
        p[c] = fmaf(w.z, x.z, p[c]);
        p[c] = fmaf(w.w, x.w, p[c]);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < kFold; ++c)
      if (c < net.out) p[c] += __shfl_xor_sync(0xffffffffu, p[c], o);
#pragma unroll
  for (int c = 0; c < kFold; ++c) y[c] = c < net.out ? p[c] + t.b[(net.n - 1) * H + c] : 0.f;
}

// Fold warp w's share of one row's first layer: act[j] = elu(s[j] + sum_c
// in[c] w0[c][j]) for j in [w H / kFoldWarps, (w + 1) H / kFoldWarps) (no
// barrier).
__device__ __forceinline__ void fold_first_layer(const Net& net, const FwdNet& t, const float (&in)[kFold],
                                                 const float* s, float* act) {
  const int H = t.ld, per = H / kFoldWarps, j0 = (threadIdx.x >> 5) * per;
  for (int j = j0 + (threadIdx.x & 31); j < j0 + per; j += 32) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kFold; ++c)
      if (c < net.kin) acc = fmaf(in[c], t.w0[c * H + j], acc);
    act[j] = elu(s[j] + acc);
  }
}

// The readout of `net` for R rows into y (y[r H + c], c < out), then a
// barrier: a narrow one by groups of 4 lanes, one (row, output) a group; a
// wide one as a layer (from L2).
template <int R>
__device__ void tile_readout(const Net& net, const FwdNet& t, const float* a, float* y) {
  const int H = t.ld, nc = H / kMaxH, ks = walk_ks();
  const float* bl = t.b + (net.n - 1) * H;
  if (narrow_out(net)) {
    const int n = R * net.out, g = threadIdx.x >> 2;
    for (int p0 = 0; p0 < n; p0 += kThreads / 4) {  // the same trip count in every lane
      const int p = p0 + g;
      const bool live = p < n;
      const int r = live ? p / net.out : 0, c = live ? p - r * net.out : 0;
      float part = 0.f;
      if (live) {
        const float4* w4 = reinterpret_cast<const float4*>(t.wl + c * H);
        const float4* a4 = reinterpret_cast<const float4*>(a + r * H);
        float a0 = 0.f, a1 = 0.f;
        for (int m = ks; m < H / 4; m += 4) {
          const float4 u = w4[m], x = a4[m];
          a0 = fmaf(u.x, x.x, a0);
          a1 = fmaf(u.y, x.y, a1);
          a0 = fmaf(u.z, x.z, a0);
          a1 = fmaf(u.w, x.w, a1);
        }
        part = a0 + a1;
      }
      const float v = quad_sum(part);
      if (live && ks == 0) y[r * H + c] = v + bl[c];
    }
  } else {
    for (int oc = 0; oc < nc; ++oc) {
      float acc[R];
      chunk_rows<R>(net.w[net.n], H, oc, a, acc);
      const int j = oc * kMaxH + walk_k();
      if (ks == 0 && j < net.out)
#pragma unroll
        for (int r = 0; r < R; ++r) y[r * H + j] = acc[r] + bl[j];
    }
  }
  __syncthreads();
}

// The first layer of `net` for R rows: act[r][j] = elu(s[r][j] + sum_c
// x[r][c] w0[c][j]) from the inputs x and the stream rows s (rows of H
// floats; x zero beyond kin), then a barrier.
template <int R>
__device__ void first_layer(const Net& net, const FwdNet& t, const float* x, const float* s, float* act) {
  const int H = t.ld, nc = H / kMaxH, ks = walk_ks();
  for (int oc = 0; oc < nc; ++oc) {
    const int j = oc * kMaxH + walk_k();
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (narrow_in(net)) {
      if (ks == 0)
        for (int c = 0; c < net.kin; ++c) {
          const float w = t.w0[c * H + j];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r * H + c], w, acc[r]);
        }
    } else {
      chunk_rows<R>(net.w[0], H, oc, x, acc);
    }
    if (ks == 0)
#pragma unroll
      for (int r = 0; r < R; ++r) act[r * H + j] = elu(s[r * H + j] + acc[r]);
  }
  __syncthreads();
}

// Stage q's derivative y done: the input of stage q + 1 or, at the last
// stage, the step's result, from the carry xc, the step size and the
// earlier stages' derivatives kq(i), i < q (the plain loop's arithmetic).
template <class K>
__device__ __forceinline__ float stage_next(int solver, int q, float xc, float dt, float y, K kq) {
  if (solver == 0) return xc + dt * y;                                  // Euler
  if (solver == 1) return q == 0 ? xc + y * (0.5f * dt) : xc + dt * y;  // Midpoint
  switch (q) {                                                          // RK4, Kutta's 3/8 rule
    case 0: return xc + dt * y * kOneThird;
    case 1: return xc + dt * (y - kq(0) * kOneThird);
    case 2: return xc + dt * (kq(0) - kq(1) + y);
    default: return xc + (kq(0) + 3.0f * (kq(1) + kq(2)) + y) * dt * 0.125f;
  }
}

// A 4-byte copy into a step buffer: by cp.async into shared memory (the
// caller commits and waits), or, where the buffers live in global memory
// (`async` false), at once.
__device__ __forceinline__ void step_copy(float* dst, const float* src, bool valid, bool async) {
  if (async) {
    cp_async_f32(dst, src, valid);
  } else {
    *dst = valid ? *src : 0.f;
  }
}

// A thread's share of a step's prefetch of ns stream rows (stream q's base
// from base(q)) for the block's R rows, h floats each into rows of H: its
// one 16-byte copy, found once, when the step has at most kThreads of them
// (h % 4 == 0, by cp.async); else every step runs the general loop. src is
// the copy's source at step 0 (null: zero fill); a step adds t B h.
struct RowCopy {
  const float* src;
  int dst;  // its offset in a step's buffer; -1: no copy of its own
  bool fast, async;
};

template <class Base>
__device__ inline RowCopy row_copy(int ns, int R, int h, int H, int row0, int B, bool async, Base base) {
  RowCopy c{nullptr, -1, async && h % 4 == 0 && ns * R * (H / 4) <= kThreads, async};
  const int o = threadIdx.x, per = H / 4;
  if (c.fast && o < ns * R * per) {
    const int q = o / (R * per), rest = o - q * R * per, r = rest / per, j = 4 * (rest - r * per);
    c.dst = (q * R + r) * H + j;
    if (row0 + r < B && j < h) c.src = base(q) + static_cast<size_t>(row0 + r) * h + j;
  }
  return c;
}

// Starts the copies of step t's stream rows into dst (the caller commits);
// zero is any 16-byte aligned global address.
template <class Base>
__device__ __forceinline__ void prefetch_rows(const RowCopy& c, float* dst, int t, int ns, int R, int h, int H,
                                              int row0, int B, const float* zero, Base base) {
  const size_t step = static_cast<size_t>(t) * B * h;
  if (c.fast) {
    if (c.dst >= 0) cp_async_f32x4(dst + c.dst, c.src ? c.src + step : zero, c.src != nullptr);
    return;
  }
  for (int o = threadIdx.x; o < ns * R * H; o += kThreads) {
    const int q = o / (R * H), rest = o - q * R * H, r = rest / H, j = rest - r * H;
    const bool ok = row0 + r < B && j < h;
    step_copy(dst + o, ok ? base(q) + step + static_cast<size_t>(row0 + r) * h + j : zero, ok, c.async);
  }
}

// Places the nets' hidden weights: the first regs of the first net's in
// register banks (M16; regs at most the kernel's banks), then, in order, as
// many as fit beside `rest` floats of shared memory (at most max_slots;
// M16), the others in L2. Only a width of kMaxH stays on chip. Returns the
// shared-memory slots taken.
__host__ inline int fwd_place(Net* const* nets, int count, int H, int regs, int max_slots, size_t rest) {
  for (int i = 0; i < count; ++i)
    for (int l = 0; l < kMaxTail; ++l) nets[i]->res_slot[l] = -1;
  if (H != kMaxH) return 0;
  const long long room = (static_cast<long long>(kSmemMax / sizeof(float)) - static_cast<long long>(rest)) / kMat;
  int q = 0, b = 0;
  for (int i = 0; i < count; ++i)
    for (int l = 0; l + 1 < nets[i]->n; ++l) {
      if (i == 0 && b < regs) {
        nets[i]->res_slot[l] = reg_bank(b++);
      } else if (q < max_slots && q < room) {
        nets[i]->res_slot[l] = q++;
      }
    }
  return q;
}

// The rows a block takes and where its buffers live: the most rows, at most
// `rows` (halving), whose buffers (floats(R) floats, no weight resident) fit
// a block's shared memory; else one row with its buffers in global memory
// (gmem), `floats` a block's share there, a multiple of 4.
struct FwdShape {
  int rows;
  size_t floats;
  bool gmem;
};

template <class F>
__host__ inline FwdShape fwd_shape(int rows, F floats) {
  for (int R = rows; R >= 1; R /= 2)
    if (floats(R) * sizeof(float) <= kSmemMax) return {R, floats(R), false};
  return {1, (floats(1) + 3) / 4 * 4, true};
}

// Blocks of pack_nets for `floats` outputs: enough that the copy takes a few
// microseconds, few enough to start at once.
__host__ inline int pack_blocks(size_t floats) {
  const size_t b = (floats + kThreads - 1) / kThreads;
  return static_cast<int>(b < 32 ? b : 32);
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
  int nt;           // output tiles a side of the widest job (1 at H = kMaxH)
};

// Block (range blockIdx.x, job blockIdx.y): the job's sums over its range
// of rows, in order, kKc rows at a time staged in shared memory (the next
// chunk's loads in flight in registers while the current one is
// multiplied), into the range's partial sums. An h x h job runs on the
// tensor cores; a narrow one (a first layer's few inputs, a last layer's
// few outputs) on the CUDA cores, a thread an output. kWide: the job's
// output tile blockIdx.z = (tu, tv) of nt x nt, its U columns 128 tu.. and
// V columns 128 tv.. (a tile past the job's widths returns at once; the
// bias sums come from the tiles with tu = 0).
template <bool kWide>
__device__ __forceinline__ void contract_body(const CtArgs& a, float* smem) {
  float* us = smem;           // [kKc][kLdt]: U, a row per summed row
  float* vs = smem + kChunk;  // [kKc][kLdt]: V
  const Job& jb = a.jobs.j[blockIdx.y];
  const Bufs& bf = a.bf;
  int cu0 = 0, cv0 = 0, wu = jb.wu, wv = jb.wv;  // the tile's first columns and widths
  if constexpr (kWide) {
    const int tu = blockIdx.z / a.nt, tv = blockIdx.z - tu * a.nt;
    cu0 = tu * kMaxH;
    cv0 = tv * kMaxH;
    if (cu0 >= jb.wu || cv0 >= jb.wv) return;
    wu = jb.wu - cu0 < kMaxH ? jb.wu - cu0 : kMaxH;
    wv = jb.wv - cv0 < kMaxH ? jb.wv - cv0 : kMaxH;
  }
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
      ru[i] = live && col < wu
                  ? (jb.u_act ? __ldg(bf.res + bf.at(e, jb.lu, r) + cu0 + col)
                              : __ldg(bf.xin_row(e, r) + cu0 + col))
                  : 0.f;
      rv[i] = live && col < wv
                  ? (jb.v_gy ? __ldg(bf.gy_row(e, r) + cv0 + col) : __ldg(bf.gres + bf.at(e, jb.lv, r) + cv0 + col))
                  : 0.f;
    }
  };
  // the tensor cores truncate as they accumulate: a chunk's products are
  // summed from zero, and the chunk sums added in float32 (round to nearest)
  Acc<1> acc, part;
  zero<1>(acc);
  const Frag f = frag<1>();
  const int n_out = wu * wv;
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
      if constexpr (kWide) {
        if (o < n_out) out[static_cast<long long>(cu0 + o / wv) * jb.wv + cv0 + o % wv] = nacc[q];
      } else {
        if (o < n_out) out[o] = nacc[q];
      }
    }
  } else {
    if constexpr (kWide) {
      for_acc_mn<1>(acc, wu, wv, [&](float& v, int m, int n) {
        out[static_cast<long long>(cu0 + m) * jb.wv + cv0 + n] = v;
      });
    } else {
      for_acc_mn<1>(acc, wu, wv, [&](float& v, int m, int n) { out[m * wv + n] = v; });
    }
  }
  if constexpr (kWide) {
    if (cu0 == 0 && static_cast<int>(threadIdx.x) < wv)
      out[static_cast<long long>(jb.wu) * jb.wv + cv0 + threadIdx.x] = bsum;
  } else {
    if (static_cast<int>(threadIdx.x) < wv) out[static_cast<long long>(jb.wu) * wv + threadIdx.x] = bsum;
  }
}

__global__ void __launch_bounds__(kThreads, 1) contract_jobs(const __grid_constant__ CtArgs a) {
  extern __shared__ __align__(16) float smem[];
  contract_body<false>(a, smem);
}

__global__ void __launch_bounds__(kThreads, 1) contract_jobs_wide(const __grid_constant__ CtArgs a) {
  extern __shared__ __align__(16) float smem[];
  contract_body<true>(a, smem);
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

// Launches the contraction's two kernels on st: the tiles of a wide
// contraction (a.nt > 1) in the grid's third dimension.
__host__ inline cudaError_t launch_contraction(const CtArgs& a, int nsplit, cudaStream_t st) {
  const size_t smem = 2 * kChunk * sizeof(float);
  if (a.nt > 1) {
    const dim3 grid(nsplit, a.jobs.n, a.nt * a.nt);
    contract_jobs_wide<<<grid, kThreads, smem, st>>>(a);
  } else {
    const dim3 grid(nsplit, a.jobs.n);
    contract_jobs<<<grid, kThreads, smem, st>>>(a);
  }
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

#ifdef NE_PHASE_CLOCK
// The forward phase clock's marks of the last launch (at most 64), their
// phases and their count, copied out after the device is synchronised;
// returns the error.
extern "C" int psn_ne_fwd_clock(long long* marks, int* bins, int* n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(marks, g_ne_fwd, sizeof(long long) * 64);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(bins, g_ne_fwd_bin, sizeof(int) * 64);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, g_ne_fwd_n, sizeof(int));
  return static_cast<int>(e);
}
#endif
