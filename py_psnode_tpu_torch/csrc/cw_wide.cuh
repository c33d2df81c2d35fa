// The channel-wise kernels' wide layout, for h > kMaxH (csrc/fused_cw_rollout.cu
// and csrc/fused_cw_rollout_bwd.cu take it above 128): one evaluation of the
// dynamics of csrc/cw_tile.cuh, its activations too large for shared memory.
//
// A batch row's three [h, h] activations a0, a1, a2 live in two tiles of the
// row's scratch in global memory (they stay in L2 at the trainer's batches
// and h = 256), feature-major T[f][l] of stride hp = h rounded up to 128,
// every element below hp written (zero beyond h), so that a product's
// operand chunks copy without bounds. A cluster of kc = 1, 2, 4 or 8 blocks
// (a value of the launch: one instantiation serves them all) shares the row:
// each [hp, hp] product is cut into 128 x 128 output blocks, block q to rank
// q % kc, and each output block is a block-level product on
// the tensor cores in 3xTF32 (mma_k8 of csrc/mma_tile.cuh at its 128 x 128
// tiling), its operands staged KW values of k at a time by cp.async, double-
// buffered, from the tiles (cp.async.cg: L2, where the cluster's writes are)
// and from the weights. A cluster barrier orders each layer's writes before
// the next layer's reads (barrier.cluster also where kc = 1: a launch
// without clusters is one of a block). The small parts (the per-channel nets, O = a2 W3,
// the folded first layer's cotangent) every block computes whole, reading
// the tiles from L2 (ld.global.cg); no distributed shared memory is used.
// The bf16 compute mode (kBf16) rounds as csrc/cw_tile.cuh says: every
// product's operands to bf16 as the product reads them (the weights' are
// bf16 values already), one TF32 pass; the tiles keep float32.

#pragma once

#include "cw_tile.cuh"

namespace {

constexpr int kWb = 128;  // an output block's edge: Tiling<1>
// The widest h of the forward and of the backward: those the JAX package's
// block choice (py_psnode_tpu/ops/fused_channelwise.py:choose_cw_blocks)
// runs; past them it fails.
constexpr int kMaxHFwd = 724;
constexpr int kMaxHBwd = 572;

// h rounded up to a multiple of kWb: the tiles' stride and extent.
__host__ __device__ inline int wide_pad(int h) { return (h + kWb - 1) / kWb * kWb; }

// A product's operand X(i, k) (i the output's row or column index, k the
// summed one) in global memory: p[k * ld + i], or with kIm p[i * ld + k];
// zero where i >= ilim or k >= klim. v4: 16-byte copies (p and ld aligned
// to 4 floats, and ilim, or with kIm klim, a multiple of 4).
struct WOp {
  const float* p;
  int ld, ilim, klim;
  bool v4;
};

// Floats of one staged chunk of KW values of k: [KW][kLdt] from a k-major
// operand, [kWb][KW + 4] from an i-major one (KW + 4 = 4 mod 8 keeps a
// fragment's reads on distinct banks).
template <int KW>
__host__ __device__ constexpr int wide_stage_floats() {
  return KW * kLdt > kWb * (KW + 4) ? KW * kLdt : kWb * (KW + 4);
}

// Stages values k0 .. k0 + KW of the operand's rows i0 .. i0 + kWb into buf.
template <int KW, bool kIm>
__device__ __forceinline__ void wide_stage(float* buf, const WOp& o, int i0, int k0) {
  if constexpr (!kIm) {  // buf[k][i]
    if (o.v4) {
      for (int e = threadIdx.x; e < KW * kWb / 4; e += kThreads) {
        const int r = e / (kWb / 4), c = 4 * (e % (kWb / 4)), i = i0 + c, k = k0 + r;
        const bool ok = i < o.ilim && k < o.klim;
        cp_async_f32x4(buf + r * kLdt + c, ok ? o.p + static_cast<size_t>(k) * o.ld + i : o.p, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KW * kWb; e += kThreads) {
        const int r = e / kWb, c = e % kWb, i = i0 + c, k = k0 + r;
        const bool ok = i < o.ilim && k < o.klim;
        cp_async_f32(buf + r * kLdt + c, ok ? o.p + static_cast<size_t>(k) * o.ld + i : o.p, ok);
      }
    }
  } else {  // buf[i][k]
    constexpr int ld = KW + 4;
    if (o.v4) {
      for (int e = threadIdx.x; e < KW * kWb / 4; e += kThreads) {
        const int c = e / (KW / 4), r = 4 * (e % (KW / 4)), i = i0 + c, k = k0 + r;
        const bool ok = i < o.ilim && k < o.klim;
        cp_async_f32x4(buf + c * ld + r, ok ? o.p + static_cast<size_t>(i) * o.ld + k : o.p, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KW * kWb; e += kThreads) {
        const int c = e / KW, r = e % KW, i = i0 + c, k = k0 + r;
        const bool ok = i < o.ilim && k < o.klim;
        cp_async_f32(buf + c * ld + r, ok ? o.p + static_cast<size_t>(i) * o.ld + k : o.p, ok);
      }
    }
  }
}

// acc = sum_{k < K} A(m0 + m, k) B(k, n0 + n) over the 128 x 128 output
// block, in 3xTF32; sa and sb hold two staged chunks each. Starts by
// writing sa and sb (no thread of the block may read them then) and ends
// with a barrier of the block. kBf16: both operands rounded to bf16 as
// they are read, in one TF32 pass.
template <int KW, bool kAIm, bool kBIm, bool kBf16 = false>
__device__ __forceinline__ void wide_mma(const WOp& A, int m0, const WOp& B, int n0, int K, float* sa,
                                         float* sb, Acc<1>& acc) {
  constexpr int kS = wide_stage_floats<KW>(), la = KW + 4;
  const Frag f = frag<1>();
  zero<1>(acc);
  const int nchunk = (K + KW - 1) / KW;
  auto stage = [&](int c) {
    wide_stage<KW, kAIm>(sa + (c & 1) * kS, A, m0, c * KW);
    wide_stage<KW, kBIm>(sb + (c & 1) * kS, B, n0, c * KW);
    cp_async_commit();
  };
  stage(0);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible to every thread
    const float* a = sa + (c & 1) * kS;
    const float* b = sb + (c & 1) * kS;
    const int kr = K - c * KW;  // values of this chunk below K
#pragma unroll
    for (int s = 0; s < KW / 8; ++s)
      if (8 * s < kr)
        mma_k8<1, kBf16>(
            f, 8 * s, [&](int m, int k) { return rnd<kBf16>(kAIm ? a[m * la + k] : a[k * kLdt + m]); },
            [&](int k, int n) { return rnd<kBf16>(kBIm ? b[n * la + k] : b[k * kLdt + n]); }, acc);
    __syncthreads();  // done with buffer c & 1 before chunk c + 2 lands there
  }
}

// fn(acc[i][j][r], m, n) for each of the thread's outputs of a 128 x 128
// block (m, n within it).
template <class F>
__device__ __forceinline__ void for_wide(Acc<1>& acc, F fn) {
  const Frag f = frag<1>();
#pragma unroll
  for (int i = 0; i < Tiling<1>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<1>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) fn(acc[i][j][r], acc_row(f, i, r), acc_col(f, j, r));
}

// Shared memory of one wide evaluation; the tiles t1, t2 ([hp][hp] each)
// are the row's in global memory.
struct WideSmem {
  float* sa;  // 2 staged chunks of the A operand
  float* sb;  // 2 staged chunks of the B operand
  float* ft;  // [C][h]: the channel features (V transposed)
  float* as;  // [C][h]: a
  float* b1;  // [h]
  float* b2;  // [h]
  float* w3;  // [h][xd]
  float* b3;  // [xd]
  float* e;   // [xd][h]: ext activations
  float* ot;  // [xd][h]: the vertical net's output, per channel
  float* he;  // [xd][h]: head activations
  float* t1;  // global [hp][hp]
  float* t2;  // global [hp][hp]
  int hp;
  int kc, rank;  // blocks in the cluster, this block's rank
};

// A barrier of the cluster's threads, and its two halves (csrc/cw_tile.cuh:
// cl_sync).
__device__ __forceinline__ void wide_sync() {
  cluster_arrive();
  cluster_wait();
}

// Carves WideSmem's shared part out of p for chunks of KW; returns the
// first float after it.
template <int KW>
__device__ __forceinline__ float* carve_wide(WideSmem& s, float* p, int h, int xd, int zd) {
  constexpr int kS = wide_stage_floats<KW>();
  const int C = xd + zd, n = xd * h;
  s.sa = p;  p += 2 * kS;
  s.sb = p;  p += 2 * kS;
  s.ft = p;  p += C * h;
  s.as = p;  p += C * h;
  s.b1 = p;  p += h;
  s.b2 = p;  p += h;
  s.w3 = p;  p += h * xd;
  s.b3 = p;  p += xd;
  s.e = p;   p += n;
  s.ot = p;  p += n;
  s.he = p;  p += n;
  return p;
}

template <int KW>
__host__ inline size_t wide_eval_floats(int h, int xd, int zd) {
  const size_t C = xd + zd;
  return 4 * static_cast<size_t>(wide_stage_floats<KW>()) + 2 * C * h + 2 * static_cast<size_t>(h) +
         static_cast<size_t>(h + 1) * xd + 3 * static_cast<size_t>(xd) * h;
}

// Copies the small weights into shared memory; the caller publishes them
// with a barrier.
__device__ __forceinline__ void init_wide(const Net& w, const WideSmem& s, int h, int xd, int zd) {
  for (int e = threadIdx.x; e < (xd + zd) * h; e += kThreads) s.as[e] = __ldg(w.a + e);
  for (int n = threadIdx.x; n < h; n += kThreads) {
    s.b1[n] = __ldg(w.b1 + n);
    s.b2[n] = __ldg(w.b2 + n);
  }
  for (int e = threadIdx.x; e < h * xd; e += kThreads) s.w3[e] = __ldg(w.w3 + e);
  for (int c = threadIdx.x; c < xd; c += kThreads) s.b3[c] = __ldg(w.b3 + c);
}

// The tile operand T[k][i] (k-major: T's rows are features) or, with kIm,
// T[i][k], of the row's [hp, hp] tile t.
__device__ __forceinline__ WOp tile_op(const float* t, int hp) { return WOp{t, hp, hp, hp, true}; }

// A weight [h, h] row-major as the operand W(k, n) = w[k][n] (k-major) or,
// with kIm, W(k, n) = w[n][k].
__device__ __forceinline__ WOp weight_op(const float* w, int h) {
  return WOp{w, h, h, h, h % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0};
}

// a0 = elu(V A + s_constV) over output block q (rows l, columns j) into t
// as t[j][l]: float32 on the CUDA cores (K = C), zero beyond h; kBf16:
// each feature rounded to bf16 as it is read.
template <bool kBf16 = false>
__device__ __forceinline__ void wide_first_layer(const WideSmem& s, int C, int h, int q,
                                                 const float* __restrict__ sv, float* t) {
  const int nbk = s.hp / kWb, l0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
  Acc<1> acc;
  for_wide(acc, [&](float& v, int m, int n) {
    v = __ldg(sv + static_cast<size_t>(min(l0 + m, h - 1)) * h + min(j0 + n, h - 1));
  });
  for (int c = 0; c < C; ++c)
    for_wide(acc, [&](float& v, int m, int n) {
      v = fmaf(rnd<kBf16>(s.ft[c * h + min(l0 + m, h - 1)]), s.as[c * h + min(j0 + n, h - 1)], v);
    });
  for_wide(acc, [&](float& v, int m, int n) {
    const int l = l0 + m, j = j0 + n;
    t[static_cast<size_t>(j) * s.hp + l] = l < h && j < h ? elu(v) : 0.f;
  });
}

// One wide evaluation of the dynamics for batch row b at xs [xd][h] (shared
// memory, published) into y [xd][h], as eval_fwd in csrc/cw_tile.cuh: leaves
// e, ft, ot, he in shared memory and a1 in t2, a2 in t1. The a0 store waits
// at the cluster barrier whose arrival the caller made once done reading
// t1; with kArrive, the evaluation makes the next one itself, after O.
// Stages KW values of k at a time (carve_wide's). Ends with a barrier of
// the block. The phase clock's marks 0-9 are eval_fwd's, but for the first
// layer: mark 2 to 3 is the wait for t1, 3 to 4 the first layer and its
// store. kBf16: the bf16 compute mode.
template <bool kArrive, int KW, bool kBf16 = false>
__device__ __forceinline__ void wide_eval_fwd(const Net& w, const WideSmem& s, int h, int xd, int zd,
                                              const float* xs, const float* __restrict__ fz_t,
                                              const float* __restrict__ sv, float* y) {
  const int C = xd + zd, hp = s.hp, nb2 = (hp / kWb) * (hp / kWb), rank = s.rank, kc = s.kc;
  const WOp wt1 = tile_op(s.t1, hp), wt2 = tile_op(s.t2, hp);
  CW_PHASE(0);
  gemv_ch<kBf16>(xs, h, xd, h, w.ew0, w.eb0, s.e, h, h, true, nullptr);
  for (int o = threadIdx.x; o < zd * h; o += kThreads) s.ft[xd * h + o] = __ldg(fz_t + o);
  __syncthreads();
  CW_PHASE(1);
  gemv_ch<kBf16>(s.e, h, xd, h, w.ew1, w.eb1, s.ft, h, h, false, nullptr);
  __syncthreads();
  CW_PHASE(2);
  cluster_wait();  // no block of the cluster reads t1 any more
  CW_PHASE(3);
  for (int q = rank; q < nb2; q += kc) wide_first_layer<kBf16>(s, C, h, q, sv, s.t1);
  wide_sync();
  CW_PHASE(4);
  Acc<1> acc;
  const int nbk = hp / kWb;
  // a1 = elu(a0 W1 + b1) into t2, then a2 = elu(a1 W2 + b2) into t1
  for (int layer = 0; layer < 2; ++layer) {
    const WOp& in = layer == 0 ? wt1 : wt2;
    const WOp wgt = weight_op(layer == 0 ? w.w1 : w.w2, h);
    const float* bias = layer == 0 ? s.b1 : s.b2;
    float* out = layer == 0 ? s.t2 : s.t1;
    for (int q = rank; q < nb2; q += kc) {
      const int l0 = (q / nbk) * kWb, j0 = (q % nbk) * kWb;
      wide_mma<KW, false, false, kBf16>(in, l0, wgt, j0, h, s.sa, s.sb, acc);
      for_wide(acc, [&](float& v, int m, int n) {
        const int l = l0 + m, j = j0 + n;
        out[static_cast<size_t>(j) * hp + l] = l < h && j < h ? elu(v + bias[j]) : 0.f;
      });
    }
    wide_sync();
    CW_PHASE(5 + layer);
  }
  // O = a2 W3 + b3 as ot[c][l], every block all of it
  for (int o = threadIdx.x; o < xd * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    float v = 0.f;
    for (int k = 0; k < h; ++k)
      v = fmaf(rnd<kBf16>(__ldcg(s.t1 + static_cast<size_t>(k) * hp + l)), s.w3[k * xd + c], v);
    s.ot[o] = v + s.b3[c];
  }
  __syncthreads();
  CW_PHASE(7);
  if constexpr (kArrive) cluster_arrive();
  gemv_ch<kBf16>(s.ot, h, xd, h, w.hw0, w.hb0, s.he, h, h, true, nullptr);
  __syncthreads();
  CW_PHASE(8);
  gemv_ch<kBf16>(s.he, h, xd, h, w.hw1, w.hb1, y, h, h, false, nullptr);
  __syncthreads();
  CW_PHASE(9);
}

// Blocks per batch row of a wide kernel: the largest kc of 8, 4, 2 that
// has an output block for each of its blocks and of which the card runs
// `rows` clusters at once, else 1.
template <class K>
int pick_wide_cluster(K kernel, int rows, int hp, size_t smem) {
  const int nb2 = (hp / kWb) * (hp / kWb);
  for (int kc = 8; kc >= 2; kc /= 2)
    if (kc <= nb2 && rows <= active_clusters(kernel, kc, smem)) return kc;
  return 1;
}

}  // namespace
