// Building blocks of the channel-wise kernels (csrc/fused_cw_rollout.cu and
// csrc/fused_cw_rollout_bwd.cu): one block of kThreads threads evaluates the
// channel-wise dynamics of one batch row, float32 on the CUDA cores (no TF32,
// no tensor cores).
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
// 2 h^3 + (5 xd + C) h^2 multiply-adds). They run as tiles: the
// [h, h] activations live in shared memory as feature-major tiles T[f][l]
// (stride kLdt = 129, odd, so that a warp reads a row or a column of a tile
// without bank conflicts), the weight streams from L2 through a
// double-buffered staging area of kKc rows, and each thread keeps an 8 x 8
// register tile of the output (rows ty + 16 i, columns tx + 16 j). The
// per-channel nets are matrix-vector products read straight from L2 (one
// thread per output, coalesced over the output index).
//
// h is a runtime value up to kMaxH; the tiles are sized for kMaxH and the
// rows and columns beyond h are masked.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads, an 8 x 8 output tile each
constexpr int kMaxH = 128;             // the largest hidden width the tiles hold
constexpr int kLdt = kMaxH + 1;        // tile stride: odd, conflict-free both ways
constexpr int kTile = kMaxH * kLdt;    // floats in one [h, h] tile
constexpr int kKc = 16;                // weight rows staged at once
constexpr int kChunk = kKc * kMaxH;    // floats in one staged chunk
constexpr int kPre = kChunk / kThreads;  // staged floats per thread
constexpr int kR = 8;                  // register tile: kR x kR outputs a thread
constexpr float kOneThird = 1.0f / 3.0f;

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// elu'(p) from the activation a = elu(p): 1 above 0, else exp(p) = a + 1.
__device__ __forceinline__ float delu_act(float a) { return a > 0.f ? 1.f : a + 1.f; }

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
};

// acc[i][j] = sum_{k < K} tin[k * kLdt + m] * w[k * n + col], m = ty + 16 i,
// col = tx + 16 j: a tile (feature-major) times a weight [K, n] from global
// memory, staged kKc rows at a time, the next chunk's loads in flight while
// the current one is multiplied. Starts by writing wbuf (no other thread may
// read it then) and ends with a barrier.
__device__ __forceinline__ void gemm_tw(const float* tin, int K, const float* __restrict__ w,
                                        int n, float* wbuf, float (&acc)[kR][kR]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
  float pre[kPre];
  const int nchunk = (K + kKc - 1) / kKc;
  auto load = [&](int c) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int e = tid + s * kThreads;
      const int k = c * kKc + e / kMaxH, col = e % kMaxH;
      pre[s] = (k < K && col < n) ? __ldg(w + static_cast<size_t>(k) * n + col) : 0.f;
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) buf[tid + s * kThreads] = pre[s];
  };
  load(0);
  stash(wbuf);
  __syncthreads();
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) load(c + 1);
    const float* bw = wbuf + (c & 1) * kChunk;
    const int kn = K - c * kKc < kKc ? K - c * kKc : kKc;
    const float* ta = tin + static_cast<size_t>(c) * kKc * kLdt + ty;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float av[kR], bv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) av[i] = ta[kk * kLdt + 16 * i];
#pragma unroll
      for (int j = 0; j < kR; ++j) bv[j] = bw[kk * kMaxH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (c + 1 < nchunk) stash(wbuf + ((c + 1) & 1) * kChunk);
    __syncthreads();
  }
}

// acc[i][j] += sum_{l < L} ta[m * kLdt + l] * tb[col * kLdt + l]: the
// product of two tiles over their position axis, a^T g for tiles aT, gT
// (the gradient of a dense weight). No barrier.
__device__ __forceinline__ void gemm_tt(const float* ta, const float* tb, int L,
                                        float (&acc)[kR][kR]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* pa = ta + ty * kLdt;
  const float* pb = tb + tx * kLdt;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    float av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = pa[16 * i * kLdt + l];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = pb[16 * j * kLdt + l];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// tout[col * kLdt + m] = elu(acc + add), add = bias[col] or, with rows set,
// rows[m * h + col] (the row's s_constV tile); m, col < h.
__device__ __forceinline__ void store_fwd(const float (&acc)[kR][kR], int h,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ rows, float* tout) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int col = tx + 16 * j;
      if (m < h && col < h) {
        const float add = rows ? __ldg(rows + static_cast<size_t>(m) * h + col) : __ldg(bias + col);
        tout[col * kLdt + m] = elu(acc[i][j] + add);
      }
    }
  }
}

// t[col * kLdt + m] = acc * elu'(t[col * kLdt + m]) in place: the cotangent
// of a pre-activation from that of its activation, over the activation tile.
__device__ __forceinline__ void store_bwd(const float (&acc)[kR][kR], int h, float* t) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int col = tx + 16 * j;
      if (m < h && col < h) {
        float* p = t + col * kLdt + m;
        *p = acc[i][j] * delu_act(*p);
      }
    }
  }
}

// Per-channel matrix-vector products: out[c][j] = sum_{k < K} in[c][k]
// w[c][k][j] (+ b[c][j]) for c < nc, j < n, then elu when act, or times
// elu'(dact[c][j]) when dact is set. in/out/dact in shared memory with row
// strides ld_in/ld_out/n, w [nc, K, n] and b [nc, n] in global memory. One
// thread per output; neighbouring threads read neighbouring weights.
__device__ void gemv_ch(const float* in, int ld_in, int nc, int K, const float* __restrict__ w,
                        const float* __restrict__ b, float* out, int ld_out, int n, bool act,
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
// a barrier. Not inlined: the steppers reach it from several places.
__device__ __noinline__ void eval_fwd(const Net& w, const EvalSmem& s, int h, int xd, int zd,
                                      const float* xs, const float* __restrict__ fz_t,
                                      const float* __restrict__ sv, float* y) {
  const int C = xd + zd;
  float acc[kR][kR];
  gemv_ch(xs, h, xd, h, w.ew0, w.eb0, s.e, h, h, true, nullptr);
  for (int o = threadIdx.x; o < zd * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    s.ft[(xd + c) * kLdt + l] = __ldg(fz_t + o);
  }
  __syncthreads();
  gemv_ch(s.e, h, xd, h, w.ew1, w.eb1, s.ft, kLdt, h, false, nullptr);
  __syncthreads();
  gemm_tw(s.ft, C, w.a, h, s.wbuf, acc);  // a0 = elu(V A + s_constV)
  store_fwd(acc, h, nullptr, sv, s.t1);
  __syncthreads();
  gemm_tw(s.t1, h, w.w1, h, s.wbuf, acc);  // a1
  store_fwd(acc, h, w.b1, nullptr, s.t2);
  __syncthreads();
  gemm_tw(s.t2, h, w.w2, h, s.wbuf, acc);  // a2
  store_fwd(acc, h, w.b2, nullptr, s.t1);
  __syncthreads();
  // O = a2 W3 + b3 as ot[c][l]: one thread per output
  for (int o = threadIdx.x; o < xd * h; o += kThreads) {
    const int c = o / h, l = o - c * h;
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < h; ++k) v = fmaf(s.t1[k * kLdt + l], __ldg(w.w3 + k * xd + c), v);
    s.ot[o] = v + __ldg(w.b3 + c);
  }
  __syncthreads();
  gemv_ch(s.ot, h, xd, h, w.hw0, w.hb0, s.he, h, h, true, nullptr);
  __syncthreads();
  gemv_ch(s.he, h, xd, h, w.hw1, w.hb1, y, h, h, false, nullptr);
  __syncthreads();
}

}  // namespace
