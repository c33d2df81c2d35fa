// The tensor-core product routine of the port's kernels (the channel-wise
// pair, csrc/cw_tile.cuh, and the no-encode backward pair,
// csrc/noencode_bwd.cuh): a block of kThreads threads multiplies [h, h]
// tiles held in shared memory, h <= kMaxH, on the tensor cores.
//
// Warp-level mma.sync m16n8k8 with TF32 inputs and float32 accumulation
// (csrc/hopper_ops.cuh), at float32 accuracy by the 3xTF32 split: each
// operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (x - hi is exact),
// and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the dropped a_lo b_lo lying
// 2^-22 below a b. One TF32 pass alone keeps about 11 bits. mma_k8 is the
// one routine: it reads each operand element through a function of the
// caller, so one routine serves every layout (a tile times a weight staged
// from global memory, a tile times a tile, staged row chunks).
//
// A tile is feature-major, T[f][l] (f the feature, l the position), of
// stride kLdt = 136: 8 mod 32, so the A fragment of a forward product (8
// positions x 4 features a load) falls on 32 distinct banks. A weight
// streams from L2 by cp.async, kKc rows at a time, into a double-buffered
// staging area of the same stride, the next chunk in flight while the
// current one is multiplied.
//
// A cluster of KC = 1, 2 or 4 blocks may share a product: each block
// computes the column slice [rank, rank + 1) * kMaxH / KC of it. The 16
// warps of a block tile its slice (Tiling), so a thread holds the
// accumulators of a few mma tiles in the fragment layout of the PTX ISA.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ops.cuh"

namespace {

constexpr int kThreads = 512;         // 16 warps
constexpr int kMaxH = 128;            // the largest hidden width the tiles hold
constexpr int kLdt = kMaxH + 8;       // tile stride: 8 mod 32, see above
constexpr int kTile = kMaxH * kLdt;   // floats in one [h, h] tile
constexpr int kKc = 32;               // weight rows staged at once
constexpr int kChunk = kKc * kLdt;    // floats in one staged chunk

// How the 16 warps of a block of a KC-block cluster tile its column slice
// [kMaxH, kSlice] of an [h, h] product: kAlongM warps along the rows, each
// a kWarpM x kWarpN slice of kMi x kNi mma tiles of 16 x 8.
template <int KC>
struct Tiling {
  static constexpr int kSlice = kMaxH / KC;
  static constexpr int kAlongM = KC == 4 ? 8 : 4;
  static constexpr int kWarpM = kMaxH / kAlongM;
  static constexpr int kWarpN = kSlice / (kThreads / 32 / kAlongM);
  static constexpr int kMi = kWarpM / 16;
  static constexpr int kNi = kWarpN / 8;
};

// A thread's accumulators: acc[i][j][r] is D[m][n] of the [h, h] output with
// m = acc_row(i, r), n = acc_col(j, r).
template <int KC>
using Acc = float[Tiling<KC>::kMi][Tiling<KC>::kNi][4];

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// elu'(p) from the activation a = elu(p): 1 above 0, else exp(p) = a + 1.
__device__ __forceinline__ float delu_act(float a) { return a > 0.f ? 1.f : a + 1.f; }

template <int KC>
__device__ __forceinline__ unsigned block_rank() {
  if constexpr (KC == 1) return 0;
  else return cluster_rank();
}

// The warp's output slice and the lane's place in the fragments.
struct Frag {
  int m0, n0, g, q;
};

template <int KC>
__device__ __forceinline__ Frag frag() {
  using T = Tiling<KC>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return Frag{(w % T::kAlongM) * T::kWarpM,
              static_cast<int>(block_rank<KC>()) * T::kSlice + (w / T::kAlongM) * T::kWarpN,
              lane >> 2, lane & 3};
}

__device__ __forceinline__ int acc_row(const Frag& f, int i, int r) {
  return f.m0 + 16 * i + f.g + 8 * (r >> 1);
}

__device__ __forceinline__ int acc_col(const Frag& f, int j, int r) {
  return f.n0 + 8 * j + 2 * f.q + (r & 1);
}

template <int KC>
__device__ __forceinline__ void zero(Acc<KC>& acc) {
#pragma unroll
  for (int i = 0; i < Tiling<KC>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<KC>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// fn(acc[i][j][r], m, n) for each of the thread's outputs with m < mh and
// n < nh.
template <int KC, class F>
__device__ __forceinline__ void for_acc_mn(Acc<KC>& acc, int mh, int nh, F fn) {
  const Frag f = frag<KC>();
#pragma unroll
  for (int i = 0; i < Tiling<KC>::kMi; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<KC>::kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = acc_row(f, i, r), n = acc_col(f, j, r);
        if (m < mh && n < nh) fn(acc[i][j][r], m, n);
      }
}

// fn(acc[i][j][r], m, n) for each of the thread's outputs with m, n < h.
template <int KC, class F>
__device__ __forceinline__ void for_acc(Acc<KC>& acc, int h, F fn) {
  for_acc_mn<KC>(acc, h, h, fn);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// acc += A[m][kb + k] B[kb + k][n] over k < 8 and the warp's slice, in the
// three TF32 passes; ga(m, k) and gb(k, n) read one operand element.
template <int KC, class GA, class GB>
__device__ __forceinline__ void mma_k8(const Frag& f, int kb, GA ga, GB gb, Acc<KC>& acc) {
  using T = Tiling<KC>;
  uint32_t bh[T::kNi][2], bl[T::kNi][2];
#pragma unroll
  for (int j = 0; j < T::kNi; ++j) {
    const int n = f.n0 + 8 * j + f.g;
    split_tf32(gb(kb + f.q, n), bh[j][0], bl[j][0]);
    split_tf32(gb(kb + f.q + 4, n), bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < T::kMi; ++i) {
    const int m = f.m0 + 16 * i + f.g;
    uint32_t ah[4], al[4];
    split_tf32(ga(m, kb + f.q), ah[0], al[0]);
    split_tf32(ga(m + 8, kb + f.q), ah[1], al[1]);
    split_tf32(ga(m, kb + f.q + 4), ah[2], al[2]);
    split_tf32(ga(m + 8, kb + f.q + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < T::kNi; ++j) {  // the small terms first
      mma_tf32(acc[i][j], al, bh[j]);
      mma_tf32(acc[i][j], ah, bl[j]);
      mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
}

// acc = sum_{k < K} tin[k][m] w[k][n] over the block's column slice: a tile
// (feature-major) times a weight [K, n] row-major in global memory (K, n <=
// kMaxH), the slice's columns staged kKc rows at a time by cp.async. The
// tile's rows beyond K must be zero. Starts by writing wbuf (no thread of
// the block may read it then) and ends with a barrier of the block.
template <int KC>
__device__ __forceinline__ void mma_tile_weight(const float* tin, int K,
                                                const float* __restrict__ w, int n, float* wbuf,
                                                Acc<KC>& acc) {
  constexpr int kSlice = Tiling<KC>::kSlice;
  const Frag f = frag<KC>();
  const int c0 = static_cast<int>(block_rank<KC>()) * kSlice;  // the slice's first column
  zero<KC>(acc);
  const int nchunk = (K + kKc - 1) / kKc;
  // 16-byte copies where the weight's rows are 16-byte aligned
  const bool v4 = n % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto stage = [&](int c) {
    float* buf = wbuf + (c & 1) * kChunk;
    if (v4) {
      for (int e = threadIdx.x; e < kKc * kSlice / 4; e += kThreads) {
        const int r = e / (kSlice / 4), col = c0 + 4 * (e % (kSlice / 4)), k = c * kKc + r;
        const bool ok = k < K && col < n;
        cp_async_f32x4(buf + r * kLdt + col, ok ? w + static_cast<size_t>(k) * n + col : w, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kKc * kSlice; e += kThreads) {
        const int r = e / kSlice, col = c0 + e % kSlice, k = c * kKc + r;
        const bool ok = k < K && col < n;
        cp_async_f32(buf + r * kLdt + col, ok ? w + static_cast<size_t>(k) * n + col : w, ok);
      }
    }
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
    __syncthreads();  // chunk c (and the tile) visible to every thread
    const float* bw = wbuf + (c & 1) * kChunk;
    const float* ta = tin + c * kKc * kLdt;
    const int kr = K - c * kKc;  // rows of this chunk below K
#pragma unroll
    for (int s = 0; s < kKc / 8; ++s)
      if (8 * s < kr)
        mma_k8<KC>(
            f, 8 * s, [&](int m, int k) { return ta[k * kLdt + m]; },
            [&](int k, int nn) { return bw[k * kLdt + nn]; }, acc);
    __syncthreads();  // done with buffer c & 1 before chunk c + 2 lands there
  }
}

// acc = sum_{l < L} ta[m][l] tb[n][l] over the block's column slice: two
// tiles multiplied over their position axis, a^T g for an activation tile
// aT and a cotangent tile gT (the gradient of a dense weight). Positions
// beyond L must be zero. No barrier.
template <int KC>
__device__ __forceinline__ void mma_tile_tile(const float* ta, const float* tb, int L,
                                              Acc<KC>& acc) {
  const Frag f = frag<KC>();
  zero<KC>(acc);
  for (int kb = 0; kb < L; kb += 8)
    mma_k8<KC>(
        f, kb, [&](int m, int k) { return ta[m * kLdt + k]; },
        [&](int k, int n) { return tb[n * kLdt + k]; }, acc);
}

}  // namespace
