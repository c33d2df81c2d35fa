// The Hopper (sm_90) instructions the channel-wise kernels use beyond plain
// CUDA C++, each behind one inline function:
//
//   to_tf32       cvt.rna.tf32.f32: x rounded to TF32 (the top 19 bits,
//                 round to nearest, ties away from zero), as a .b32
//   mma_tf32      mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32:
//                 d += A B for a 16x8 A, an 8x8 B and a 16x8 float32 d,
//                 held by the 32 lanes of a warp in the PTX ISA's
//                 fragment layout (g = lane / 4, q = lane % 4):
//                   a[0] A[g][q]     a[1] A[g+8][q]
//                   a[2] A[g][q+4]   a[3] A[g+8][q+4]
//                   b[0] B[q][g]     b[1] B[q+4][g]
//                   d[r] D[g + 8 (r / 2)][2 q + r % 2]
//   cp_async_f32  cp.async.ca.shared.global of 4 bytes, or 4 zero bytes
//                 into shared memory when `valid` is false
//   cp_async_f32x4  the same for 16 bytes (cp.async.cg, through L2 only);
//                 both addresses 16-byte aligned
//   cp_async_commit / cp_async_wait<N>: close a group of copies; wait
//                 until at most N groups are still in flight
//   cluster_rank  %cluster_ctarank: the block's rank in its cluster
//   map_rank      mapa: the address of the same shared-memory location in
//                 the cluster's block of another rank (a generic pointer)
//   cluster_arrive / cluster_wait: barrier.cluster.arrive.release and
//                 barrier.cluster.wait.acquire, the two halves of a barrier
//                 of every thread of the cluster that orders shared-memory
//                 writes (remote ones too) before the reads after it
//
// Kept apart so that the host build of the kernels (utils/host_build.py)
// can put its own model of them (csrc/host/hopper_ops.cuh) in their place.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // the source bytes read; the rest is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ float* map_rank(float* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<float*>(out);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace
