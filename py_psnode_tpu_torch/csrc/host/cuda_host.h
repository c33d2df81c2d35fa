// A host model of the CUDA subset the port's hand-written kernels use (the
// channel-wise pair and the no-encode forward and backward pairs), so that their
// sources build with g++ and run on a CPU at small shapes
// (py_psnode_tpu_torch/utils/host_build.py): one OS thread per CUDA thread;
// __syncthreads as a std::barrier of the block; a cluster's blocks run at
// once, the next cluster after them; shared memory a poisoned (NaN) buffer
// per block; launches, cudaLaunchKernelEx with a cluster dimension, and the
// few runtime calls the launchers make. Included ahead of the source
// (g++ -include); csrc/host/hopper_ops.cuh models the Hopper instructions.

#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};

// One warp's mma operands (hopper_ops.cuh) or shuffled values, one slot a
// lane.
struct HostMmaSlot {
  uint32_t a[4], b[2];
  float f;
};
// A cp.async copy, made when its group is waited for.
struct HostCopy {
  float* dst;
  const float* src;
  bool valid;
};

// What a CUDA thread knows beyond its indices.
struct HostThread {
  std::barrier<>* block_bar;
  std::barrier<>* warp_bar;
  HostMmaSlot* slots;  // its warp's 32
  float* smem;
  unsigned crank;              // rank in the cluster
  float* const* cluster_smem;  // every block's shared memory, by rank
  std::barrier<>* cluster_bar;
  std::optional<std::barrier<>::arrival_token> token;
  std::vector<HostCopy> pending;
  std::vector<size_t> groups;  // ends of the committed copy groups in pending
};
inline thread_local HostThread host_t;
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

inline void __syncthreads() { host_t.block_bar->arrive_and_wait(); }
// the value of lane (lane ^ m) of the warp, through the warp's slots; every
// lane of the warp takes part, as in the kernels
inline float __shfl_xor_sync(unsigned, float v, int m) {
  const int lane = threadIdx.x & 31;
  host_t.slots[lane].f = v;
  host_t.warp_bar->arrive_and_wait();
  const float o = host_t.slots[lane ^ m].f;
  host_t.warp_bar->arrive_and_wait();
  return o;
}
// the value of lane src of the warp, likewise
inline float __shfl_sync(unsigned, float v, int src) {
  const int lane = threadIdx.x & 31;
  host_t.slots[lane].f = v;
  host_t.warp_bar->arrive_and_wait();
  const float o = host_t.slots[src & 31].f;
  host_t.warp_bar->arrive_and_wait();
  return o;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// the kernels add to an address from one thread only: a plain add models it
inline float atomicAdd(float* p, float v) {
  const float o = *p;
  *p = o + v;
  return o;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr size_t kHostSmemLimit = 232448;  // an H100 block's dynamic shared memory
inline cudaError_t host_last_error = cudaSuccess;
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  return static_cast<size_t>(v) <= kHostSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = host_last_error;
  host_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }

// Runs the grid one cluster of kc blocks (along x) at a time, the cluster's
// blocks at once.
template <class K, class... A>
void host_launch(K kernel, dim3 grid, dim3 block, size_t smem, unsigned kc, const A&... args) {
  const unsigned nt = block.x * block.y * block.z;
  if (nt > 1024 || nt % 32 || smem > kHostSmemLimit || grid.x % kc) {
    host_last_error = cudaErrorInvalidValue;
    return;
  }
  const unsigned nw = nt / 32;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned cx = 0; cx < grid.x; cx += kc) {
        std::vector<std::vector<float>> store(kc, std::vector<float>(smem / 4 + 4, std::nanf("")));
        std::vector<float*> base(kc);
        for (unsigned r = 0; r < kc; ++r)  // 16-byte aligned, as the card's
          base[r] = reinterpret_cast<float*>(
              (reinterpret_cast<uintptr_t>(store[r].data()) + 15) & ~uintptr_t(15));
        std::barrier<> cluster_bar(nt * kc);
        std::vector<std::unique_ptr<std::barrier<>>> block_bars, warp_bars;
        for (unsigned r = 0; r < kc; ++r) block_bars.emplace_back(new std::barrier<>(nt));
        for (unsigned w = 0; w < nw * kc; ++w) warp_bars.emplace_back(new std::barrier<>(32));
        std::vector<HostMmaSlot> slots(nt * kc);
        std::vector<std::thread> threads;
        threads.reserve(nt * kc);
        for (unsigned r = 0; r < kc; ++r)
          for (unsigned t = 0; t < nt; ++t)
            threads.emplace_back([&, r, t] {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
              blockIdx = dim3(cx + r, by, bz);
              blockDim = block;
              gridDim = grid;
              host_t.block_bar = block_bars[r].get();
              host_t.warp_bar = warp_bars[r * nw + t / 32].get();
              host_t.slots = slots.data() + r * nt + (t / 32) * 32;
              host_t.smem = base[r];
              host_t.crank = r;
              host_t.cluster_smem = base.data();
              host_t.cluster_bar = &cluster_bar;
              host_t.token.reset();
              host_t.pending.clear();
              host_t.groups.clear();
              kernel(args...);
              if (host_t.token) std::abort();  // a cluster arrival without its wait
            });
        for (auto& th : threads) th.join();
      }
}

// kernel<<<grid, block, smem, stream>>>(args...), as host_build.py rewrites it
template <class K, class... A>
void host_launch_plain(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       const A&... args) {
  host_launch(kernel, grid, block, smem, 1, args...);
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned host_cluster_of(const cudaLaunchConfig_t* c) {
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) return c->attrs[i].val.clusterDim.x;
  return 1;
}
template <class K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, K kernel, const A&... args) {
  host_launch(kernel, c->gridDim, c->blockDim, c->dynamicSmemBytes, host_cluster_of(c), args...);
  return cudaGetLastError();
}
// a model card of 132 SMs that holds one block an SM
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* c) {
  *n = 132 / static_cast<int>(host_cluster_of(c));
  return cudaSuccess;
}
