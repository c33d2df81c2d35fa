// The host model of csrc/hopper_ops.cuh (with csrc/host/cuda_host.h): TF32
// rounding on the top 19 bits, round to nearest with ties away from zero;
// mma.sync m16n8k8 through a slot per lane and a barrier of the warp, each
// lane gathering its four outputs in the PTX ISA's fragment layout; a
// cp.async copy made only when its group is waited for; the cluster's
// barrier and shared-memory map, with a check that arrivals and waits
// alternate.

#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint32_t to_tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return u;
}

inline float tf32_value(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }

inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  HostMmaSlot* s = host_t.slots;
  std::memcpy(s[lane].a, a, sizeof(s[lane].a));
  std::memcpy(s[lane].b, b, sizeof(s[lane].b));
  host_t.warp_bar->arrive_and_wait();
  float out[4];
  for (int r = 0; r < 4; ++r) {
    const int row = g + 8 * (r >> 1), col = 2 * q + (r & 1);
    float acc = d[r];
    for (int k = 0; k < 8; ++k) {
      // A[row][k] lies with lane (row % 8, k % 4), B[k][col] with lane (col, k % 4)
      const float av = tf32_value(s[(row % 8) * 4 + k % 4].a[(row >= 8) + 2 * (k >= 4)]);
      const float bv = tf32_value(s[col * 4 + k % 4].b[k >= 4]);
      acc = std::fmaf(av, bv, acc);
    }
    out[r] = acc;
  }
  host_t.warp_bar->arrive_and_wait();
  for (int r = 0; r < 4; ++r) d[r] = out[r];
}

inline void cp_async_f32(float* dst, const float* src, bool valid) {
  host_t.pending.push_back({dst, src, valid});
}

inline void cp_async_f32x4(float* dst, const float* src, bool valid) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) std::abort();
  for (int i = 0; i < 4; ++i) host_t.pending.push_back({dst + i, src + i, valid});
}

inline void cp_async_commit() { host_t.groups.push_back(host_t.pending.size()); }

template <int N>
inline void cp_async_wait() {
  auto& groups = host_t.groups;
  if (groups.size() <= static_cast<size_t>(N)) return;
  const size_t done = groups[groups.size() - N - 1];
  for (size_t i = 0; i < done; ++i) {
    const HostCopy& c = host_t.pending[i];
    *c.dst = c.valid ? *c.src : 0.f;
  }
  host_t.pending.erase(host_t.pending.begin(), host_t.pending.begin() + done);
  std::vector<size_t> rest;
  for (size_t i = groups.size() - N; i < groups.size(); ++i) rest.push_back(groups[i] - done);
  groups = rest;
}

inline unsigned cluster_rank() { return host_t.crank; }

inline float* map_rank(float* p, unsigned rank) {
  return host_t.cluster_smem[rank] + (p - host_t.smem);
}

inline void cluster_arrive() {
  if (host_t.token) std::abort();  // two arrivals without a wait
  host_t.token.emplace(host_t.cluster_bar->arrive());
}

inline void cluster_wait() {
  if (!host_t.token) std::abort();  // a wait without its arrival
  host_t.cluster_bar->wait(std::move(*host_t.token));
  host_t.token.reset();
}

}  // namespace
