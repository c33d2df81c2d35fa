// The host model of csrc/hopper_ops.cuh (with csrc/host/cuda_host.h): TF32
// rounding on the top 19 bits, round to nearest with ties away from zero;
// mma.sync m16n8k8 through a slot per lane and a barrier of the warp, the
// last lane to arrive computing every lane's four outputs in the PTX ISA's
// fragment layout, each output's sum (the accumulator and eight exact
// products) rounded toward zero, as the tensor cores truncate when they
// accumulate; a
// cp.async copy made only when its group is waited for; the cluster's
// barrier and shared-memory map, with a check that arrivals and waits
// alternate.

#pragma once

#include <cmath>
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
  const int lane = threadIdx.x & 31;
  HostMmaSlot* s = host_cur->slots;
  std::memcpy(s[lane].a, a, sizeof(s[lane].a));
  std::memcpy(s[lane].b, b, sizeof(s[lane].b));
  std::memcpy(s[lane].d, d, sizeof(s[lane].d));
  // the last lane to arrive multiplies for the warp: D = C + A B as the
  // 16 x 8 tile, each sum (the accumulator, then the eight exact products
  // in k order) in double, rounded toward zero; then each lane's four
  // outputs in the fragment layout
  host_cur->warp_bar->arrive_and_wait([s] {
    double A[16][8], B[8][8], D[16][8];
    for (int row = 0; row < 16; ++row)
      for (int k = 0; k < 8; ++k)  // A[row][k] lies with lane (row % 8, k % 4)
        A[row][k] = tf32_value(s[(row % 8) * 4 + k % 4].a[(row >= 8) + 2 * (k >= 4)]);
    for (int k = 0; k < 8; ++k)
      for (int col = 0; col < 8; ++col)  // B[k][col] with lane (col, k % 4)
        B[k][col] = tf32_value(s[col * 4 + k % 4].b[k >= 4]);
    for (int l = 0; l < 32; ++l)  // D[g + 8 (r / 2)][2 q + r % 2] lies with lane (g, q)
      for (int r = 0; r < 4; ++r) D[(l >> 2) + 8 * (r >> 1)][2 * (l & 3) + (r & 1)] = s[l].d[r];
    for (int row = 0; row < 16; ++row)
      for (int k = 0; k < 8; ++k)
        for (int col = 0; col < 8; ++col) D[row][col] += A[row][k] * B[k][col];  // exact products
    for (int l = 0; l < 32; ++l)
      for (int r = 0; r < 4; ++r) {
        const double acc = D[(l >> 2) + 8 * (r >> 1)][2 * (l & 3) + (r & 1)];
        float f = static_cast<float>(acc);
        if (std::fabs(static_cast<double>(f)) > std::fabs(acc)) f = std::nextafterf(f, 0.f);
        s[l].d[r] = f;
      }
  });
  std::memcpy(d, s[lane].d, sizeof(s[lane].d));
}

inline void cp_async_f32(float* dst, const float* src, bool valid) {
  host_cur->pending.push_back({dst, src, valid});
}

inline void cp_async_f32x4(float* dst, const float* src, bool valid) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) std::abort();
  for (int i = 0; i < 4; ++i) host_cur->pending.push_back({dst + i, src + i, valid});
}

inline void cp_async_commit() { host_cur->groups.push_back(host_cur->pending.size()); }

template <int N>
inline void cp_async_wait() {
  auto& groups = host_cur->groups;
  if (groups.size() <= static_cast<size_t>(N)) return;
  const size_t k = groups.size() - N;  // the groups to complete
  const size_t done = groups[k - 1];
  auto& pending = host_cur->pending;
  for (size_t i = 0; i < done; ++i) {
    const HostCopy& c = pending[i];
    *c.dst = c.valid ? *c.src : 0.f;
  }
  pending.erase(pending.begin(), pending.begin() + done);
  groups.erase(groups.begin(), groups.begin() + k);
  for (size_t& g : groups) g -= done;
}

inline unsigned cluster_rank() { return host_cur->crank; }

inline float* map_rank(float* p, unsigned rank) {
  return host_cur->cluster_smem[rank] + (p - host_cur->smem);
}

inline void cluster_arrive() {
  if (host_cur->token) host_die("two cluster arrivals without a wait");
  host_cur->token = host_cur->cluster_bar->arrive();
}

inline void cluster_wait() {
  if (!host_cur->token) host_die("a cluster wait without its arrival");
  host_cur->cluster_bar->wait(*host_cur->token);
  host_cur->token.reset();
}

}  // namespace
