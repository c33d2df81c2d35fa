// The host model of cuda_bf16.h (with csrc/host/cuda_host.h): the
// __nv_bfloat16 storage type and the two conversions the kernels use,
// float to bf16 rounded to nearest with ties to even (a NaN stays a quiet
// NaN) and bf16 to float (exact).

#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
