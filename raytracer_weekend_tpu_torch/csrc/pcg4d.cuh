// Device PCG4D and closed-form samplers.
//
// Bit-exact with raytracer_weekend_tpu/rng.py (pcg4d, rand4) and with the
// port's plain torch version (raytracer_weekend_tpu_torch/rng.py): uint32
// arithmetic wraps mod 2^32 in both. Every sample is keyed on
// (seed, ray_id, depth, salt), so a lane draws the same numbers whatever the
// launch shape or chunking.
#pragma once

#include <stdint.h>

namespace rtw {

constexpr uint32_t SALT_PIXEL_JITTER = 0x9E3779B1u;
constexpr uint32_t SALT_LENS = 0x85EBCA77u;
constexpr uint32_t SALT_TIME = 0xC2B2AE3Du;
constexpr uint32_t SALT_LAMBERTIAN = 0x27D4EB2Fu;
constexpr uint32_t SALT_METAL = 0x165667B1u;
constexpr uint32_t SALT_DIELECTRIC = 0xD3A2646Cu;
constexpr uint32_t SALT_ISOTROPIC = 0xFD7046C5u;
constexpr uint32_t SALT_VOLUME = 0xB55A4F09u;  // + volume index

// f32(2*pi), the value the JAX and torch versions multiply by.
constexpr float TWO_PI_F = 6.283185307179586f;

__device__ __forceinline__ void pcg4d(uint32_t& v0, uint32_t& v1, uint32_t& v2,
                                      uint32_t& v3) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v3 = v3 * 1664525u + 1013904223u;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
}

// uint32 -> f32 in [0, 1) from the top 24 bits (exact).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// rand4(seed, ray_id, depth, salt): four uniforms in [0, 1).
__device__ __forceinline__ float4 rand4(uint32_t seed, uint32_t ray_id,
                                        uint32_t depth, uint32_t salt) {
  uint32_t v0 = ray_id, v1 = depth, v2 = salt, v3 = seed;
  pcg4d(v0, v1, v2, v3);
  return make_float4(unit_float(v0), unit_float(v1), unit_float(v2),
                     unit_float(v3));
}

// Uniform direction on the unit sphere (rng.unit_vector_from_uniforms).
__device__ __forceinline__ float3 unit_vector(float u1, float u2) {
  float z = 1.0f - 2.0f * u1;
  float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  float phi = TWO_PI_F * u2;
  return make_float3(r * cosf(phi), r * sinf(phi), z);
}

}  // namespace rtw
