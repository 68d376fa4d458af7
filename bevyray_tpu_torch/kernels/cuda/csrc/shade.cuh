// Device helpers of the shading step, shared by the fused kernel
// (megakernel.cu) and the wavefront bounce kernels (bounce.cu): the
// NaN-keeping clamps, reflect / refract / Schlick, the exact PCG draws of
// engine/slots.py's layout with the unit-ball sampler, and the sky. Each
// rounds as the plain PyTorch versions do (kernels/shade.py, core/rng.py,
// kernels/composite.py) under --fmad=false: torch.clamp keeps a NaN, as
// min_nan / max_nan do, 1.0 / x is an IEEE division and the
// transcendentals are the CUDA math library's full-precision ones, as
// torch's on the card.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kNearZero = 1e-8f;
constexpr float kTwoPi = 6.28318548202514648f;   // f32(2*pi)
constexpr float kThird = 0.333333343267440796f;  // f32(1/3)
constexpr float kInv2Pow32 = 2.3283064365386963e-10f;

// Draw slots (engine/slots.py).
constexpr uint32_t kJitterU = 0, kLensU = 2;   // u, then v at the next slot
constexpr uint32_t kRaygenDraws = 4, kDrawsPerBounce = 13;
constexpr uint32_t kSMetal = 0, kSTrans = 1, kSReflect = 2, kSBall1 = 3,
                   kSBall2 = 8;

// jnp.minimum / jnp.maximum against a constant: a NaN operand stays NaN.
__device__ __forceinline__ float min_nan(float x, float c) { return x > c ? c : x; }
__device__ __forceinline__ float max_nan(float x, float c) { return x < c ? c : x; }

__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }

__device__ __forceinline__ V3 refract(V3 v, V3 n, float eta) {
  float cos_theta = min_nan(dot(neg(v), n), 1.0f);
  V3 perp = scale(add(v, scale(n, cos_theta)), eta);
  V3 par = scale(n, -sqrtf(fabsf(1.0f - dot(perp, perp))));
  return add(perp, par);
}

__device__ __forceinline__ float schlick(float cosine, float ri) {
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  float om = 1.0f - cosine;
  float p5 = om * om;
  p5 = p5 * p5 * om;
  return r0 + (1.0f - r0) * p5;
}

// ---- counter-based PCG streams (core/rng.py) --------------------------------

__device__ __forceinline__ uint32_t pcg(uint32_t state) {
  uint32_t old = state + 747796405u + 2891336453u;
  uint32_t word = ((old >> ((old >> 28u) + 4u)) ^ old) * 277803737u;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ float draw(uint32_t stream, uint32_t slot) {
  return __uint2float_rn(pcg(pcg(stream ^ (slot * 0xC2B2AE35u)))) * kInv2Pow32;
}

__device__ __forceinline__ uint32_t stream_init(uint32_t pixel, uint32_t sample,
                                                uint32_t seed) {
  return pcg(pcg((pixel * 0x9E3779B9u) ^ (sample * 0x85EBCA6Bu) ^ seed));
}

// Uniform point in the unit ball from draws first..first+4: Box-Muller
// direction times the radius exp(log(u)/3).
__device__ V3 unit_ball(uint32_t stream, uint32_t first) {
  float u1 = max_nan(draw(stream, first), 1e-10f);
  float u2 = draw(stream, first + 1);
  float u3 = max_nan(draw(stream, first + 2), 1e-10f);
  float u4 = draw(stream, first + 3);
  float u5 = draw(stream, first + 4);
  float r1 = sqrtf(-2.0f * logf(u1));
  float r3 = sqrtf(-2.0f * logf(u3));
  V3 g = {r1 * cosf(kTwoPi * u2), r1 * sinf(kTwoPi * u2), r3 * cosf(kTwoPi * u4)};
  float inv_len = 1.0f / max_nan(sqrtf(dot(g, g)), 1e-20f);
  float radius = expf(logf(max_nan(u5, 1e-30f)) * kThird);
  return scale(g, inv_len * radius);
}

// The exact path's draws of one (pixel, sample) stream: two PCG steps per
// slot of engine/slots.py.
struct ExactDraws {
  uint32_t stream;

  __device__ ExactDraws(uint32_t s, int) : stream(s) {}
  __device__ static uint32_t base(int b) {
    return kRaygenDraws + kDrawsPerBounce * static_cast<uint32_t>(b);
  }
  __device__ float jitter(uint32_t k) const { return draw(stream, kJitterU + k); }
  __device__ float lens(uint32_t k) const { return draw(stream, kLensU + k); }
  __device__ void lens_offset(float rr, float lv, float& lx, float& ly) const {
    const float theta = kTwoPi * lv;
    lx = rr * cosf(theta);
    ly = rr * sinf(theta);
  }
  __device__ float u_metal(int b) const { return draw(stream, base(b) + kSMetal); }
  __device__ float u_trans(int b) const { return draw(stream, base(b) + kSTrans); }
  __device__ float u_reflect(int b) const { return draw(stream, base(b) + kSReflect); }
  __device__ V3 ball1(int b) const { return unit_ball(stream, base(b) + kSBall1); }
  __device__ V3 ball2(int b) const { return unit_ball(stream, base(b) + kSBall2); }
};

__device__ __forceinline__ V3 sky(V3 d) {
  V3 unit = normalize(d);
  float a = 0.5f * (unit.y + 1.0f);
  return {1.0f - a + a * 0.5f, 1.0f - a + a * 0.7f, 1.0f - a + a * 1.0f};
}

}  // namespace
