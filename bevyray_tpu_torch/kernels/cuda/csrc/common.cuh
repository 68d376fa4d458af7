// Device helpers shared by the fused kernel (megakernel.cu) and the
// wavefront kernels (wavefront.cu): the miss sentinel and the acceptance
// distance, a 3-vector in float32 and its operations, and the NaN-keeping
// min/max of the slab tests. Every operation rounds as the plain PyTorch
// versions do under --fmad=false: dot is x*x' + y*y' + z*z' left to right,
// normalize is v * (1 / sqrt(v.v)) with IEEE division and sqrt.

#pragma once

#include <cuda_runtime.h>

constexpr float kInf = 3.402823466e+38f;   // f32 max: the miss sentinel
constexpr float kTMin = 1e-3f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 v) { return scale(v, 1.0f / sqrtf(dot(v, v))); }

// jnp.minimum / jnp.maximum (and torch.minimum / torch.maximum) of two
// values: NaN if either is NaN. fminf and fmaxf would drop the NaN of a slab
// on a face plane (0 * inf) and enter a box that the JAX walk culls.
__device__ __forceinline__ float min2_nan(float x, float y) {
  return (x != x || y != y) ? x + y : fminf(x, y);
}
__device__ __forceinline__ float max2_nan(float x, float y) {
  return (x != x || y != y) ? x + y : fmaxf(x, y);
}

// The same minimum and maximum in one instruction each (sm_80+: PTX
// min.NaN.f32 / max.NaN.f32, one FMNMX with the NaN flag), for the fused
// kernel's candidate walk. Where either input is NaN the result is NaN, as
// min2_nan's x + y is; only the NaN's payload differs (the canonical NaN).
// Otherwise it is the FMNMX that fminf / fmaxf emit, signed zeros and
// denormals alike (no .ftz). So every comparison of the result, all false
// for any NaN, reads as min2_nan's / max2_nan's does.
__device__ __forceinline__ float min_nan1(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ float max_nan1(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
