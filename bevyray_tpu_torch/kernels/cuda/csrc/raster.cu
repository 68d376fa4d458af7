// The raster layer's ray generation (K8) and shading (K9) for Hopper
// (sm_90a), around the dense triangle test K2 (wavefront.cu).
//
// They replace XLA code of the JAX package, not a `pl.pallas_call`: the
// jitted `rasterize_impl` of bevyray_tpu/engine/raster.py:74-129 (jitted at
// :132-134) outside its triangle test:
//
// - raster_rays (K8): `pixel_uv`, a jitter of 0.5 and `generate_rays`
//   without the lens (raster.py:80-82, kernels/raygen.py:28-70): the centre
//   ray of every pixel, as the origin and direction columns K2 reads;
// - raster_shade (K9): from K2's (t, index) and the ray's direction
//   (raster.py:85-129): the miss test, the clamped index, the hit
//   triangle's colour row and corners, its normalised geometric normal,
//   |N.V| clamped at 1e-4, Bevy's ambient split-sum shade (F_AB on the
//   diffuse and the specular lobe, the specular occlusion), the clear
//   colour on a miss, and the reverse-Z depth near / view_z (0 on a miss).
//
// Each computes what its plain PyTorch version (`rasterize_impl_reference`
// of bevyray_tpu_torch/engine/raster.py) computes, term for term, in IEEE
// float32 with no contraction (--fmad=false): K8 with K5's ray generation
// (bounce.cu raygen_kernel) and the camera row's scalars computed by torch
// (kernels/bounce.py camera_row, torch's tan); K9 with every Python
// constant rounded from its double as torch rounds it, NaN-keeping clamps
// and minimum, IEEE division and sqrt, and the CUDA math library's exp2f
// (as torch's exp2 on the card). The same bits in every pixel.
//
// Bound on an H100 SXM: bytes. K8 writes 24 bytes a pixel (origin and
// direction) from a 76-byte camera row, ~30 fp32 operations; K9 reads 24
// (t, index, direction) and writes 16 (colour, depth), ~120 operations on
// a hit; the triangle table (60 bytes a row) is read once. At 1280x720 that
// is 22.1 MB (6.6 us at 3.35 TB/s) and 36.9 MB (11.0 us). What the design
// does about it: one thread a pixel, each column read and written once,
// coalesced (pixel i at thread i); the table's rows are gathered through
// the read-only cache; a miss reads neither the table nor the index.

#include <cstdint>

#include <cuda_runtime.h>

#include "bounce.h"
#include "common.cuh"
#include "image.h"

namespace {

constexpr int kThreads = 256;

// Python floats as torch rounds them into a float32 operation.
#define F32(x) static_cast<float>(x)

// torch.clamp(x, min=c) and torch.clamp(x, lo, hi): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float c) { return x < c ? c : x; }
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 cam3(const float* cam, int k) {
  return {__ldg(cam + k), __ldg(cam + k + 1), __ldg(cam + k + 2)};
}

// raster.py _f_ab: Bevy's F_AB, (scale, bias).
__device__ __forceinline__ void f_ab(float pr, float no_v, float& s, float& b) {
  const float rx = pr * F32(-1.0) + F32(1.0);
  const float ry = pr * F32(-0.0275) + F32(0.0425);
  const float rz = pr * F32(-0.572) + F32(1.04);
  const float rw = pr * F32(0.022) - F32(0.04);
  const float a004 = min2_nan(rx * rx, exp2f(no_v * F32(-9.28))) * rx + ry;
  s = a004 * F32(-1.04) + rz;
  b = a004 * F32(1.04) + rw;
}

// K8: rasterize_impl_reference's pixel_uv and generate_rays, one thread a
// pixel.
__global__ void __launch_bounds__(kThreads)
    raster_rays_kernel(const float* __restrict__ cam, RasterRays r, int w, int h) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w * h) return;
  const int y = i / w;
  const int x = i - y * w;
  // pixel_uv: (j + 0.5) / f32(width), row-major.
  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(w);
  const float v = (static_cast<float>(y) + 0.5f) / static_cast<float>(h);
  const float c_scale = __ldg(cam + CAM_SCALE);
  const float aspect = __ldg(cam + CAM_ASPECT);
  // generate_rays with the jitter 0.5: (j - 0.5) / w is +0.
  const float jitter = 0.5f;
  const float ndc_x = (u * 2.0f - 1.0f) + (jitter - 0.5f) / __ldg(cam + CAM_WIDTH);
  const float ndc_y = (1.0f - v * 2.0f) + (jitter - 0.5f) / __ldg(cam + CAM_HEIGHT);
  const V3 d = normalize(add(add(cam3(cam, CAM_DIR_X), scale(cam3(cam, CAM_RIGHT_X),
                                                              ndc_x * aspect * c_scale)),
                             scale(cam3(cam, CAM_UP_X), ndc_y * c_scale)));
  const V3 o = cam3(cam, CAM_POS_X);
  r.ox[i] = o.x;
  r.oy[i] = o.y;
  r.oz[i] = o.z;
  r.dx[i] = d.x;
  r.dy[i] = d.y;
  r.dz[i] = d.z;
}

// K9: rasterize_impl_reference after its triangle test, one thread a pixel.
__global__ void __launch_bounds__(kThreads) raster_shade_kernel(RasterShade a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float t = a.t[i];
  if (!(t < kInf)) {   // the miss sentinel is f32 max
    a.out_r[i] = a.clear[0];
    a.out_g[i] = a.clear[1];
    a.out_b[i] = a.clear[2];
    a.out_depth[i] = 0.0f;
    return;
  }
  const int64_t index = a.index[i];
  const int row = static_cast<int>(index < 0 ? 0 : (index > a.rows - 1 ? a.rows - 1 : index));
  const float* c = a.colors + static_cast<int64_t>(row) * 6;
  const V3 base = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
  const float metallic = __ldg(c + 3), rough = __ldg(c + 4), refl = __ldg(c + 5);
  const V3 d = {a.dx[i], a.dy[i], a.dz[i]};

  // The hit triangle's geometric normal; |N.V| with Bevy's 1e-4 clamp.
  const V3 ac0 = {__ldg(a.tri[0] + row), __ldg(a.tri[1] + row), __ldg(a.tri[2] + row)};
  const V3 ab = sub(V3{__ldg(a.tri[3] + row), __ldg(a.tri[4] + row), __ldg(a.tri[5] + row)},
                    ac0);
  const V3 ac = sub(V3{__ldg(a.tri[6] + row), __ldg(a.tri[7] + row), __ldg(a.tri[8] + row)},
                    ac0);
  const V3 n = normalize(cross(ab, ac));
  const float no_v = clamp_min(fabsf(dot(n, d)), F32(1e-4));

  const float one_m = F32(1.0) - metallic;
  const V3 diffuse = scale(base, one_m);
  const float spec = refl * F32(0.16) * refl * one_m;
  const V3 f0 = add(scale(base, metallic), V3{spec, spec, spec});
  float d_scale, d_bias, s_scale, s_bias;
  f_ab(1.0f, no_v, d_scale, d_bias);
  f_ab(rough, no_v, s_scale, s_bias);
  const float spec_occ = clamp_to((f0.x + f0.y + f0.z) * F32(50.0 * 0.33), 0.0f, 1.0f);
  const V3 shaded =
      scale(add(add(scale(diffuse, d_scale), V3{d_bias, d_bias, d_bias}),
                scale(add(scale(f0, s_scale), V3{s_bias, s_bias, s_bias}), spec_occ)),
            a.ambient);
  a.out_r[i] = shaded.x;
  a.out_g[i] = shaded.y;
  a.out_b[i] = shaded.z;

  // Reverse-Z depth near / view_z, view_z = t along the camera's forward
  // axis.
  const float view_z = t * dot(d, cam3(a.camera, CAM_DIR_X));
  a.out_depth[i] = __ldg(a.near) / clamp_min(view_z, F32(1e-20));
}

int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

template <class Kernel>
cudaError_t facts(Kernel kernel, WaveKernelInfo* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  *out = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
          static_cast<int>(attr.sharedSizeBytes), 0, blocks};
  return cudaSuccess;
}

}  // namespace

void launch_raster_rays(const float* camera, RasterRays rays, int w, int h, cudaStream_t stream) {
  if (w <= 0 || h <= 0) return;
  raster_rays_kernel<<<grid_for(w * h), kThreads, 0, stream>>>(camera, rays, w, h);
}

void launch_raster_shade(const RasterShade& args, cudaStream_t stream) {
  if (args.n <= 0) return;
  raster_shade_kernel<<<grid_for(args.n), kThreads, 0, stream>>>(args);
}

cudaError_t raster_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(raster_rays_kernel, out);
  if (which == 1) return facts(raster_shade_kernel, out);
  return cudaErrorInvalidValue;
}
