// The launch interface of the image kernels: the à-trous denoiser (K7,
// denoise.cu) and the raster layer's ray generation and shading (K8, K9,
// raster.cu), shared with their Python binding (binding.cpp). Plain C types
// only, so the .cu files need none of PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wavefront.h"

// K7: one à-trous iteration at `stride` over an image `img` [h, w, 3] and
// its depth guide `z` [h, w] (float32, contiguous) into `out` [h, w, 3].
// `inv_2sc2` and `inv_2sz2` are the iteration's 1 / (2 sigma^2) of colour
// and depth, rounded to float32 by the caller.
void launch_atrous_pass(const float* img, const float* z, float* out, int h, int w, int stride,
                        float inv_2sc2, float inv_2sz2, cudaStream_t stream);

// K8: the centre ray of each of the `w` x `h` pixels (row-major) from the
// camera row (kernels/bounce.py camera_row): origin and unit direction
// columns, n = w * h each.
struct RasterRays {
  float* ox;
  float* oy;
  float* oz;
  float* dx;
  float* dy;
  float* dz;
};
void launch_raster_rays(const float* camera, RasterRays rays, int w, int h, cudaStream_t stream);

// K9: the ambient shade and reverse-Z depth of each ray from the triangle
// test's (t, index): the raster triangles' nine corner columns, their
// [rows, 6] colour rows (base r, g, b, metallic, perceptual roughness,
// reflectance), the camera row and `near` (one float on the card).
struct RasterShade {
  const float* t;
  const int64_t* index;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tri[9];   // ax, ay, az, bx, by, bz, cx, cy, cz
  const float* colors;   // rows x 6
  int rows;
  const float* camera;
  const float* near;
  float clear[3];
  float ambient;
  float* out_r;
  float* out_g;
  float* out_b;
  float* out_depth;
  int n;
};
void launch_raster_shade(const RasterShade& args, cudaStream_t stream);

// The facts of K7, and of K8 (which 0) or K9 (which 1).
cudaError_t atrous_kernel_info(WaveKernelInfo* out);
cudaError_t raster_kernel_info(int which, WaveKernelInfo* out);
