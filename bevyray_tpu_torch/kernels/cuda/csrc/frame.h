// The launch interface of the frame's tail (K10) and the fused film pass's
// fold (K11), frame.cu, shared with their Python binding (binding.cpp).
// Plain C types only, so the .cu file needs none of PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wavefront.h"

// K10: a frame's sums resolved and composited into its image and depth.
// `sum` holds r, g, b and depth: row-major, `width` x `height`, or with
// `nbx` > 0 in the fused kernel's order of 64 x 64 pixel blocks, `nbx`
// blocks a row (padding lanes past the frame are never read). Each is
// scaled by `inv` (`has_inv`), or by 1 / max(count, 1) where `count` is not
// null (one count, stride 0, or one a pixel, stride 1), or not at all. At
// `level` 0 the image is the raster colour, at 3 the traced colour; else
// the raster layer wins where its reverse-Z depth lies past the traced
// one's (`near` / t, -1 past `far`; both one float on the card). A null
// raster colour column is white, a null raster depth 0; a raster column's
// stride is 0 (one value) or 1 (one a pixel). `image` is [height, width,
// 3], `depth` [height, width].
struct FrameTail {
  const float* sum[4];
  int nbx;
  bool has_inv;
  float inv;
  const float* count;
  int count_stride;
  int level;
  const float* near;
  const float* far;
  const float* raster[3];
  int raster_stride[3];
  const float* raster_depth;
  int raster_depth_stride;
  float* image;
  float* depth;
  int width;
  int height;
};
void launch_resolve_frame(const FrameTail& args, cudaStream_t stream);

// K11: a fused film pass folded into the film: `out` = `film` + the pass's
// sums (`pass`, in block order, `nbx` blocks a row), r, g, b and depth, row
// major; and `n_out` = `n_in` + `spp`, `total_out` = `total_in` + the
// pass's `segments` (one value each on the card).
struct PassFold {
  const float* film[4];
  const float* pass[4];
  float* out[4];
  const float* n_in;
  float* n_out;
  float spp;
  const int64_t* total_in;
  const int64_t* segments;
  int64_t* total_out;
  int nbx;
  int width;
  int height;
};
void launch_fold_pass(const PassFold& args, cudaStream_t stream);

// The facts of K10 (which 0) or K11 (which 1).
cudaError_t frame_kernel_info(int which, WaveKernelInfo* out);
