// The launch interface of the camera row (K12, camera.cu), shared with its
// Python binding (binding.cpp). Plain C types only, so the .cu file needs
// none of PyTorch's headers.

#pragma once

#include <cuda_runtime.h>

#include "wavefront.h"

// The camera's fifteen values, one float each on the card, in the order of
// core/types.py camera_leaves: position, direction, up (x, y, z each),
// fov, near, far, aspect, aperture, focus distance.
enum {
  L_POS = 0, L_DIR = 3, L_UP = 6, L_FOV = 9, L_NEAR, L_FAR, L_ASPECT, L_APERTURE,
  L_FOCUS, N_LEAVES
};

// K12: the fused row (`fused`, 24 floats in the slots of kernels/camera.py
// C_*, the JAX kernel's layout) and the wavefront row
// (`wavefront`, bounce.h's CAM_FLOATS floats) of one camera; a null row is not
// written. `width`, `height` and `npix` are the frame's, as float32;
// `level1` picks the wavefront row's miss depth, far + 10 (level 1) or
// far - 1.
struct CameraArgs {
  const float* leaf[N_LEAVES];
  float* fused;
  float* wavefront;
  float width;
  float height;
  float npix;
  bool level1;
};
void launch_camera_rows(const CameraArgs& args, cudaStream_t stream);

// The facts of K12.
cudaError_t camera_kernel_info(WaveKernelInfo* out);
