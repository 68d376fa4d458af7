// The à-trous denoiser for Hopper (sm_90a): K7, one iteration a launch.
//
// It replaces XLA code of the JAX package, not a `pl.pallas_call`: the
// jitted `atrous_denoise` of bevyray_tpu/engine/denoise.py:46-82 (jitted at
// :85-87), which XLA fuses into a few passes over the image an iteration.
// Its plain PyTorch version is `atrous_denoise_reference` of
// bevyray_tpu_torch/engine/denoise.py, which queues about 22 torch kernels a
// tap, 25 taps an iteration.
//
// Each thread computes one pixel of one iteration as the plain version does,
// term for term, in IEEE float32 with no contraction (--fmad=false): the 25
// taps with `iy` outer and `ix` inner, each reading the pixel (clamp(y - dy),
// clamp(x - dx)) that the plain version's roll and replicate border give;
// dc2 = (d0 * d0 + d1 * d1) + d2 * d2 of the centre minus the tap, dz2 the
// depth difference squared, w = (ty * tx) * expf(-(dc2 * inv_2sc2 + dz2 *
// inv_2sz2)) with the CUDA math library's full-precision expf (as torch's
// exp on the card), the colour and weight sums taken tap by tap from +0, and
// acc / max(wsum, 1e-8) with an IEEE division and a NaN-keeping clamp. The
// same bits in every pixel.
//
// Bound on an H100 SXM: operations. An iteration moves 28 bytes a pixel
// (the image and depth read once, the image written once), 25.8 MB at
// 1280x720, 7.7 us at 3.35 TB/s; it does ~22 fp32 operations a tap beside
// one expf (about ten instructions), ~800 a pixel, 0.74 GFLOP at 1280x720,
// 11 us at 67 TFLOP/s and 22 us at the --fmad=false issue rate of 33.45 T/s.
// What the design does about it: one thread a pixel in 16 x 16 blocks, so a
// warp's taps fall on two rows of neighbouring pixels and the 25 x 16
// bytes a pixel reads again come from L1 and L2, not from device memory;
// the tap weights are constants and the iteration's scalars kernel
// arguments. Staging a tile and its 2 * stride halo in shared memory is
// left for later.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "image.h"

namespace {

constexpr int kTile = 16;   // a block is kTile x kTile pixels

// B3-spline 1D taps (1/16)·[1 4 6 4 1]; each product of two is exact in
// float32, as the plain version's float(ty * tx).
__constant__ float kTaps[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f,
                               1.0f / 16.0f};

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__global__ void __launch_bounds__(kTile* kTile)
    atrous_kernel(const float* __restrict__ img, const float* __restrict__ z,
                  float* __restrict__ out, int h, int w, int stride, float inv_2sc2,
                  float inv_2sz2) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const float c0 = img[3 * p], c1 = img[3 * p + 1], c2 = img[3 * p + 2];
  const float zc = z[p];
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int iy = 0; iy < 5; ++iy) {
    const int64_t row = static_cast<int64_t>(clampi(y - (iy - 2) * stride, h - 1)) * w;
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const int64_t q = row + clampi(x - (ix - 2) * stride, w - 1);
      const float q0 = __ldg(img + 3 * q), q1 = __ldg(img + 3 * q + 1),
                  q2 = __ldg(img + 3 * q + 2);
      const float d0 = c0 - q0, d1 = c1 - q1, d2 = c2 - q2;
      const float dc2 = (d0 * d0 + d1 * d1) + d2 * d2;
      const float dz = zc - __ldg(z + q);
      const float dz2 = dz * dz;
      const float wt = (kTaps[iy] * kTaps[ix]) * expf(-(dc2 * inv_2sc2 + dz2 * inv_2sz2));
      acc0 = acc0 + q0 * wt;
      acc1 = acc1 + q1 * wt;
      acc2 = acc2 + q2 * wt;
      wsum = wsum + wt;
    }
  }
  // torch.clamp(wsum, min=1e-8) keeps a NaN.
  const float den = wsum < 1e-8f ? 1e-8f : wsum;
  out[3 * p] = acc0 / den;
  out[3 * p + 1] = acc1 / den;
  out[3 * p + 2] = acc2 / den;
}

}  // namespace

void launch_atrous_pass(const float* img, const float* z, float* out, int h, int w, int stride,
                        float inv_2sc2, float inv_2sz2, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return;
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  atrous_kernel<<<grid, block, 0, stream>>>(img, z, out, h, w, stride, inv_2sc2, inv_2sz2);
}

cudaError_t atrous_kernel_info(WaveKernelInfo* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, atrous_kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, atrous_kernel, kTile * kTile, 0);
  }
  if (err != cudaSuccess) return err;
  *out = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
          static_cast<int>(attr.sharedSizeBytes), 0, blocks};
  return cudaSuccess;
}
