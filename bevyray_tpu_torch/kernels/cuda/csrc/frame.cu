// The frame's tail (K10) and the fused film pass's fold (K11) for Hopper
// (sm_90a).
//
// They replace XLA code of the JAX package, not a `pl.pallas_call`: the
// tails of its jitted frame programs, which XLA fuses into a pass or two
// over the pixels.
//
// - resolve_frame (K10): `unshuffle_blocks` (bevyray_tpu/kernels/pallas/
//   megakernel.py:2746) where the sums come in the fused kernel's block
//   order, the mean (sums x 1/spp, or x 1 / max(n, 1) of a film's counts:
//   engine/renderer.py:242-252, engine/pallas_renderer.py:36-45,
//   engine/film.py:98-112), `composite` (kernels/composite.py:29) at the
//   frame's level over the raster layer, and the [H, W, 3] image and
//   [H, W] depth;
// - fold_pass (K11): `pallas_accumulate_impl`'s un-shuffle and its four
//   adds, with the film's sample count and segment total
//   (engine/film.py:127-145), into new tensors: the old film stays as it
//   was.
//
// Each computes what its plain PyTorch version (kernels/frame.py)
// computes, term for term, in IEEE float32 with no contraction
// (--fmad=false): the reciprocal of the clamped count as an IEEE division
// (torch's `1.0 / t` is `t.reciprocal() * 1.0`, and the multiply by one is
// exact), `near / t` as an IEEE division, and both compares false on a
// NaN, as torch's are: the same bits in every pixel.
//
// Bound on an H100 SXM: bytes. K10 reads 16 bytes a pixel (four sums) and
// writes 16 (the image's three floats and the depth), 4 more a pixel for
// a count a pixel and 16 for a raster layer a pixel, against a handful of
// fp32 operations; at 1920x1080 that is 66 MB, 19.8 us at 3.35 TB/s. K11
// reads 32 bytes a pixel and writes 16. What the design does about it: one
// thread a pixel in row-major order, so the writes are coalesced and the
// block-ordered reads too (a warp's 32 pixels of one row lie in one 64-wide
// block row); nothing is read twice, and a frame's constants (the scale,
// near, far, a 0-d raster layer) come through the read-only cache.

#include <cstdint>

#include <cuda_runtime.h>

#include "frame.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockW = 64;   // the fused kernel's pixel block (megakernel.py BLOCK_W, BLOCK_H)
constexpr int kBlockH = 64;

// The lane of pixel (x, y) in the block order of a grid `nbx` blocks wide.
__device__ __forceinline__ int block_lane(int x, int y, int nbx) {
  return ((y / kBlockH * nbx + x / kBlockW) * kBlockH + y % kBlockH) * kBlockW + x % kBlockW;
}

// K10: resolve_frame_reference, one thread a pixel.
__global__ void __launch_bounds__(kThreads) resolve_kernel(FrameTail a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.width * a.height) return;
  const int src = a.nbx > 0 ? block_lane(p % a.width, p / a.width, a.nbx) : p;
  float r = a.sum[0][src];
  float g = a.sum[1][src];
  float b = a.sum[2][src];
  float d = a.sum[3][src];
  if (a.count != nullptr) {
    // 1.0 / torch.clamp(n, min=1.0): a NaN count stays NaN.
    const float n = __ldg(a.count + p * a.count_stride);
    const float inv = 1.0f / (n != n ? n : (n < 1.0f ? 1.0f : n));
    r = r * inv;
    g = g * inv;
    b = b * inv;
    d = d * inv;
  } else if (a.has_inv) {
    r = r * a.inv;
    g = g * a.inv;
    b = b * a.inv;
    d = d * a.inv;
  }
  if (a.level != 3) {
    bool raster = true;   // level 0: the raster layer as it is
    if (a.level != 0) {
      const float rz = d > __ldg(a.far) ? -1.0f : __ldg(a.near) / d;
      const float rd = a.raster_depth != nullptr
                           ? __ldg(a.raster_depth + p * a.raster_depth_stride)
                           : 0.0f;
      raster = rd > rz;
    }
    if (raster) {
      r = a.raster[0] != nullptr ? __ldg(a.raster[0] + p * a.raster_stride[0]) : 1.0f;
      g = a.raster[1] != nullptr ? __ldg(a.raster[1] + p * a.raster_stride[1]) : 1.0f;
      b = a.raster[2] != nullptr ? __ldg(a.raster[2] + p * a.raster_stride[2]) : 1.0f;
    }
  }
  a.image[3 * p] = r;
  a.image[3 * p + 1] = g;
  a.image[3 * p + 2] = b;
  a.depth[p] = d;
}

// K11: fold_pass_reference, one thread a pixel.
__global__ void __launch_bounds__(kThreads) fold_kernel(PassFold a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p == 0) {
    *a.n_out = *a.n_in + a.spp;
    *a.total_out = *a.total_in + *a.segments;
  }
  if (p >= a.width * a.height) return;
  const int src = block_lane(p % a.width, p / a.width, a.nbx);
  for (int k = 0; k < 4; ++k) a.out[k][p] = a.film[k][p] + a.pass[k][src];
}

int grid_for(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

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

void launch_resolve_frame(const FrameTail& args, cudaStream_t stream) {
  const int n = args.width * args.height;
  if (n == 0) return;
  resolve_kernel<<<grid_for(n), kThreads, 0, stream>>>(args);
}

void launch_fold_pass(const PassFold& args, cudaStream_t stream) {
  // At least one block: thread 0 writes the count and the total.
  fold_kernel<<<grid_for(args.width * args.height), kThreads, 0, stream>>>(args);
}

cudaError_t frame_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(resolve_kernel, out);
  if (which == 1) return facts(fold_kernel, out);
  return cudaErrorInvalidValue;
}
