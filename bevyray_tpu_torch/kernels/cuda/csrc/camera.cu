// The camera row (K12) for Hopper (sm_90a).
//
// It replaces XLA code of the JAX package, not a `pl.pallas_call`: the
// camera part of its jitted frame programs, `_pack_camera`
// (bevyray_tpu/kernels/pallas/megakernel.py:2722-2738) and the camera terms
// of `generate_rays` (kernels/raygen.py:53-57), which the port computed as
// some twenty torch kernels a frame. One thread writes the fused kernel's
// row and/or the wavefront row (kernels/camera.py), each entry as its plain
// PyTorch version computes it, in IEEE float32 with no contraction
// (--fmad=false): right = direction x up as y*z' - z*y' (torch's cross),
// the miss depth as far + 10 or far - 1, and tan(fov * 0.5) through
// glibc_tanf below, a port of glibc 2.36's tanf, which XLA's `tan` calls on
// a CPU host with that C library (kernels/camera.py glibc_tanf runs the same
// steps in torch): the same bits in every slot.
//
// Bound on an H100 SXM: neither bytes (60 read, at most 172 written) nor
// operations (about 60); a launch's latency, a few microseconds. What the
// design does about it: one launch of one thread for both rows, so a frame
// pays that latency once, where the torch version queued ~20 kernels.

#include <cstdint>

#include <cuda_runtime.h>

#include "bounce.h"
#include "camera.h"

namespace {

// The fused row's slots (kernels/camera.py C_*).
enum {
  C_POS_X, C_POS_Y, C_POS_Z, C_DIR_X, C_DIR_Y, C_DIR_Z, C_UP_X, C_UP_Y, C_UP_Z,
  C_RIGHT_X, C_RIGHT_Y, C_RIGHT_Z, C_SCALE, C_ASPECT, C_NEAR, C_FAR, C_WIDTH,
  C_HEIGHT, C_NPIX, C_APERTURE, C_FOCUS, N_CAM = 24
};

// -- tanf begin (glibc sysdeps/ieee754/flt-32/s_tanf.c and k_tanf.c)
__device__ __forceinline__ float masked(float x) {
  return __int_as_float(__float_as_int(x) & ~0xfff);
}

// __kernel_tanf(x, y, iy): tan(x + y) (iy 1) or -1 / tan(x + y) (iy -1),
// |x| <= pi/4.
__device__ float kernel_tanf(float x, float y, int iy) {
  const float kT[] = {  // T0..T12 (k_tanf.c), exact float32 values
      0x1.555556p-2f, 0x1.111112p-3f, 0x1.ba1ba2p-5f, 0x1.664f48p-6f,
      0x1.226e3ep-7f, 0x1.d6d22cp-9f, 0x1.7dbc9p-10f, 0x1.344d9p-11f,
      0x1.026f72p-12f, 0x1.47e88ap-14f, 0x1.2b80f4p-14f, -0x1.375cbep-16f,
      0x1.b2a708p-16f};
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7fffffff;
  if (ix < 0x39000000) {   // |x| < 2^-13
    if (iy == 1) return x;
    if (ix == 0) return 1.0f / fabsf(x);
    return -1.0f / x;
  }
  const bool big = ix > 0x3f2ca13f;   // |x| >= 0.6744: tan(pi/4 - |x|)
  if (big) {
    if (hx < 0) {
      x = -x;
      y = -y;
    }
    const float z = 0x1.921fb4p-1f - x;   // pi/4 in two parts
    const float w = 0x1.4442dp-25f - y;
    x = w + z;
    y = 0.0f;
    if (fabsf(x) < 0x1p-13f) {
      return static_cast<float>((1 - ((hx >> 30) & 2)) * iy) *
             (1.0f - static_cast<float>(2 * iy) * x);
    }
  }
  const float z = x * x;
  float w = z * z;
  float r = kT[1] + w * (kT[3] + w * (kT[5] + w * (kT[7] + w * (kT[9] + w * kT[11]))));
  float v = z * (kT[2] + w * (kT[4] + w * (kT[6] + w * (kT[8] + w * (kT[10] + w * kT[12])))));
  const float s = z * x;
  r = y + z * (s * (r + v) + y);
  r += kT[0] * s;
  w = x + r;
  if (big) {
    v = static_cast<float>(iy);
    return static_cast<float>(1 - ((hx >> 30) & 2)) * (v - 2.0f * (x - (w * w / (w + v) - r)));
  }
  if (iy == 1) return w;
  // -1 / (x + r) from a 12-bit split of each factor.
  const float zt = masked(w);
  v = r - (zt - x);
  const float a = -1.0f / w;
  const float t = masked(a);
  const float s2 = 1.0f + t * zt;
  return t + a * (s2 + t * v);
}

// tanf(x): the kernel, after a reduction by pi/2 in float64 (reduce_small)
// above pi/4. NaN from |x| >= 119.5 (the large reduction is not ported).
__device__ float glibc_tanf(float x) {
  const int ix = __float_as_int(x) & 0x7fffffff;
  if (ix <= 0x3f490fda) return kernel_tanf(x, 0.0f, 1);
  if (ix >= 0x42f00000) return __int_as_float(0x7fc00000);
  const double xd = static_cast<double>(x);
  const double r = xd * 0x1.45f306dc9c883p+23;   // 2^24 * 2/pi
  const int n = (static_cast<int>(r) + 0x800000) >> 24;
  const double xr = xd - static_cast<double>(n) * 0x1.921fb54442d18p+0;
  const float y0 = static_cast<float>(xr);
  const float y1 = static_cast<float>(xr - static_cast<double>(y0));
  return kernel_tanf(y0, y1, 1 - ((n & 1) << 1));
}
// -- tanf end

__global__ void __launch_bounds__(32) camera_kernel(CameraArgs a) {
  if (threadIdx.x != 0) return;
  float leaf[N_LEAVES];
  for (int k = 0; k < N_LEAVES; ++k) leaf[k] = __ldg(a.leaf[k]);
  const float* d = leaf + L_DIR;
  const float* u = leaf + L_UP;
  const float right[3] = {d[1] * u[2] - d[2] * u[1], d[2] * u[0] - d[0] * u[2],
                          d[0] * u[1] - d[1] * u[0]};
  const float scale = glibc_tanf(leaf[L_FOV] * 0.5f);
  if (a.fused != nullptr) {
    float* row = a.fused;
    for (int k = 0; k < N_CAM; ++k) row[k] = 0.0f;
    for (int k = 0; k < 3; ++k) {
      row[C_POS_X + k] = leaf[L_POS + k];
      row[C_DIR_X + k] = d[k];
      row[C_UP_X + k] = u[k];
      row[C_RIGHT_X + k] = right[k];
    }
    row[C_SCALE] = scale;
    row[C_ASPECT] = leaf[L_ASPECT];
    row[C_NEAR] = leaf[L_NEAR];
    row[C_FAR] = leaf[L_FAR];
    row[C_WIDTH] = a.width;
    row[C_HEIGHT] = a.height;
    row[C_NPIX] = a.npix;
    row[C_APERTURE] = leaf[L_APERTURE];
    row[C_FOCUS] = leaf[L_FOCUS];
  }
  if (a.wavefront != nullptr) {
    float* row = a.wavefront;
    for (int k = 0; k < 3; ++k) {
      row[CAM_POS_X + k] = leaf[L_POS + k];
      row[CAM_DIR_X + k] = d[k];
      row[CAM_UP_X + k] = u[k];
      row[CAM_RIGHT_X + k] = right[k];
    }
    row[CAM_SCALE] = scale;
    row[CAM_ASPECT] = leaf[L_ASPECT];
    row[CAM_HEIGHT] = a.height;
    row[CAM_WIDTH] = a.height * leaf[L_ASPECT];
    row[CAM_APERTURE] = leaf[L_APERTURE];
    row[CAM_FOCUS] = leaf[L_FOCUS];
    row[CAM_FALLBACK] = a.level1 ? leaf[L_FAR] + 10.0f : leaf[L_FAR] - 1.0f;
  }
}

}  // namespace

void launch_camera_rows(const CameraArgs& args, cudaStream_t stream) {
  camera_kernel<<<1, 32, 0, stream>>>(args);
}

cudaError_t camera_kernel_info(WaveKernelInfo* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, camera_kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, camera_kernel, 32, 0);
  }
  if (err != cudaSuccess) return err;
  *out = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
          static_cast<int>(attr.sharedSizeBytes), 0, blocks};
  return cudaSuccess;
}
