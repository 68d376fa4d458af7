// The launch interface of the wavefront bounce kernels (bounce.cu), shared
// with their Python binding (binding.cpp). Plain C types only, so the .cu
// file needs none of PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wavefront.h"

// Slots of the camera row (kernels/bounce.py CAM_*), computed once a frame
// by torch on the card: position, direction, up, right = direction x up,
// tan(fov / 2), aspect, the frame's height and height * aspect, aperture,
// focus distance and the miss depth of the frame's level.
enum {
  CAM_POS_X, CAM_POS_Y, CAM_POS_Z, CAM_DIR_X, CAM_DIR_Y, CAM_DIR_Z, CAM_UP_X, CAM_UP_Y,
  CAM_UP_Z, CAM_RIGHT_X, CAM_RIGHT_Y, CAM_RIGHT_Z, CAM_SCALE, CAM_ASPECT, CAM_HEIGHT,
  CAM_WIDTH, CAM_APERTURE, CAM_FOCUS, CAM_FALLBACK, CAM_FLOATS
};

// One sample's lanes (kernels/bounce.py SampleState), n each, updated in
// place: the ray, its throughput and radiance, the active flag, the first
// hit's distance, the stream word (u32 bits), the sample's segment count
// (one int64) and its harvest (gamma colour and depth), with the camera row.
struct WaveState {
  float* ox;
  float* oy;
  float* oz;
  float* dx;
  float* dy;
  float* dz;
  float* color_r;   // ray_color: the path's throughput
  float* color_g;
  float* color_b;
  float* rad_r;     // radiance
  float* rad_g;
  float* rad_b;
  bool* active;
  float* first_depth;
  uint32_t* stream;
  unsigned long long* segments;
  float* out_r;     // the harvest
  float* out_g;
  float* out_b;
  float* out_depth;
  const float* camera;
  int n;
};

// The sums a sample folds into (kernels/bounce.py FrameSums): r, g, b and
// depth, n each, and the segment total (one int64); null `r`: no fold. The
// sample adds its harvest and its segments to `base` (null: zero), which
// may be these sums themselves (in place).
struct SumColumns {
  float* r;
  float* g;
  float* b;
  float* depth;
  unsigned long long* segments;
  const float* base_r;
  const float* base_g;
  const float* base_b;
  const float* base_depth;
  const unsigned long long* base_segments;
};

// A bounce's ray test results: the sphere test's (t, index) and, for a
// scene with triangles, the triangle test's (null without).
struct HitColumns {
  const float* t;
  const int64_t* index;
  const float* tri_t;
  const int64_t* tri_index;
};

// The columns the shading reads: sphere centers and material ids, triangle
// corners and material ids (null corners: no triangles) and the material
// table (base colour, metallic, roughness, ior, transmission, emission).
struct ShadeScene {
  const float* cx;
  const float* cy;
  const float* cz;
  const int* sphere_material;
  int n_spheres;
  const float* tri[9];   // ax, ay, az, bx, by, bz, cx, cy, cz
  const int* tri_material;
  int n_tris;
  const float* mat[10];  // base r, g, b, metallic, roughness, ior, transmission, emissive r, g, b
  int n_materials;
};

// The slots of K6's probe instance (kernels/bounce.py SHADE_PROBE_SLOTS):
// the threads' cycles by stage (the flag and t reads, the lists of live
// lanes, a miss, the hit record and material gather, the branch choice's
// draws, the branch body, the stores, the harvest) and, at the entry of
// each path and branch, the warps that enter and their active lanes.
enum ShadeProbeSlot {
  kPTotal, kPClassify, kPCompact, kPMiss, kPRecord, kPDraws, kPBranch, kPStores, kPHarvest,
  kPMissWarps, kPMissLanes, kPRecordWarps, kPRecordLanes, kPMetalWarps, kPMetalLanes,
  kPGlassWarps, kPGlassLanes, kPDiffuseWarps, kPDiffuseLanes, kShadeProbeSlots
};

// K5: the sample's start state of every lane, and the segment count
// zeroed: lane i takes pixel `pixel_ids[i]` (int64) at `u[i]`, `v[i]`, or
// where `pixel_ids` is null pixel `first` + i of the `width` x `height`
// frame in row-major order, at its centre's coordinates. With `sums`, the
// segment total starts at the base's (0 without one) unless the sums are
// their own base. K6: bounce `bounce` of every lane, its segments added to
// the total of `sums` too; when `last`, the harvest written and, with
// `sums`, added to the base into the sums. K6 runs `tiles` blocks of
// 256 * `per` lanes each (per 1, 2 or 4; tiles = ceil(n / (256 * per))),
// each warp over a run of 32 * per of them. A non-null `probe`
// (kShadeProbeSlots zeros) launches the probe instance, which adds its sums
// there. Both launch on `stream` and allocate nothing; the caller checks the
// launch.
void launch_raygen_sample(const WaveState& s, const int64_t* pixel_ids, const float* u,
                          const float* v, int first, int width, int height, uint32_t sample,
                          uint32_t seed, bool defocus, const SumColumns& sums,
                          cudaStream_t stream);
void launch_shade_bounce(const WaveState& s, const HitColumns& hit, const ShadeScene& scene,
                         const SumColumns& sums, int bounce, bool last, bool cosine, int per,
                         int tiles, unsigned long long* probe, cudaStream_t stream);

// The facts of K5 (which 0), K6 (which 1) or K6's probe instance (which 2).
cudaError_t bounce_kernel_info(int which, WaveKernelInfo* out);
