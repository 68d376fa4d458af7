// The wavefront renderer's bounce body for Hopper (sm_90a): ray generation
// (K5) and shading (K6).
//
// They replace XLA code of the JAX package, not a `pl.pallas_call`: the
// jitted `trace_sample` of bevyray_tpu/engine/renderer.py, which XLA fuses
// into a few passes over the lanes a bounce.
//
// - raygen_sample (K5): the stream, jitter and lens draws and
//   `generate_rays` (renderer.py:103-112, kernels/raygen.py:40-70) and the
//   carry's init (:130-139);
// - shade_bounce (K6): the `while_loop` body (:149-200) without its ray
//   tests: the sphere and triangle hit records and their merge, the first
//   hit's depth, the sky on a miss, the material gather and emission,
//   `scatter` (kernels/shade.py) and the carry's update, with the segment
//   count; on the last bounce the sample's harvest (:207-212): its gamma
//   colour and its depth.
//
// Each computes what its plain PyTorch version in kernels/bounce.py
// computes, term for term, in IEEE float32 with no contraction
// (--fmad=false), with the same draws (shade.cuh): the same bits in every
// lane. The plain `scatter` computes all three branches and selects one;
// K6 computes the chosen one only, with only its draws (a draw is a pure
// function of its key), so a NaN of a branch not taken never reaches a
// lane, as torch.where keeps it out.
//
// Bound on an H100 SXM: bytes. One thread a lane over the state's SoA
// columns, which the ray tests (K1-K4) read as they are. A hit lane moves
// about 114 bytes (o, d, throughput and radiance read and written, the
// flag, the stream word, the winning test's t and index; 4 more with
// triangles, the other test's t) against a few hundred fp32 operations
// (the draws' integer hashes and one branch's transcendentals); a miss
// reads only d, the throughput, the radiance and the t's, and writes the
// radiance and the flag; a lane that is inactive at entry reads its flag
// and writes nothing but the harvest on the last bounce. K5 writes 57 bytes a lane and reads 16. What the design
// does about it:
//
// - each column is read and written once a bounce, coalesced (lane i at
//   thread i), and the tables (spheres, triangles, materials) are gathered
//   through the read-only cache;
// - the segment count is one __syncthreads_count and one 64-bit atomicAdd
//   a block: an integer sum, exact and the same in every run;
// - the stream word is computed once a sample (K5) and kept as 4 bytes a
//   lane, cheaper than the pixel id's 8 that K6 would hash again.

#include <cstdint>

#include <cuda_runtime.h>

#include "bounce.h"
#include "common.cuh"
#include "shade.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ V3 load3(const float* x, const float* y, const float* z, int i) {
  return {x[i], y[i], z[i]};
}

__device__ __forceinline__ void store3(float* x, float* y, float* z, int i, V3 v) {
  x[i] = v.x;
  y[i] = v.y;
  z[i] = v.z;
}

// Vec3.cross (core/vec.py).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp(index, 0, rows - 1) of a ray test's int64 index.
__device__ __forceinline__ int row_of(int64_t index, int rows) {
  return static_cast<int>(index < 0 ? 0 : (index > rows - 1 ? rows - 1 : index));
}

__device__ __forceinline__ int clamp_id(int id, int rows) { return min(max(id, 0), rows - 1); }

// K5: raygen_sample_reference, one thread a lane.
__global__ void __launch_bounds__(kThreads)
    raygen_kernel(WaveState s, const int64_t* __restrict__ pixel_ids,
                  const float* __restrict__ u, const float* __restrict__ v, uint32_t sample,
                  uint32_t seed, bool defocus) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) *s.segments = 0ull;
  if (i >= s.n) return;
  const float* cam = s.camera;
  const uint32_t stream = stream_init(static_cast<uint32_t>(pixel_ids[i]), sample, seed);
  const ExactDraws draws(stream, 0);
  const V3 cam_pos = {__ldg(cam + CAM_POS_X), __ldg(cam + CAM_POS_Y), __ldg(cam + CAM_POS_Z)};
  const V3 cam_dir = {__ldg(cam + CAM_DIR_X), __ldg(cam + CAM_DIR_Y), __ldg(cam + CAM_DIR_Z)};
  const V3 up = {__ldg(cam + CAM_UP_X), __ldg(cam + CAM_UP_Y), __ldg(cam + CAM_UP_Z)};
  const V3 right = {__ldg(cam + CAM_RIGHT_X), __ldg(cam + CAM_RIGHT_Y),
                    __ldg(cam + CAM_RIGHT_Z)};
  const float c_scale = __ldg(cam + CAM_SCALE);
  const float aspect = __ldg(cam + CAM_ASPECT);
  // generate_rays (kernels/raygen.py): w = h * aspect is the row's.
  const float ju = draws.jitter(0);
  const float jv = draws.jitter(1);
  const float ndc_x = (u[i] * 2.0f - 1.0f) + (ju - 0.5f) / __ldg(cam + CAM_WIDTH);
  const float ndc_y = (1.0f - v[i] * 2.0f) + (jv - 0.5f) / __ldg(cam + CAM_HEIGHT);
  V3 d = normalize(add(add(cam_dir, scale(right, ndc_x * aspect * c_scale)),
                       scale(up, ndc_y * c_scale)));
  V3 o = cam_pos;
  if (defocus) {
    const float lu = draws.lens(0);
    const float lv = draws.lens(1);
    const float rr = __ldg(cam + CAM_APERTURE) * 0.5f * sqrtf(lu);
    float lx, ly;
    draws.lens_offset(rr, lv, lx, ly);
    const V3 focal = add(o, scale(d, __ldg(cam + CAM_FOCUS)));
    o = add(add(o, scale(right, lx)), scale(up, ly));
    d = normalize(sub(focal, o));
  }
  store3(s.ox, s.oy, s.oz, i, o);
  store3(s.dx, s.dy, s.dz, i, d);
  store3(s.color_r, s.color_g, s.color_b, i, {1.0f, 1.0f, 1.0f});
  store3(s.rad_r, s.rad_g, s.rad_b, i, {0.0f, 0.0f, 0.0f});
  s.active[i] = true;
  s.first_depth[i] = kInf;
  s.stream[i] = stream;
}

// K6: shade_bounce_reference, one thread a lane.
__global__ void __launch_bounds__(kThreads)
    shade_kernel(WaveState s, HitColumns hit, ShadeScene sc, int bounce, bool last,
                 bool cosine) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < s.n;
  const bool live = in && s.active[i];
  // segments + active.sum(), the lanes active at entry.
  const int count = __syncthreads_count(live);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(s.segments, static_cast<unsigned long long>(count));
  }
  if (!in) return;

  // merge_hits: the triangle wins only with a strictly smaller t.
  const bool tris = hit.tri_t != nullptr;
  const float t = hit.t[i];
  const float tt = tris ? hit.tri_t[i] : kInf;
  const bool tri_wins = tris && tt < t;
  const float hit_t = tri_wins ? tt : t;
  if (bounce == 0) s.first_depth[i] = hit_t;   // every lane, as the plain version

  V3 rad;
  if (live) {
    const V3 d = load3(s.dx, s.dy, s.dz, i);
    const V3 ray_color = load3(s.color_r, s.color_g, s.color_b, i);
    rad = load3(s.rad_r, s.rad_g, s.rad_b, i);
    if (t >= kInf && (!tris || tt >= kInf)) {
      // A miss picks up the sky and ends the path.
      rad = add(rad, mul(ray_color, sky(d)));
      s.active[i] = false;
    } else {
      // The winner's hit record (make_hit_info / triangle_hit_info). Only
      // a hit reads the origin and the winner's index.
      const V3 o = load3(s.ox, s.oy, s.oz, i);
      V3 position, n;
      int material;
      if (tri_wins) {
        // tt < t <= f32 max: the triangle test hit.
        const int row = row_of(hit.tri_index[i], sc.n_tris);
        const V3 a = {__ldg(sc.tri[0] + row), __ldg(sc.tri[1] + row), __ldg(sc.tri[2] + row)};
        const V3 b = {__ldg(sc.tri[3] + row), __ldg(sc.tri[4] + row), __ldg(sc.tri[5] + row)};
        const V3 c = {__ldg(sc.tri[6] + row), __ldg(sc.tri[7] + row), __ldg(sc.tri[8] + row)};
        n = normalize(cross(sub(b, a), sub(c, a)));
        position = add(o, scale(d, tt));
        material = __ldg(sc.tri_material + row);
      } else {
        const bool sphere_miss = t >= kInf;
        const int row = row_of(hit.index[i], sc.n_spheres);
        position = add(o, scale(d, sphere_miss ? 0.0f : t));
        const V3 center = {__ldg(sc.cx + row), __ldg(sc.cy + row), __ldg(sc.cz + row)};
        n = sphere_miss ? V3{0.0f, 1.0f, 0.0f} : normalize(sub(position, center));
        material = __ldg(sc.sphere_material + row);
      }
      const bool front_face = dot(d, n) < 0.0f;
      const int m = clamp_id(material, sc.n_materials);
      const V3 base_color = {__ldg(sc.mat[0] + m), __ldg(sc.mat[1] + m), __ldg(sc.mat[2] + m)};
      const float metallic = __ldg(sc.mat[3] + m);
      const float roughness = __ldg(sc.mat[4] + m);
      const float ior = __ldg(sc.mat[5] + m);
      const float transmission = __ldg(sc.mat[6] + m);
      const V3 emissive = {__ldg(sc.mat[7] + m), __ldg(sc.mat[8] + m), __ldg(sc.mat[9] + m)};
      rad = add(rad, mul(ray_color, emissive));

      // scatter (kernels/shade.py), the chosen branch only.
      const ExactDraws draws(s.stream[i], 0);
      V3 dir;
      V3 attenuation = base_color;
      bool absorbed;
      if (draws.u_metal(bounce) < metallic) {
        dir = add(normalize(reflect(d, n)), scale(draws.ball1(bounce), roughness));
        absorbed = dot(dir, n) < 0.0f;
      } else if (draws.u_trans(bounce) < transmission) {
        const V3 unit = normalize(d);
        const float ri = front_face ? 1.0f / ior : ior;
        const float cos_theta = min_nan(dot(neg(unit), n), 1.0f);
        const float sin_theta = sqrtf(max_nan(1.0f - cos_theta * cos_theta, 0.0f));
        const bool use_reflect =
            ri * sin_theta > 1.0f || schlick(cos_theta, ri) > draws.u_reflect(bounce);
        dir = use_reflect ? reflect(unit, n) : refract(unit, n, ri);
        attenuation = {1.0f, 1.0f, 1.0f};
        absorbed = false;
      } else {
        const V3 ball1 = draws.ball1(bounce);
        if (cosine) {
          dir = add(n, normalize(ball1));
        } else {
          dir = add(add(n, ball1), scale(draws.ball2(bounce), roughness));
        }
        if (fabsf(dir.x) < kNearZero && fabsf(dir.y) < kNearZero && fabsf(dir.z) < kNearZero) {
          dir = n;
        }
        absorbed = dot(dir, n) < 0.0f;
      }
      if (!absorbed) store3(s.color_r, s.color_g, s.color_b, i, mul(ray_color, attenuation));
      store3(s.ox, s.oy, s.oz, i, position);
      store3(s.dx, s.dy, s.dz, i, dir);
      s.active[i] = !absorbed;
    }
    store3(s.rad_r, s.rad_g, s.rad_b, i, rad);
  }

  if (last) {
    // The sample's harvest: gamma per sample and the depth's fallback.
    if (!live) rad = load3(s.rad_r, s.rad_g, s.rad_b, i);
    const float first = bounce == 0 ? hit_t : s.first_depth[i];
    store3(s.out_r, s.out_g, s.out_b, i,
           {sqrtf(max_nan(rad.x, 0.0f)), sqrtf(max_nan(rad.y, 0.0f)),
            sqrtf(max_nan(rad.z, 0.0f))});
    s.out_depth[i] = first >= kInf ? __ldg(s.camera + CAM_FALLBACK) : first;
  }
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

void launch_raygen_sample(const WaveState& s, const int64_t* pixel_ids, const float* u,
                          const float* v, uint32_t sample, uint32_t seed, bool defocus,
                          cudaStream_t stream) {
  // At least one block: thread 0 zeroes the segment count.
  raygen_kernel<<<grid_for(s.n), kThreads, 0, stream>>>(s, pixel_ids, u, v, sample, seed,
                                                        defocus);
}

void launch_shade_bounce(const WaveState& s, const HitColumns& hit, const ShadeScene& scene,
                         int bounce, bool last, bool cosine, cudaStream_t stream) {
  if (s.n == 0) return;
  shade_kernel<<<grid_for(s.n), kThreads, 0, stream>>>(s, hit, scene, bounce, last, cosine);
}

cudaError_t bounce_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(raygen_kernel, out);
  if (which == 1) return facts(shade_kernel, out);
  return cudaErrorInvalidValue;
}
