// The wavefront renderer's bounce body for Hopper (sm_90a): ray generation
// (K5) and shading (K6).
//
// They replace XLA code of the JAX package, not a `pl.pallas_call`: the
// jitted `trace_sample` of bevyray_tpu/engine/renderer.py, which XLA fuses
// into a few passes over the lanes a bounce.
//
// - raygen_sample (K5): the pixel's centre coordinates `pixel_uv`
//   (kernels/raygen.py:29-38) where a frame's lanes take its pixels in
//   order, the stream, jitter and lens draws and `generate_rays`
//   (renderer.py:103-112, kernels/raygen.py:40-70) and the carry's init
//   (:130-139);
// - shade_bounce (K6): the `while_loop` body (:149-200) without its ray
//   tests: the sphere and triangle hit records and their merge, the first
//   hit's depth, the sky on a miss, the material gather and emission,
//   `scatter` (kernels/shade.py) and the carry's update, with the segment
//   count; on the last bounce the sample's harvest (:207-212): its gamma
//   colour and its depth. With the frame's (or film's) sums, each bounce
//   adds its segments to their total and the last bounce adds the harvest
//   to them: the per-sample adds of `render_impl` (:215-236) and
//   `accumulate_impl` (engine/film.py:80-95).
//
// Each computes what its plain PyTorch version in kernels/bounce.py
// computes, term for term, in IEEE float32 with no contraction
// (--fmad=false), with the same draws (shade.cuh): the same bits in every
// lane. The plain `scatter` computes all three branches and selects one;
// K6 computes the chosen one only, with only its draws (a draw is a pure
// function of its key), so a NaN of a branch not taken never reaches a
// lane, as torch.where keeps it out.
//
// Bound on an H100 SXM: bytes, then the fp32 issue rate. Both kernels
// work on the state's SoA columns, which the ray tests (K1-K4) read as
// they are. A hit lane moves about 114 bytes (o, d, throughput and
// radiance read and written, the flag, the stream word, the winning test's
// t and index; 4 more with triangles, the other test's t) against a few
// hundred fp32 operations (the draws' integer hashes and one branch's
// transcendentals); a miss reads only d, the throughput, the radiance and
// the t's, and writes the radiance and the flag; a lane that is inactive
// at entry reads its flag and writes nothing but the harvest on the last
// bounce; with sums, the last bounce also reads the base's 16 bytes a lane
// (none on a frame's first sample) and writes the sums' 16. K5 writes 57
// bytes a lane and reads 16, or 0 where it takes a frame's pixels in
// order.
//
// K5 runs one thread a lane: each column read and written once, coalesced
// (lane i at thread i); a frame's lanes compute their pixel and its
// coordinates from the lane index (IEEE division, as `pixel_uv`), so no id
// or coordinate column is made or read; the stream word is computed once a
// sample and kept as 4 bytes a lane, cheaper than the pixel id's 8 that K6
// would hash again.
//
// K6. Its probe instance (clock64() by stage, and
// the warps entering each path and branch with their active lanes;
// tests/torch_shade_probe.py, chip_smoke.py 13(b)) found the one-thread-
// a-lane kernel held back by latency, not by bytes, past bounce 0: at the
// headline's bounces 1-4 a warp ran the hit path for 13, 6, 5 and 3 of its
// 32 lanes and most warps ran the sky path as well; at bounce 0 its warps
// were full (31.6 lanes) and it reached 70% of its bound. Where the live
// lanes are sparse the 32-byte sectors they share with dead lanes move too
// (chip_smoke.shade_sectors), so at bounces 2-4 the floor is 2-3 times the
// bytes the lanes need. What the design does:
//
// - each warp owns a run of 32 * kPer lanes and shades only its live ones:
//   it reads its flags (and the live lanes' t's) with every round's loads
//   in flight, lists the misses and then the hits in lane order in shared
//   memory, and takes the list 32 at a time, so a warp runs one path for up
//   to 32 lanes gathered from kPer 128-byte lines a column;
// - no block barrier orders these steps (a warp's list is its own), so a
//   warp's gathers overlap other warps' streams; the harvest is a coalesced
//   pass over the run after __syncwarp, every round's loads in flight;
// - a hit lane issues every column load but the winner's index at once, so
//   its chain is one trip to memory and two to the tables (L1/L2);
// - kPer is 1 at bounce 0 (a frame's lanes are all live there, and a list
//   fills a warp no better; 48 registers, 5 blocks a SM) and 4 later where
//   the tiles still fill the card (the runs' 60 registers cost a block a
//   SM, and the lists pay for it), as measured at every bounce of the
//   headline and config 5; with kPer 1 there is no list, and a thread
//   reads its lane's t with its flag (small launches wait on latency);
// - the segment count is one atomicAdd a block (two with sums) of the
//   warps' list lengths: an integer sum, exact and the same in every run;
// - on the last bounce the sums are added where the harvest is written, so
//   no pass over the lanes follows a sample.

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
                  const float* __restrict__ u, const float* __restrict__ v, int first, int width,
                  int height, uint32_t sample, uint32_t seed, bool defocus, SumColumns sums) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) {
    *s.segments = 0ull;
    if (sums.r != nullptr && sums.base_segments != sums.segments) {
      *sums.segments = sums.base_segments != nullptr ? *sums.base_segments : 0ull;
    }
  }
  if (i >= s.n) return;
  const float* cam = s.camera;
  uint32_t pixel;
  float pu, pv;
  if (pixel_ids != nullptr) {
    pixel = static_cast<uint32_t>(pixel_ids[i]);
    pu = u[i];
    pv = v[i];
  } else {
    // pixel_uv (kernels/raygen.py): (x + 0.5) / width, (y + 0.5) / height.
    const int p = first + i;
    const int y = p / width;
    const int x = p - y * width;
    pixel = static_cast<uint32_t>(p);
    pu = (static_cast<float>(x) + 0.5f) / static_cast<float>(width);
    pv = (static_cast<float>(y) + 0.5f) / static_cast<float>(height);
  }
  const uint32_t stream = stream_init(pixel, sample, seed);
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
  const float ndc_x = (pu * 2.0f - 1.0f) + (ju - 0.5f) / __ldg(cam + CAM_WIDTH);
  const float ndc_y = (1.0f - pv * 2.0f) + (jv - 0.5f) / __ldg(cam + CAM_HEIGHT);
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

// The probe instance's sums of one thread (ShadeProbeSlot order): cycles
// by stage, and at the entry of each path and branch the warps entering
// (counted by the first active lane) and their active lanes.
struct ShadeClock {
  unsigned long long c[kShadeProbeSlots];
};

template <bool kProbe>
__device__ __forceinline__ long long tick() {
  return kProbe ? clock64() : 0;
}

template <bool kProbe>
__device__ __forceinline__ void tock(ShadeClock& clk, int slot, long long& since) {
  if (kProbe) {
    const long long now = clock64();
    clk.c[slot] += static_cast<unsigned long long>(now - since);
    since = now;
  }
}

template <bool kProbe>
__device__ __forceinline__ void enter(ShadeClock& clk, int warps_slot) {
  if (kProbe) {
    const unsigned mask = __activemask();
    if (static_cast<int>(threadIdx.x & 31) == __ffs(mask) - 1) {
      clk.c[warps_slot] += 1;
      clk.c[warps_slot + 1] += __popc(mask);
    }
  }
}

// K6's tiles: block b owns lanes [b * kPer * kThreads, (b + 1) * kPer *
// kThreads) of the state, kPer = 1, 2 or 4 (the wrapper's
// `shade_tiles`), and its warp w the run of 32 * kPer lanes from
// (b * kWarps + w) * 32 * kPer: lane run + j * 32 + lane_id in round j.
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// A miss picks up the sky and ends the path: live lane i of
// shade_bounce_reference whose tests both missed.
template <bool kProbe>
__device__ __forceinline__ void shade_miss(const WaveState& s, int i, ShadeClock& clk,
                                           long long& t_stage) {
  enter<kProbe>(clk, kPMissWarps);
  const V3 d = load3(s.dx, s.dy, s.dz, i);
  const V3 ray_color = load3(s.color_r, s.color_g, s.color_b, i);
  const V3 rad = load3(s.rad_r, s.rad_g, s.rad_b, i);
  store3(s.rad_r, s.rad_g, s.rad_b, i, add(rad, mul(ray_color, sky(d))));
  s.active[i] = false;
  tock<kProbe>(clk, kPMiss, t_stage);
}

// Live lane i of shade_bounce_reference whose nearest hit is a sphere's or
// a triangle's, term for term: the hit record, the material and
// `scatter`'s chosen branch; its radiance, throughput, ray and flag
// written. Every column it reads but the winner's index is read at once.
template <bool kProbe>
__device__ __forceinline__ void shade_hit(const WaveState& s, const HitColumns& hit,
                                          const ShadeScene& sc, int i, int bounce, bool cosine,
                                          bool tris, ShadeClock& clk, long long& t_stage) {
  enter<kProbe>(clk, kPRecordWarps);
  // merge_hits: the triangle wins only with a strictly smaller t.
  const float t = hit.t[i];
  const float tt = tris ? hit.tri_t[i] : kInf;
  const V3 d = load3(s.dx, s.dy, s.dz, i);
  const V3 ray_color = load3(s.color_r, s.color_g, s.color_b, i);
  V3 rad = load3(s.rad_r, s.rad_g, s.rad_b, i);
  const V3 o = load3(s.ox, s.oy, s.oz, i);
  const int64_t sphere_index = hit.index[i];
  const ExactDraws draws(s.stream[i], 0);
  const bool tri_wins = tris && tt < t;
  V3 position, n;
  int material;
  if (tri_wins) {
    // tt < t <= f32 max: the triangle test hit (make_hit_info /
    // triangle_hit_info).
    const int row = row_of(hit.tri_index[i], sc.n_tris);
    const V3 a = {__ldg(sc.tri[0] + row), __ldg(sc.tri[1] + row), __ldg(sc.tri[2] + row)};
    const V3 b = {__ldg(sc.tri[3] + row), __ldg(sc.tri[4] + row), __ldg(sc.tri[5] + row)};
    const V3 c = {__ldg(sc.tri[6] + row), __ldg(sc.tri[7] + row), __ldg(sc.tri[8] + row)};
    n = normalize(cross(sub(b, a), sub(c, a)));
    position = add(o, scale(d, tt));
    material = __ldg(sc.tri_material + row);
  } else {
    const bool sphere_miss = t >= kInf;
    const int row = row_of(sphere_index, sc.n_spheres);
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
  if (kProbe) {
    // Wait for the gathers here, so that their time is this stage's.
    asm volatile("" ::"f"(base_color.x), "f"(metallic), "f"(roughness), "f"(ior),
                 "f"(transmission), "f"(rad.x), "r"(draws.stream));
  }
  tock<kProbe>(clk, kPRecord, t_stage);

  // scatter (kernels/shade.py), the chosen branch only.
  const bool is_metal = draws.u_metal(bounce) < metallic;
  const bool is_glass = !is_metal && draws.u_trans(bounce) < transmission;
  tock<kProbe>(clk, kPDraws, t_stage);
  V3 dir;
  V3 attenuation = base_color;
  bool absorbed;
  if (is_metal) {
    enter<kProbe>(clk, kPMetalWarps);
    dir = add(normalize(reflect(d, n)), scale(draws.ball1(bounce), roughness));
    absorbed = dot(dir, n) < 0.0f;
  } else if (is_glass) {
    enter<kProbe>(clk, kPGlassWarps);
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
    enter<kProbe>(clk, kPDiffuseWarps);
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
  tock<kProbe>(clk, kPBranch, t_stage);
  if (!absorbed) store3(s.color_r, s.color_g, s.color_b, i, mul(ray_color, attenuation));
  store3(s.ox, s.oy, s.oz, i, position);
  store3(s.dx, s.dy, s.dz, i, dir);
  store3(s.rad_r, s.rad_g, s.rad_b, i, rad);
  s.active[i] = !absorbed;
  tock<kProbe>(clk, kPStores, t_stage);
}

// K6: shade_bounce_reference, each warp over its own run of 32 * kPer
// lanes, in four steps without a block barrier:
// (a) Classify: the warp reads its lanes' flags, 32 consecutive lanes a
//     round, every round's loads in flight at once; then the t's of the
//     live lanes (of every lane at bounce 0, for the first depth, and with
//     one lane a thread), and each live lane is a miss or a hit. A ballot a round and class holds
//     the classes as bit masks.
// (b) Compact: each live lane writes its offset in the run to its place
//     in the warp's list in shared memory: the misses, then the hits, each
//     in lane order.
// (c) Shade: the warp takes its list 32 entries at a time, so that it
//     shades up to 32 misses or up to 32 hits (both where the misses end
//     inside them) from a window of kPer 128-byte lines a column. With
//     one lane a thread (kPer 1) there is no list: each thread shades its
//     own lane, as a one-thread-a-lane kernel does.
// (d) Harvest, on the last bounce: after __syncwarp, so that it reads the
//     radiance (c) wrote, a coalesced pass over every lane of the run, each
//     thread's kPer lanes read at once, then written.
// The segment count is the live lanes of the block's lists: one atomicAdd
// a block (two with sums), after the only barrier. Every read of a lane
// comes before that lane's write, in one thread or across __syncwarp, so
// the state and `sums` (which may be `base`) are updated in place.
template <int kPer, bool kProbe>
__global__ void __launch_bounds__(kThreads)
    shade_kernel(WaveState s, HitColumns hit, ShadeScene sc, SumColumns sums, int bounce,
                 bool last, bool cosine, unsigned long long* probe) {
  __shared__ uint8_t s_list[kWarps][32 * kPer];
  __shared__ int s_live;
  ShadeClock clk;
  if (kProbe) {
    for (int k = 0; k < kShadeProbeSlots; ++k) clk.c[k] = 0;
  }
  const long long t_start = tick<kProbe>();
  long long t_stage = t_start;
  const int warp = threadIdx.x >> 5;
  const int lane_id = threadIdx.x & 31;
  const int run = (blockIdx.x * kWarps + warp) * 32 * kPer;   // the warp's first lane
  const bool tris = hit.tri_t != nullptr;
  if (threadIdx.x == 0) s_live = 0;

  // (a)
  bool live[kPer];
  float t[kPer], tt[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = run + j * 32 + lane_id;
    live[j] = i < s.n && s.active[i];
    t[j] = tt[j] = kInf;
  }
  if (bounce == 0 || kPer == 1) {
    // Every lane's t's, with the flags: at bounce 0 for the first depth;
    // with one lane a thread (small launches) to save the flags' round
    // trip, for 4 bytes a dead lane.
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = run + j * 32 + lane_id;
      if (i < s.n) {
        t[j] = hit.t[i];
        if (tris) tt[j] = hit.tri_t[i];
        // The merged hit's t, every lane, as the plain version.
        if (bounce == 0) s.first_depth[i] = tris && tt[j] < t[j] ? tt[j] : t[j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = run + j * 32 + lane_id;
      if (live[j]) {
        t[j] = hit.t[i];
        if (tris) tt[j] = hit.tri_t[i];
      }
    }
  }
  unsigned miss_mask[kPer], hit_mask[kPer];
  int n_miss = 0, n_live = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool is_miss = live[j] && t[j] >= kInf && (!tris || tt[j] >= kInf);
    miss_mask[j] = __ballot_sync(kFullMask, is_miss);
    hit_mask[j] = __ballot_sync(kFullMask, live[j] && !is_miss);
    n_miss += __popc(miss_mask[j]);
    n_live += __popc(miss_mask[j]) + __popc(hit_mask[j]);
  }
  tock<kProbe>(clk, kPClassify, t_stage);

  if (kPer == 1) {
    // One lane a thread: a list would hold the warp's own lanes in another
    // order and fill it no better, so each thread shades its lane.
    tock<kProbe>(clk, kPCompact, t_stage);
    if ((hit_mask[0] >> lane_id) & 1u) {
      shade_hit<kProbe>(s, hit, sc, run + lane_id, bounce, cosine, tris, clk, t_stage);
    } else if ((miss_mask[0] >> lane_id) & 1u) {
      shade_miss<kProbe>(s, run + lane_id, clk, t_stage);
    }
  } else {
    // (b)
    const unsigned below = (1u << lane_id) - 1u;
    int miss_at = 0, hit_at = n_miss;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const uint8_t offset = static_cast<uint8_t>(j * 32 + lane_id);
      if ((miss_mask[j] >> lane_id) & 1u) {
        s_list[warp][miss_at + __popc(miss_mask[j] & below)] = offset;
      } else if ((hit_mask[j] >> lane_id) & 1u) {
        s_list[warp][hit_at + __popc(hit_mask[j] & below)] = offset;
      }
      miss_at += __popc(miss_mask[j]);
      hit_at += __popc(hit_mask[j]);
    }
    __syncwarp();
    tock<kProbe>(clk, kPCompact, t_stage);

    // (c)
    for (int e = lane_id; e < n_live; e += 32) {
      const int i = run + s_list[warp][e];
      if (e < n_miss) {
        shade_miss<kProbe>(s, i, clk, t_stage);
      } else {
        shade_hit<kProbe>(s, hit, sc, i, bounce, cosine, tris, clk, t_stage);
      }
    }
  }

  // (d) The sample's harvest: gamma per sample and the depth's fallback.
  if (last) {
    __syncwarp();
    const float fallback = __ldg(s.camera + CAM_FALLBACK);
    const bool base = sums.base_r != nullptr;
    V3 rad[kPer];
    float first_depth[kPer];
    float4 prior[kPer];   // the base's r, g, b, depth
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = run + j * 32 + lane_id;
      if (i < s.n) {
        rad[j] = load3(s.rad_r, s.rad_g, s.rad_b, i);
        first_depth[j] = s.first_depth[i];
        prior[j] = base ? make_float4(sums.base_r[i], sums.base_g[i], sums.base_b[i],
                                      sums.base_depth[i])
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = run + j * 32 + lane_id;
      if (i >= s.n) break;
      const V3 c = {sqrtf(max_nan(rad[j].x, 0.0f)), sqrtf(max_nan(rad[j].y, 0.0f)),
                    sqrtf(max_nan(rad[j].z, 0.0f))};
      const float depth = first_depth[j] >= kInf ? fallback : first_depth[j];
      store3(s.out_r, s.out_g, s.out_b, i, c);
      s.out_depth[i] = depth;
      if (sums.r != nullptr) {
        // base + harvest; a frame's first sample adds to 0.0f, as torch's
        // zeros + harvest does (a -0.0 harvest gives +0.0).
        sums.r[i] = prior[j].x + c.x;
        sums.g[i] = prior[j].y + c.y;
        sums.b[i] = prior[j].z + c.z;
        sums.depth[i] = prior[j].w + depth;
      }
    }
    tock<kProbe>(clk, kPHarvest, t_stage);
  }

  // segments + active.sum(), the lanes active at entry.
  __syncthreads();
  if (lane_id == 0 && n_live > 0) atomicAdd(&s_live, n_live);
  __syncthreads();
  if (threadIdx.x == 0 && s_live > 0) {
    atomicAdd(s.segments, static_cast<unsigned long long>(s_live));
    if (sums.r != nullptr) atomicAdd(sums.segments, static_cast<unsigned long long>(s_live));
  }

  if (kProbe) {
    clk.c[kPTotal] += static_cast<unsigned long long>(clock64() - t_start);
    __shared__ unsigned long long s_clk[kShadeProbeSlots];
    if (threadIdx.x < kShadeProbeSlots) s_clk[threadIdx.x] = 0;
    __syncthreads();
    for (int k = 0; k < kShadeProbeSlots; ++k) {
      if (clk.c[k] != 0) atomicAdd(&s_clk[k], clk.c[k]);
    }
    __syncthreads();
    if (threadIdx.x < kShadeProbeSlots && s_clk[threadIdx.x] != 0) {
      atomicAdd(probe + threadIdx.x, s_clk[threadIdx.x]);
    }
  }
}

template <int kPer>
void launch_shade_tiles(const WaveState& s, const HitColumns& hit, const ShadeScene& scene,
                        const SumColumns& sums, int bounce, bool last, bool cosine, int tiles,
                        unsigned long long* probe, cudaStream_t stream) {
  if (probe != nullptr) {
    shade_kernel<kPer, true><<<tiles, kThreads, 0, stream>>>(s, hit, scene, sums, bounce, last,
                                                             cosine, probe);
  } else {
    shade_kernel<kPer, false><<<tiles, kThreads, 0, stream>>>(s, hit, scene, sums, bounce,
                                                              last, cosine, nullptr);
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
                          const float* v, int first, int width, int height, uint32_t sample,
                          uint32_t seed, bool defocus, const SumColumns& sums,
                          cudaStream_t stream) {
  // At least one block: thread 0 zeroes the segment count.
  raygen_kernel<<<grid_for(s.n), kThreads, 0, stream>>>(s, pixel_ids, u, v, first, width,
                                                        height, sample, seed, defocus, sums);
}

void launch_shade_bounce(const WaveState& s, const HitColumns& hit, const ShadeScene& scene,
                         const SumColumns& sums, int bounce, bool last, bool cosine, int per,
                         int tiles, unsigned long long* probe, cudaStream_t stream) {
  if (s.n == 0) return;
  if (per == 1) {
    launch_shade_tiles<1>(s, hit, scene, sums, bounce, last, cosine, tiles, probe, stream);
  } else if (per == 2) {
    launch_shade_tiles<2>(s, hit, scene, sums, bounce, last, cosine, tiles, probe, stream);
  } else {
    launch_shade_tiles<4>(s, hit, scene, sums, bounce, last, cosine, tiles, probe, stream);
  }
}

cudaError_t bounce_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(raygen_kernel, out);
  // The instance of the headline's lanes (4 a thread on 132 SMs).
  if (which == 1) return facts(shade_kernel<4, false>, out);
  if (which == 2) return facts(shade_kernel<4, true>, out);
  return cudaErrorInvalidValue;
}
