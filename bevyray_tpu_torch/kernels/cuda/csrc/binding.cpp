// Python binding of the fused path-tracing kernel (megakernel.cu), the
// wavefront ray tests (wavefront.cu), the wavefront bounce body (bounce.cu),
// the image kernels: the denoiser (denoise.cu) and the raster layer
// (raster.cu), the frame's tail and the film pass's fold (frame.cu), the
// camera row (camera.cu), and the adaptive pass's map and fold and the
// sharded step's sums and tp hit merge (passes.cu). The one source that includes PyTorch's
// headers: it checks the tensors, launches on PyTorch's current stream and
// checks the launch.

#include <torch/extension.h>

#include <algorithm>
#include <map>
#include <vector>
#include <string>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "bounce.h"
#include "camera.h"
#include "frame.h"
#include "image.h"
#include "megakernel.h"
#include "passes.h"
#include "wavefront.h"

namespace {

constexpr int64_t kNCam = 24;
constexpr int64_t kNAttr = 13;
constexpr int64_t kNTri = 10;
constexpr int64_t kTile = 64 * 64;
constexpr int64_t kSlRows = 5;
constexpr int64_t kSlChunk = 8;
constexpr int64_t kSlMax = 512;

void check_f32(const torch::Tensor& t, const torch::Tensor& like, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on the scene's device");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// `sl`/`slmeta` are read only when `split`; `gaabb`'s candidate columns only
// when `candidates`; `spp_map` (int32, one target per lane) only when it is
// not empty; the first `n_tris` rows of `tri` only when it is not 0.
// `fast_rng` takes the fast draw path with `draw_words` words per bounce;
// `fuse` pixel blocks share a work item's lane positions (the split only);
// `grid` CUDA blocks take the items. `counters` holds two int64 zeros: the
// segment count and the work counter. A non-empty `probe` (kProbeSlots
// int64 zeros) launches the probe instance of the default kernel.
void render_tiles(const torch::Tensor& cam, const torch::Tensor& sph,
                  const torch::Tensor& attr, const torch::Tensor& gaabb,
                  const torch::Tensor& tri, int64_t n_tris,
                  const torch::Tensor& sl, const torch::Tensor& slmeta,
                  const torch::Tensor& spp_map,
                  torch::Tensor out_r, torch::Tensor out_g, torch::Tensor out_b,
                  torch::Tensor out_depth, torch::Tensor counters, int64_t nbx,
                  int64_t block_offset,
                  int64_t width, int64_t height, int64_t spp, int64_t bounces,
                  int64_t seed, int64_t sample_offset, double inv_spp,
                  int64_t level, bool defocus,
                  bool cosine, bool split, bool candidates, int64_t gc,
                  int64_t n_cand, int64_t cand_off, bool fast_rng,
                  int64_t draw_words, int64_t fuse, int64_t grid,
                  const torch::Tensor& probe) {
  check_f32(sph, sph, "sph");
  check_f32(cam, sph, "cam");
  check_f32(attr, sph, "attr");
  check_f32(gaabb, sph, "gaabb");
  check_f32(tri, sph, "tri");
  TORCH_CHECK(cam.numel() == kNCam, "cam must hold ", kNCam, " floats");
  TORCH_CHECK(sph.dim() == 2 && sph.size(0) == 4 && sph.size(1) > 0,
              "sph must be (4, S)");
  TORCH_CHECK(attr.dim() == 2 && attr.size(0) == kNAttr && attr.size(1) >= sph.size(1),
              "attr must be (13, >= S)");
  TORCH_CHECK(gaabb.dim() == 2 && gaabb.size(0) == 6, "gaabb must be (6, columns)");
  TORCH_CHECK(tri.dim() == 2 && tri.size(0) == kNTri, "tri must be (10, T)");
  TORCH_CHECK(n_tris >= 0 && n_tris <= tri.size(1) &&
                  attr.size(1) >= sph.size(1) + n_tris,
              "n_tris must lie in [0, T] and attr must hold a column per live triangle");
  const int64_t n_lanes = out_r.numel();
  const int64_t n_tiles = n_lanes / kTile;
  TORCH_CHECK(n_lanes > 0 && n_lanes % kTile == 0, "outputs must cover whole 64x64 blocks");
  // A launch renders n_tiles blocks from global block block_offset: the whole
  // grid, or one shard's range of a grid padded to a multiple of the shards.
  TORCH_CHECK(nbx == (width + 63) / 64, "nbx must be the frame's blocks per row");
  TORCH_CHECK(block_offset >= 0 && block_offset + n_tiles < (int64_t{1} << 31) &&
                  n_tiles * (kTile / 256) < (int64_t{1} << 31),
              "block_offset must be >= 0 and the blocks' indices and 256-lane units must "
              "fit in int32");
  for (const auto* out : {&out_r, &out_g, &out_b, &out_depth}) {
    check_f32(*out, sph, "outputs");
    TORCH_CHECK(out->numel() == n_lanes, "outputs must have equal sizes");
  }
  for (const torch::Tensor* t : {static_cast<const torch::Tensor*>(&counters), &probe}) {
    TORCH_CHECK(t->is_cuda() && t->device() == sph.device() &&
                    t->scalar_type() == torch::kInt64 && t->is_contiguous(),
                "counters and probe must be int64 tensors on the scene's device");
  }
  TORCH_CHECK(counters.numel() == 2, "counters must hold two int64: segments, work");
  const bool has_probe = probe.numel() > 0;
  TORCH_CHECK(!has_probe || (probe.numel() == kProbeSlots && split && candidates && fast_rng),
              "the probe takes kProbeSlots int64 and the split/candidates fast instance");
  TORCH_CHECK(grid >= 1 && grid < (int64_t{1} << 31), "grid must be a positive int32");
  TORCH_CHECK(spp >= 1 && bounces >= 0, "spp must be >= 1 and bounces >= 0");
  TORCH_CHECK(!candidates || (gc > 0 && n_cand > 0 && cand_off >= 0 &&
                              cand_off + n_cand <= gaabb.size(1) &&
                              n_cand * gc >= sph.size(1)),
              "candidate groups must cover the table and have gaabb columns");
  int64_t sl_cap = 0;
  if (split) {
    check_f32(sl, sph, "sl");
    check_f32(slmeta, sph, "slmeta");
    sl_cap = sl.dim() == 3 ? sl.size(2) : 0;
    TORCH_CHECK(sl_cap >= kSlChunk && sl_cap <= kSlMax && sl_cap % kSlChunk == 0 &&
                    sl.size(0) == n_tiles && sl.size(1) == kSlRows,
                "sl must be (n_tiles, 5, K) with K a multiple of 8 up to 512");
    TORCH_CHECK(slmeta.dim() == 2 && slmeta.size(0) == n_tiles &&
                    slmeta.size(1) == 1 + sl_cap / kSlChunk,
                "slmeta must be (n_tiles, 1 + K/8)");
  }
  const bool has_map = spp_map.numel() > 0;
  if (has_map) {
    TORCH_CHECK(spp_map.is_cuda() && spp_map.device() == sph.device(),
                "spp_map must be a CUDA tensor on the scene's device");
    TORCH_CHECK(spp_map.scalar_type() == torch::kInt32 && spp_map.is_contiguous() &&
                    spp_map.numel() == n_lanes,
                "spp_map must be contiguous int32 with one target per lane");
  }
  TORCH_CHECK(sample_offset >= 0 && sample_offset <= 0xFFFFFFFFLL,
              "sample_offset must lie in [0, 2^32)");
  TORCH_CHECK(!fast_rng || draw_words == 6 || draw_words == 9 || draw_words == 13,
              "the fast path takes 6, 9 or 13 words per bounce");
  TORCH_CHECK(fuse == 1 || (split && (fuse == 2 || fuse == 4 || fuse == 8)),
              "fuse must be 1, or 2, 4 or 8 with the split");

  RenderArgs args{};
  args.cam = cam.data_ptr<float>();
  args.sph = sph.data_ptr<float>();
  args.attr = attr.data_ptr<float>();
  args.gaabb = gaabb.data_ptr<float>();
  args.tri = n_tris > 0 ? tri.data_ptr<float>() : nullptr;
  args.sl = split ? sl.data_ptr<float>() : nullptr;
  args.slmeta = split ? slmeta.data_ptr<float>() : nullptr;
  args.spp_map = has_map ? spp_map.data_ptr<int32_t>() : nullptr;
  args.out_r = out_r.data_ptr<float>();
  args.out_g = out_g.data_ptr<float>();
  args.out_b = out_b.data_ptr<float>();
  args.out_depth = out_depth.data_ptr<float>();
  args.counters = reinterpret_cast<unsigned long long*>(counters.data_ptr<int64_t>());
  args.probe =
      has_probe ? reinterpret_cast<unsigned long long*>(probe.data_ptr<int64_t>()) : nullptr;
  args.n_spheres = static_cast<int>(sph.size(1));
  args.attr_stride = static_cast<int>(attr.size(1));
  args.gaabb_stride = static_cast<int>(gaabb.size(1));
  args.tri_stride = static_cast<int>(tri.size(1));
  args.n_tris_live = static_cast<int>(n_tris);
  args.n_tiles = static_cast<int>(n_tiles);
  args.block_offset = static_cast<int>(block_offset);
  args.nbx = static_cast<int>(nbx);
  args.width = static_cast<int>(width);
  args.height = static_cast<int>(height);
  args.spp = static_cast<int>(spp);
  args.bounces = static_cast<int>(bounces);
  args.seed = static_cast<unsigned int>(seed & 0xFFFFFFFF);
  args.sample_offset = static_cast<unsigned int>(sample_offset);
  args.inv_spp = static_cast<float>(inv_spp);
  args.level = static_cast<int>(level);
  args.defocus = defocus ? 1 : 0;
  args.cosine = cosine ? 1 : 0;
  args.split = split ? 1 : 0;
  args.candidates = candidates ? 1 : 0;
  args.sl_cap = static_cast<int>(sl_cap);
  args.gc = static_cast<int>(gc);
  args.n_cand = static_cast<int>(n_cand);
  args.cand_off = static_cast<int>(cand_off);
  args.fast_rng = fast_rng ? 1 : 0;
  args.draw_words = static_cast<int>(draw_words);
  args.fuse = static_cast<int>(fuse);
  args.grid = static_cast<int>(grid);

  const c10::cuda::CUDAGuard guard(sph.device());
  C10_CUDA_CHECK(launch_render_tiles(args, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers, spills, shared memory and resident blocks per SM of one kernel
// instance at `fuse` staged shortlists of `sl_cap` entries, and the SM count,
// on CUDA device `device`.
std::map<std::string, int64_t> instance_info(int64_t device, bool split, bool candidates,
                                             bool fast, bool probe, int64_t fuse,
                                             int64_t sl_cap) {
  TORCH_CHECK(fuse >= 1 && fuse <= 8 && sl_cap >= 0 && sl_cap <= kSlMax,
              "fuse must lie in [1, 8] and sl_cap in [0, 512]");
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  KernelInfo info{};
  C10_CUDA_CHECK(::kernel_info(split, candidates, fast, probe, static_cast<int>(fuse),
                               static_cast<int>(sl_cap), &info));
  return {{"num_regs", info.num_regs},         {"local_bytes", info.local_bytes},
          {"static_smem", info.static_smem},   {"dynamic_smem", info.dynamic_smem},
          {"blocks_per_sm", info.blocks_per_sm}, {"n_sms", info.n_sms}};
}

// ---- the wavefront kernels ---------------------------------------------------

const float* column(const torch::Tensor& t, int64_t n, const torch::Tensor& like,
                    const char* name) {
  check_f32(t, like, name);
  TORCH_CHECK(t.dim() == 1 && t.numel() == n, name, " must hold ", n, " floats");
  return t.data_ptr<float>();
}

const bool* flags(const torch::Tensor& t, int64_t n, const torch::Tensor& like,
                  const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                  t.scalar_type() == torch::kBool && t.is_contiguous() && t.numel() == n,
              name, " must be a contiguous bool tensor of ", n, " lanes on the rays' device");
  return t.data_ptr<bool>();
}

const int* ints(const torch::Tensor& t, int64_t n, const torch::Tensor& like,
                const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                  t.scalar_type() == torch::kInt32 && t.is_contiguous() && t.numel() == n,
              name, " must be a contiguous int32 tensor of ", n, " rows on the rays' device");
  return t.data_ptr<int32_t>();
}

int32_t rows(int64_t n, const char* name) {
  TORCH_CHECK(n >= 0 && n < (int64_t{1} << 31), name, " must have fewer than 2^31 rows");
  return static_cast<int32_t>(n);
}

// `rays`: ox, oy, oz, dx, dy, dz (float32, n lanes each); `active`: n bools
// or an empty tensor (every lane); `out_t`/`out_i`: float32 / int64, n each.
RayBatch ray_batch(const std::vector<torch::Tensor>& rays, const torch::Tensor& active,
                   const torch::Tensor& out_t, const torch::Tensor& out_i) {
  TORCH_CHECK(rays.size() == 6, "rays must be ox, oy, oz, dx, dy, dz");
  const torch::Tensor& like = rays[0];
  const int64_t n = like.numel();
  RayBatch b{};
  b.n = rows(n, "rays");
  b.ox = column(rays[0], n, like, "ox");
  b.oy = column(rays[1], n, like, "oy");
  b.oz = column(rays[2], n, like, "oz");
  b.dx = column(rays[3], n, like, "dx");
  b.dy = column(rays[4], n, like, "dy");
  b.dz = column(rays[5], n, like, "dz");
  b.active = active.numel() == 0 ? nullptr : flags(active, n, like, "active");
  column(out_t, n, like, "out_t");
  TORCH_CHECK(out_i.is_cuda() && out_i.device() == like.device() &&
                  out_i.scalar_type() == torch::kInt64 && out_i.is_contiguous() &&
                  out_i.numel() == n,
              "out_i must be a contiguous int64 tensor of one lane per ray");
  return b;
}

// `spheres`: cx, cy, cz, radius (float32), valid (bool), S rows each.
SphereTable sphere_table(const std::vector<torch::Tensor>& spheres, const torch::Tensor& like) {
  TORCH_CHECK(spheres.size() == 5, "spheres must be cx, cy, cz, radius, valid");
  const int64_t n = spheres[0].numel();
  TORCH_CHECK(n > 0, "the sphere table must have rows");
  return {column(spheres[0], n, like, "cx"), column(spheres[1], n, like, "cy"),
          column(spheres[2], n, like, "cz"), column(spheres[3], n, like, "radius"),
          flags(spheres[4], n, like, "valid"), rows(n, "spheres")};
}

// `tris`: ax, ay, az, bx, by, bz, cx, cy, cz (float32), valid (bool).
TriangleTable triangle_table(const std::vector<torch::Tensor>& tris, const torch::Tensor& like) {
  TORCH_CHECK(tris.size() == 10, "triangles must be ax, ay, az, bx, by, bz, cx, cy, cz, valid");
  const int64_t n = tris[0].numel();
  TORCH_CHECK(n > 0, "the triangle table must have rows");
  const float* c[9];
  for (int k = 0; k < 9; ++k) c[k] = column(tris[k], n, like, "triangle corners");
  return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
          flags(tris[9], n, like, "valid"), rows(n, "triangles")};
}

// `bvh`: min xyz, max xyz (float32), index, count (int32), N rows each,
// then prim_ids (int32) or an empty tensor.
BvhTable bvh_table(const std::vector<torch::Tensor>& bvh, int64_t stack_size,
                   int64_t max_leaf_size, const torch::Tensor& like) {
  TORCH_CHECK(bvh.size() == 9, "bvh must be min xyz, max xyz, index, count, prim_ids");
  TORCH_CHECK(stack_size >= 1 && stack_size <= kMaxStack, "stack_size must lie in [1, ",
              kMaxStack, "]");
  TORCH_CHECK(max_leaf_size >= 1 && max_leaf_size < (int64_t{1} << 31),
              "max_leaf_size must be a positive int32");
  const int64_t n = bvh[0].numel();
  TORCH_CHECK(n > 0, "the BVH must have nodes");
  BvhTable b{};
  b.min_x = column(bvh[0], n, like, "min_x");
  b.min_y = column(bvh[1], n, like, "min_y");
  b.min_z = column(bvh[2], n, like, "min_z");
  b.max_x = column(bvh[3], n, like, "max_x");
  b.max_y = column(bvh[4], n, like, "max_y");
  b.max_z = column(bvh[5], n, like, "max_z");
  b.index = ints(bvh[6], n, like, "index");
  b.count = ints(bvh[7], n, like, "count");
  b.n_nodes = rows(n, "bvh");
  const int64_t n_ids = bvh[8].numel();
  b.prim_ids = n_ids == 0 ? nullptr : ints(bvh[8], n_ids, like, "prim_ids");
  b.n_prim_ids = rows(n_ids, "prim_ids");
  b.stack_size = static_cast<int>(stack_size);
  b.max_leaf_size = static_cast<int>(max_leaf_size);
  return b;
}

void intersect_spheres(const std::vector<torch::Tensor>& rays, const torch::Tensor& active,
                       const std::vector<torch::Tensor>& spheres, torch::Tensor out_t,
                       torch::Tensor out_i) {
  const RayBatch b = ray_batch(rays, active, out_t, out_i);
  const SphereTable tab = sphere_table(spheres, rays[0]);
  const c10::cuda::CUDAGuard guard(rays[0].device());
  launch_intersect_spheres(b, tab, out_t.data_ptr<float>(), out_i.data_ptr<int64_t>(),
                           c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void intersect_triangles(const std::vector<torch::Tensor>& rays, const torch::Tensor& active,
                         const std::vector<torch::Tensor>& tris, torch::Tensor out_t,
                         torch::Tensor out_i) {
  const RayBatch b = ray_batch(rays, active, out_t, out_i);
  const TriangleTable tab = triangle_table(tris, rays[0]);
  const c10::cuda::CUDAGuard guard(rays[0].device());
  launch_intersect_triangles(b, tab, out_t.data_ptr<float>(), out_i.data_ptr<int64_t>(),
                             c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// `walk`: the paired-child record of a sphere BVH (core/types.py
// SphereWalk): nodes (int32, N x 16), rows (float32, S x 4) and prims
// (int32, S), one slot a leaf slot.
SphereWalk sphere_walk(const std::vector<torch::Tensor>& walk, int64_t stack_size,
                       int64_t max_leaf_size, const torch::Tensor& like) {
  TORCH_CHECK(walk.size() == 3, "walk must be nodes, rows, prims");
  TORCH_CHECK(stack_size >= 1 && stack_size <= kMaxStack, "stack_size must lie in [1, ",
              kMaxStack, "]");
  TORCH_CHECK(max_leaf_size >= 1 && max_leaf_size < (int64_t{1} << 31),
              "max_leaf_size must be a positive int32");
  TORCH_CHECK(walk[0].dim() == 2 && walk[0].size(1) == 16 && walk[0].size(0) > 0,
              "walk nodes must be (nodes, 16) with nodes > 0");
  TORCH_CHECK(walk[1].dim() == 2 && walk[1].size(1) == 4 && walk[1].size(0) > 0,
              "walk rows must be (slots, 4) with slots > 0");
  const int64_t n_nodes = walk[0].size(0);
  const int64_t n_slots = walk[1].size(0);
  SphereWalk w{};
  w.nodes = reinterpret_cast<const int4*>(ints(walk[0].view({-1}), 16 * n_nodes, like,
                                               "walk nodes"));
  w.rows = reinterpret_cast<const float4*>(
      column(walk[1].view({-1}), 4 * n_slots, like, "walk rows"));
  w.prims = ints(walk[2], n_slots, like, "walk prims");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(w.nodes) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w.rows) % 16 == 0,
              "walk nodes and rows must be 16-byte aligned");
  w.n_nodes = rows(n_nodes, "walk nodes");
  w.n_slots = rows(n_slots, "walk rows");
  w.stack_size = static_cast<int>(stack_size);
  w.max_leaf_size = static_cast<int>(max_leaf_size);
  return w;
}

void intersect_bvh(const std::vector<torch::Tensor>& rays, const torch::Tensor& active,
                   const std::vector<torch::Tensor>& walk, int64_t stack_size,
                   int64_t max_leaf_size, torch::Tensor out_t, torch::Tensor out_i) {
  const RayBatch b = ray_batch(rays, active, out_t, out_i);
  const SphereWalk w = sphere_walk(walk, stack_size, max_leaf_size, rays[0]);
  const c10::cuda::CUDAGuard guard(rays[0].device());
  launch_intersect_bvh(b, w, out_t.data_ptr<float>(), out_i.data_ptr<int64_t>(),
                       c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void intersect_bvh_triangles(const std::vector<torch::Tensor>& rays,
                             const torch::Tensor& active, const std::vector<torch::Tensor>& bvh,
                             int64_t stack_size, int64_t max_leaf_size,
                             const std::vector<torch::Tensor>& tris, torch::Tensor out_t,
                             torch::Tensor out_i) {
  const RayBatch b = ray_batch(rays, active, out_t, out_i);
  const BvhTable tree = bvh_table(bvh, stack_size, max_leaf_size, rays[0]);
  const TriangleTable tab = triangle_table(tris, rays[0]);
  const c10::cuda::CUDAGuard guard(rays[0].device());
  launch_intersect_bvh_triangles(b, tree, tab, out_t.data_ptr<float>(),
                                 out_i.data_ptr<int64_t>(),
                                 c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// ---- the bounce body ---------------------------------------------------------

const int64_t* longs(const torch::Tensor& t, int64_t n, const torch::Tensor& like,
                     const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                  t.scalar_type() == torch::kInt64 && t.is_contiguous() && t.numel() == n,
              name, " must be a contiguous int64 tensor of ", n, " lanes on the state's device");
  return t.data_ptr<int64_t>();
}

float* lane_floats(torch::Tensor t, int64_t n, const torch::Tensor& like, const char* name) {
  return const_cast<float*>(column(t, n, like, name));
}

// `state`: ox, oy, oz, dx, dy, dz, ray_color r, g, b, radiance r, g, b
// (float32), active (bool), first_depth (float32), stream (int32), n lanes
// each; segments (one int64); the harvest's r, g, b, depth (float32, n
// each); the camera row (CAM_FLOATS float32).
WaveState wave_state(const std::vector<torch::Tensor>& state) {
  TORCH_CHECK(state.size() == 21, "state must be the 21 columns of a SampleState");
  const torch::Tensor& like = state[0];
  const int64_t n = like.numel();
  WaveState s{};
  s.n = rows(n, "state");
  float** cols[] = {&s.ox, &s.oy, &s.oz, &s.dx, &s.dy, &s.dz, &s.color_r, &s.color_g,
                    &s.color_b, &s.rad_r, &s.rad_g, &s.rad_b};
  for (int k = 0; k < 12; ++k) *cols[k] = lane_floats(state[k], n, like, "state columns");
  s.active = const_cast<bool*>(flags(state[12], n, like, "active"));
  s.first_depth = lane_floats(state[13], n, like, "first_depth");
  s.stream = reinterpret_cast<uint32_t*>(const_cast<int32_t*>(ints(state[14], n, like,
                                                                    "stream")));
  TORCH_CHECK(state[15].is_cuda() && state[15].device() == like.device() &&
                  state[15].scalar_type() == torch::kInt64 && state[15].numel() == 1,
              "segments must be one int64 on the state's device");
  s.segments = reinterpret_cast<unsigned long long*>(state[15].data_ptr<int64_t>());
  s.out_r = lane_floats(state[16], n, like, "color r");
  s.out_g = lane_floats(state[17], n, like, "color g");
  s.out_b = lane_floats(state[18], n, like, "color b");
  s.out_depth = lane_floats(state[19], n, like, "depth");
  s.camera = column(state[20], CAM_FLOATS, like, "camera");
  return s;
}

// `sums`: r, g, b, depth (float32, n each) and the segment total (one
// int64), or empty (no fold); `base`: the same five of the sums the sample
// adds to, or empty (zero); `base` may be `sums` itself.
SumColumns sum_columns(const std::vector<torch::Tensor>& sums,
                       const std::vector<torch::Tensor>& base, int64_t n,
                       const torch::Tensor& like) {
  SumColumns c{};
  if (sums.empty()) {
    TORCH_CHECK(base.empty(), "a base needs sums to add into");
    return c;
  }
  auto total = [&like](const torch::Tensor& t, const char* name) {
    TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                    t.scalar_type() == torch::kInt64 && t.numel() == 1,
                name, " must be one int64 on the state's device");
    return reinterpret_cast<unsigned long long*>(t.data_ptr<int64_t>());
  };
  TORCH_CHECK(sums.size() == 5, "sums must be r, g, b, depth and the segment total");
  c.r = lane_floats(sums[0], n, like, "sums r");
  c.g = lane_floats(sums[1], n, like, "sums g");
  c.b = lane_floats(sums[2], n, like, "sums b");
  c.depth = lane_floats(sums[3], n, like, "sums depth");
  c.segments = total(sums[4], "the sums' segment total");
  if (!base.empty()) {
    TORCH_CHECK(base.size() == 5, "base must be r, g, b, depth and the segment total");
    c.base_r = column(base[0], n, like, "base r");
    c.base_g = column(base[1], n, like, "base g");
    c.base_b = column(base[2], n, like, "base b");
    c.base_depth = column(base[3], n, like, "base depth");
    c.base_segments = total(base[4], "the base's segment total");
  }
  return c;
}

// Lane i takes pixel `pixel_ids[i]` at `u[i]`, `v[i]`, or with `by_index`
// pixel `first` + i of the `width` x `height` frame (the three tensors then
// unread).
void raygen_sample(const std::vector<torch::Tensor>& state, const torch::Tensor& pixel_ids,
                   const torch::Tensor& u, const torch::Tensor& v, bool by_index,
                   int64_t first, int64_t width, int64_t height, int64_t sample, int64_t seed,
                   bool defocus, const std::vector<torch::Tensor>& sums,
                   const std::vector<torch::Tensor>& base) {
  const WaveState s = wave_state(state);
  const torch::Tensor& like = state[0];
  const int64_t* ids = nullptr;
  const float* pu = nullptr;
  const float* pv = nullptr;
  if (by_index) {
    TORCH_CHECK(width > 0 && height > 0 && width * height < (int64_t{1} << 31) && first >= 0 &&
                    first + s.n <= width * height,
                "the lanes must be pixels of the frame: first + n <= width * height < 2^31");
  } else {
    ids = longs(pixel_ids, s.n, like, "pixel_ids");
    pu = column(u, s.n, like, "u");
    pv = column(v, s.n, like, "v");
  }
  TORCH_CHECK(sample >= 0 && sample <= 0xFFFFFFFFLL && seed >= 0 && seed <= 0xFFFFFFFFLL,
              "sample and seed must be u32 words");
  const SumColumns c = sum_columns(sums, base, s.n, like);
  const c10::cuda::CUDAGuard guard(like.device());
  launch_raygen_sample(s, ids, pu, pv, static_cast<int>(first), static_cast<int>(width),
                       static_cast<int>(height), static_cast<uint32_t>(sample),
                       static_cast<uint32_t>(seed), defocus, c,
                       c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// `t`/`index`: the sphere test's float32 / int64, n each; `tri_t` /
// `tri_index` the triangle test's, read only with `tris`. `spheres`: cx,
// cy, cz (float32), material_id (int32); `tris`: the nine corner columns
// (float32) and material_id (int32), or empty without triangles;
// `materials`: base r, g, b, metallic, roughness, ior, transmission,
// emissive r, g, b (float32). `sums` and `base` as raygen_sample's. The
// launch: `tiles` blocks of 256 * `per` lanes (kernels/bounce.py
// shade_tiles). A non-empty
// `probe` (kShadeProbeSlots int64 zeros) launches the probe instance,
// which adds its sums there.
void shade_bounce(const std::vector<torch::Tensor>& state, const torch::Tensor& t,
                  const torch::Tensor& index, const torch::Tensor& tri_t,
                  const torch::Tensor& tri_index, const std::vector<torch::Tensor>& spheres,
                  const std::vector<torch::Tensor>& tris,
                  const std::vector<torch::Tensor>& materials,
                  const std::vector<torch::Tensor>& sums,
                  const std::vector<torch::Tensor>& base, int64_t bounce, bool last,
                  bool cosine, int64_t per, int64_t tiles, const torch::Tensor& probe) {
  const WaveState s = wave_state(state);
  const torch::Tensor& like = state[0];
  HitColumns hit{};
  hit.t = column(t, s.n, like, "t");
  hit.index = longs(index, s.n, like, "index");
  ShadeScene sc{};
  TORCH_CHECK(spheres.size() == 4, "spheres must be cx, cy, cz, material_id");
  const int64_t n_sph = spheres[0].numel();
  TORCH_CHECK(n_sph > 0, "the sphere table must have rows");
  sc.cx = column(spheres[0], n_sph, like, "cx");
  sc.cy = column(spheres[1], n_sph, like, "cy");
  sc.cz = column(spheres[2], n_sph, like, "cz");
  sc.sphere_material = ints(spheres[3], n_sph, like, "sphere material_id");
  sc.n_spheres = rows(n_sph, "spheres");
  if (!tris.empty()) {
    hit.tri_t = column(tri_t, s.n, like, "tri_t");
    hit.tri_index = longs(tri_index, s.n, like, "tri_index");
    TORCH_CHECK(tris.size() == 10, "triangles must be the nine corners and material_id");
    const int64_t n_tri = tris[0].numel();
    TORCH_CHECK(n_tri > 0, "the triangle table must have rows");
    for (int k = 0; k < 9; ++k) sc.tri[k] = column(tris[k], n_tri, like, "triangle corners");
    sc.tri_material = ints(tris[9], n_tri, like, "triangle material_id");
    sc.n_tris = rows(n_tri, "triangles");
  }
  TORCH_CHECK(materials.size() == 10, "materials must be the ten columns the shading reads");
  const int64_t n_mat = materials[0].numel();
  TORCH_CHECK(n_mat > 0, "the material table must have rows");
  for (int k = 0; k < 10; ++k) sc.mat[k] = column(materials[k], n_mat, like, "materials");
  sc.n_materials = rows(n_mat, "materials");
  TORCH_CHECK(bounce >= 0 && bounce < (int64_t{1} << 24), "bounce must be a small count");
  TORCH_CHECK(per == 1 || per == 2 || per == 4, "per must be 1, 2 or 4");
  TORCH_CHECK(tiles == std::max<int64_t>(1, (s.n + 256 * per - 1) / (256 * per)),
              "tiles must be ceil(n / (256 * per)), at least 1");
  const SumColumns c = sum_columns(sums, base, s.n, like);
  unsigned long long* clocks = nullptr;
  if (probe.numel() > 0) {
    TORCH_CHECK(probe.is_cuda() && probe.device() == like.device() &&
                    probe.scalar_type() == torch::kInt64 && probe.is_contiguous() &&
                    probe.numel() == kShadeProbeSlots,
                "probe must be kShadeProbeSlots int64 on the state's device");
    clocks = reinterpret_cast<unsigned long long*>(probe.data_ptr<int64_t>());
  }
  const c10::cuda::CUDAGuard guard(like.device());
  launch_shade_bounce(s, hit, sc, c, static_cast<int>(bounce), last, cosine,
                      static_cast<int>(per), static_cast<int>(tiles), clocks,
                      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers, spills, shared memory and resident blocks per SM of K1 and
// K2 (over a table of `rows` rows), K3, K5 and K6, on CUDA device `device`.
std::map<std::string, std::map<std::string, int64_t>> wavefront_info(int64_t device,
                                                                     int64_t rows) {
  TORCH_CHECK(rows >= 1 && rows < (int64_t{1} << 31), "rows must be a positive int32");
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  std::map<std::string, std::map<std::string, int64_t>> out;
  auto put = [&out](const char* name, cudaError_t err, const WaveKernelInfo& info) {
    C10_CUDA_CHECK(err);
    out[name] = {{"num_regs", info.num_regs},
                 {"local_bytes", info.local_bytes},
                 {"static_smem", info.static_smem},
                 {"dynamic_smem", info.dynamic_smem},
                 {"blocks_per_sm", info.blocks_per_sm}};
  };
  const char* names[] = {"intersect_spheres", "intersect_bvh", "intersect_triangles"};
  for (int which = 0; which < 3; ++which) {
    WaveKernelInfo info{};
    const cudaError_t err = ::wavefront_kernel_info(which, static_cast<int>(rows), &info);
    put(names[which], err, info);
  }
  const char* bounce_names[] = {"raygen_sample", "shade_bounce", "shade_bounce_probe"};
  for (int which = 0; which < 3; ++which) {
    WaveKernelInfo info{};
    const cudaError_t err = ::bounce_kernel_info(which, &info);
    put(bounce_names[which], err, info);
  }
  out["intersect_spheres"]["rays_per_thread"] = kDenseRays;
  out["intersect_triangles"]["rays_per_thread"] = kDenseRays;
  return out;
}

// ---- the image kernels -------------------------------------------------------

int32_t side(int64_t n, const char* name) {
  TORCH_CHECK(n > 0 && n < (int64_t{1} << 31), name, " must be a positive int32");
  return static_cast<int32_t>(n);
}

// K7: one à-trous iteration at `stride` of `img` (float32, [h, w, 3]) guided
// by `z` (float32, [h, w]) into `out` (float32, [h, w, 3]), all contiguous
// on one card, `out` apart from `img`.
void atrous_pass(const torch::Tensor& img, const torch::Tensor& z, torch::Tensor out,
                 int64_t stride, double inv_2sc2, double inv_2sz2) {
  check_f32(img, img, "img");
  check_f32(z, img, "z");
  check_f32(out, img, "out");
  TORCH_CHECK(img.dim() == 3 && img.size(2) == 3, "img must be (H, W, 3)");
  const int32_t h = side(img.size(0), "H");
  const int32_t w = side(img.size(1), "W");
  TORCH_CHECK(z.dim() == 2 && z.size(0) == h && z.size(1) == w, "z must be (H, W)");
  TORCH_CHECK(out.sizes() == img.sizes(), "out must have img's shape");
  TORCH_CHECK(out.data_ptr<float>() != img.data_ptr<float>(), "out must not be img");
  TORCH_CHECK(stride >= 1 && 2 * stride < std::min(h, w),
              "stride must be >= 1 with 2 * stride < min(H, W)");
  const c10::cuda::CUDAGuard guard(img.device());
  launch_atrous_pass(img.data_ptr<float>(), z.data_ptr<float>(), out.data_ptr<float>(), h, w,
                     static_cast<int>(stride), static_cast<float>(inv_2sc2),
                     static_cast<float>(inv_2sz2), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K8: the centre ray of each pixel of a `width` x `height` frame from the
// camera row (CAM_FLOATS float32) into `rays`: ox, oy, oz, dx, dy, dz
// (float32, width * height each).
void raster_rays(const torch::Tensor& camera, const std::vector<torch::Tensor>& rays,
                 int64_t width, int64_t height) {
  const int32_t w = side(width, "width");
  const int32_t h = side(height, "height");
  const int64_t n = static_cast<int64_t>(w) * h;
  rows(n, "pixels");
  TORCH_CHECK(rays.size() == 6, "rays must be ox, oy, oz, dx, dy, dz");
  const torch::Tensor& like = rays[0];
  RasterRays r{};
  float** cols[] = {&r.ox, &r.oy, &r.oz, &r.dx, &r.dy, &r.dz};
  for (int k = 0; k < 6; ++k) *cols[k] = lane_floats(rays[k], n, like, "ray columns");
  const float* cam = column(camera, CAM_FLOATS, like, "camera");
  const c10::cuda::CUDAGuard guard(like.device());
  launch_raster_rays(cam, r, w, h, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K9: the shade and depth of each ray from the triangle test's `t`
// (float32) / `index` (int64) and its direction `dirs` (dx, dy, dz,
// float32), n each; `tris`: the nine corner columns (float32, T each);
// `colors` (float32, [T, 6]); the camera row and `near` (one float32);
// `clear` (r, g, b) and `ambient` as Python floats; `out`: r, g, b, depth
// (float32, n each).
void raster_shade(const torch::Tensor& t, const torch::Tensor& index,
                  const std::vector<torch::Tensor>& dirs, const std::vector<torch::Tensor>& tris,
                  const torch::Tensor& colors, const torch::Tensor& camera,
                  const torch::Tensor& near, std::vector<double> clear, double ambient,
                  const std::vector<torch::Tensor>& out) {
  const int64_t n = t.numel();
  RasterShade a{};
  a.n = rows(n, "rays");
  a.t = column(t, n, t, "t");
  a.index = longs(index, n, t, "index");
  TORCH_CHECK(dirs.size() == 3, "dirs must be dx, dy, dz");
  a.dx = column(dirs[0], n, t, "dx");
  a.dy = column(dirs[1], n, t, "dy");
  a.dz = column(dirs[2], n, t, "dz");
  TORCH_CHECK(tris.size() == 9, "tris must be ax, ay, az, bx, by, bz, cx, cy, cz");
  const int64_t n_tri = tris[0].numel();
  TORCH_CHECK(n_tri > 0, "the triangle table must have rows");
  for (int k = 0; k < 9; ++k) a.tri[k] = column(tris[k], n_tri, t, "triangle corners");
  a.rows = rows(n_tri, "triangles");
  check_f32(colors, t, "colors");
  TORCH_CHECK(colors.dim() == 2 && colors.size(0) == n_tri && colors.size(1) == 6,
              "colors must be (T, 6)");
  a.colors = colors.data_ptr<float>();
  a.camera = column(camera, CAM_FLOATS, t, "camera");
  check_f32(near, t, "near");
  TORCH_CHECK(near.numel() == 1, "near must be one float");
  a.near = near.data_ptr<float>();
  TORCH_CHECK(clear.size() == 3, "clear must be r, g, b");
  for (int k = 0; k < 3; ++k) a.clear[k] = static_cast<float>(clear[k]);
  a.ambient = static_cast<float>(ambient);
  TORCH_CHECK(out.size() == 4, "out must be r, g, b, depth");
  a.out_r = lane_floats(out[0], n, t, "out r");
  a.out_g = lane_floats(out[1], n, t, "out g");
  a.out_b = lane_floats(out[2], n, t, "out b");
  a.out_depth = lane_floats(out[3], n, t, "out depth");
  const c10::cuda::CUDAGuard guard(t.device());
  launch_raster_shade(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers, spills, shared memory and resident blocks per SM of K7, K8 and
// K9 on CUDA device `device`.
std::map<std::string, std::map<std::string, int64_t>> image_info(int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  std::map<std::string, std::map<std::string, int64_t>> out;
  const char* names[] = {"atrous_pass", "raster_rays", "raster_shade"};
  for (int which = 0; which < 3; ++which) {
    WaveKernelInfo info{};
    C10_CUDA_CHECK(which == 0 ? ::atrous_kernel_info(&info)
                              : ::raster_kernel_info(which - 1, &info));
    out[names[which]] = {{"num_regs", info.num_regs},
                         {"local_bytes", info.local_bytes},
                         {"static_smem", info.static_smem},
                         {"dynamic_smem", info.dynamic_smem},
                         {"blocks_per_sm", info.blocks_per_sm}};
  }
  return out;
}

// ---- the frame's tail and the film pass's fold --------------------------------

// One float32 a frame or one a pixel (`n`) on `like`'s device: the stride.
int per_pixel(const torch::Tensor& t, int64_t n, const torch::Tensor& like, const char* name) {
  check_f32(t, like, name);
  TORCH_CHECK(t.numel() == 1 || (t.dim() == 1 && t.numel() == n), name,
              " must hold one float or one a pixel");
  return t.numel() == 1 ? 0 : 1;
}

const float* one_float(const torch::Tensor& t, const torch::Tensor& like, const char* name) {
  check_f32(t, like, name);
  TORCH_CHECK(t.numel() == 1, name, " must be one float");
  return t.data_ptr<float>();
}

// The pixels of a `width` x `height` frame and its block grid's width, with
// the block-ordered sums' lanes checked: whole 64 x 64 blocks covering it.
int64_t frame_pixels(int64_t width, int64_t height, int64_t nbx, int64_t lanes) {
  TORCH_CHECK(width > 0 && height > 0 && width * height < (int64_t{1} << 31),
              "the frame must have between 1 and 2^31 pixels");
  if (nbx > 0) {
    const int64_t nby = (height + 63) / 64;
    TORCH_CHECK(nbx == (width + 63) / 64 && lanes >= nbx * nby * kTile &&
                    lanes < (int64_t{1} << 31),
                "block-ordered sums must cover the frame's 64x64 block grid");
  }
  return width * height;
}

// K10: `sums` r, g, b, depth (float32, row-major width * height each, or
// with `nbx` > 0 block-ordered over the frame's block grid); `count` empty
// or one float32 / one a pixel; `inv` read when `has_inv` and `count` is
// empty; `near`/`far` one float32 each; `raster` empty (white) or three
// columns of one float / one a pixel; `raster_depth` empty (0) or one
// float / one a pixel; `image` [height, width, 3] and `depth` [height,
// width] float32.
void resolve_frame(const std::vector<torch::Tensor>& sums, int64_t nbx, bool has_inv,
                   double inv, const torch::Tensor& count, int64_t level,
                   const torch::Tensor& near, const torch::Tensor& far,
                   const std::vector<torch::Tensor>& raster, const torch::Tensor& raster_depth,
                   torch::Tensor image, torch::Tensor depth, int64_t width, int64_t height) {
  TORCH_CHECK(sums.size() == 4, "sums must be r, g, b, depth");
  const torch::Tensor& like = sums[3];
  const int64_t n = frame_pixels(width, height, nbx, like.numel());
  FrameTail a{};
  for (int k = 0; k < 4; ++k) {
    a.sum[k] = column(sums[k], nbx > 0 ? like.numel() : n, like, "sums");
  }
  a.nbx = static_cast<int>(nbx);
  a.has_inv = has_inv;
  a.inv = static_cast<float>(inv);
  if (count.numel() > 0) {
    a.count_stride = per_pixel(count, n, like, "count");
    a.count = count.data_ptr<float>();
  }
  TORCH_CHECK(level >= 0 && level < (int64_t{1} << 24), "level must be a small count");
  a.level = static_cast<int>(level);
  a.near = one_float(near, like, "near");
  a.far = one_float(far, like, "far");
  if (!raster.empty()) {
    TORCH_CHECK(raster.size() == 3, "raster must be r, g, b");
    for (int k = 0; k < 3; ++k) {
      a.raster_stride[k] = per_pixel(raster[k], n, like, "raster colour");
      a.raster[k] = raster[k].data_ptr<float>();
    }
  }
  if (raster_depth.numel() > 0) {
    a.raster_depth_stride = per_pixel(raster_depth, n, like, "raster depth");
    a.raster_depth = raster_depth.data_ptr<float>();
  }
  check_f32(image, like, "image");
  check_f32(depth, like, "depth");
  TORCH_CHECK(image.dim() == 3 && image.size(0) == height && image.size(1) == width &&
                  image.size(2) == 3,
              "image must be (height, width, 3)");
  TORCH_CHECK(depth.dim() == 2 && depth.size(0) == height && depth.size(1) == width,
              "depth must be (height, width)");
  a.image = image.data_ptr<float>();
  a.depth = depth.data_ptr<float>();
  a.width = static_cast<int>(width);
  a.height = static_cast<int>(height);
  const c10::cuda::CUDAGuard guard(like.device());
  launch_resolve_frame(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K11: `film` r, g, b, depth (float32, width * height each, row-major);
// `pass` the pass's r, g, b, depth in block order; `out` four new float32
// columns like the film's; `n_in`/`n_out` one float32 each, `total_in`,
// `segments`, `total_out` one int64 each.
void fold_pass(const std::vector<torch::Tensor>& film, const std::vector<torch::Tensor>& pass,
               const std::vector<torch::Tensor>& out, const torch::Tensor& n_in,
               torch::Tensor n_out, double spp, const torch::Tensor& total_in,
               const torch::Tensor& segments, torch::Tensor total_out, int64_t nbx,
               int64_t width, int64_t height) {
  TORCH_CHECK(film.size() == 4 && pass.size() == 4 && out.size() == 4,
              "film, pass and out must each be r, g, b, depth");
  const torch::Tensor& like = film[3];
  TORCH_CHECK(nbx > 0, "the pass's sums are block-ordered");
  const int64_t n = frame_pixels(width, height, nbx, pass[3].numel());
  PassFold a{};
  for (int k = 0; k < 4; ++k) {
    a.film[k] = column(film[k], n, like, "film sums");
    a.pass[k] = column(pass[k], pass[3].numel(), like, "pass sums");
    a.out[k] = lane_floats(out[k], n, like, "out");
  }
  a.n_in = one_float(n_in, like, "n_in");
  a.n_out = const_cast<float*>(one_float(n_out, like, "n_out"));
  a.spp = static_cast<float>(spp);
  auto total = [&like](const torch::Tensor& t, const char* name) {
    TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                    t.scalar_type() == torch::kInt64 && t.numel() == 1,
                name, " must be one int64 on the film's device");
    return t.data_ptr<int64_t>();
  };
  a.total_in = total(total_in, "total_in");
  a.segments = total(segments, "segments");
  a.total_out = total(total_out, "total_out");
  a.nbx = static_cast<int>(nbx);
  a.width = static_cast<int>(width);
  a.height = static_cast<int>(height);
  const c10::cuda::CUDAGuard guard(like.device());
  launch_fold_pass(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers, spills, shared memory and resident blocks per SM of K10 and
// K11 on CUDA device `device`.
std::map<std::string, std::map<std::string, int64_t>> frame_info(int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  std::map<std::string, std::map<std::string, int64_t>> out;
  const char* names[] = {"resolve_frame", "fold_pass"};
  for (int which = 0; which < 2; ++which) {
    WaveKernelInfo info{};
    C10_CUDA_CHECK(::frame_kernel_info(which, &info));
    out[names[which]] = {{"num_regs", info.num_regs},
                         {"local_bytes", info.local_bytes},
                         {"static_smem", info.static_smem},
                         {"dynamic_smem", info.dynamic_smem},
                         {"blocks_per_sm", info.blocks_per_sm}};
  }
  return out;
}

// ---- the camera row, the adaptive pass and the sharded step's sums ------------

// One int64 on `like`'s device.
const int64_t* one_long(const torch::Tensor& t, const torch::Tensor& like, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() &&
                  t.scalar_type() == torch::kInt64 && t.numel() == 1,
              name, " must be one int64 on the same device");
  return t.data_ptr<int64_t>();
}

// K12: `leaves` the camera's fifteen values (float32, one each, in
// camera_leaves order); `fused` empty or 24 float32, `wavefront` empty or
// CAM_FLOATS float32 (not both empty).
void camera_rows(const std::vector<torch::Tensor>& leaves, torch::Tensor fused,
                 torch::Tensor wavefront, double width, double height, double npix,
                 bool level1) {
  TORCH_CHECK(leaves.size() == N_LEAVES, "the camera must be its fifteen values");
  const torch::Tensor& like = leaves[L_FOV];
  CameraArgs a{};
  for (int k = 0; k < N_LEAVES; ++k) a.leaf[k] = one_float(leaves[k], like, "camera value");
  TORCH_CHECK(fused.numel() > 0 || wavefront.numel() > 0, "camera_rows writes a row");
  if (fused.numel() > 0) a.fused = lane_floats(fused, kNCam, like, "fused row");
  if (wavefront.numel() > 0) a.wavefront = lane_floats(wavefront, CAM_FLOATS, like, "wavefront row");
  a.width = static_cast<float>(width);
  a.height = static_cast<float>(height);
  a.npix = static_cast<float>(npix);
  a.level1 = level1;
  const c10::cuda::CUDAGuard guard(like.device());
  launch_camera_rows(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K13: `err` float32 width * height; `out` int32, whole 64 x 64 blocks of
// the frame's grid (`nbx` wide).
void adaptive_map(const torch::Tensor& err, torch::Tensor out, double tolerance, bool reprobe,
                  int64_t spp, int64_t nbx, int64_t width, int64_t height) {
  const int64_t n = frame_pixels(width, height, nbx, out.numel());
  AdaptiveMap a{};
  a.err = column(err, n, err, "err");
  TORCH_CHECK(out.is_cuda() && out.device() == err.device() &&
                  out.scalar_type() == torch::kInt32 && out.is_contiguous() &&
                  out.numel() % kTile == 0,
              "the map must be whole blocks of contiguous int32 on err's device");
  TORCH_CHECK(spp >= 0 && spp < (int64_t{1} << 24), "spp must be a small count");
  a.out = out.data_ptr<int32_t>();
  a.tolerance = static_cast<float>(tolerance);
  a.reprobe = reprobe;
  a.spp = static_cast<int>(spp);
  a.nbx = static_cast<int>(nbx);
  a.width = static_cast<int>(width);
  a.height = static_cast<int>(height);
  a.lanes = static_cast<int>(out.numel());
  const c10::cuda::CUDAGuard guard(err.device());
  launch_adaptive_map(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K14: `film` r, g, b, depth, n_samples, err (float32, width * height each,
// row-major); `pass` the pass's r, g, b, depth in block order; `out` six new
// float32 columns like the film's; `total_in`, `segments`, `total_out` one
// int64 each.
void fold_adaptive(const std::vector<torch::Tensor>& film, const std::vector<torch::Tensor>& pass,
                   const std::vector<torch::Tensor>& out, const torch::Tensor& total_in,
                   const torch::Tensor& segments, torch::Tensor total_out, double tolerance,
                   bool reprobe, int64_t spp, int64_t nbx, int64_t width, int64_t height) {
  TORCH_CHECK(film.size() == 6 && pass.size() == 4 && out.size() == 6,
              "film and out must be six columns, pass r, g, b, depth");
  const torch::Tensor& like = film[3];
  TORCH_CHECK(nbx > 0, "the pass's sums are block-ordered");
  const int64_t n = frame_pixels(width, height, nbx, pass[3].numel());
  AdaptiveFold a{};
  for (int k = 0; k < 6; ++k) {
    a.film[k] = column(film[k], n, like, "film");
    a.out[k] = lane_floats(out[k], n, like, "out");
  }
  for (int k = 0; k < 4; ++k) a.pass[k] = column(pass[k], pass[3].numel(), like, "pass sums");
  a.total_in = one_long(total_in, like, "total_in");
  a.segments = one_long(segments, like, "segments");
  a.total_out = const_cast<int64_t*>(one_long(total_out, like, "total_out"));
  TORCH_CHECK(spp >= 0 && spp < (int64_t{1} << 24), "spp must be a small count");
  a.tolerance = static_cast<float>(tolerance);
  a.reprobe = reprobe;
  a.spp = static_cast<float>(spp);
  a.nbx = static_cast<int>(nbx);
  a.width = static_cast<int>(width);
  a.height = static_cast<int>(height);
  const c10::cuda::CUDAGuard guard(like.device());
  launch_fold_adaptive(a, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K15: `parts` r, g, b, depth of each part in (sp_i, dp_i) order, `n`
// float32 each; `segments` one int64 a part; `out` r, g, b, depth of sp * n
// float32 each; `total` one int64. One launch for every kPartsPerLaunch
// parts, in order; returns the launches.
int64_t sum_shards(const std::vector<torch::Tensor>& parts,
                   const std::vector<torch::Tensor>& segments, const std::vector<torch::Tensor>& out,
                   torch::Tensor total, int64_t sp, int64_t dp, int64_t n) {
  TORCH_CHECK(sp >= 1 && dp >= 1 && sp * dp < (int64_t{1} << 31), "sum_shards takes at least one part");
  TORCH_CHECK(parts.size() == static_cast<size_t>(4 * sp * dp) &&
                  segments.size() == static_cast<size_t>(sp * dp) && out.size() == 4,
              "parts must be r, g, b, depth of each part, segments one a part");
  TORCH_CHECK(n >= 0 && sp * n < (int64_t{1} << 31), "the joined sums must have fewer than 2^31 lanes");
  const torch::Tensor& like = out[3];
  ShardSums a{};
  for (int k = 0; k < 4; ++k) a.out[k] = lane_floats(out[k], sp * n, like, "out");
  a.total = const_cast<int64_t*>(one_long(total, like, "total"));
  a.dp = static_cast<int>(dp);
  a.n = static_cast<int>(n);
  const c10::cuda::CUDAGuard guard(like.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  int64_t launches = 0;
  for (int64_t first = 0; first < sp * dp; first += kPartsPerLaunch) {
    a.first = static_cast<int>(first);
    a.count = static_cast<int>(std::min<int64_t>(kPartsPerLaunch, sp * dp - first));
    for (int p = 0; p < a.count; ++p) {
      for (int k = 0; k < 4; ++k) {
        a.part[p][k] = column(parts[4 * (first + p) + k], n, like, "part");
      }
      a.segments[p] = one_long(segments[first + p], like, "segments");
    }
    launch_sum_shards(a, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    ++launches;
  }
  return launches;
}

// K16: `t` float32 and `index` int64 of each tp slice, `n` lanes each, the
// slice's first sphere `offset`; `t_out`, `index_out` like one slice's. One
// launch for the first kSlicesPerLaunch slices, then one for every
// kSlicesPerLaunch - 1 more, which merges them into the output; returns the
// launches.
int64_t merge_tp_hits(const std::vector<torch::Tensor>& t, const std::vector<torch::Tensor>& index,
                      const std::vector<int64_t>& offset, torch::Tensor t_out,
                      torch::Tensor index_out) {
  const int64_t tp = static_cast<int64_t>(t.size());
  TORCH_CHECK(tp >= 1 && index.size() == t.size() && offset.size() == t.size(),
              "merge_tp_hits takes t, index and an offset of each of at least one slice");
  const torch::Tensor& like = t_out;
  const int64_t n = like.numel();
  TORCH_CHECK(n < (int64_t{1} << 31), "merge_tp_hits takes fewer than 2^31 lanes");
  TpHits a{};
  a.t_out = lane_floats(t_out, n, like, "t_out");
  a.index_out = const_cast<int64_t*>(longs(index_out, n, like, "index_out"));
  a.n = static_cast<int>(n);
  const c10::cuda::CUDAGuard guard(like.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  int64_t launches = 0;
  for (int64_t next = 0; next < tp;) {
    int k = 0;
    if (next > 0) {   // the slices merged so far, as slice 0
      a.t[0] = a.t_out;
      a.index[0] = a.index_out;
      a.offset[0] = 0;
      k = 1;
    }
    for (; k < kSlicesPerLaunch && next < tp; ++k, ++next) {
      TORCH_CHECK(offset[next] >= 0, "a slice's offset must be at least 0");
      a.t[k] = column(t[next], n, like, "t");
      a.index[k] = longs(index[next], n, like, "index");
      a.offset[k] = offset[next];
    }
    a.count = k;
    launch_merge_tp_hits(a, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    ++launches;
  }
  return launches;
}

// Registers, spills, shared memory and resident blocks per SM of K12-K16 on
// CUDA device `device`.
std::map<std::string, std::map<std::string, int64_t>> passes_info(int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  std::map<std::string, std::map<std::string, int64_t>> out;
  const char* names[] = {"camera_rows", "adaptive_map", "fold_adaptive", "sum_shards",
                         "merge_tp_hits"};
  for (int which = 0; which < 5; ++which) {
    WaveKernelInfo info{};
    C10_CUDA_CHECK(which == 0 ? ::camera_kernel_info(&info)
                              : ::passes_kernel_info(which - 1, &info));
    out[names[which]] = {{"num_regs", info.num_regs},
                         {"local_bytes", info.local_bytes},
                         {"static_smem", info.static_smem},
                         {"dynamic_smem", info.dynamic_smem},
                         {"blocks_per_sm", info.blocks_per_sm}};
  }
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("render_tiles", &render_tiles,
        "Trace a frame into block-ordered r/g/b/depth and add its segment count");
  m.def("kernel_info", &instance_info,
        "Registers, spills, shared memory and occupancy of one kernel instance");
  m.attr("probe_slots") = static_cast<int>(kProbeSlots);
  m.attr("shade_probe_slots") = static_cast<int>(kShadeProbeSlots);
  m.def("intersect_spheres", &intersect_spheres,
        "Nearest sphere hit of each ray over the whole table (t, index)");
  m.def("intersect_triangles", &intersect_triangles,
        "Nearest triangle hit of each ray over the whole table (t, index)");
  m.def("intersect_bvh", &intersect_bvh,
        "Nearest sphere hit of each ray by the BVH walk over its paired-child record");
  m.def("wavefront_info", &wavefront_info,
        "Registers, spills, shared memory and occupancy of the K1, K2, K3, K5 and K6 kernels");
  m.def("intersect_bvh_triangles", &intersect_bvh_triangles,
        "Nearest triangle hit of each ray by the BVH walk");
  m.def("raygen_sample", &raygen_sample,
        "A sample's start state of every lane (K5), the segment count zeroed");
  m.def("shade_bounce", &shade_bounce,
        "One bounce's shading of every lane (K6), the harvest on the last");
  m.def("atrous_pass", &atrous_pass, "One a-trous denoising iteration (K7)");
  m.def("raster_rays", &raster_rays, "The raster layer's centre ray of every pixel (K8)");
  m.def("raster_shade", &raster_shade,
        "The raster layer's ambient shade and reverse-Z depth of every ray (K9)");
  m.def("image_info", &image_info,
        "Registers, spills, shared memory and occupancy of the K7, K8 and K9 kernels");
  m.def("resolve_frame", &resolve_frame,
        "A frame's sums resolved and composited into its image and depth (K10)");
  m.def("fold_pass", &fold_pass, "A fused film pass folded into a new film (K11)");
  m.def("frame_info", &frame_info,
        "Registers, spills, shared memory and occupancy of the K10 and K11 kernels");
  m.def("camera_rows", &camera_rows, "A camera's fused and wavefront rows (K12)");
  m.def("adaptive_map", &adaptive_map, "An adaptive pass's block-ordered sample map (K13)");
  m.def("fold_adaptive", &fold_adaptive, "An adaptive pass folded into a new film (K14)");
  m.def("sum_shards", &sum_shards, "The sharded step's sums over dp, the sp shards joined (K15)");
  m.def("merge_tp_hits", &merge_tp_hits, "The nearest hit over the tp slices of the sphere table (K16)");
  m.def("passes_info", &passes_info,
        "Registers, spills, shared memory and occupancy of the K12-K16 kernels");
}
