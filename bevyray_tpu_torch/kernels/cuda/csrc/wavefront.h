// The launch interface of the wavefront kernels (wavefront.cu), shared with
// their Python binding (binding.cpp). Plain C types only, so the .cu file
// needs none of PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// One ray per lane: origin and direction components, n floats each, and an
// optional active mask (null: every lane is active).
struct RayBatch {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const bool* active;
  int n;
};

// The sphere table's columns (n rows); `valid` false on padding rows.
struct SphereTable {
  const float* cx;
  const float* cy;
  const float* cz;
  const float* radius;
  const bool* valid;
  int n;
};

// The triangle table's corner columns (n rows); `valid` false on padding.
struct TriangleTable {
  const float* ax;
  const float* ay;
  const float* az;
  const float* bx;
  const float* by;
  const float* bz;
  const float* cx;
  const float* cy;
  const float* cz;
  const bool* valid;
  int n;
};

// A flattened BVH2 (core/types.py BvhNodes), the table K4 walks: n_nodes
// rows of boxes, the first prim (leaf) or first child (inner) and the prim
// count (0: inner); `prim_ids` (n_prim_ids rows, or null) maps a leaf's
// slots to prims. The walk keeps `stack_size` entries (at most kMaxStack)
// and tests at most `max_leaf_size` prims a leaf.
struct BvhTable {
  const float* min_x;
  const float* min_y;
  const float* min_z;
  const float* max_x;
  const float* max_y;
  const float* max_z;
  const int* index;
  const int* count;
  const int* prim_ids;
  int n_nodes;
  int n_prim_ids;
  int stack_size;
  int max_leaf_size;
};

constexpr int kMaxStack = 32;   // raytrace.wgsl:310

// The paired-child record of a sphere BVH over its sphere table
// (core/types.py `SphereWalk`, built with the scene), the one table K3
// reads. `nodes`: 4 int4 a node. An inner node (count 0) holds the boxes
// of its children clamp(index) and clamp(index + 1) (min xyz, max xyz of
// the first, then of the second: 12 floats' bits); a leaf (count > 0)
// holds its first prim's row (cx, cy, cz, r) and 8 zero words. The fourth
// int4 is (count, index, the first prim's id, 0). `rows` and `prims` give
// each of the n_slots leaf slots' sphere row and prim id. The walk keeps
// `stack_size` entries (at most kMaxStack) and tests at most
// `max_leaf_size` prims a leaf.
struct SphereWalk {
  const int4* nodes;
  const float4* rows;
  const int* prims;
  int n_nodes;
  int n_slots;
  int stack_size;
  int max_leaf_size;
};

// Registers, spill bytes (local memory) and static shared memory a thread
// or block of one wavefront kernel instance, and its resident blocks per SM
// at the dynamic shared memory it launches with.
struct WaveKernelInfo {
  int num_regs;
  int local_bytes;
  int static_smem;
  int dynamic_smem;
  int blocks_per_sm;
};

// Each launch writes every lane's nearest hit: `out_t` (f32 max on a miss
// and on an inactive lane) and `out_i` (the row, -1 there). They launch on
// `stream` and allocate nothing; the caller checks the launch.
void launch_intersect_spheres(const RayBatch& rays, const SphereTable& spheres,
                              float* out_t, int64_t* out_i, cudaStream_t stream);
void launch_intersect_triangles(const RayBatch& rays, const TriangleTable& tris,
                                float* out_t, int64_t* out_i, cudaStream_t stream);
void launch_intersect_bvh(const RayBatch& rays, const SphereWalk& walk, float* out_t,
                          int64_t* out_i, cudaStream_t stream);
void launch_intersect_bvh_triangles(const RayBatch& rays, const BvhTable& bvh,
                                    const TriangleTable& tris, float* out_t,
                                    int64_t* out_i, cudaStream_t stream);

// The dense tests (K1, K2) take up to kDenseRays rays a thread
// (wavefront.cu's design note).
constexpr int kDenseRays = 4;

// The facts of kernel `which` (0: K1 over a sphere table of `rows` rows,
// 2: K2 over a triangle table of `rows` rows, which sets their staged
// tiles; 1: K3).
cudaError_t wavefront_kernel_info(int which, int rows, WaveKernelInfo* out);
