// The wavefront renderer's ray tests for Hopper (sm_90a): the dense sphere
// and triangle tests and the BVH walk, one thread per ray.
//
// They replace XLA loops of the JAX package, not a `pl.pallas_call`:
//
// - intersect_spheres (K1): the `lax.scan` over sphere chunks of
//   `intersect_spheres`, bevyray_tpu/kernels/intersect.py:41, which XLA
//   fuses into one reduction pass over a [rays x chunk] block;
// - intersect_triangles (K2): the same scan of `intersect_triangles`
//   (Moller-Trumbore), bevyray_tpu/kernels/intersect.py:116;
// - intersect_bvh / intersect_bvh_triangles (K3/K4): the `lax.while_loop`
//   of `_intersect_bvh_generic`, bevyray_tpu/kernels/traverse.py:125, with
//   a sphere leaf and a triangle leaf.
//
// Each computes what its plain PyTorch version in kernels/intersect.py or
// kernels/traverse.py computes, term for term, in IEEE float32 with no
// contraction (--fmad=false): the same t to the bit and the same index.
// A lane whose `active` flag is false writes t = f32 max and index -1.
//
// Bound on an H100 SXM: fp32 issue. A dense sphere test is 21 fp32
// operations with one IEEE sqrt where the discriminant is not negative, a
// triangle test 60 with one IEEE division, a BVH box test 27. Each ray
// reads 25 bytes and writes 12, and the tables are a few KB to a few
// hundred KB, so at the headline (2 M rays x 512 spheres) the operations
// take ~14 times as long as the bytes (K1: 1.36 ms against a 0.33 ms
// bound, PERF.md). The walk's node and prim reads differ across a warp
// after bounce 0, so its time goes to their latency (K3: 0.18 ms against
// 0.006 at 4,971 spheres). What the design does about it:
//
// - the dense tests keep no [rays x table] temporaries: the table goes
//   through shared memory in tiles (512 rows: 10 KB of spheres, 20 KB of
//   triangles with their edges computed once per tile), read by all the
//   threads of a block at the same address (a broadcast), and each thread
//   keeps its running (t, index) in registers. A strict t < best in
//   ascending row order gives the lowest index on every tie, as the plain
//   version's chunk rule does;
// - a negative discriminant returns before the sqrt, whose IEEE path calls
//   a slow subroutine for inputs with the sign bit set (megakernel.cu);
// - an inactive lane returns at once, and a block with no active lane
//   skips the table (the bounce loop runs masked over every lane);
// - the walk keeps its 32-entry stack in the thread and visits the nodes
//   in the plain version's order (the first child pushed first, so popped
//   second), so the first hit found along that order wins a tie, as in
//   the reference; a push past the top is dropped and stops the walk (the
//   reference's silent truncation), and the slab test keeps the NaN of a
//   face plane through the ray's origin (min2_nan/max2_nan).

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "wavefront.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;   // table rows per shared-memory tile

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// The lane's ray, or false for a lane past the batch or inactive.
__device__ __forceinline__ bool lane_ray(const RayBatch& r, int i, V3& o, V3& d) {
  if (i >= r.n || (r.active != nullptr && !r.active[i])) return false;
  o = {r.ox[i], r.oy[i], r.oz[i]};
  d = {r.dx[i], r.dy[i], r.dz[i]};
  return true;
}

// Near-root sphere distance (hit_sphere, wgsl:371-383; intersect.py
// intersect_spheres_reference): f32 max unless disc >= 0 and t > T_MIN.
// `a` = d.d and `inv_a` = 1 / a; `r2` = r * r.
__device__ __forceinline__ float sphere_t(V3 o, V3 d, float a, float inv_a, float cx, float cy,
                                          float cz, float r2) {
  const float ocx = cx - o.x;
  const float ocy = cy - o.y;
  const float ocz = cz - o.z;
  const float h = d.x * ocx + d.y * ocy + d.z * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = h * h - a * c;
  if (!(disc >= 0.0f)) return kInf;
  const float t = (h - sqrtf(disc)) * inv_a;
  return t > kTMin ? t : kInf;
}

// Moller-Trumbore, two-sided (intersect.py _chunk_hits) from the corner a
// and the edges e1 = b - a, e2 = c - a: f32 max unless |det| > 1e-12,
// u >= 0, v >= 0, u + v <= 1 and t > T_MIN.
__device__ __forceinline__ float triangle_t(V3 o, V3 d, float ax, float ay, float az,
                                            float e1x, float e1y, float e1z, float e2x,
                                            float e2y, float e2z) {
  const float px = d.y * e2z - d.z * e2y;
  const float py = d.z * e2x - d.x * e2z;
  const float pz = d.x * e2y - d.y * e2x;
  const float det = px * e1x + py * e1y + pz * e1z;
  const float inv_det = 1.0f / det;
  const float tx = o.x - ax;
  const float ty = o.y - ay;
  const float tz = o.z - az;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin;
  return ok ? t : kInf;
}

// K1: every active ray against every valid sphere of the table.
__global__ void __launch_bounds__(kThreads)
    spheres_kernel(RayBatch rays, SphereTable tab, float* __restrict__ out_t,
                   int64_t* __restrict__ out_i) {
  __shared__ float s_cx[kTile], s_cy[kTile], s_cz[kTile], s_r2[kTile];
  __shared__ bool s_valid[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  const bool live = lane_ray(rays, i, o, d);
  float best_t = kInf;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    const float a = dot(d, d);
    const float inv_a = 1.0f / a;
    for (int base = 0; base < tab.n; base += kTile) {
      const int rows = min(kTile, tab.n - base);
      for (int k = threadIdx.x; k < rows; k += kThreads) {
        const float r = tab.radius[base + k];
        s_cx[k] = tab.cx[base + k];
        s_cy[k] = tab.cy[base + k];
        s_cz[k] = tab.cz[base + k];
        s_r2[k] = r * r;
        s_valid[k] = tab.valid[base + k];
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < rows; ++k) {
          if (!s_valid[k]) continue;
          const float t = sphere_t(o, d, a, inv_a, s_cx[k], s_cy[k], s_cz[k], s_r2[k]);
          if (t < best_t) {
            best_t = t;
            best_i = base + k;
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < rays.n) {
    out_t[i] = best_t;
    out_i[i] = best_i;
  }
}

// K2: every active ray against every valid triangle; each tile holds the
// corner a and the edges, computed once per row.
__global__ void __launch_bounds__(kThreads)
    triangles_kernel(RayBatch rays, TriangleTable tab, float* __restrict__ out_t,
                     int64_t* __restrict__ out_i) {
  __shared__ float s_row[9][kTile];   // ax, ay, az, e1 xyz, e2 xyz
  __shared__ bool s_valid[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  const bool live = lane_ray(rays, i, o, d);
  float best_t = kInf;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < tab.n; base += kTile) {
      const int rows = min(kTile, tab.n - base);
      for (int k = threadIdx.x; k < rows; k += kThreads) {
        const int s = base + k;
        const float ax = tab.ax[s], ay = tab.ay[s], az = tab.az[s];
        s_row[0][k] = ax;
        s_row[1][k] = ay;
        s_row[2][k] = az;
        s_row[3][k] = tab.bx[s] - ax;
        s_row[4][k] = tab.by[s] - ay;
        s_row[5][k] = tab.bz[s] - az;
        s_row[6][k] = tab.cx[s] - ax;
        s_row[7][k] = tab.cy[s] - ay;
        s_row[8][k] = tab.cz[s] - az;
        s_valid[k] = tab.valid[s];
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < rows; ++k) {
          if (!s_valid[k]) continue;
          const float t = triangle_t(o, d, s_row[0][k], s_row[1][k], s_row[2][k], s_row[3][k],
                                     s_row[4][k], s_row[5][k], s_row[6][k], s_row[7][k],
                                     s_row[8][k]);
          if (t < best_t) {
            best_t = t;
            best_i = base + k;
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < rays.n) {
    out_t[i] = best_t;
    out_i[i] = best_i;
  }
}

// The walk's leaf tests: one prim's distance, f32 max on a miss.
struct SphereLeaf {
  SphereTable tab;
  float a, inv_a;

  __device__ void begin(V3 d) {
    a = dot(d, d);
    inv_a = 1.0f / a;
  }
  __device__ float t(V3 o, V3 d, int prim) const {
    const float r = __ldg(tab.radius + prim);
    return sphere_t(o, d, a, inv_a, __ldg(tab.cx + prim), __ldg(tab.cy + prim),
                    __ldg(tab.cz + prim), r * r);
  }
};

struct TriangleLeaf {
  TriangleTable tab;

  __device__ void begin(V3) {}
  __device__ float t(V3 o, V3 d, int prim) const {
    if (!tab.valid[prim]) return kInf;
    const float ax = __ldg(tab.ax + prim), ay = __ldg(tab.ay + prim), az = __ldg(tab.az + prim);
    return triangle_t(o, d, ax, ay, az, __ldg(tab.bx + prim) - ax, __ldg(tab.by + prim) - ay,
                      __ldg(tab.bz + prim) - az, __ldg(tab.cx + prim) - ax,
                      __ldg(tab.cy + prim) - ay, __ldg(tab.cz + prim) - az);
  }
};

// Entry distance of the ray into node c's box (ray_bounding_dst,
// wgsl:387-398): 0 from inside, f32 max on a miss; a NaN slab fails.
__device__ __forceinline__ float slab(const BvhTable& b, int c, V3 o, V3 inv) {
  const float tx1 = (__ldg(b.min_x + c) - o.x) * inv.x;
  const float tx2 = (__ldg(b.max_x + c) - o.x) * inv.x;
  const float ty1 = (__ldg(b.min_y + c) - o.y) * inv.y;
  const float ty2 = (__ldg(b.max_y + c) - o.y) * inv.y;
  const float tz1 = (__ldg(b.min_z + c) - o.z) * inv.z;
  const float tz2 = (__ldg(b.max_z + c) - o.z) * inv.z;
  const float t_near =
      max2_nan(max2_nan(min2_nan(tx1, tx2), min2_nan(ty1, ty2)), min2_nan(tz1, tz2));
  const float t_far =
      min2_nan(min2_nan(max2_nan(tx1, tx2), max2_nan(ty1, ty2)), max2_nan(tz1, tz2));
  if (t_far >= t_near && t_far > 0.0f) return t_near > 0.0f ? t_near : 0.0f;
  return kInf;
}

// K3/K4: the bounded-stack walk (raycast, wgsl:313-346; traverse.py
// _intersect_bvh_reference). `capacity` is the prim table's row count.
template <class Leaf>
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(RayBatch rays, BvhTable bvh, Leaf leaf, int capacity, float* __restrict__ out_t,
               int64_t* __restrict__ out_i) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  V3 o, d;
  float best_t = kInf;
  int best_i = -1;
  if (lane_ray(rays, i, o, d)) {
    Leaf lf = leaf;
    lf.begin(d);
    const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    int stack[kMaxStack];
    stack[0] = 0;   // the root; stack index 1 (wgsl:316-318)
    int sp = 1;
    while (sp > 0 && sp < bvh.stack_size) {   // wgsl:320
      const int node = stack[--sp];
      const int count = __ldg(bvh.count + node);
      const int first = __ldg(bvh.index + node);
      if (count > 0) {   // leaf: prims [first, first + count) (wgsl:348-362)
        for (int k = 0; k < bvh.max_leaf_size && k < count; ++k) {
          const int prim =
              bvh.prim_ids != nullptr
                  ? clampi(__ldg(bvh.prim_ids + clampi(first + k, 0, bvh.n_prim_ids - 1)), 0,
                           capacity - 1)
                  : clampi(first + k, 0, capacity - 1);
          const float t = lf.t(o, d, prim);
          if (t < best_t) {
            best_t = t;
            best_i = prim;
          }
        }
      } else if (count == 0) {   // inner: push the children ahead of the best hit
        const int c1 = clampi(first, 0, bvh.n_nodes - 1);
        const int c2 = clampi(first + 1, 0, bvh.n_nodes - 1);
        const float d1 = slab(bvh, c1, o, inv);
        const float d2 = slab(bvh, c2, o, inv);
        if (d1 < kInf && d1 < best_t) {
          if (sp < bvh.stack_size) stack[sp] = c1;
          ++sp;
        }
        if (d2 < kInf && d2 < best_t) {
          if (sp < bvh.stack_size) stack[sp] = c2;
          ++sp;
        }
      }
    }
  }
  out_t[i] = best_t;
  out_i[i] = best_i;
}

int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

void launch_intersect_spheres(const RayBatch& rays, const SphereTable& spheres, float* out_t,
                              int64_t* out_i, cudaStream_t stream) {
  if (rays.n == 0) return;
  spheres_kernel<<<grid_for(rays.n), kThreads, 0, stream>>>(rays, spheres, out_t, out_i);
}

void launch_intersect_triangles(const RayBatch& rays, const TriangleTable& tris, float* out_t,
                                int64_t* out_i, cudaStream_t stream) {
  if (rays.n == 0) return;
  triangles_kernel<<<grid_for(rays.n), kThreads, 0, stream>>>(rays, tris, out_t, out_i);
}

void launch_intersect_bvh(const RayBatch& rays, const BvhTable& bvh, const SphereTable& spheres,
                          float* out_t, int64_t* out_i, cudaStream_t stream) {
  if (rays.n == 0) return;
  bvh_kernel<SphereLeaf><<<grid_for(rays.n), kThreads, 0, stream>>>(
      rays, bvh, SphereLeaf{spheres, 0.0f, 0.0f}, spheres.n, out_t, out_i);
}

void launch_intersect_bvh_triangles(const RayBatch& rays, const BvhTable& bvh,
                                    const TriangleTable& tris, float* out_t, int64_t* out_i,
                                    cudaStream_t stream) {
  if (rays.n == 0) return;
  bvh_kernel<TriangleLeaf><<<grid_for(rays.n), kThreads, 0, stream>>>(
      rays, bvh, TriangleLeaf{tris}, tris.n, out_t, out_i);
}
