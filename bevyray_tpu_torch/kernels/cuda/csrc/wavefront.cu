// The wavefront renderer's ray tests for Hopper (sm_90a): the dense sphere
// and triangle tests and the BVH walk.
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
// triangle test 60 with one IEEE reciprocal, a BVH box test 27. Each ray
// reads 25 bytes and writes 12, and the tables are a few KB to a few
// hundred KB, so at the headline (2 M rays x 512 spheres) the operations
// take ~14 times as long as the bytes. Without contraction each operation
// is one issued instruction, so K1's floor is the issue rate (0.66 ms at
// the headline's bounce 0, PERF.md; 17 of the 21 operations come before
// the discriminant's sign, so ~0.54 ms where few pairs pass it), and
// what stands above it is every other instruction a (ray, sphere) pair
// pays. The walk's node and prim reads differ across a warp after bounce
// 0, so K3's time goes to the latency of its dependent loads, not to
// arithmetic. What the design does about it:
//
// - K1 gives each thread up to kDenseRays rays, so that one 16-byte row
//   (cx, cy, cz, r * r) read from shared memory feeds that many pairs. An
//   invalid row is staged with r * r = NaN: c and so the discriminant are
//   NaN, `disc >= 0` fails and the row never wins, with no load of a valid
//   flag and no branch on it. Each pair pays its 17 operations to the
//   discriminant and one compare; one branch a row, taken where any of the
//   thread's rays has `disc >= 0`, guards the sqrt and the acceptance, so
//   a negative discriminant never reaches the sqrt (whose IEEE path calls
//   a slow subroutine for inputs with the sign bit set, megakernel.cu).
//   The table is staged once a block, in tiles of kRowsK1 rows (32 KB)
//   where it is larger;
// - K1 and K2 compact each block's active lanes first (the bounce loop
//   launches them masked over every lane): the live rays go to the first
//   threads, each thread takes as many rays as the block's count needs, a
//   warp with none skips the rows, and a block with no active lane returns
//   before staging anything. Where the batch fills the card's resident
//   blocks at kDenseRays rays a thread, whole waves of blocks take that
//   many and the lanes left go in blocks of one ray a thread, so that the
//   last wave, which part of the card runs alone, is short; a smaller
//   batch takes fewer rays a thread, so that every resident slot gets a
//   block. The two share that skeleton (dense_kernel) and differ in their
//   rows;
// - K2 stages the valid rows of each tile of kRowsK2 table rows
//   compacted (a ballot and a popcount a warp, in ascending order, each
//   with its row index), the corner and the edges computed once a row, as
//   three 16-byte rows: the loop runs over the live rows only (12 of
//   config 5's 128), three shared loads feed a thread's rays, and no
//   valid flag is read. A pair whose |det| or u fails leaves the row
//   before q, v and t (~32 of its 60 operations). A dead slot runs the
//   block's last live ray, not a zero direction whose det of 0 sends the
//   IEEE reciprocal to its slow path on every row;
// - the dense tests keep a strict t < best in ascending row order, which
//   gives the lowest index on every tie, as the plain version's chunk rule
//   does;
// - K3 walks a paired-child record built with the scene (core/types.py
//   `make_sphere_walk`): a popped node is one round of four independent
//   16-byte loads, which hold an inner node's two children's boxes, or a
//   leaf's first sphere row and prim id, beside the node's count and index (the columns took two dependent rounds, and a
//   leaf a third). The stack of node ids stays in the thread's local
//   memory, which L1 holds: in shared memory (32 entries x 256 threads)
//   it ran no faster and took L1's room from the record (PERF.md). Each
//   ray visits the nodes in the plain version's order (the first child
//   pushed first, so popped second, each pruned by d < best_t), so the
//   first hit found along that order wins a tie, as in the reference; a
//   push past the top is dropped and stops the walk (the reference's
//   silent truncation), and the slab test keeps the NaN of a face plane
//   through the ray's origin (min2_nan/max2_nan);
// - K4 walks the BvhNodes columns themselves, one thread per ray, its
//   stack in the thread.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "wavefront.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsK1 = 2048;   // K1: sphere rows per staged tile (32 KB)
constexpr int kRowsK2 = 512;    // K2: triangle table rows per staged tile (<= 24 KB)

constexpr int kMaxDevices = 64;

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// The lane's ray, or false for a lane past the batch or inactive.
__device__ __forceinline__ bool lane_ray(const RayBatch& r, int i, V3& o, V3& d) {
  if (i >= r.n || (r.active != nullptr && !r.active[i])) return false;
  o = {r.ox[i], r.oy[i], r.oz[i]};
  d = {r.dx[i], r.dy[i], r.dz[i]};
  return true;
}

// The near-root sphere test (hit_sphere, wgsl:371-383; intersect.py
// intersect_spheres_reference) in two steps: the discriminant, with `h` =
// d.(c - o), then the root. `a` = d.d, `inv_a` = 1 / a, `r2` = r * r.
__device__ __forceinline__ float sphere_disc(V3 o, V3 d, float a, float cx, float cy, float cz,
                                             float r2, float& h) {
  const float ocx = cx - o.x;
  const float ocy = cy - o.y;
  const float ocz = cz - o.z;
  h = d.x * ocx + d.y * ocy + d.z * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  return h * h - a * c;
}

// The root where disc >= 0: accepted where t > T_MIN.
__device__ __forceinline__ float sphere_root(float h, float disc, float inv_a) {
  return (h - sqrtf(disc)) * inv_a;
}

// Near-root sphere distance: f32 max unless disc >= 0 and t > T_MIN.
__device__ __forceinline__ float sphere_t(V3 o, V3 d, float a, float inv_a, float cx, float cy,
                                          float cz, float r2) {
  float h;
  const float disc = sphere_disc(o, d, a, cx, cy, cz, r2, h);
  if (!(disc >= 0.0f)) return kInf;
  const float t = sphere_root(h, disc, inv_a);
  return t > kTMin ? t : kInf;
}

// Moller-Trumbore, two-sided (intersect.py _chunk_hits) from the corner a
// and the edges e1 = b - a, e2 = c - a: f32 max unless |det| > 1e-12,
// u >= 0, v >= 0, u + v <= 1 and t > T_MIN. With kExit a pair whose |det|
// or u fails returns before q, v and t: it skips only terms of a pair that
// the final test rejects, so it gives the same value.
template <bool kExit>
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
  if (kExit && !(fabsf(det) > 1e-12f && u >= 0.0f)) return kInf;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin;
  return ok ? t : kInf;
}

// ---- the dense tests: K1 and K2 ----------------------------------------------

// K1's rows against the Q rays of each thread: lanes `s_lane[threadIdx.x +
// j * kThreads]` for the slots below `m` (the block's active lanes, in
// lane order). A dead slot carries a NaN origin: its discriminants are
// NaN and it never enters the sqrt branch.
template <int Q>
__device__ __forceinline__ void dense_scan(const RayBatch& rays, const SphereTable& tab,
                                           const int* s_lane, int m, float4* s_row,
                                           float* __restrict__ out_t,
                                           int64_t* __restrict__ out_i) {
  V3 o[Q], d[Q];
  float a[Q], inv_a[Q], best_t[Q];
  int best_i[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int slot = threadIdx.x + j * kThreads;
    const int i = slot < m ? s_lane[slot] : -1;
    if (i >= 0) {
      o[j] = {rays.ox[i], rays.oy[i], rays.oz[i]};
      d[j] = {rays.dx[i], rays.dy[i], rays.dz[i]};
    } else {
      const float nan = __int_as_float(0x7fc00000);
      o[j] = {nan, nan, nan};
      d[j] = {0.0f, 0.0f, 0.0f};
    }
    a[j] = dot(d[j], d[j]);
    inv_a[j] = 1.0f / a[j];
    best_t[j] = kInf;
    best_i[j] = -1;
  }
  const bool warp_live = (threadIdx.x & ~31) < m;   // slot 0 is the warp's lowest
  for (int base = 0; base < tab.n; base += kRowsK1) {
    const int rows = min(kRowsK1, tab.n - base);
    if (base > 0) __syncthreads();   // every warp is done with the last tile
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const int s = base + k;
      const float r = tab.radius[s];
      s_row[k] = make_float4(tab.cx[s], tab.cy[s], tab.cz[s],
                             tab.valid[s] ? r * r : __int_as_float(0x7fc00000));
    }
    __syncthreads();
    if (!warp_live) continue;
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      const float4 row = s_row[k];
      float h[Q], disc[Q];
      bool any = false;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        disc[j] = sphere_disc(o[j], d[j], a[j], row.x, row.y, row.z, row.w, h[j]);
        any |= disc[j] >= 0.0f;
      }
      if (any) {
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          if (disc[j] >= 0.0f) {
            const float t = sphere_root(h[j], disc[j], inv_a[j]);
            if (t > kTMin && t < best_t[j]) {
              best_t[j] = t;
              best_i[j] = base + k;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int slot = threadIdx.x + j * kThreads;
    if (slot < m) {
      const int i = s_lane[slot];
      out_t[i] = best_t[j];
      out_i[i] = best_i[j];
    }
  }
}

// K2's rows against the Q rays of each thread (the slots of K1's scan). A
// dead slot takes the block's last live ray and writes nothing: a zero
// direction would give det = 0, whose IEEE reciprocal takes the slow path
// on every row. A tile of kRowsK2 table rows is staged compacted: its
// valid rows in ascending order, each as three float4 (ax, ay, az, e1x),
// (e1y, e1z, e2x, e2y), (e2z, the row's index, 0, 0), so that the loop
// runs over the live rows only, three 16-byte loads a row and no valid
// flag.
template <int Q>
__device__ __forceinline__ void dense_scan(const RayBatch& rays, const TriangleTable& tab,
                                           const int* s_lane, int m, float4* s_row,
                                           float* __restrict__ out_t,
                                           int64_t* __restrict__ out_i) {
  __shared__ int s_count[2][kWarps];   // valid rows a warp, two rounds in turn
  V3 o[Q], d[Q];
  float best_t[Q];
  int best_i[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int i = s_lane[min(static_cast<int>(threadIdx.x) + j * kThreads, m - 1)];
    o[j] = {rays.ox[i], rays.oy[i], rays.oz[i]};
    d[j] = {rays.dx[i], rays.dy[i], rays.dz[i]};
    best_t[j] = kInf;
    best_i[j] = -1;
  }
  const bool warp_live = (threadIdx.x & ~31) < m;
  const int warp = threadIdx.x / 32;
  const unsigned below = (1u << (threadIdx.x % 32)) - 1u;
  int turn = 0;
  for (int base = 0; base < tab.n; base += kRowsK2) {
    const int rows = min(kRowsK2, tab.n - base);
    if (base > 0) __syncthreads();   // every warp is done with the last tile
    int live = 0;   // the tile's valid rows staged so far
    for (int k0 = 0; k0 < rows; k0 += kThreads, turn ^= 1) {
      const int k = k0 + threadIdx.x;
      const int s = base + k;
      const bool valid = k < rows && tab.valid[s];
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (threadIdx.x % 32 == 0) s_count[turn][warp] = __popc(ballot);
      __syncthreads();
      int slot = live + __popc(ballot & below);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_count[turn][w];
        slot += w < warp ? c : 0;
        live += c;
      }
      if (valid) {
        const float ax = tab.ax[s], ay = tab.ay[s], az = tab.az[s];
        float4* row = s_row + 3 * slot;
        row[0] = make_float4(ax, ay, az, tab.bx[s] - ax);
        row[1] = make_float4(tab.by[s] - ay, tab.bz[s] - az, tab.cx[s] - ax, tab.cy[s] - ay);
        row[2] = make_float4(tab.cz[s] - az, __int_as_float(s), 0.0f, 0.0f);
      }
    }
    __syncthreads();
    if (!warp_live) continue;
#pragma unroll 2
    for (int k = 0; k < live; ++k) {
      const float4 r0 = s_row[3 * k], r1 = s_row[3 * k + 1], r2 = s_row[3 * k + 2];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float t = triangle_t<true>(o[j], d[j], r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z,
                                         r1.w, r2.x);
        if (t < best_t[j]) {
          best_t[j] = t;
          best_i[j] = __float_as_int(r2.y);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int slot = threadIdx.x + j * kThreads;
    if (slot < m) {
      const int i = s_lane[slot];
      out_t[i] = best_t[j];
      out_i[i] = best_i[j];
    }
  }
}

// The scan at the block's ray count: q rays a thread (1 <= q <= Q).
template <int Q, class Table>
__device__ void dense_dispatch(int q, const RayBatch& rays, const Table& tab, const int* s_lane,
                               int m, float4* s_row, float* __restrict__ out_t,
                               int64_t* __restrict__ out_i) {
  if constexpr (Q > 1) {
    if (q < Q) {
      dense_dispatch<Q - 1>(q, rays, tab, s_lane, m, s_row, out_t, out_i);
      return;
    }
  }
  dense_scan<Q>(rays, tab, s_lane, m, s_row, out_t, out_i);
}

// K1 (Table = SphereTable) and K2 (TriangleTable): every active ray
// against every valid row of the table. A block takes kThreads x
// `per_thread` consecutive lanes and compacts its active ones: kDenseRays
// a thread in the first `wide` blocks, `tail` in the others. Three blocks
// an SM: K1 80 registers a thread and no spill (PERF.md).
template <class Table>
__global__ void __launch_bounds__(kThreads, 3)
    dense_kernel(RayBatch rays, Table tab, int wide, int tail, float* __restrict__ out_t,
                 int64_t* __restrict__ out_i) {
  const int block = static_cast<int>(blockIdx.x);
  const int per_thread = block < wide ? kDenseRays : tail;
  const int first = block < wide ? block * (kThreads * kDenseRays)
                                 : wide * (kThreads * kDenseRays) + (block - wide) * (kThreads * tail);
  extern __shared__ float4 s_row[];
  __shared__ int s_lane[kThreads * kDenseRays];
  __shared__ int s_start[kDenseRays * kWarps + 1];   // each (chunk, warp)'s first slot
  const int warp = threadIdx.x / 32;
  const unsigned below = (1u << (threadIdx.x % 32)) - 1u;
  bool live[kDenseRays];
#pragma unroll
  for (int c = 0; c < kDenseRays; ++c) {
    const int i = first + c * kThreads + threadIdx.x;
    live[c] = c < per_thread && i < rays.n && (rays.active == nullptr || rays.active[i]);
    const unsigned ballot = __ballot_sync(0xffffffffu, live[c]);
    if (threadIdx.x % 32 == 0) s_start[c * kWarps + warp] = __popc(ballot);
    if (c < per_thread && i < rays.n && !live[c]) {
      out_t[i] = kInf;
      out_i[i] = -1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // exclusive scan of the counts; the total last
    int sum = 0;
    for (int k = 0; k < kDenseRays * kWarps; ++k) {
      const int n = s_start[k];
      s_start[k] = sum;
      sum += n;
    }
    s_start[kDenseRays * kWarps] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kDenseRays; ++c) {
    const unsigned ballot = __ballot_sync(0xffffffffu, live[c]);
    if (live[c]) {
      s_lane[s_start[c * kWarps + warp] + __popc(ballot & below)] =
          first + c * kThreads + threadIdx.x;
    }
  }
  const int m = s_start[kDenseRays * kWarps];
  __syncthreads();
  if (m == 0) return;   // the whole block: skip the table
  dense_dispatch<kDenseRays>((m + kThreads - 1) / kThreads, rays, tab, s_lane, m, s_row, out_t,
                             out_i);
}

// ---- the walks ---------------------------------------------------------------

// Entry distance of the ray into a box (ray_bounding_dst, wgsl:387-398): 0
// from inside, f32 max on a miss; a NaN slab fails.
__device__ __forceinline__ float slab(float min_x, float min_y, float min_z, float max_x,
                                      float max_y, float max_z, V3 o, V3 inv) {
  const float tx1 = (min_x - o.x) * inv.x;
  const float tx2 = (max_x - o.x) * inv.x;
  const float ty1 = (min_y - o.y) * inv.y;
  const float ty2 = (max_y - o.y) * inv.y;
  const float tz1 = (min_z - o.z) * inv.z;
  const float tz2 = (max_z - o.z) * inv.z;
  const float t_near =
      max2_nan(max2_nan(min2_nan(tx1, tx2), min2_nan(ty1, ty2)), min2_nan(tz1, tz2));
  const float t_far =
      min2_nan(min2_nan(max2_nan(tx1, tx2), max2_nan(ty1, ty2)), max2_nan(tz1, tz2));
  if (t_far >= t_near && t_far > 0.0f) return t_near > 0.0f ? t_near : 0.0f;
  return kInf;
}

// Node c's box from the BvhNodes columns.
__device__ __forceinline__ float slab(const BvhTable& b, int c, V3 o, V3 inv) {
  return slab(__ldg(b.min_x + c), __ldg(b.min_y + c), __ldg(b.min_z + c), __ldg(b.max_x + c),
              __ldg(b.max_y + c), __ldg(b.max_z + c), o, inv);
}

__device__ __forceinline__ float bits(int x) { return __int_as_float(x); }

// K3: the bounded-stack walk (raycast, wgsl:313-346; traverse.py
// _intersect_bvh_reference) over the paired-child record.
__global__ void __launch_bounds__(kThreads)
    walk_spheres_kernel(RayBatch rays, SphereWalk w, float* __restrict__ out_t,
                        int64_t* __restrict__ out_i) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  V3 o, d;
  float best_t = kInf;
  int best_i = -1;
  if (lane_ray(rays, i, o, d)) {
    const float a = dot(d, d);
    const float inv_a = 1.0f / a;
    const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    int stack[kMaxStack];   // in the thread's local memory
    stack[0] = 0;   // the root; stack index 1 (wgsl:316-318)
    int sp = 1;
    while (sp > 0 && sp < w.stack_size) {   // wgsl:320
      const int4* rec = w.nodes + 4 * static_cast<int64_t>(stack[--sp]);
      const int4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2), q3 = __ldg(rec + 3);
      const int count = q3.x;
      const int first = q3.y;
      if (count > 0) {   // leaf: prims of slots [first, first + count) (wgsl:348-362)
        const float r = bits(q0.w);
        float t = sphere_t(o, d, a, inv_a, bits(q0.x), bits(q0.y), bits(q0.z), r * r);
        if (t < best_t) {
          best_t = t;
          best_i = q3.z;
        }
        for (int k = 1; k < w.max_leaf_size && k < count; ++k) {
          const int s = clampi(first + k, 0, w.n_slots - 1);
          const float4 row = __ldg(w.rows + s);
          t = sphere_t(o, d, a, inv_a, row.x, row.y, row.z, row.w * row.w);
          if (t < best_t) {
            best_t = t;
            best_i = __ldg(w.prims + s);
          }
        }
      } else if (count == 0) {   // inner: push the children ahead of the best hit
        const float d1 = slab(bits(q0.x), bits(q0.y), bits(q0.z), bits(q0.w), bits(q1.x),
                              bits(q1.y), o, inv);
        const float d2 = slab(bits(q1.z), bits(q1.w), bits(q2.x), bits(q2.y), bits(q2.z),
                              bits(q2.w), o, inv);
        if (d1 < kInf && d1 < best_t) {
          if (sp < w.stack_size) stack[sp] = clampi(first, 0, w.n_nodes - 1);
          ++sp;
        }
        if (d2 < kInf && d2 < best_t) {
          if (sp < w.stack_size) stack[sp] = clampi(first + 1, 0, w.n_nodes - 1);
          ++sp;
        }
      }
    }
  }
  out_t[i] = best_t;
  out_i[i] = best_i;
}

// K4: the same walk over the BvhNodes columns with a triangle leaf.
// `capacity` is the triangle table's row count.
__global__ void __launch_bounds__(kThreads)
    walk_triangles_kernel(RayBatch rays, BvhTable bvh, TriangleTable tab, int capacity,
                          float* __restrict__ out_t, int64_t* __restrict__ out_i) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  V3 o, d;
  float best_t = kInf;
  int best_i = -1;
  if (lane_ray(rays, i, o, d)) {
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
          if (!tab.valid[prim]) continue;
          const float ax = __ldg(tab.ax + prim), ay = __ldg(tab.ay + prim),
                      az = __ldg(tab.az + prim);
          const float t = triangle_t<false>(
              o, d, ax, ay, az, __ldg(tab.bx + prim) - ax, __ldg(tab.by + prim) - ay,
              __ldg(tab.bz + prim) - az, __ldg(tab.cx + prim) - ax, __ldg(tab.cy + prim) - ay,
              __ldg(tab.cz + prim) - az);
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

int grid_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

// Dynamic shared memory of a dense test's staged tile over a table of
// `rows` rows.
size_t dense_smem(const SphereTable&, int rows) {
  return static_cast<size_t>(std::min(rows, kRowsK1)) * sizeof(float4);
}
size_t dense_smem(const TriangleTable&, int rows) {
  return static_cast<size_t>(std::min(rows, kRowsK2)) * 3 * sizeof(float4);
}

template <class Kernel>
cudaError_t facts(Kernel kernel, size_t smem, WaveKernelInfo* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *out = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
          static_cast<int>(attr.sharedSizeBytes), static_cast<int>(smem), blocks};
  return cudaSuccess;
}

// A dense test's grid: whole waves of blocks of kDenseRays rays a thread
// (one block on each resident slot of the card), then the lanes left in
// blocks of one ray a thread, so that the last wave is short. Lanes too
// few for one such wave take one width in every block, the most that
// keeps a block on every slot.
template <class Table>
void launch_dense(const RayBatch& rays, const Table& tab, float* out_t, int64_t* out_i,
                  cudaStream_t stream) {
  if (rays.n == 0) return;
  static int slots[kMaxDevices] = {};   // one per Table: its kernel's
  int device = 0;
  cudaGetDevice(&device);
  int resident = 0;
  if (device < kMaxDevices) resident = slots[device];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_kernel<Table>, kThreads,
                                                  dense_smem(tab, 1 << 30));
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
    if (device < kMaxDevices) slots[device] = resident;
  }
  const int wave = kThreads * kDenseRays * resident;   // lanes of a whole wide wave
  int wide = rays.n / wave * resident, tail = 1;
  if (wide == 0) tail = std::min(std::max(rays.n / (kThreads * resident), 1), kDenseRays);
  const int left = rays.n - wide * kThreads * kDenseRays;
  const int grid = wide + grid_for(left, kThreads * tail);
  dense_kernel<Table><<<grid, kThreads, dense_smem(tab, tab.n), stream>>>(rays, tab, wide, tail,
                                                                        out_t, out_i);
}

}  // namespace

void launch_intersect_spheres(const RayBatch& rays, const SphereTable& spheres, float* out_t,
                              int64_t* out_i, cudaStream_t stream) {
  launch_dense(rays, spheres, out_t, out_i, stream);
}

void launch_intersect_triangles(const RayBatch& rays, const TriangleTable& tris, float* out_t,
                                int64_t* out_i, cudaStream_t stream) {
  launch_dense(rays, tris, out_t, out_i, stream);
}

void launch_intersect_bvh(const RayBatch& rays, const SphereWalk& walk, float* out_t,
                          int64_t* out_i, cudaStream_t stream) {
  if (rays.n == 0) return;
  walk_spheres_kernel<<<grid_for(rays.n, kThreads), kThreads, 0, stream>>>(rays, walk, out_t,
                                                                           out_i);
}

void launch_intersect_bvh_triangles(const RayBatch& rays, const BvhTable& bvh,
                                    const TriangleTable& tris, float* out_t, int64_t* out_i,
                                    cudaStream_t stream) {
  if (rays.n == 0) return;
  walk_triangles_kernel<<<grid_for(rays.n, kThreads), kThreads, 0, stream>>>(
      rays, bvh, tris, tris.n, out_t, out_i);
}

cudaError_t wavefront_kernel_info(int which, int rows, WaveKernelInfo* out) {
  if (which == 0 && rows >= 1) {
    return facts(dense_kernel<SphereTable>, dense_smem(SphereTable{}, rows), out);
  }
  if (which == 1) return facts(walk_spheres_kernel, 0, out);
  if (which == 2 && rows >= 1) {
    return facts(dense_kernel<TriangleTable>, dense_smem(TriangleTable{}, rows), out);
  }
  return cudaErrorInvalidValue;
}
