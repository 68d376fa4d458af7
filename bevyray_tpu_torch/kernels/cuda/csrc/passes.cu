// The adaptive pass's map (K13) and fold (K14) and the sharded step's sums
// (K15) and tp hit merge (K16) for Hopper (sm_90a).
//
// They replace XLA code of the JAX package, not a `pl.pallas_call`:
//
// - adaptive_map (K13): `shuffle_blocks(where(err >= tolerance | reprobe,
//   spp, 0))` of `_adaptive_pass` (bevyray_tpu/engine/adaptive.py:66-68,
//   kernels/pallas/megakernel.py:2754), the sample map the fused kernel reads;
// - fold_adaptive (K14): the rest of the pass after `render_tiles`
//   (adaptive.py:73-100): the un-shuffle of its sums, the inter-pass
//   disagreement and the film's adds, into new tensors (the old film stays
//   as it was), and the segment total;
// - sum_shards (K15): `jax.lax.psum` of the sharded steps' sums over dp and
//   the join of the sp shards (parallel/sharding.py:142-144, :231-232);
// - merge_tp_hits (K16): the wavefront sharded step's nearest hit over the
//   tp slices of the sphere table (`_tp_intersect_fn`, parallel/sharding.py:
//   84-92): each slice's index offset, `pmin` over t, `pmin` over the lowest
//   index reaching it, -1 where the least t is INF.
//
// Each computes what its plain PyTorch version (kernels/passes.py) computes,
// term for term, in IEEE float32 with no contraction (--fmad=false): the
// reciprocal of a clamped count as an IEEE division (torch's `1.0 / t` is
// `t.reciprocal() * 1.0`, and the multiply by one is exact), a NaN count
// kept by the clamp as torch.clamp keeps it, the float32 roundings of 1/3
// and 0.05, fabsf (|-0| = +0, as torch.abs), compares false on a NaN, and
// the dp parts added one after another in ascending order, the least t by
// torch.minimum's rule on the card (a NaN operand wins, the first of two;
// else fminf): the same bits in every pixel. K15's and K16's pointers are
// kernel arguments, so a launch takes at most 32 parts or slices; more take
// more launches, each carrying the running sum or nearest hit through the
// output (a left fold in chunks is the whole fold, bit for bit; the least t
// and the lowest index are exact and associative).
//
// Bound on an H100 SXM: bytes. K13 reads 4 bytes a pixel and writes 4 a
// lane; K14 reads 40 bytes a pixel (the pass's four sums, the film's six
// columns) and writes 24; K15 reads 16 * dp bytes a lane of each shard and
// writes 16; K16 reads 12 bytes a lane of each slice and writes 12. At
// 1920x1080 K14 moves 133 MB, 40 us at 3.35 TB/s; K16 at tp = 2 75 MB, 22
// us. What the design does about it: one thread a pixel or lane, in
// row-major order for the film's columns, so every access is coalesced (a
// warp's 32 pixels of one row lie in one 64-wide block row), nothing is
// read twice (K16 keeps the running least t and index in registers, in one
// pass over the slices), and the counts, the tolerance, the offsets and
// the segment totals come as scalars.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "passes.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockW = 64;   // the fused kernel's pixel block (megakernel.py BLOCK_W, BLOCK_H)
constexpr int kBlockH = 64;

// The lane of pixel (x, y) in the block order of a grid `nbx` blocks wide.
__device__ __forceinline__ int block_lane(int x, int y, int nbx) {
  return ((y / kBlockH * nbx + x / kBlockW) * kBlockH + y % kBlockH) * kBlockW + x % kBlockW;
}

// 1.0 / torch.clamp(n, min=1.0): a NaN count stays NaN.
__device__ __forceinline__ float inv_count(float n) {
  return 1.0f / (n != n ? n : (n < 1.0f ? 1.0f : n));
}

// K13: adaptive_map_reference, one thread a lane of the block grid.
__global__ void __launch_bounds__(kThreads) adaptive_map_kernel(AdaptiveMap a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.lanes) return;
  const int tile = kBlockW * kBlockH;
  const int block = lane / tile;
  const int r = lane % tile;
  const int x = block % a.nbx * kBlockW + r % kBlockW;
  const int y = block / a.nbx * kBlockH + r / kBlockW;
  int target = 0;
  if (x < a.width && y < a.height) {
    const bool want = a.reprobe || __ldg(a.err + y * a.width + x) >= a.tolerance;
    target = want ? a.spp : 0;
  }
  a.out[lane] = target;
}

// K14: fold_adaptive_reference, one thread a pixel.
__global__ void __launch_bounds__(kThreads) fold_adaptive_kernel(AdaptiveFold a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p == 0) *a.total_out = *a.total_in + *a.segments;
  if (p >= a.width * a.height) return;
  const int src = block_lane(p % a.width, p / a.width, a.nbx);
  float film[6];
  for (int k = 0; k < 6; ++k) film[k] = a.film[k][p];
  float sum[4];
  for (int k = 0; k < 4; ++k) sum[k] = a.pass[k][src];
  const float n = film[4];
  const float err = film[5];
  const bool want = a.reprobe || err >= a.tolerance;
  const float took = (want ? 1.0f : 0.0f) * a.spp;
  const float old_inv = inv_count(n);
  const float new_inv = inv_count(took);
  float old_mean[3];
  float delta = 0.0f;
  for (int k = 0; k < 3; ++k) {
    old_mean[k] = film[k] * old_inv;
    const float d = fabsf(sum[k] * new_inv - old_mean[k]);
    delta = k == 0 ? d : delta + d;
  }
  const float third = 1.0f / 3.0f;   // float32(1 / 3), as torch rounds the Python float
  const float lum = (old_mean[0] + old_mean[1] + old_mean[2]) * third;
  const float rel = delta * third / (lum + 0.05f);
  float new_err = err;
  if (want) new_err = n > 0.0f ? rel : __int_as_float(0x7f800000);   // +inf
  for (int k = 0; k < 4; ++k) a.out[k][p] = film[k] + sum[k];
  a.out[4][p] = n + took;
  a.out[5][p] = new_err;
}

// K15: sum_shards_reference, one thread a lane of the shards that parts
// first .. first + count - 1 belong to.
__global__ void __launch_bounds__(kThreads) sum_shards_kernel(ShardSums a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j == 0) {
    int64_t total = a.first == 0 ? 0 : *a.total;
    for (int p = 0; p < a.count; ++p) total += *a.segments[p];
    *a.total = total;
  }
  const int first_shard = a.first / a.dp;
  const int shards = (a.first + a.count - 1) / a.dp - first_shard + 1;
  if (j >= shards * a.n) return;
  const int shard = first_shard + j / a.n;
  const int l = j % a.n;
  const int begin = shard * a.dp;   // the shard's first part
  const int lo = begin > a.first ? begin : a.first;
  const int hi = min(begin + a.dp, a.first + a.count);
  const int out = shard * a.n + l;
  // A shard that starts here starts from its first part, one that began
  // in an earlier launch from the sums that launch left; then part after
  // part in ascending order.
  const bool starts = lo == begin;
  for (int k = 0; k < 4; ++k) {
    float acc = starts ? a.part[lo - a.first][k][l] : a.out[k][out];
    for (int p = starts ? lo + 1 : lo; p < hi; ++p) acc = acc + a.part[p - a.first][k][l];
    a.out[k][out] = acc;
  }
}

// torch.minimum of two float32 on the card, NaN bits included: a NaN
// operand, the first of two; else fminf. (common.cuh's min2_nan gives the
// NaN of x + y, which the plain version does not.)
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// K16: merge_tp_hits_reference, one thread a lane, one pass over the
// slices. The running index is the lowest over the slices so far whose t
// equals the running least t: when the least t changes, no earlier slice
// reaches the new one (it is smaller than every earlier t, or NaN).
__global__ void __launch_bounds__(kThreads) merge_tp_hits_kernel(TpHits a) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= a.n) return;
  constexpr int64_t kNone = INT64_MAX;
  float t_min = 0.0f;
  int64_t i_min = kNone;
  for (int k = 0; k < a.count; ++k) {
    const float t = a.t[k][l];
    const int64_t i = a.index[k][l];
    const int64_t global = i >= 0 ? i + a.offset[k] : -1;
    const float least = k == 0 ? t : torch_minimum(t_min, t);
    if (k > 0 && !(least == t_min)) i_min = kNone;
    if (t == least && global >= 0 && global < i_min) i_min = global;
    t_min = least;
  }
  a.t_out[l] = t_min;
  a.index_out[l] = t_min >= kInf ? -1 : i_min;
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

void launch_adaptive_map(const AdaptiveMap& args, cudaStream_t stream) {
  if (args.lanes == 0) return;
  adaptive_map_kernel<<<grid_for(args.lanes), kThreads, 0, stream>>>(args);
}

void launch_fold_adaptive(const AdaptiveFold& args, cudaStream_t stream) {
  // At least one block: thread 0 writes the segment total.
  fold_adaptive_kernel<<<grid_for(args.width * args.height), kThreads, 0, stream>>>(args);
}

void launch_sum_shards(const ShardSums& args, cudaStream_t stream) {
  // The lanes of the shards this launch's parts belong to; at least one
  // block: thread 0 writes the segment total.
  const int shards = (args.first + args.count - 1) / args.dp - args.first / args.dp + 1;
  sum_shards_kernel<<<grid_for(shards * args.n), kThreads, 0, stream>>>(args);
}

void launch_merge_tp_hits(const TpHits& args, cudaStream_t stream) {
  if (args.n == 0) return;
  merge_tp_hits_kernel<<<grid_for(args.n), kThreads, 0, stream>>>(args);
}

cudaError_t passes_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(adaptive_map_kernel, out);
  if (which == 1) return facts(fold_adaptive_kernel, out);
  if (which == 2) return facts(sum_shards_kernel, out);
  if (which == 3) return facts(merge_tp_hits_kernel, out);
  return cudaErrorInvalidValue;
}
