// The adaptive pass's map (K13) and fold (K14) and the sharded step's sums
// (K15) for Hopper (sm_90a).
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
//   the join of the sp shards (parallel/sharding.py:142-144, :231-232).
//
// Each computes what its plain PyTorch version (kernels/passes.py) computes,
// term for term, in IEEE float32 with no contraction (--fmad=false): the
// reciprocal of a clamped count as an IEEE division (torch's `1.0 / t` is
// `t.reciprocal() * 1.0`, and the multiply by one is exact), a NaN count
// kept by the clamp as torch.clamp keeps it, the float32 roundings of 1/3
// and 0.05, fabsf (|-0| = +0, as torch.abs), compares false on a NaN, and
// the dp parts added one after another in ascending order: the same bits in
// every pixel.
//
// Bound on an H100 SXM: bytes. K13 reads 4 bytes a pixel and writes 4 a
// lane; K14 reads 40 bytes a pixel (the pass's four sums, the film's six
// columns) and writes 24; K15 reads 16 * dp bytes a lane of each shard and
// writes 16. At 1920x1080 K14 moves 133 MB, 40 us at 3.35 TB/s. What the
// design does about it: one thread a pixel or lane, in row-major order for
// the film's columns, so every access is coalesced (a warp's 32 pixels of
// one row lie in one 64-wide block row), nothing is read twice, and the
// counts, the tolerance and the segment totals come as scalars.

#include <cstdint>

#include <cuda_runtime.h>

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

// K15: sum_shards_reference, one thread a lane of the joined sums.
__global__ void __launch_bounds__(kThreads) sum_shards_kernel(ShardSums a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j == 0) {
    int64_t total = 0;
    for (int p = 0; p < a.sp * a.dp; ++p) total += *a.segments[p];
    *a.total = total;
  }
  if (j >= a.sp * a.n) return;
  const int shard = j / a.n;
  const int l = j % a.n;
  for (int k = 0; k < 4; ++k) {
    float acc = a.part[shard * a.dp][k][l];
    for (int d = 1; d < a.dp; ++d) acc = acc + a.part[shard * a.dp + d][k][l];
    a.out[k][j] = acc;
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

void launch_adaptive_map(const AdaptiveMap& args, cudaStream_t stream) {
  if (args.lanes == 0) return;
  adaptive_map_kernel<<<grid_for(args.lanes), kThreads, 0, stream>>>(args);
}

void launch_fold_adaptive(const AdaptiveFold& args, cudaStream_t stream) {
  // At least one block: thread 0 writes the segment total.
  fold_adaptive_kernel<<<grid_for(args.width * args.height), kThreads, 0, stream>>>(args);
}

void launch_sum_shards(const ShardSums& args, cudaStream_t stream) {
  sum_shards_kernel<<<grid_for(args.sp * args.n), kThreads, 0, stream>>>(args);
}

cudaError_t passes_kernel_info(int which, WaveKernelInfo* out) {
  if (which == 0) return facts(adaptive_map_kernel, out);
  if (which == 1) return facts(fold_adaptive_kernel, out);
  if (which == 2) return facts(sum_shards_kernel, out);
  return cudaErrorInvalidValue;
}
