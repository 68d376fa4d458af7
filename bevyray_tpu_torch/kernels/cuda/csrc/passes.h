// The launch interface of the adaptive pass's map (K13) and fold (K14), the
// sharded step's sums (K15) and its tp hit merge (K16), passes.cu, shared
// with their Python binding (binding.cpp). Plain C types only, so the .cu
// file needs none of PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wavefront.h"

// The parts one K15 launch adds, and the slices one K16 launch merges: their
// pointers travel as kernel arguments. More take more launches, each carrying
// the running result on (kernels/passes.py PARTS_PER_LAUNCH,
// SLICES_PER_LAUNCH).
constexpr int kPartsPerLaunch = 32;
constexpr int kSlicesPerLaunch = 32;

// K13: the sample map of an adaptive pass, int32 in the fused kernel's block
// order over a grid `nbx` blocks wide: `spp` on a pixel whose `err` is at or
// above `tolerance` (every pixel when `reprobe`), 0 elsewhere and on the
// lanes past the frame; `lanes` of them.
struct AdaptiveMap {
  const float* err;
  int* out;
  float tolerance;
  bool reprobe;
  int spp;
  int nbx;
  int width;
  int height;
  int lanes;
};
void launch_adaptive_map(const AdaptiveMap& args, cudaStream_t stream);

// K14: an adaptive pass folded into its film. `film` holds the colour sums
// r, g, b, the depth sum, the per-pixel sample counts and errors, row major;
// `pass` the pass's r, g, b, depth in block order (`nbx` blocks a row). The
// new film goes to `out` in the same six columns, the new segment total
// `total_out` = `total_in` + `segments` (one int64 each on the card).
struct AdaptiveFold {
  const float* film[6];
  const float* pass[4];
  float* out[6];
  const int64_t* total_in;
  const int64_t* segments;
  int64_t* total_out;
  float tolerance;
  bool reprobe;
  float spp;
  int nbx;
  int width;
  int height;
};
void launch_fold_adaptive(const AdaptiveFold& args, cudaStream_t stream);

// K15: the sharded step's sums. Part p = sp_i * dp + dp_i holds r, g, b and
// depth (`n` lanes each) and one int64 segment count; `out` r, g, b, depth
// of sp * n lanes: lane sp_i * n + l is the sum over dp_i in ascending order
// of the parts' lane l; `total` the sum of every part's segments. One launch
// adds parts `first` .. `first + count - 1` (`part[0]` is part `first`, at
// most kPartsPerLaunch of them): a shard whose first part is among them
// starts from it, one whose parts began in an earlier launch from its `out`
// lanes, and `total` likewise from 0 or from the earlier launches' total.
// Launches in ascending `first` give the one left fold's bits.
struct ShardSums {
  const float* part[kPartsPerLaunch][4];
  const int64_t* segments[kPartsPerLaunch];
  float* out[4];
  int64_t* total;
  int first;
  int count;
  int dp;
  int n;
};
void launch_sum_shards(const ShardSums& args, cudaStream_t stream);

// K16: the tp nearest-hit merge. Slice k holds each lane's nearest hit in
// its part of the sphere table, `t[k]` (float32, f32 max on a miss) and
// `index[k]` (int64, -1 on a miss), local to the slice, whose first sphere
// is `offset[k]`. `t_out` is torch.minimum of the t's over the slices in
// order, `index_out` the lowest global index among the slices reaching it,
// -1 where it is f32 max or more. `count` slices, at most kSlicesPerLaunch;
// for more, a later launch takes the output as its slice 0 (offset 0) and
// merges the next slices into it in place.
struct TpHits {
  const float* t[kSlicesPerLaunch];
  const int64_t* index[kSlicesPerLaunch];
  int64_t offset[kSlicesPerLaunch];
  float* t_out;
  int64_t* index_out;
  int count;
  int n;
};
void launch_merge_tp_hits(const TpHits& args, cudaStream_t stream);

// The facts of K13 (which 0), K14 (1), K15 (2) or K16 (3).
cudaError_t passes_kernel_info(int which, WaveKernelInfo* out);
