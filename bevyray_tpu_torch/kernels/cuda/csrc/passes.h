// The launch interface of the adaptive pass's map (K13) and fold (K14) and
// the sharded step's sums (K15), passes.cu, shared with their Python binding
// (binding.cpp). Plain C types only, so the .cu file needs none of
// PyTorch's headers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wavefront.h"

constexpr int kMaxParts = 32;   // the shards K15 takes (kernels/passes.py MAX_PARTS)

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
// depth (`part[p]`, `n` lanes each) and one int64 segment count
// (`segments[p]`); `out` r, g, b, depth of sp * n lanes: lane sp_i * n + l
// is the sum over dp_i in ascending order of the parts' lane l; `total`
// the sum of every part's segments.
struct ShardSums {
  const float* part[kMaxParts][4];
  const int64_t* segments[kMaxParts];
  float* out[4];
  int64_t* total;
  int sp;
  int dp;
  int n;
};
void launch_sum_shards(const ShardSums& args, cudaStream_t stream);

// The facts of K13 (which 0), K14 (1) or K15 (2).
cudaError_t passes_kernel_info(int which, WaveKernelInfo* out);
