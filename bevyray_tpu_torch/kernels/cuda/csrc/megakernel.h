// The launch interface of the fused path-tracing kernel (megakernel.cu),
// shared with its Python binding (binding.cpp). Plain C types only, so the
// .cu file needs none of PyTorch's headers.

#pragma once

#include <cuda_runtime.h>

struct RenderArgs {
  const float* cam;     // (24,) packed camera row
  const float* sph;     // (4, n_spheres): cx, cy, cz, r²
  const float* attr;    // (13, attr_stride): center (triangle normal) xyz, 10 material floats
  const float* gaabb;   // (6, gaabb_stride): min xyz, max xyz of each box
  const float* tri;     // (10, tri_stride): ax, ay, az, bx, ..., cz, valid
  const float* sl;      // (n_tiles, 5, sl_cap) shortlists, or null
  const float* slmeta;  // (n_tiles, 1 + sl_cap / 8): [full flag, chunk t_lo...]
  const int* spp_map;   // (n_tiles * 4096,) per-lane sample targets, block-ordered, or null
  float* out_r;
  float* out_g;
  float* out_b;
  float* out_depth;
  long long* segments;  // one int64, added to
  int n_spheres;
  int attr_stride;
  int gaabb_stride;
  int tri_stride;       // triangle rows of the table (padded)
  int n_tris_live;      // rows the walks test: the last valid one + 1 (0: none)
  int n_tiles;          // 64x64 pixel blocks this launch renders (outputs hold n_tiles * 4096)
  int block_offset;     // global index of the first of them (a shard's offset)
  int nbx;              // blocks per row of the frame's grid
  int width;
  int height;
  int spp;
  int bounces;
  unsigned int seed;
  unsigned int sample_offset;  // added to every sample index (mod 2^32)
  float inv_spp;
  int level;
  int defocus;
  int cosine;
  int split;            // bounce 0 walks the block's shortlist
  int candidates;       // the full walk visits candidate groups only
  int sl_cap;           // shortlist capacity K (a multiple of 8, <= 512)
  int gc;               // spheres per candidate group
  int n_cand;           // candidate groups
  int cand_off;         // gaabb column of candidate group 0
  int fast_rng;         // the fast draw path (else the exact PCG streams)
  int draw_words;       // fast path: words per bounce, 6, 9 or 13
  int fuse;             // pixel blocks per CUDA block's lane positions: 1, 2, 4, 8
};

// Launches on `stream`; allocates nothing. Returns the error of the set-up
// before the launch (a shared-memory limit); the caller checks the launch.
cudaError_t launch_render_tiles(const RenderArgs& args, cudaStream_t stream);
