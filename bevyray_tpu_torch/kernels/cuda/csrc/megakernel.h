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
  // Two int64 counters, zero at launch: [0] the traced segments, added to;
  // [1] the work counter: the next work item a CUDA block takes, or in the
  // full walk (neither split nor candidates) the next pixel a thread takes.
  unsigned long long* counters;
  // The probe instance's per-stage clock sums (kProbeSlots), or null.
  unsigned long long* probe;
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
  int n_cand;           // candidate groups (<= kMaxCandGroups)
  int cand_off;         // gaabb column of candidate group 0
  int fast_rng;         // the fast draw path (else the exact PCG streams)
  int draw_words;       // fast path: words per bounce, 6, 9 or 13
  int fuse;             // pixel blocks per work item's lane positions: 1, 2, 4, 8
  int grid;             // CUDA blocks of the persistent grid
  // The full walk's two launches (megakernel.py `pilot_samples`): the main
  // launch continues each lane's sums in the outputs from sample
  // first_sample on (0: none) and takes the lanes in `order`'s order (or
  // null: block order); the pilot adds each pixel's segments to `cost` (or
  // null).
  int first_sample;
  const int* order;
  int* cost;
};

// Slots of the probe's clock sums (cycles summed over threads, as unsigned
// 64-bit): the thread's whole run, taking an item and staging its
// shortlists (0 in the full walk, which takes no items), taking pixels (and
// writing finished ones), the segment iterations, within them the bounce-0
// shortlist walk, the table walks (candidates or every sphere) and the
// triangle loop; a lane's wait for its warp once it has no pixel left in the
// item (the full walk: in the launch); then the warp-level segment
// iterations (counted once per group of lanes that run one together) and the
// lanes' segments, and the candidate-box slab tests the lanes run in the
// table walks (0 in the full walk over every sphere, which tests no box).
// The rest of a thread's cycles (the item's closing barrier, or the full
// walk's one wait at the block's end; the loops' overhead) is the total less
// the stages. Then one thread of each block times the block's run, from its
// start to the moment the block finds no work left (the full walk: its last
// thread): summed over blocks in nanoseconds (%globaltimer) and in
// its SM's cycles, whose ratio is the SM clock the launch ran at; the
// longest block's nanoseconds (the launch, as the blocks start together)
// and cycles, which hold its threads' runs to within the few cycles between
// their starts: their 32-bit sums hold only below 2^32. The last two are
// maxima over the blocks, not sums.
enum ProbeSlot {
  kProbeTotal, kProbeStage, kProbeFetch, kProbeSegment, kProbeWalk0,
  kProbeWalk, kProbeTriangles, kProbeWarpIdle, kProbeIssues, kProbeSegments,
  kProbeSlabTests, kProbeBlockNs, kProbeBlockCycles, kProbeMaxNs,
  kProbeMaxCycles, kProbeSlots
};

// Candidate groups a launch may have: 31-group mask words x 6, the JAX
// kernel's limit (megakernel.py MAX_CAND_WORDS). The candidate instances
// stage every group's box in shared memory, 32 bytes a group.
constexpr int kMaxCandGroups = 31 * 6;

// Static facts of one kernel instance on the current device.
struct KernelInfo {
  int num_regs;           // registers per thread
  int local_bytes;        // local memory per thread (spills)
  int static_smem;        // static shared memory per block
  int dynamic_smem;       // shared memory the launch asks for (the staged shortlists)
  int blocks_per_sm;      // resident blocks per SM at that shared memory
  int n_sms;              // SMs of the device
};

// Launches on `stream`; allocates nothing. Returns the error of the set-up
// before the launch (a shared-memory limit); the caller checks the launch.
// A non-null `args.probe` launches a probe instance, on the fast draws: of
// the default kernel (split, candidates) or of the unsplit full walk (off,
// grouped), which frames over MAX_SPLIT_SPP samples a pixel run.
cudaError_t launch_render_tiles(const RenderArgs& args, cudaStream_t stream);

// The facts of the instance (split, candidates, fast, probe) at `fuse`
// staged shortlists of `sl_cap` entries each; a probe instance as above.
cudaError_t kernel_info(bool split, bool candidates, bool fast, bool probe, int fuse,
                        int sl_cap, KernelInfo* out);
