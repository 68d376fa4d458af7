#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root (or anywhere: it imports the package beside
it). It builds the port's CUDA kernel from the sources in the checkout, holds
each of its sphere-walk modes against the plain PyTorch version on the card,
drives the fused-renderer main path at the headline settings (RTiOW final
scene, 1920x1080, 16 spp, 4 bounces) with the default configuration, which
takes the phase split with the candidate walk, then each other mode the same
way, and checks that every frame went through the kernel.

Phase 5 drives the accumulating path at the same settings:
``ProgressiveRenderer(backend="pallas")`` (2 passes of 8 spp against one
16 spp frame: equal segments, image within 1e-5; then 8 timed passes of
16 spp) and ``AdaptiveRenderer`` (tolerance 0.02, a re-probe every 4
passes: 8 timed passes with the share of pixels each samples; tolerance 0
against the uniform film), each pass one kernel launch of the fast path
and no plain run; then the kernel under the sample map of adaptive pass 3,
at sample offset 32, against its plain version on both draw paths: within
the bars on the lanes the map samples, and exact zero sums from both on
every lane whose target is 0.

Phase 6 drives BASELINE config 5 (scripts/bench_matrix.py:101-114) at full
size: the final scene with a metallic cube mesh, the raster layer on the
card (K8, K2 and K9 once each a call, no plain run), 1280x720, 16 spp, 4
bounces, level 2, through the default-config
``FusedRenderer`` (one kernel launch per frame, no plain run), then the
kernel against its plain version at those shapes with the triangle tests in
the bound. Phase 2 holds the kernel's triangle branch against its plain
version in every mode on a small mesh scene and on duplicate meshes.

Phases 2-4 and 6 pin the exact PCG streams (``exact_rng=True``); the films
of phase 5 take the default draw path, which on the card is the fast one.
Phase 7 holds the fast path and block fusion: (a) the fast kernel against
its fast plain version at 128x128, 4 spp, in every mode under each of the
three draw layouts, with the lens, with forced fuses whose tail block is
padding, with the cube mesh in every mode, and under a sample map at a
sample offset; (b) the default-config headline through ``FusedRenderer``,
which must resolve to the fast path, split/candidates and fuse 4, timed in
the order exact, fast, fast, exact, then the fast kernel against its plain
version there; (c) the fuse ladder 1, 2, 4, "auto" at the headline on the
fast path: kernel ms and bit-equal frames; (d) the fast headline frame
against the exact one, statistically; (e) BASELINE config 5 on both paths
(kernel ms unfused and at the rule's fuse), the fast kernel against its
plain version there, and progressive passes under the default.

Phase 8 holds the shard offsets, the sharded frames and the wavefront
renderer; its (d) drives the wavefront sharded step with tp (the sphere
table split over the slices, their nearest hits merged by K16) at the
headline on meshes (1, 1, 2) and (2, 2, 2), ``default_mesh_shape(8)``,
against the unsharded ``Renderer`` (within ``IDENTITY_TOL``, segments
equal, no host wait), and runs the step at ``WAVE_SIZE`` on
``WAVE_MESHES`` (one of 40 parts: two K15 launches); 13(d) profiles a
1-spp tp = 2 headline frame beside the same frame with the plain merge
patched in (the op-by-op merge K16 replaced). Phase 9 measures what bounds the kernel on the card: (a) each
instance's registers, spills, shared memory and resident blocks per SM, and
the work items of each main-path grid against them; (b) the probe instance
of the default kernel (``clock64()`` per stage, active lanes per segment
iteration) at the headline, under the adaptive pass-3 map and at config 5,
each launch bit-equal to the default instance; (c) the default instance's
IEEE sqrt in the SASS of the built library (``cuobjdump -sass``); (d) the
book's final render (Ray Tracing in One Weekend v4, 14.1: 1200x675, 500
spp, depth 50, thin lens; the benchmark's configuration and scene) through
``FusedRenderer`` at its defaults, which must take the unsplit full walk
(off/grouped) on the fast draws, and the off/grouped probe instance on that
frame, bit-equal to the default instance: cycles by stage, lanes live per
issue, segments a sample, the SM clock and the blocks' runs against the
launch's.

Phase 10 drives the port's command line in-process (``app.cli.main``) at
its defaults (final scene, 1280x720, 16 spp, 4 bounces, level 3): (a)
``render`` with backend auto, which extracts a BVH and resolves to "brute",
bit-equal to ``Renderer.render``; (b) ``--backend bvh`` within 1e-6 of (a)
with equal segments; (c) ``--backend pallas``, one launch of the CUDA
kernel, bit-equal to ``FusedRenderer.render``; (d) ``--denoise 3`` equal to
``atrous_denoise`` of (a)'s frame, three K7 launches and no plain run; (e)
``accumulate --adaptive-tolerance``
on a scene that carries a BVH, and ``bench --backend pallas``, whose JSON
names the card; (f) 4,971 spheres at 640x360, 4 spp, where "auto" walks the
BVH of the native builder, against "brute".

Phase 11 holds the port on the card to its NumPy oracle
(``bevyray_tpu_torch/testing/oracle.py``, run on the host from the same
``World``) on the exact draws, at the bars of the JAX golden tests: (a) the
final scene (508 spheres) at 192x108, 4 spp, through the kernel in each of
its four modes; (b) the mesh scene, the kernel and the wavefront
``Renderer``; (c) hollow glass, the kernel and ``Renderer`` with the dense
test and the BVH walk; (d) the kitchen sink at level 2 with the raster layer
on the card, ``FusedRenderer`` and ``Renderer``; (e) the level-1 cube world
through ``Renderer`` within 2e-5; (f) 4,971 spheres, the BVH walk and the
kernel's candidate walk.

Phase 12 runs the bench modules (``bevyray_tpu_torch/bench/``: the
headline, the BASELINE matrix, the orbit and edit arms, the scaling
harness) at the JAX scripts' own sizes; their JSON rows come on lines of
their own.

Phase 13 holds the wavefront renderer's hand-written kernels: the ray
tests of ``kernels/cuda/csrc/wavefront.cu`` (K1 ``intersect_spheres``, K2
``intersect_triangles``, K3 ``intersect_bvh``, K4
``intersect_bvh_triangles``) and the bounce body of ``bounce.cu`` (K5
``raygen_sample``, K6 ``shade_bounce``), which replace XLA code of the JAX
package: (a) the main path with the counts zeroed just before each run
and read just after, timed: the wavefront headline (K1), config 5's mesh
through ``Renderer`` dense (K1, K2) and by the BVH (K3, K4), 10(f)'s
4,971 spheres walking the BVH (K3), the cube field
(``cube_field_world``: 4,092 triangles at config 5's settings, "auto"
taking the dense test, 80 K2 launches), the wavefront sharded step on
mesh (2, 1, 2) and a ``ProgressiveRenderer(backend="xla")`` pass (K5 and
K6 in every run), each frame equal (image, depth, segments) to the one
with the plain bounce body patched in, and the headline frame equal to
the one with every plain version (the tail's too) patched in, each run one
launch of the frame's tail K10; (b) each kernel against its
plain version on the same CUDA tensors: the ray tests t max |d| 0 and
index equal on every lane, at bounces 0 and 2 of real frames with their
active masks (K2 and K4 also on the cube field), on the leaf-4 BVH, a
4-entry stack, axis-aligned rays on box planes, odd lane counts, sparse
masks, rows twice, every third triangle row invalid and the raster
layer's call; K5 on the headline's pixels (all, the first
``ODD_LANES``, a shard's half at another sample) and the night scene's
lens, by id tensor and by index (a frame's pixels in order from an
offset) folding into the frame's sums, K6 on the states of bounces 0, 2
and 4 of the headline, config 5 (also at level 1), the cube field, 4,971
spheres by the BVH, the night scene (lens, emission, cosine lobes) and odd
lanes, without sums and folding into them (from zero, from another film's
and in place), every column of the state and the sums bit-equal and the
segments equal; each with its time beside its bound (the dense tests'
also at the issue rate); (c) ``host_syncs`` over
``Renderer`` frames (brute, bvh, mesh) and a config-5 round, which must
be empty; (d) the kernels of a 1-spp and a 16-spp wavefront frame and
the card's busy time (torch's profiler), and of a 1-spp tp = 2 frame of
the sharded step with K16 and with the plain merge.

Phase 14 holds the image kernels, which replace the JAX package's jitted
``atrous_denoise`` and ``rasterize_impl``: K7 ``atrous_pass``
(``kernels/cuda/csrc/denoise.cu``, one launch an iteration) on 10(d)'s
frame at 0, 1, 3 and 5 iterations, at an odd size, where the stride rule
ends the filter after 1 and 2 iterations and on a depth with misses at the
far fallback; K8 ``raster_rays`` and K9 ``raster_shade``
(``csrc/raster.cu``, around K2) on config 5's camera at 1280x720 and
1920x1080, the kitchen sink at level 2, a rotated raster cube and a view
where every pixel misses; each bit-equal to its plain version
(``engine/denoise.py``, ``engine/raster.py``), with its time beside its
bound and the plain version's.

Phase 15 holds the frame's tail and the fused film pass's fold
(``kernels/cuda/csrc/frame.cu``), which replace the tails of the JAX
package's jitted frame programs and ``pallas_accumulate_impl``'s fold:
K10 ``resolve_frame`` (the block order undone, the mean, the composite
and the image; one launch a frame of either renderer and a film's
resolve, counted in phases 3, 5 and 13(a)) on the fused and wavefront
headline, BASELINE config 4's film (a fresh one and after two passes), an
``AdaptiveFilm`` (counts a pixel), config 5 at levels 2, 1 and 0 over its
raster layer and ``ODD_IMAGE`` at every level over three raster layers;
K11 ``fold_pass`` (one launch a fused film pass, counted in phase 5) on
config 4's passes and at ``ODD_IMAGE``, the old film unchanged; each
bit-equal to its plain version (``kernels/frame.py``), with its time
beside its bound and the plain version's, and the kernels and busy time of
a fused headline frame and of a config-4 film pass (torch's profiler).

Phase 16 holds the camera row (``kernels/cuda/csrc/camera.cu``) and the
adaptive pass's map and fold and the sharded step's sums
(``csrc/passes.cu``), which replace the camera part of the JAX package's
jitted frame programs, ``_adaptive_pass`` around ``render_tiles`` and the
psum over dp: K12 ``camera_rows`` (one launch a frame, film pass, shard,
wavefront sample state and raster call) on the headline, night (lens) and
level-1 cameras; K13 ``adaptive_map`` and K14 ``fold_adaptive`` (one
each an adaptive pass) on four adaptive headline passes, the fourth a
re-probe, the old film unchanged; K15 ``sum_shards`` (one launch a sharded
frame of up to 32 parts, one for every 32 of more) on the parts of fused
headline frames and of wavefront frames on (2, 1, 2) and on meshes of 36
and 40 parts; K16 ``merge_tp_hits`` (one a bounce of the tp step) on the
slices' hits of a headline bounce at tp 2, 4 and 8, also timed against
the torch stack, min and gather that compute the same; each bit-equal to its plain version
(``kernels/camera.py``, ``kernels/passes.py``), with its time beside its
bound and the plain version's, and the kernels and busy time of an
adaptive pass and of a mesh (3, 1) frame (torch's profiler). Phases 3,
5, 8(b), 8(d) and 13(a) count K12-K16's launches on the main path and
that no plain version of theirs ran.

Each phase prints its lines; the line before the last is the kernel table
as JSON, and the last line is ``{"ok": true, "device": {...}}``. Any failed
phase raises and the script exits nonzero without that line. It exits
nonzero at once when there is no CUDA card or no port beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# K10 and K11 launches in the main-path runs of phases 3, 5 and 13(a), each
# between a zeroing of the counts and their reading.
TAIL_LAUNCHES = collections.Counter()
KERNEL_SOURCE = "bevyray_tpu_torch/kernels/cuda/csrc/megakernel.cu"
TPU_KERNEL = "bevyray_tpu/kernels/pallas/megakernel.py"
# The branch of the TPU kernel that each (primary, intersect) mode replaces.
REPLACES = {
    ("off", "grouped"): f"{TPU_KERNEL}:596",          # _intersect_grouped
    ("split", "grouped"): f"{TPU_KERNEL}:720",        # _intersect_shortlist
    ("off", "candidates"): f"{TPU_KERNEL}:1199",      # _intersect_candidates
    ("split", "candidates"): f"{TPU_KERNEL}:2147",    # body_once_flat
}
MODES = list(REPLACES)

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 4
TIMED_FRAMES = 5      # the default-config headline
OTHER_FRAMES = 3      # each other mode at the headline
PASSES = 8            # accumulating passes (the CLI's accumulate default)
TOLERANCE, REPROBE_EVERY = 0.02, 4   # AdaptiveRenderer's defaults
MAP_PASS, MAP_OFFSET = 3, 32   # the adaptive pass whose map phase 5 checks
HYBRID_SIZE = (1280, 720)      # BASELINE config 5 (scripts/bench_matrix.py)
RASTER_REPS = 5                # timed raster-layer calls after a first one
# The 2 x 8 spp film against the 16 spp frame: the same samples, summed in
# another order.
IDENTITY_TOL = 1e-5
# Kernel against plain version on the card: both round in IEEE float32 with no
# contraction and normalize as v * (1 / sqrt(v.v)); on the H100 they agree to
# the bit (PERF.md). An ulp of another card's or toolkit's libm
# (log/sin/cos/exp) would flip a path now and then; such a pixel differs by
# up to the whole color of a sample, and its depth by up to (far - 1) / spp
# where a first hit flips to a miss. The bars hold color and depth alike: the
# share of pixels within PIXEL_TOL, and the mean |d| (depth's relative to the
# plain version's mean depth).
PIXEL_TOL, PIXEL_FRAC, MEAN_TOL, DEPTH_MEAN_RTOL, SEG_RTOL = (
    1e-3, 0.999, 5e-5, 1e-4, 1e-3)
# The bound: fp32 operations of the walks over the H100 SXM's fp32 peak
# outside the tensor cores, or the bytes over its memory rate, whichever is
# longer. A sphere test (megakernel.cu test_sphere) is 18 arithmetic
# operations, one sqrt and 2 compares; a candidate slab test (walk_candidates)
# 6 subtractions, 7 multiplies, 10 min/max and 4 compares; a triangle test
# (test_triangles) 6 edge subtractions, 9 operations for p = d x e2, 5 for
# det, one division, 3 for o - a, 6 each for u, v and t, 9 for q and 9 for
# |det| and the compares. Shading, draws and the tests' loop overhead are
# left out, so the bound is a floor.
SPHERE_TEST_OPS, SLAB_TEST_OPS, TRIANGLE_TEST_OPS = 21, 27, 60
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# Without contraction (--fmad=false) each operation is one issued fp32
# instruction: 132 SMs x 128 lanes x 1.98 GHz.
ISSUE_RATE = 132 * 128 * 1.98e9
# Phase 7. The TPU kernel's fast draw path and block fusion.
FAST_REPLACES = f"{TPU_KERNEL}:486"     # HwRngProvider (+ fast math :375)
FUSE_REPLACES = f"{TPU_KERNEL}:195"     # _resolve_fuse (+ halves :1517)
LAYOUTS = {6: (True, True), 9: (True, False), 13: (False, True)}
FUSE_LADDER = (1, 2, 4, "auto")
# The fast frame against the exact frame of the same seed, both 16 spp:
# other random streams, the same estimator. Means within STAT_MEAN_TOL;
# after a BOX x BOX box filter the mean |d| within BOX_MEAN_TOL, twice
# what the CPU twin (tests/torch_fast_rng_twin.py, the plain versions on the
# final scene at 240x136 and 480x270) reads: 0.0032 and 0.0030.
STAT_MEAN_TOL, BOX, BOX_MEAN_TOL = 0.01, 8, 0.006
# Phase 8. The shard offsets and the sharded frames.
SHARD_REPLACES = f"{TPU_KERNEL}:1510"   # block_offset / n_tiles_local :1510-1540
SHARD_MESHES = ((3, 1), (4, 1), (2, 2), (1, 4))   # (sp, dp) at the headline
SHARD_FRAMES = 3       # timed frames per mesh
# A dp > 1 frame against the unsharded one: the same samples, the sums taken
# in another order (JAX's bar, tests/test_sharding.py:62); depth relatively.
SHARD_TOL, SHARD_DEPTH_RTOL = 1e-6, 1e-5
WAVE_SIZE = (480, 270)  # the wavefront sharded step and its film
WAVE_MESHES = ((2, 1, 2), (1, 2, 2), (40, 1, 1))
# The wavefront sharded step with tp at the headline: (2, 2, 2) is
# default_mesh_shape(8), the JAX package's default mesh.
TP_MESHES = ((1, 1, 2), (2, 2, 2))
# Phase 9(d). The book's final render (Ray Tracing in One Weekend v4, 14.1
# "A Final Render") as the benchmark defines it: its configuration
# (benchmark/configs/, 1200x675, 500 spp, max_depth 50 as 49 bounces) and
# scene (benchmark/scenes/rtiow_book.py, the book's camera and thin lens),
# read by `book_inputs`. Over MAX_SPLIT_SPP samples a pixel the split's gate
# declines, and below 1025 padded spheres "auto" takes no candidate walk.
BOOK_CONFIG = "rtiow-book-final"
BOOK_MODE = ("off", "grouped")
# What the full walk's instances (off/grouped) may take on the card, by draw
# path: 64 registers a thread hold 4 resident blocks of 256 threads per SM;
# the exact draws' PCG state spills 32 bytes, the fast draws none.
BOOK_INSTANCE = {"fast": dict(num_regs=64, local_bytes=0, blocks_per_sm=4),
                 "exact": dict(num_regs=64, local_bytes=32, blocks_per_sm=4)}
# Phase 10. The command line at its defaults (bevyray_tpu_torch/app/cli.py:
# final scene, scene seed 42, 1280x720, 16 spp, 4 bounces, level 3, seed 1),
# held against direct calls of the same renderers. CLI_ARGV goes after each
# subcommand's own arguments (empty: the defaults, on the card).
CLI_ARGV = []
CLI_FRAME = dict(width=1280, height=720, samples_per_pixel=16, bounces=4,
                 level=3)
CLI_SEED, CLI_SCENE_SEED = 1, 42
CLI_DENOISE = 3
CLI_PASSES, CLI_TOLERANCE = 4, 0.05   # tests/test_adaptive.py:81
CLI_BENCH_FRAMES = 4
# "bvh" against "brute": the same t from the same operations, the first hit
# along the walk against the lowest index on an exact tie (tests/test_bvh.py
# :203's bar).
BVH_TOL = 1e-6
# (f): 4,971 spheres, over the 4,096 rows above which "auto" walks the BVH.
BIG_GRID, BIG_SIZE, BIG_SPP = 35, (640, 360), 4
# Phase 11. The port on the card against its NumPy oracle
# (bevyray_tpu_torch/testing/oracle.py) on the exact draws. The bars are those
# of the JAX golden tests each check mirrors: image mean |d| under the first
# number and under the second's share of pixels past ORACLE_OUTLIER
# (tests/test_golden.py:39-44), the looser pair for the mesh, hollow-glass
# and kitchen-sink scenes; level 1 within ORACLE_ATOL everywhere
# (tests/test_raster.py:76).
ORACLE_OUTLIER, ORACLE_TIGHT, ORACLE_LOOSE = 5e-3, (2e-3, 0.01), (4e-3, 0.02)
ORACLE_ATOL = 2e-5
# Frames as (width, height, spp, bounces, level, frame seed). (a): the final
# scene, all 508 spheres; (f): 4,971 spheres; (b)-(e): the frames of
# tests/test_golden.py:145-148, :179-186, :227-236 and tests/test_raster.py:
# 60-69.
ORACLE_FINAL = (192, 108, 4, 4, 3, 1)
ORACLE_BIG = (64, 36, 2, 4, 3, 1)
ORACLE_FRAMES = {"mesh": (40, 40, 2, 4, 3, 6),
                 "hollow_glass": (32, 32, 2, 6, 3, 4),
                 "kitchen_sink": (48, 48, 3, 4, 2, 21),
                 "cube": (32, 32, 2, 3, 1, 5)}

# Phase 13. The wavefront renderer's ray tests (csrc/wavefront.cu), each held
# against its plain version on the same CUDA tensors (t max |d| 0, index
# equal on every lane). They replace XLA loops of the JAX package, not a
# pallas_call: the scan of the dense sphere and triangle tests and the
# while_loop of the BVH walk.
WAVE_SOURCE = "bevyray_tpu_torch/kernels/cuda/csrc/wavefront.cu"
WAVE_REPLACES = {
    "intersect_spheres": "bevyray_tpu/kernels/intersect.py:41",
    "intersect_triangles": "bevyray_tpu/kernels/intersect.py:116",
    "intersect_bvh": "bevyray_tpu/kernels/traverse.py:125",
    "intersect_bvh_triangles": "bevyray_tpu/kernels/traverse.py:125",
}
CUBE_FIELD = 341        # cubes of cube_field_world: 4,092 triangles
WAVE_BOUNCES = (0, 2)   # the captured bounces the kernels are held on
WAVE_REPS = 20          # launches per CUDA-event timing
AXIS_RAYS = 1 << 16     # axis-aligned rays, origins on box and face planes
ODD_LANES = 100_003     # a lane count off every block's multiple
SPARSE_FIRST, SPARSE_STEP = 17, 4099   # the active lanes of a sparse mask
# Bytes per lane a ray test reads (origin, direction, active) and writes
# (t, index); bytes per row of its table.
RAY_BYTES = 6 * 4 + 1 + 4 + 8
ROW_BYTES = {"intersect_spheres": 4 * 4 + 1, "intersect_triangles": 9 * 4 + 1,
             "bvh_node": 6 * 4 + 2 * 4}
# The bounce body (csrc/bounce.cu): K5 ``raygen_sample`` and K6
# ``shade_bounce``, each held against its plain version
# (kernels/bounce.py) to the bit on every column of the sample's state.
BOUNCE_SOURCE = "bevyray_tpu_torch/kernels/cuda/csrc/bounce.cu"
BOUNCE_REPLACES = {"raygen_sample": "bevyray_tpu/engine/renderer.py:103",
                   "shade_bounce": "bevyray_tpu/engine/renderer.py:149"}
# K6 is held at these bounces: the captured ones and the last (the
# harvest).
SHADE_BOUNCES = WAVE_BOUNCES + (BOUNCES,)
NIGHT_SIZE = (1920, 1080)   # BASELINE config 4, the night scene's frame
# Bytes a lane K5 reads (pixel id, u, v) and writes (origin, direction,
# throughput, radiance, flag, first depth, stream word).
RAYGEN_LANE_BYTES = 8 + 4 + 4 + 4 * 12 + 1 + 4 + 4
# Operations a lane, counted roughly from the sources (each instruction of
# the CUDA math library's log, sin, cos and exp one operation): K5 the
# stream word, two draws and generate_rays; K6 a hit's record, material,
# draws and one branch's two unit balls, a miss its sky. The bytes bound
# both kernels by several times these.
RAYGEN_LANE_OPS = 80
SHADE_HIT_OPS, SHADE_MISS_OPS = 500, 30

# Phase 14. The image kernels: K7 ``atrous_pass`` (csrc/denoise.cu) and the
# raster layer's K8 ``raster_rays`` and K9 ``raster_shade`` (csrc/raster.cu),
# each held against its plain version (engine/denoise.py, engine/raster.py)
# to the bit on the same CUDA tensors. They replace XLA code of the JAX
# package, not a pallas_call: the jitted atrous_denoise and rasterize_impl.
IMAGE_SOURCES = {
    "atrous_pass": "bevyray_tpu_torch/kernels/cuda/csrc/denoise.cu",
    "raster_rays": "bevyray_tpu_torch/kernels/cuda/csrc/raster.cu",
    "raster_shade": "bevyray_tpu_torch/kernels/cuda/csrc/raster.cu"}
IMAGE_REPLACES = {"atrous_pass": "bevyray_tpu/engine/denoise.py:46",
                  "raster_rays": "bevyray_tpu/engine/raster.py:83",
                  "raster_shade": "bevyray_tpu/engine/raster.py:88"}
RASTER_SIZES = ((1280, 720), (1920, 1080))   # config 5's camera at each
IMAGE_REPS = 20         # launches per CUDA-event timing
ODD_IMAGE = (37, 53)    # (H, W) off every block's multiple
# Operations a pixel, each issued fp32 instruction one operation: a K7 tap
# is 8 for the colour difference, 2 for the depth's, 4 for the exponent's
# argument, expf's 10 (its range reduction, polynomial and the MUFU.EX2),
# 2 for the weight and 7 for the sums; the pixel adds the clamp and three
# IEEE divisions (~10 each). K8: the uv divisions and generate_rays (~50);
# K9 a hit's shade (~130). Address arithmetic is left out: a floor.
ATROUS_PIXEL_OPS = 25 * 33 + 31
RASTER_RAYS_OPS, RASTER_SHADE_OPS = 50, 130
# Bytes: K7 reads the image and depth and writes the image (28 a pixel);
# K8 writes the origin and direction (24); K9 reads t (4) and writes the
# colour and depth (16) a pixel, and on a hit also the index and the
# direction (20); each table row once (nine corners and six colours).
ATROUS_PIXEL_BYTES, RAYS_PIXEL_BYTES = 28, 24
SHADE_PIXEL_BYTES, SHADE_HIT_BYTES, SHADE_ROW_BYTES = 20, 20, 60
# Phase 15. The frame's tail (K10 ``resolve_frame``) and the fused film
# pass's fold (K11 ``fold_pass``) of csrc/frame.cu, each held against its
# plain version (kernels/frame.py) to the bit on the same CUDA tensors. They
# replace XLA code of the JAX package, not a pallas_call: the tails of its
# jitted frame programs (render_impl's, pallas_render_impl's, resolve_impl)
# and pallas_accumulate_impl's fold.
TAIL_SOURCE = "bevyray_tpu_torch/kernels/cuda/csrc/frame.cu"
TAIL_REPLACES = {"resolve_frame": "bevyray_tpu/engine/renderer.py:242",
                 "fold_pass": "bevyray_tpu/engine/film.py:127"}
TAIL_REPS = 20          # launches per CUDA-event timing
ODD_PIXELS = (53, 37)   # (W, H): ODD_IMAGE as a frame
# Bytes a pixel: K10 reads four sums and writes the image and the depth
# (32); a count a pixel adds 4, a raster depth a pixel 4 at levels 1-2, a
# raster colour a pixel 12 where the raster layer wins (every pixel at
# level 0). K11 reads the film's and the pass's sums and writes the new
# sums (48). Their operations (a scale, a division, two compares) are a
# few a pixel: the bytes bound both.
TAIL_PIXEL_BYTES, FOLD_PIXEL_BYTES = 32, 48
# Phase 16. The camera row (K12 ``camera_rows``, csrc/camera.cu) and the
# adaptive pass's map and fold and the sharded step's sums and tp hit merge
# (K13 ``adaptive_map``, K14 ``fold_adaptive``, K15 ``sum_shards``, K16
# ``merge_tp_hits``, csrc/passes.cu), each held against its plain version
# (kernels/camera.py, kernels/passes.py) to the bit on the same CUDA
# tensors. They replace XLA code of the JAX package, not a pallas_call: the
# camera row of its jitted frame programs, the adaptive pass around
# render_tiles, the psum over dp, the pmin over tp.
PASSES_CU = "bevyray_tpu_torch/kernels/cuda/csrc/passes.cu"
PASS_SOURCES = {
    "camera_rows": "bevyray_tpu_torch/kernels/cuda/csrc/camera.cu",
    "adaptive_map": PASSES_CU, "fold_adaptive": PASSES_CU,
    "sum_shards": PASSES_CU, "merge_tp_hits": PASSES_CU}
PASS_REPLACES = {"camera_rows": "bevyray_tpu/kernels/pallas/megakernel.py:2722",
                 "adaptive_map": "bevyray_tpu/engine/adaptive.py:66",
                 "fold_adaptive": "bevyray_tpu/engine/adaptive.py:73",
                 "sum_shards": "bevyray_tpu/parallel/sharding.py:231",
                 "merge_tp_hits": "bevyray_tpu/parallel/sharding.py:86"}
PASS_PLAIN = {"camera_rows": "camera_rows_reference",
              "adaptive_map": "adaptive_map_reference",
              "fold_adaptive": "fold_adaptive_reference",
              "sum_shards": "sum_shards_reference",
              "merge_tp_hits": "merge_tp_hits_reference"}
PASS_REPS = 20          # launches per CUDA-event timing
# K15's fused cases, meshes (sp, dp) of phase 8(b); its row is timed at
# (2, 2), where it adds two parts a lane and joins two shards. Its
# wavefront cases past 32 parts, (sp, dp, tp, spp) at WAVE_SIZE, each two
# launches: (6, 6, 1) splits shard 5's parts between them.
K15_MESHES, K15_TIMED = ((3, 1), (2, 2), (1, 4)), (2, 2)
K15_LARGE = ((6, 6, 1, 12), (40, 1, 1, SPP))
# K16's cases: the slices' hits of a 1-spp headline frame's bounce 0 at
# each tp; its row is timed at tp 2. K16 reads a float32 t and an int64
# index a lane of each slice and writes one of each (12 bytes).
K16_TPS, K16_TIMED, TP_LANE_BYTES = (2, 4, 8), 2, 12
ADAPT_PASSES, ADAPT_REPROBE = 4, 3   # phase 16's adaptive passes: the 4th re-probes
# K12 reads the camera's 15 floats (60 bytes) and writes a fused row of 24
# floats and a wavefront row of 19 (172), with about 60 operations
# (CAMERA_OPS: the cross product, the tangent's reduction and polynomial).
# K13 reads an error a pixel and writes a target a lane (4 + 4). K14 reads
# the pass's four sums and the film's six columns and writes six (64 a
# pixel) and three int64 (24). K15 reads 16 bytes a lane of each part and
# writes 16 a joined lane, and one int64 a part and the total.
CAMERA_OPS, CAMERA_BYTES = 60, 60 + 172
MAP_PIXEL_BYTES, MAP_LANE_BYTES = 4, 4
ADAPT_PIXEL_BYTES = 64


def mesh_scene(copies=1):
    """The simple scene with a metallic cube mesh in front of a sphere,
    ``copies`` times at one place (only the lower triangle index may win a
    tie)."""
    from bevyray_tpu_torch import (StandardMaterial, Transform, cube_mesh,
                                   rtiow)

    world = rtiow.simple_scene()
    for color in ((0.9, 0.6, 0.2), (0.2, 0.9, 0.2))[:copies]:
        world.spawn_mesh(Transform.from_xyz(0.3, 0.4, 1.0), cube_mesh(0.5),
                         StandardMaterial(base_color=color, metallic=1.0,
                                          perceptual_roughness=0.1))
    return world


def config5_world():
    """BASELINE config 5 (scripts/bench_matrix.py:101-114): the final scene
    with a metallic cube mesh, and its ``RenderConfig``."""
    from bevyray_tpu_torch import (RenderConfig, StandardMaterial, Transform,
                                   cube_mesh, rtiow)

    world = rtiow.final_scene(seed=42)
    world.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                     StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                      perceptual_roughness=0.15))
    return world, RenderConfig(*HYBRID_SIZE, SPP, BOUNCES, level=2)


def cube_field_world(pkg):
    """The final scene (seed 42) with CUBE_FIELD cube meshes of 12
    triangles on the ground in front of the camera, each sized, placed,
    turned about y and colored from numpy's generator seeded with 13:
    4,092 triangles in a table of 4,096 rows, the largest that "auto"
    sends to the dense triangle test. Built with ``pkg`` (the port, or a
    package with the same scene API); render it with config 5's
    ``RenderConfig`` (1280x720, 16 spp, 4 bounces, level 2)."""
    import numpy as np

    T = pkg.Transform
    rng = np.random.default_rng(13)
    world = pkg.rtiow.final_scene(seed=42)
    for _ in range(CUBE_FIELD):
        size, x, z, yaw = (float(v) for v in rng.uniform(
            (0.15, -4.0, -5.0, 0.0), (0.45, 4.0, 2.5, np.pi / 2)))
        color = tuple(float(c) for c in rng.uniform(0.1, 0.9, 3))
        metallic, rough = (float(v) for v in rng.uniform((0.0, 0.05),
                                                         (1.0, 0.5)))
        world.spawn_mesh(
            T.from_xyz(x, size / 2, z).with_rotation(
                T.rotation_axis_angle((0.0, 1.0, 0.0), yaw)),
            pkg.cube_mesh(size),
            pkg.StandardMaterial(base_color=color, metallic=round(metallic),
                                 perceptual_roughness=rough))
    return world


def golden_world(pkg, name):
    """A scene of the JAX golden tests, built with ``pkg`` (the port, or a
    package with the same scene API): "mesh" (tests/test_golden.py:133-144),
    "hollow_glass" (:166-177, an inner shell of negative radius),
    "kitchen_sink" (:201-225: the raster cube, a traced mesh, an emissive
    sphere, hollow glass, the thin lens) or "cube" (tests/test_raster.py:
    14-25: ground, a sphere and the raster cube)."""
    T, S, M = pkg.Transform, pkg.RaytracedSphere, pkg.StandardMaterial
    w = pkg.World()
    ground = (T.from_xyz(0, -1000, 0), S(1000.0), M(base_color=(0.5, 0.5, 0.5)))
    glass = M(base_color=(1.0, 1.0, 1.0), ior=1.5, specular_transmission=1.0)
    pure = pkg.RaytracedCamera(level=pkg.Raytracing.PURE)
    if name == "mesh":
        w.set_camera(T.from_xyz(0, 0.8, 5).looking_at((0, 0.5, 0)), camera=pure)
        w.spawn_sphere(*ground)
        w.spawn_sphere(T.from_xyz(-1.3, 0.5, 0), S(0.5),
                       M(base_color=(0.8, 0.2, 0.2)))
        w.spawn_mesh(T.from_xyz(0.9, 0.5, 0), pkg.cube_mesh(1.0),
                     M(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                       perceptual_roughness=0.1))
    elif name == "hollow_glass":
        w.set_camera(T.from_xyz(0, 0.6, 4).looking_at((0, 0.5, 0)), camera=pure)
        w.spawn_sphere(*ground)
        w.spawn_sphere(T.from_xyz(0, 0.5, 0), S(0.5), glass)
        w.spawn_sphere(T.from_xyz(0, 0.5, 0), S(-0.4), glass)
        w.spawn_sphere(T.from_xyz(-1.2, 0.5, 0), S(0.5),
                       M(base_color=(0.9, 0.3, 0.2)))
    elif name == "kitchen_sink":
        w.set_camera(T.from_xyz(0, 1.0, 5).looking_at((0, 0.5, 0)),
                     camera=pkg.RaytracedCamera(
                         level=pkg.Raytracing.FALLBACK_RAYTRACED,
                         aperture=0.2, focus_distance=5.0))
        w.spawn_sphere(*ground)
        w.spawn_sphere(T.from_xyz(-1.4, 0.5, 0.3), S(0.5), glass)
        w.spawn_sphere(T.from_xyz(-1.4, 0.5, 0.3), S(-0.4), glass)
        w.spawn_sphere(T.from_xyz(1.6, 0.7, -1.0), S(0.7),
                       M(base_color=(0.0, 0.0, 0.0), emissive=(3.0, 1.5, 0.7)))
        w.spawn_mesh(T.from_xyz(0.8, 0.4, 0.8), pkg.cube_mesh(0.8),
                     M(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                       perceptual_roughness=0.05))
        w.spawn_raster_mesh(T.from_xyz(0.0, 0.5, -0.4), pkg.cube_mesh(1.0),
                            M(base_color=(0.8, 0.7, 0.6)))
    elif name == "cube":
        w.set_camera(T.from_xyz(0.0, 1.0, 4.0).looking_at((0.0, 0.5, 0.0)))
        w.spawn_sphere(*ground)
        w.spawn_sphere(T.from_xyz(-1.2, 0.5, 0.0), S(0.5),
                       M(base_color=(0.1, 0.2, 0.5)))
        w.spawn_raster_mesh(T.from_xyz(0.0, 0.5, 0.0), pkg.cube_mesh(1.0),
                            M(base_color=(0.8, 0.7, 0.6)))
    else:
        raise ValueError(f"no golden scene {name!r}")
    return w


def oracle_frame(world, frame, raster=None, **options) -> tuple:
    """The oracle's (image [H, W, 3], depth [H, W]) of ``frame`` = (width,
    height, spp, bounces, level, seed) for ``world`` on the host, with its
    meshes as triangles and ``raster`` = (color [H, W, 3], depth [H, W])
    NumPy buffers, and the host seconds it took."""
    import numpy as np

    from bevyray_tpu_torch.testing.oracle import (oracle_inputs_from_world,
                                                  render_oracle_fast)

    centers, radii, mats, camera = oracle_inputs_from_world(world)
    camera["aspect"] = frame[0] / frame[1]
    meshes = world.extract_meshes_host(first_material_id=len(radii))
    if meshes is not None:
        va, vb, vc, tri_mids, tri_mats = meshes
        mats = np.concatenate([mats, tri_mats], axis=0)
        options["triangles"] = (va, vb, vc, tri_mids)
    if raster is not None:
        options["raster_color"], options["raster_depth"] = raster
    t0 = time.perf_counter()
    image, depth = render_oracle_fast(centers, radii, mats, camera, *frame,
                                      **options)
    return image, depth, time.perf_counter() - t0


def oracle_stats(image, depth, want, want_depth) -> dict:
    """How far an image and its depth (NumPy) sit from the oracle's: max and
    mean |d|, the share of pixels past ORACLE_OUTLIER and the first of them
    as (y, x), and the depth's max |d|."""
    import numpy as np

    err = np.abs(image - want)
    past = err.max(-1) > ORACLE_OUTLIER
    first = np.argwhere(past)[:1].tolist()
    return {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
            "frac_past": float(past.mean()),
            "first_past": first[0] if first else None,
            "depth_max_abs": float(np.abs(depth - want_depth).max()),
            "finite": bool(np.isfinite(image).all()
                           and np.isfinite(depth).all())}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, by CUDA events.
    The calls queue behind a spin kernel, so that a kernel shorter than its
    launch on the host is timed by the card, not by the host's launch rate."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_calls(module, names):
    """Count the calls of ``module``'s plain versions ``names`` while the
    block runs: yields {name: calls}, which a main-path run must leave at
    0."""
    calls = dict.fromkeys(names, 0)
    real = {name: getattr(module, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, real[name])


def profiled(fn, warm=True) -> tuple:
    """(kernels, busy ms, [(count, ms, name)]) of the card over one call of
    ``fn`` after a warm-up call (none with ``warm`` False; torch's
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevyray_tpu_torch.utils.profiling import device_kernels

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = device_kernels(prof)
    return (sum(e.count for e in device),
            sum(e.self_device_time_total for e in device) / 1e3,
            sorted(((e.count, round(e.self_device_time_total / 1e3, 4),
                    e.key[:48]) for e in device), reverse=True))


# Phase 13(d)'s profiles, each taken in a child process of its own: in one
# process a profiler session that follows another saw part of a frame's
# kernels or none, while the first session of a process saw them all. The child counts the wrappers' launches around the profiled call,
# so that the profile is held to them.
PROFILE_CHILD = """
import dataclasses, json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
from bevyray_tpu_torch import RenderConfig, Renderer, rtiow
from bevyray_tpu_torch.kernels import bounce, camera, frame, intersect, passes
from bevyray_tpu_torch.kernels.cuda import build
from bevyray_tpu_torch.parallel import sharding
from bevyray_tpu_torch.parallel.sharding import make_mesh, render_frame_sharded

build.extension()
world = rtiow.final_scene(seed=42)
scene = world.extract(with_bvh=False)
cam = world.camera_state(aspect={width} / {height})
headline = RenderConfig({width}, {height}, {spp}, {bounces}, level=3)
one = dataclasses.replace(headline, samples_per_pixel=1)
tp_mesh = make_mesh(1, 1, 2, devices=["cuda:0"] * 2)
if {which!r} == "tp_plain_merge":
    sharding.merge_tp_hits = passes.merge_tp_hits_reference
fn = {{"headline": lambda: Renderer(one).render(scene, cam, seed=3),
       "full": lambda: Renderer(headline).render(scene, cam, seed=3),
       "tp": lambda: render_frame_sharded(tp_mesh, scene, cam, one, 3),
       "tp_plain_merge": lambda: render_frame_sharded(tp_mesh, scene, cam,
                                                      one, 3)}}[{which!r}]
wrappers = {{"camera_rows": camera.camera_rows,
             "raygen_sample": bounce.raygen_sample,
             "intersect_spheres": intersect.intersect_spheres,
             "shade_bounce": bounce.shade_bounce,
             "merge_tp_hits": passes.merge_tp_hits,
             "sum_shards": passes.sum_shards,
             "resolve_frame": frame.resolve_frame}}
fn()
torch.cuda.synchronize()
before = {{k: w.launches for k, w in wrappers.items()}}
kernels, busy, by_name = chip_smoke.profiled(fn, warm=False)
launched = {{k: w.launches - before[k] for k, w in wrappers.items()}}
print(json.dumps({{"kernels": kernels, "busy_ms": busy, "by_kernel": by_name,
                   "launches": {{k: v for k, v in launched.items() if v}}}}))
"""


def profile_child(which, width, height, spp, bounces) -> dict:
    """Profile one frame of the headline's scene in a child process
    (PROFILE_CHILD; ``which``: "headline", a 1-spp frame; "full", the
    ``spp`` frame; "tp", a 1-spp frame on mesh (1, 1, 2); "tp_plain_merge",
    the same with the plain merge patched in): {"kernels", "busy_ms",
    "by_kernel", "launches" (the wrappers' launches in the profiled
    call)}."""
    out = subprocess.run(
        [sys.executable, "-c", PROFILE_CHILD.format(
            root=str(ROOT), width=width, height=height, spp=spp,
            bounces=bounces, which=which)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise SystemExit(f"phase 13(d): the profiling process ({which}) "
                         f"failed ({out.returncode}):\n{out.stdout}"
                         f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def pass_kernels() -> dict:
    """K12-K16's wrappers by name (``.launches`` counts each)."""
    from bevyray_tpu_torch.kernels import camera, passes

    return {"camera_rows": camera.camera_rows,
            "adaptive_map": passes.adaptive_map,
            "fold_adaptive": passes.fold_adaptive,
            "sum_shards": passes.sum_shards,
            "merge_tp_hits": passes.merge_tp_hits}


@contextlib.contextmanager
def pass_launches(what: str, expect: dict):
    """Zero K12-K16's counts, run the block (a main-path run), add the
    counts to TAIL_LAUNCHES and raise unless each is ``expect``'s (absent:
    0) and no plain version of theirs ran."""
    from bevyray_tpu_torch.kernels import camera, passes

    kernels = pass_kernels()
    for fn in kernels.values():
        fn.launches = 0
    with plain_calls(camera, ["camera_rows_reference"]) as cam_plain, \
            plain_calls(passes, [PASS_PLAIN[n] for n in kernels
                                 if n != "camera_rows"]) as pass_plain:
        yield
    got = {name: fn.launches for name, fn in kernels.items()}
    TAIL_LAUNCHES.update(got)
    want = {name: expect.get(name, 0) for name in kernels}
    plain = {**cam_plain, **pass_plain}
    if got != want or any(plain.values()):
        raise SystemExit(f"{what}: K12-K16 launches {got}, expected {want}; "
                         f"plain calls {plain}")


def compare(config, got, want, mask=None) -> dict:
    """Pixel agreement of two render_tiles results (block-ordered), over the
    pixels where the block-ordered ``mask`` holds (all without one)."""
    import torch

    from bevyray_tpu_torch.kernels.cuda.megakernel import unshuffle_blocks

    keep = (slice(None) if mask is None
            else unshuffle_blocks(mask.reshape(-1), config))
    rgb = [torch.stack([unshuffle_blocks(c, config) for c in out[:3]],
                       -1)[keep] for out in (got, want)]
    depths = [unshuffle_blocks(out[3], config)[keep] for out in (got, want)]
    return agreement(rgb, depths, (int(got[4]), int(want[4])))


def compare_frames(got, want) -> dict:
    """Pixel agreement of two ``FrameResult``s."""
    return agreement([f.image.reshape(-1, 3) for f in (got, want)],
                     [f.rt_depth.reshape(-1) for f in (got, want)],
                     (int(got.rays_traced), int(want.rays_traced)))


def agreement(rgb, depths, segs) -> dict:
    """The statistics that :func:`check_agreement` holds: ``rgb`` and
    ``depths`` are (got, want) pairs of [N, 3] colors and [N] depths."""
    import torch

    diff = (rgb[0] - rgb[1]).abs()
    want_depth = depths[1]
    depth = (depths[0] - want_depth).abs()
    return {
        "frac_within": float((diff.amax(-1) <= PIXEL_TOL).float().mean()),
        "mean_abs": float(diff.mean()), "max_abs": float(diff.max()),
        "depth_frac_within": float((depth <= PIXEL_TOL).float().mean()),
        "depth_mean_rel": float(depth.mean() / want_depth.abs().mean()),
        "depth_max_abs": float(depth.max()),
        "segments": segs,
        "seg_rel": abs(segs[0] - segs[1]) / max(segs[1], 1),
        "finite": bool(torch.isfinite(rgb[0]).all()
                       and torch.isfinite(depths[0]).all()),
    }


def check_agreement(name: str, stats: dict) -> None:
    print(f"{name}: {json.dumps(stats)}", flush=True)
    if not (stats["finite"] and stats["frac_within"] >= PIXEL_FRAC
            and stats["mean_abs"] < MEAN_TOL
            and stats["depth_frac_within"] >= PIXEL_FRAC
            and stats["depth_mean_rel"] < DEPTH_MEAN_RTOL
            and stats["seg_rel"] <= SEG_RTOL):
        raise SystemExit(f"{name}: the two disagree (bars: >= {PIXEL_FRAC:.1%} of pixels within "
                         f"{PIXEL_TOL} in color and in depth, mean |d| < "
                         f"{MEAN_TOL}, depth mean |d| < {DEPTH_MEAN_RTOL} of "
                         f"the mean depth, segments within {SEG_RTOL:.1%})")


def forced(config, mode):
    return dataclasses.replace(config, pallas_primary=mode[0],
                               pallas_intersect=mode[1])


def bound_ms(kscene, cam_row, sl, slmeta, n_lanes, work,
             spp_map=None) -> tuple:
    """(ms, "operations" | "bytes"): the least time the card could take for
    the walks this frame's rays need (``work``, counted by the plain
    version) and for reading each input and writing each output once."""
    inputs = [cam_row, kscene.sph, kscene.attr, kscene.gaabb, kscene.tri]
    inputs += [t for t in (sl, slmeta, spp_map) if t is not None]
    n_bytes = (sum(t.numel() * t.element_size() for t in inputs)
               + 4 * n_lanes * 4 + 8)
    ops = (SPHERE_TEST_OPS * work["sphere_tests"]
           + SLAB_TEST_OPS * work["slab_tests"]
           + TRIANGLE_TEST_OPS * work["triangle_tests"])
    by_ops, by_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def main() -> int:
    if not (ROOT / "bevyray_tpu_torch").is_dir():
        print("chip_smoke: the bevyray_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2

    from bevyray_tpu_torch import (FusedRenderer, RaytracedCamera,
                                   RaytracedSphere, RenderConfig,
                                   StandardMaterial, Transform, rtiow)
    from bevyray_tpu_torch.kernels import frame as frame_mod
    from bevyray_tpu_torch.kernels.cuda import build
    from bevyray_tpu_torch.kernels.cuda.megakernel import (
        TILE, block_grid, kernel_mode, prepare_kernel_scene, render_tiles,
        render_tiles_reference)
    from bevyray_tpu_torch.kernels.camera import camera_rows
    from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for

    dev = torch.device("cuda", 0)
    card = card_line()

    # Phase 1: the card and the kernel build.
    t0 = time.perf_counter()
    build.extension()
    print(f"phase 1 card: {card} | kernel build {time.perf_counter() - t0:.1f} s",
          flush=True)

    # Phase 2: kernel against plain version on the same CUDA tensors, every
    # mode. Level 1 differs from the others in the kernel only by its
    # fallback depth; the night scene carries the emissive term, the lens
    # case the thin lens and cosine-weighted diffuse bounces. The split cases
    # take the port's shortlists; one flags every other block's shortlist
    # full, so those blocks take the full walk at bounce 0 too; one has
    # 512 padded spheres in 64 candidate groups of 8; the last holds two
    # spheres twice (only the lower index may win a tie) in groups of 24,
    # the last of them partly empty. The mesh cases put a metallic cube mesh
    # in front of a sphere of the simple scene, in every mode, and then the
    # same cube twice (only the lower triangle index may win a tie).
    small = RenderConfig(128, 128, 4, 4, level=3, pallas_primary="off",
                         pallas_intersect="grouped")
    lens = RaytracedCamera(aperture=0.2, focus_distance=4.0)
    grid4 = lambda: rtiow.final_scene(seed=42, grid=4)   # noqa: E731

    def duplicates():
        world = grid4()
        for pos in ((0.0, 1.0, 0.0), (4.0, 1.0, 0.0)):
            world.spawn_sphere(Transform.from_xyz(*pos),
                               RaytracedSphere(radius=1.0),
                               StandardMaterial(base_color=(1.0, 0.0, 0.0)))
        return world

    cases = [("material_test_scene", rtiow.material_test_scene, {}),
             ("material_test_scene", rtiow.material_test_scene, {"level": 1}),
             ("final_scene(grid=4)", grid4, {}),
             ("final_scene(grid=4)", grid4, {"level": 1}),
             ("night_scene", rtiow.night_scene, {}),
             ("material_test_scene(aperture=0.2)",
              lambda: rtiow.material_test_scene(lens),
              {"defocus": True, "diffuse_sampling": "cosine"}),
             ("final_scene(grid=4)", grid4,
              {"pallas_primary": "split", "pallas_intersect": "candidates",
               "pallas_cand_size": 8}),
             ("final_scene(grid=4)", grid4,
              {"pallas_primary": "split", "pallas_intersect": "grouped"}),
             ("final_scene(grid=4)", grid4,
              {"pallas_primary": "off", "pallas_intersect": "candidates"}),
             ("final_scene(grid=4) overflow", grid4,
              {"pallas_primary": "split", "pallas_intersect": "candidates"}),
             ("final_scene", lambda: rtiow.final_scene(seed=42),
              {"pallas_primary": "split", "pallas_intersect": "auto",
               "pallas_cand_size": 8}),
             ("final_scene(grid=4) duplicates", duplicates,
              {"pallas_primary": "split", "pallas_intersect": "candidates",
               "pallas_cand_size": 24})]
    cases += [("simple_scene + cube mesh", mesh_scene,
               {"pallas_primary": mode[0], "pallas_intersect": mode[1]})
              for mode in MODES]
    cases.append(("simple_scene + cube mesh twice",
                  lambda: mesh_scene(copies=2),
                  {"pallas_primary": "split",
                   "pallas_intersect": "candidates"}))
    small_times = {}
    for name, scene_fn, options in cases:
        cfg = dataclasses.replace(small, **options)
        world = scene_fn()
        kscene = prepare_kernel_scene(world.extract(with_bvh=False, device=dev),
                                      cfg.pallas_cand_size)
        cam = world.camera_state(aspect=1.0, device=dev)
        sl, slmeta = device_shortlists_for(kscene, cam, cfg,
                                           cfg.samples_per_pixel)
        if "overflow" in name:
            slmeta = slmeta.clone()
            slmeta[::2, 0] = 1.0
        mode = kernel_mode(kscene, cfg, sl)
        if any(knob not in ("auto", ran) for knob, ran in zip(
                (cfg.pallas_primary, cfg.pallas_intersect), mode)):
            raise SystemExit(f"phase 2 {name}: ran {mode}, not the mode "
                             "the case forces")
        got = render_tiles(kscene, cam, cfg, 7, exact_rng=True, sl=sl,
                           slmeta=slmeta)
        want = render_tiles_reference(kscene, cam, cfg, 7, exact_rng=True,
                                      sl=sl, slmeta=slmeta)
        label = " ".join([name, "/".join(mode)]
                         + [f"{k}={v}" for k, v in options.items()
                            if not k.startswith("pallas_p")
                            and not k.startswith("pallas_i")])
        check_agreement(f"phase 2 {label} 128x128 4spp",
                        compare(cfg, got, want))
        if cfg.level == 3:
            small_times[label] = (
                cuda_ms(lambda: render_tiles(kscene, cam, cfg, 7,
                                             exact_rng=True, sl=sl,
                                             slmeta=slmeta), 10),
                cuda_ms(lambda: render_tiles_reference(
                    kscene, cam, cfg, 7, exact_rng=True, sl=sl,
                    slmeta=slmeta), 3))
    print("phase 2 times at 128x128 4spp 4 bounces (kernel ms, plain ms): "
          + json.dumps(small_times) + f" | {card}", flush=True)

    # Phase 3: the main path at full size, through the public entry points:
    # the default configuration first, then each other mode forced. The
    # launch counts are zeroed just before each run and read just after.
    world = rtiow.final_scene(seed=42)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=WIDTH / HEIGHT)
    if scene.spheres.cx.device.type != "cuda" or cam.fov.device.type != "cuda":
        raise SystemExit("phase 3: the entry points did not default to the card")
    headline = RenderConfig(WIDTH, HEIGHT, SPP, BOUNCES, level=3)
    runs = {}
    for mode in [("split", "candidates")] + [m for m in MODES
                                             if m != ("split", "candidates")]:
        default = mode == ("split", "candidates")
        config = headline if default else forced(headline, mode)
        n_frames = TIMED_FRAMES if default else OTHER_FRAMES
        renderer = FusedRenderer(config, exact_rng=True)
        renderer.render(scene, cam, seed=0)
        torch.cuda.synchronize()
        render_tiles.launches = 0
        render_tiles_reference.calls = 0
        frame_mod.resolve_frame.launches = 0
        times, rays = [], []
        with pass_launches(f"phase 3 {mode}", {"camera_rows": n_frames}):
            for i in range(n_frames):
                t0 = time.perf_counter()
                frame = renderer.render(scene, cam, seed=i + 1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                rays.append(int(frame.rays_traced))
        launches, plain_calls = render_tiles.launches, render_tiles_reference.calls
        tails = frame_mod.resolve_frame.launches
        TAIL_LAUNCHES["resolve_frame"] += tails
        if (launches != n_frames or plain_calls or tails != n_frames
                or renderer.last_mode != mode):
            raise SystemExit(f"phase 3 {mode}: {launches} kernel launches, "
                             f"{tails} tail launches (K10), {plain_calls} "
                             f"plain calls and mode {renderer.last_mode} in "
                             f"{n_frames} frames")
        image = frame.image
        if (tuple(image.shape) != (HEIGHT, WIDTH, 3)
                or not bool(torch.isfinite(image).all())
                or not bool(torch.isfinite(frame.rt_depth).all())
                or min(rays) <= 0 or not 0.0 < float(image.mean()) < 2.0):
            raise SystemExit(f"phase 3 {mode}: frame is not a finite image "
                             "with traced segments")
        times.sort()
        p50_ms = times[len(times) // 2] * 1e3
        rays_per_frame = sum(rays) / len(rays)
        runs[mode] = {"renderer": renderer, "launches": launches,
                      "p50_ms": p50_ms, "segments": rays_per_frame}
        print(f"phase 3 {'default config' if default else 'forced'} "
              f"{'/'.join(mode)} {WIDTH}x{HEIGHT} {SPP}spp {BOUNCES} bounces, "
              f"{world.n_spheres} spheres: p50 {p50_ms:.3f} ms, "
              f"{rays_per_frame / (p50_ms * 1e-3) / 1e6:.2f} Mrays/s, "
              f"{rays_per_frame:.0f} segments/frame, frame ms "
              f"{[round(t * 1e3, 3) for t in times]} | {card}", flush=True)

    # Phase 4: each mode's plain version once at the main path's shapes, held
    # against the kernel's frame of the same seed on the same inputs; the
    # plain version also counts the sphere and slab tests that the bound
    # reads.
    nbx, nby = block_grid(headline)
    n_lanes = nbx * nby * TILE
    entries = []
    for mode in MODES:
        renderer = runs[mode]["renderer"]
        config = renderer.config
        kscene = renderer.prepare(scene)
        sl, slmeta = renderer.shortlists(kscene, cam)
        run = dict(exact_rng=True, sl=sl, slmeta=slmeta)
        got = render_tiles(kscene, cam, config, 1, **run)
        torch.cuda.synchronize()
        work = {}
        t0 = time.perf_counter()
        want = render_tiles_reference(kscene, cam, config, 1, exact_rng=True,
                                      sl=sl, slmeta=slmeta, work=work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        full = compare(config, got, want)
        kernel_ms = cuda_ms(lambda: render_tiles(kscene, cam, config, 1,
                                                 **run), 3)
        b_ms, b_by = bound_ms(kscene, camera_rows(cam, config).fused, sl,
                              slmeta, n_lanes, work)
        check_agreement(
            f"phase 4 {'/'.join(mode)} fuse {renderer.last_fuse} main-path "
            f"shapes, kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), sphere tests {work['sphere_tests']}, "
            f"slab tests {work['slab_tests']} | {card}", full)
        entries.append({
            "name": f"render_tiles[{mode[0]},{mode[1]}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[mode],
            "launches": runs[mode]["launches"], "max_abs_err": full["max_abs"],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            # No single PyTorch call computes a path-traced frame.
            "library_ms": None})

    map_entry, map_pass = accumulation_phase(world, scene, cam, headline,
                                             card)
    entries.append(map_entry)
    hybrid_entry, raster_launches = hybrid_phase(card)
    entries.append(hybrid_entry)
    fast_entries = fast_phase(scene, cam, headline, card)
    entries += fast_entries
    entries.append(shard_phase(scene, cam, headline, card,
                               fast_entries[0]["bound_ms"],
                               fast_entries[0]["bound_by"]))
    probe_phase(scene, cam, headline, card, map_pass)
    book_phase(card)
    denoise_inputs, denoise_launches = cli_phase(card, dev)
    oracle_phase(card, dev)
    bench_phase(scene, cam, headline, card, dev)
    entries += wavefront_phase(scene, cam, headline, card, dev)
    entries += image_phase(card, dev, raster_launches, denoise_inputs,
                           denoise_launches)
    entries += tail_phase(world, scene, cam, headline, card, dev)
    entries += pass_phase(world, scene, cam, headline, card, dev)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def timed_passes(renderer, scene, cam, seeds) -> list:
    """Run ``renderer.step`` once per seed; per pass the host ms
    (synchronised), the segments and the per-pixel mask of the pixels the
    pass sampled."""
    import torch

    out = []
    for seed in seeds:
        before = renderer.film
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.step(scene, cam, seed=seed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = renderer.film
        out.append((ms, int(after.rays_traced) - int(before.rays_traced),
                    after.n_samples > before.n_samples))
    return out


def accumulation_phase(world, scene, cam, headline, card) -> dict:
    """Phase 5: the accumulating path at the headline through
    ``ProgressiveRenderer(backend="pallas")`` and ``AdaptiveRenderer``, and
    the kernel under a real adaptive sample map against its plain version.
    Returns the kernels-line entry of the map branch, and the map with the
    share of pixels it samples."""
    import torch

    from bevyray_tpu_torch import (AdaptiveRenderer, FusedRenderer,
                                   ProgressiveRenderer)
    from bevyray_tpu_torch.engine.film import resolve_impl
    from bevyray_tpu_torch.kernels import frame as frame_mod
    from bevyray_tpu_torch.kernels.cuda.megakernel import (
        TILE, block_grid, kernel_fuse, kernel_mode, render_tiles,
        render_tiles_reference, shuffle_blocks)
    from bevyray_tpu_torch.kernels.camera import camera_rows

    def counts_zeroed():
        render_tiles.launches = 0
        render_tiles.launches_by.clear()
        render_tiles_reference.calls = 0
        frame_mod.resolve_frame.launches = 0
        frame_mod.fold_pass.launches = 0

    def check_tail(what, passes):
        """Each pass of a film folded by one K11 launch and resolved by one
        K10 launch."""
        got = (frame_mod.fold_pass.launches, frame_mod.resolve_frame.launches)
        TAIL_LAUNCHES.update(fold_pass=got[0], resolve_frame=got[1])
        if got != (passes, passes):
            raise SystemExit(f"phase 5 {what}: {got[0]} fold (K11) and "
                             f"{got[1]} tail (K10) launches, expected "
                             f"{passes} each")

    def check_counts(what, launches):
        if (render_tiles.launches, render_tiles_reference.calls) != (
                launches, 0):
            raise SystemExit(
                f"phase 5 {what}: {render_tiles.launches} kernel launches "
                f"and {render_tiles_reference.calls} plain calls, expected "
                f"{launches} and 0")

    def check_frame(what, frame):
        image = frame.image
        if (tuple(image.shape) != (HEIGHT, WIDTH, 3)
                or not bool(torch.isfinite(image).all())
                or not bool(torch.isfinite(frame.rt_depth).all())
                or int(frame.rays_traced) <= 0
                or not 0.0 < float(image.mean()) < 2.0):
            raise SystemExit(f"phase 5 {what}: not a finite image with "
                             "traced segments")

    def check_same(what, got, want):
        segs = (int(got.rays_traced), int(want.rays_traced))
        max_abs = float((got.image - want.image).abs().max())
        print(f"phase 5 {what}: segments {segs[0]} / {segs[1]}, image max "
              f"|d| {max_abs:.3g}", flush=True)
        if segs[0] != segs[1] or not max_abs <= IDENTITY_TOL:
            raise SystemExit(f"phase 5 {what}: segments must be equal and "
                             f"the image within {IDENTITY_TOL}")

    def mrays(segments, ms):
        return segments / (ms * 1e-3) / 1e6

    # 2 passes x 8 spp against one 16 spp frame of the same seed.
    half = dataclasses.replace(headline, samples_per_pixel=SPP // 2)
    prog = ProgressiveRenderer(half, backend="pallas")
    fused = FusedRenderer(headline)
    counts_zeroed()
    with pass_launches("phase 5 2 x 8 spp film", {"camera_rows": 2}):
        prog.step(scene, cam, seed=9)
        film_frame = prog.step(scene, cam, seed=9)
        torch.cuda.synchronize()
    check_counts("2 x 8 spp film", 2)
    check_tail("2 x 8 spp film", 2)
    kscene = prog._renderer.prepare(scene)
    half_mode = kernel_mode(kscene, half,
                            prog._renderer.shortlists(kscene, cam)[0])
    frame = fused.render(scene, cam, seed=9)
    check_frame("2 x 8 spp film", film_frame)
    check_same(f"2 x {SPP // 2} spp film ({'/'.join(half_mode)}) vs 1 x "
               f"{SPP} spp frame ({'/'.join(fused.last_mode)})", film_frame,
               frame)

    # Uniform progressive passes at the headline, after one warm-up pass
    # that pays the set-up (kernel tables, shortlists).
    prog = ProgressiveRenderer(headline, backend="pallas")
    prog.step(scene, cam, seed=0)
    prog.reset()
    counts_zeroed()
    with pass_launches("phase 5 progressive passes", {"camera_rows": PASSES}):
        uniform = timed_passes(prog, scene, cam, range(1, PASSES + 1))
    check_counts("progressive passes", PASSES)
    check_tail("progressive passes", PASSES)
    uniform_frame = resolve_impl(prog.film, cam, headline)
    check_frame("progressive film", uniform_frame)
    pass_ms = sorted(ms for ms, _, _ in uniform)
    p50 = pass_ms[len(pass_ms) // 2]
    segs = sum(n for _, n, _ in uniform) / len(uniform)
    print(f"phase 5 progressive {WIDTH}x{HEIGHT} {SPP} spp/pass, {PASSES} "
          f"passes: p50 {p50:.3f} ms/pass, {mrays(segs, p50):.2f} Mrays/s, "
          f"{segs:.0f} segments/pass, pass ms "
          f"{[round(ms, 3) for ms, _, _ in uniform]} | {card}", flush=True)

    # Adaptive passes after a warm-up pass: per pass the share of pixels
    # sampled; the map of pass MAP_PASS serves the kernel check below.
    adap = AdaptiveRenderer(headline, tolerance=TOLERANCE,
                            reprobe_every=REPROBE_EVERY)
    adap.step(scene, cam, seed=0)
    adap.reset()
    kscene = adap._renderer.prepare(scene)
    sl, slmeta = adap._renderer.shortlists(kscene, cam)
    adap_mode = kernel_mode(kscene, headline, sl)
    if adap_mode != ("split", "candidates"):
        raise SystemExit(f"phase 5: the adaptive pass runs {adap_mode}, not "
                         "the default split/candidates")
    counts_zeroed()
    # Each adaptive pass: K12, K13, the kernel and K14.
    with pass_launches("phase 5 adaptive passes", dict.fromkeys(
            ("camera_rows", "adaptive_map", "fold_adaptive"), PASSES)):
        passes = timed_passes(adap, scene, cam, range(1, PASSES + 1))
    check_counts("adaptive passes", PASSES)
    adaptive_launches = render_tiles.launches
    # On the card the films draw from the fast path, as JAX's do on the TPU.
    fuse = kernel_fuse(kscene, headline, sl)
    if dict(render_tiles.launches_by) != {("fast", fuse): PASSES}:
        raise SystemExit(f"phase 5 adaptive passes: launches "
                         f"{dict(render_tiles.launches_by)}, not {PASSES} of "
                         f"the fast path at fuse {fuse}")
    check_frame("adaptive film", adap.resolve(cam))
    counts = adap.samples_map()
    for k, (ms, n, sampled) in enumerate(passes):
        print(f"phase 5 adaptive pass {k}: {ms:.3f} ms, "
              f"{float(sampled.float().mean()):.4f} of pixels sampled, {n} "
              f"segments, {mrays(n, ms):.2f} Mrays/s", flush=True)
    print(f"phase 5 adaptive tolerance {TOLERANCE}, re-probe every "
          f"{REPROBE_EVERY}, {PASSES} passes: converged "
          f"{adap.converged_fraction():.4f}, samples/pixel min "
          f"{counts.min():.0f} mean {counts.mean():.2f} max "
          f"{counts.max():.0f}, total "
          f"{sum(ms for ms, _, _ in passes):.3f} ms vs uniform "
          f"{sum(ms for ms, _, _ in uniform):.3f} ms | {card}", flush=True)

    # tolerance 0 never stops a pixel: the uniform film of the same seeds.
    flat = AdaptiveRenderer(headline, tolerance=0.0,
                            reprobe_every=REPROBE_EVERY)
    for seed in range(1, PASSES + 1):
        flat.step(scene, cam, seed=seed)
    check_same(f"adaptive tolerance 0 vs progressive, {PASSES} passes",
               flat.resolve(cam), uniform_frame)

    # The kernel against its plain version under the map of pass MAP_PASS
    # at sample offset MAP_OFFSET, on both draw paths: the exact one, which
    # phases 2-6 hold, and the fast one, which the passes above launched.
    # Sums over a pass are compared at the scale of the per-spp bars (times
    # 1/spp), on the pixels the map samples; every lane whose target is 0
    # (unsampled pixels, block padding) must trace nothing and leave exact
    # zero sums.
    spp_map = shuffle_blocks(
        torch.where(passes[MAP_PASS][2], SPP, 0).to(torch.int32), headline,
        fill=0)
    share = float((spp_map > 0).float().sum()) / (WIDTH * HEIGHT)
    nbx, nby = block_grid(headline)
    checked = {}
    for arm in ("exact", "fast"):
        run = dict(exact_rng=arm == "exact", sl=sl, slmeta=slmeta,
                   normalize=False, spp_map=spp_map, sample_offset=MAP_OFFSET)
        got = render_tiles(kscene, cam, headline, 1, **run)
        torch.cuda.synchronize()
        work = {}
        t0 = time.perf_counter()
        want = render_tiles_reference(kscene, cam, headline, 1, work=work,
                                      **run)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        scale = 1.0 / SPP
        stats = compare(headline, [x * scale for x in got[:4]] + [got[4]],
                        [x * scale for x in want[:4]] + [want[4]],
                        mask=spp_map > 0)
        idle = spp_map.reshape(-1) == 0
        idle_max = [max(float(torch.where(idle, x, 0.0).abs().max())
                        for x in out[:4]) for out in (got, want)]
        print(f"phase 5 spp_map {arm} rng: {int(idle.sum())} lanes of target "
              f"0, max |sum| there kernel {idle_max[0]:.3g}, plain "
              f"{idle_max[1]:.3g}", flush=True)
        if idle_max != [0.0, 0.0]:
            raise SystemExit("phase 5 spp_map: a lane whose target is 0 must "
                             "leave exact zero sums (r, g, b, depth)")
        kernel_ms = cuda_ms(lambda: render_tiles(kscene, cam, headline, 1,
                                                 **run), 3)
        b_ms, b_by = bound_ms(kscene, camera_rows(cam, headline).fused, sl,
                              slmeta, nbx * nby * TILE, work, spp_map)
        check_agreement(
            f"phase 5 split/candidates fuse {fuse} {arm} rng + spp_map (pass "
            f"{MAP_PASS}, {share:.4f} of pixels), sample_offset {MAP_OFFSET}, "
            f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), sphere tests {work['sphere_tests']}, "
            f"slab tests {work['slab_tests']} | {card}", stats)
        checked[arm] = stats, kernel_ms, plain_ms, b_ms, b_by
    # The entry of the instance the adaptive passes launched.
    stats, kernel_ms, plain_ms, b_ms, b_by = checked["fast"]
    return {"name": "render_tiles[split,candidates,spp_map,fast_rng]",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:1571", "launches": adaptive_launches,
            "max_abs_err": stats["max_abs"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, (spp_map, share)


def hybrid_phase(card) -> tuple:
    """Phase 6: BASELINE config 5 at full size (scripts/bench_matrix.py:
    101-114) through the public entry points: the raster layer on the card,
    then the default-config ``FusedRenderer``, which must take the mode the
    JAX gate picks (the port's copies of ``shortlists_for`` and
    ``use_candidate_walk``) and launch the kernel once per frame with no
    plain run; then the kernel against its plain version at these shapes.
    Returns the kernels-line entry of the triangle branch and the raster
    layer's launches (K8, K2, K9) over its timed calls."""
    import torch

    from bevyray_tpu_torch import FusedRenderer
    from bevyray_tpu_torch.engine import raster
    from bevyray_tpu_torch.kernels import intersect
    from bevyray_tpu_torch.kernels.cuda.megakernel import (
        TILE, block_grid, kernel_mode, render_tiles, render_tiles_reference,
        use_candidate_walk)
    from bevyray_tpu_torch.kernels.camera import camera_rows
    from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for

    width, height = HYBRID_SIZE
    world, config = config5_world()
    cam = world.camera_state(aspect=16 / 9)
    scene = world.extract(with_bvh=False)

    # The raster layer: a set-up per camera (host extraction, upload and K8
    # -> K2 -> K9, one launch each a call, no plain run), host clock around
    # a synchronised call.
    raster_times = []
    raster.raster_rays.launches = raster.raster_shade.launches = 0
    k2_before = intersect.intersect_triangles.launches
    with plain_calls(raster, ("rasterize_impl_reference",
                              "raster_rays_reference",
                              "raster_shade_reference")) as plain:
        for _ in range(1 + RASTER_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, rd = raster.raster_layer(world, cam, config)
            torch.cuda.synchronize()
            raster_times.append((time.perf_counter() - t0) * 1e3)
    raster_launches = {
        "raster_rays": raster.raster_rays.launches,
        "raster_shade": raster.raster_shade.launches,
        "intersect_triangles": (intersect.intersect_triangles.launches
                                - k2_before)}
    if set(raster_launches.values()) != {1 + RASTER_REPS} or sum(
            plain.values()):
        raise SystemExit(f"phase 6: the raster layer launched "
                         f"{raster_launches} and ran the plain versions "
                         f"{plain} in {1 + RASTER_REPS} calls")
    raster_p50 = sorted(raster_times[1:])[RASTER_REPS // 2]
    if (rd.device != scene.spheres.cx.device
            or tuple(rd.shape) != (width * height,)
            or not bool(torch.isfinite(rd).all()) or not bool((rd > 0).any())):
        raise SystemExit("phase 6: the raster layer did not give finite "
                         "buffers with the cube on the card")

    renderer = FusedRenderer(config, exact_rng=True)
    kscene = renderer.prepare(scene)
    gate_sl = device_shortlists_for(kscene, cam, config, SPP)[0]
    expected = ("split" if gate_sl is not None else "off",
                "candidates" if use_candidate_walk(
                    config, kscene.sph.shape[1], gate_sl is not None)
                else "grouped")
    renderer.render(scene, cam, seed=0, raster_color=rc, raster_depth=rd)
    torch.cuda.synchronize()
    render_tiles.launches = 0
    render_tiles_reference.calls = 0
    times, rays = [], []
    for i in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        frame = renderer.render(scene, cam, seed=i + 1, raster_color=rc,
                                raster_depth=rd)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rays.append(int(frame.rays_traced))
    launches = render_tiles.launches
    if (launches != TIMED_FRAMES or render_tiles_reference.calls
            or renderer.last_mode != expected):
        raise SystemExit(f"phase 6: {launches} kernel launches, "
                         f"{render_tiles_reference.calls} plain calls and "
                         f"mode {renderer.last_mode} (the gate picks "
                         f"{expected}) in {TIMED_FRAMES} frames")
    image = frame.image
    if (tuple(image.shape) != (height, width, 3)
            or not bool(torch.isfinite(image).all())
            or not bool(torch.isfinite(frame.rt_depth).all())
            or min(rays) <= 0 or not 0.0 < float(image.mean()) < 2.0):
        raise SystemExit("phase 6: frame is not a finite image with traced "
                         "segments")
    # Where the raster layer wins the blend (kernels/composite.py, level 2).
    rt_depth = frame.rt_depth.reshape(-1)
    rz = torch.where(rt_depth > cam.far, -1.0, cam.near / rt_depth)
    raster_wins = int((rd > rz).sum())
    times.sort()
    p50_ms = times[len(times) // 2] * 1e3
    segments = sum(rays) / len(rays)
    print(f"phase 6 BASELINE config 5 default config {'/'.join(expected)} "
          f"{width}x{height} {SPP}spp {BOUNCES} bounces level 2, "
          f"{world.n_spheres} spheres + {kscene.n_tris} triangles "
          f"({kscene.tri.shape[1]} rows): p50 {p50_ms:.3f} ms, "
          f"{segments / (p50_ms * 1e-3) / 1e6:.2f} Mrays/s, {segments:.0f} "
          f"segments/frame, frame ms {[round(t * 1e3, 3) for t in times]}; "
          f"raster layer p50 {raster_p50:.3f} ms of "
          f"{[round(t, 3) for t in raster_times]} (first call included; "
          f"launches {raster_launches}), "
          f"raster wins {raster_wins} of {width * height} pixels | {card}",
          flush=True)

    sl, slmeta = renderer.shortlists(kscene, cam)
    run = dict(exact_rng=True, sl=sl, slmeta=slmeta)
    got = render_tiles(kscene, cam, config, 1, **run)
    torch.cuda.synchronize()
    work = {}
    t0 = time.perf_counter()
    want = render_tiles_reference(kscene, cam, config, 1, exact_rng=True,
                                  sl=sl, slmeta=slmeta, work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    stats = compare(config, got, want)
    kernel_ms = cuda_ms(lambda: render_tiles(kscene, cam, config, 1, **run),
                        3)
    nbx, nby = block_grid(config)
    b_ms, b_by = bound_ms(kscene, camera_rows(cam, config).fused, sl, slmeta,
                          nbx * nby * TILE, work)
    # The cube mesh lies just outside the 16:9 frustum (its nearest edge at
    # |x/z| = 3.4/4.6 = 0.739 against tan(fov/2) * aspect = 0.736), so it
    # shows through reflections and bounces, not in primary segments.
    print(f"phase 6 segments that hit a triangle: {work['triangle_hits']} "
          f"of {int(want[4])}, {work['triangle_first_hits']} of them first "
          f"segments (of {width * height * SPP})", flush=True)
    if work["triangle_hits"] <= 0:
        raise SystemExit("phase 6: no segment hits the cube mesh")
    check_agreement(
        f"phase 6 {'/'.join(kernel_mode(kscene, config, sl))} + triangles "
        f"config-5 shapes, kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} "
        f"ms, bound {b_ms:.3f} ms ({b_by}), sphere tests "
        f"{work['sphere_tests']}, slab tests {work['slab_tests']}, triangle "
        f"tests {work['triangle_tests']} | {card}", stats)
    return {"name": f"render_tiles[{expected[0]},{expected[1]},triangles]",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:1346", "launches": launches,
            "max_abs_err": stats["max_abs"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, raster_launches


def box_mean_abs(a, b) -> float:
    """Mean |a - b| of two [H, W, 3] images after a BOX x BOX box filter."""
    h, w = (a.shape[0] // BOX) * BOX, (a.shape[1] // BOX) * BOX

    def box(img):
        return img[:h, :w].reshape(h // BOX, BOX, w // BOX, BOX, 3).mean(
            dim=(1, 3))

    return float((box(a) - box(b)).abs().mean())


def fast_phase(scene, cam, headline, card) -> list:
    """Phase 7: the fast draw path (ROADMAP B8) and block fusion (B10). Returns
    the kernels-line entries of the two branches and of the triangle branch
    on the fast path (config 5)."""
    import torch

    from bevyray_tpu_torch import (FusedRenderer, ProgressiveRenderer,
                                   RaytracedCamera, RenderConfig, rtiow)
    from bevyray_tpu_torch.engine.raster import raster_layer
    from bevyray_tpu_torch.kernels.camera import camera_rows
    from bevyray_tpu_torch.kernels.cuda import fast_rng
    from bevyray_tpu_torch.kernels.cuda import megakernel as mk
    from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for

    dev = torch.device("cuda", 0)
    render_tiles, render_tiles_reference = (mk.render_tiles,
                                            mk.render_tiles_reference)

    def counts_zeroed():
        render_tiles.launches = 0
        render_tiles.launches_by.clear()
        render_tiles_reference.calls = 0

    def held(name, kscene, cam_s, cfg, sl, slmeta, seed=7, spp_map=None,
             sample_offset=0, work=None) -> tuple:
        """The fast kernel against its fast plain version on the same CUDA
        tensors at phase 2's bars (max |d| 0 and equal segments expected).
        Under ``spp_map`` the sums are compared per spp on the lanes it
        samples, and its lanes of target 0 must leave exact zero sums.
        Returns the agreement and the plain version's ms."""
        run = dict(exact_rng=False, sl=sl, slmeta=slmeta, spp_map=spp_map,
                   sample_offset=sample_offset, normalize=spp_map is None)
        got = render_tiles(kscene, cam_s, cfg, seed, **run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = render_tiles_reference(kscene, cam_s, cfg, seed, work=work,
                                      **run)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        mask = None
        if spp_map is not None:
            idle = spp_map.reshape(-1) == 0
            if any(float(x[idle].abs().max()) != 0.0
                   for out in (got, want) for x in out[:4]):
                raise SystemExit(f"phase 7 {name}: a lane whose target is 0 "
                                 "must leave exact zero sums")
            scale = 1.0 / cfg.samples_per_pixel
            got, want = ([x * scale for x in out[:4]] + [out[4]]
                         for out in (got, want))
            mask = spp_map > 0
        stats = compare(cfg, got, want, mask)
        check_agreement(f"phase 7 fast {name}", stats)
        return stats, plain_ms

    # (a) Every mode under each layout; the lens; forced fuses 4 and 8 of
    # the split on 6 blocks, so the last CUDA block's tail halves are
    # padding; the cube mesh in every mode; and a sample map of targets 0-5
    # at sample offset MAP_OFFSET under fuse 4.
    small = RenderConfig(128, 128, 4, 4, level=3)
    wide = dataclasses.replace(small, width=192)
    final = rtiow.final_scene(seed=42)
    lens_world = rtiow.material_test_scene(
        RaytracedCamera(aperture=0.2, focus_distance=4.0))
    mesh = mesh_scene()
    cases = [(f"final_scene {'/'.join(mode)} layout {w}", final, small, mode,
              w, None, False) for mode in MODES for w in LAYOUTS]
    cases += [(f"material_test_scene(aperture=0.2) defocus layout {w}",
               lens_world, dataclasses.replace(small, defocus=True),
               ("split", "candidates"), w, None, False) for w in LAYOUTS]
    cases += [(f"final_scene 192x128 split/{mode[1]} fuse {f}", final, wide,
               mode, 6, f, False)
              for mode in MODES if mode[0] == "split" for f in (4, 8)]
    cases += [(f"simple_scene + cube mesh {'/'.join(mode)}", mesh, small,
               mode, 6, None, False) for mode in MODES]
    cases.append((f"final_scene 192x128 split/candidates fuse 4 + spp_map, "
                  f"sample_offset {MAP_OFFSET}", final, wide,
                  ("split", "candidates"), 6, 4, True))
    targets = torch.randint(0, 6, (wide.width * wide.height,),
                            generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32)
    fast_max = fused_max = 0.0
    for name, world, cfg, mode, layout, fuse, mapped in cases:
        cfg = dataclasses.replace(cfg, pallas_primary=mode[0],
                                  pallas_intersect=mode[1])
        kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False,
                                                       device=dev))
        cam_s = world.camera_state(aspect=cfg.width / cfg.height, device=dev)
        sl, slmeta = device_shortlists_for(kscene, cam_s, cfg, 4)
        fast_rng.HW_DRAWS_COMPACT, fast_rng.HW_DRAWS_ZPHI = LAYOUTS[layout]
        mk.PHASE_FUSE = "auto" if fuse is None else fuse
        ran = (mk.kernel_mode(kscene, cfg, sl), mk.kernel_fuse(kscene, cfg, sl),
               fast_rng.words_per_bounce())
        if ran[0] != mode or ran[2] != layout or fuse not in (None, ran[1]):
            raise SystemExit(f"phase 7 {name}: ran {ran}")
        extra = (dict(spp_map=mk.shuffle_blocks(targets, cfg).to(dev),
                      sample_offset=MAP_OFFSET) if mapped else {})
        stats, _ = held(f"{name} (fuse {ran[1]}) {cfg.width}x{cfg.height} "
                        "4spp", kscene, cam_s, cfg, sl, slmeta, **extra)
        fast_max = max(fast_max, stats["max_abs"])
        if ran[1] > 1:
            fused_max = max(fused_max, stats["max_abs"])
    fast_rng.HW_DRAWS_COMPACT, fast_rng.HW_DRAWS_ZPHI = LAYOUTS[6]
    mk.PHASE_FUSE = "auto"

    # (b) The default-config headline: it must resolve to the fast path,
    # split/candidates and fuse 4. Timed in the order exact, fast, fast,
    # exact, each arm a warm-up frame and TIMED_FRAMES frames; the counts
    # are zeroed before each arm and read after it.
    fast = FusedRenderer(headline)
    exact = FusedRenderer(headline, exact_rng=True)
    arms = {"exact": [], "fast": []}
    frames, fast_launches, fused_launches = {}, 0, 0
    for arm in ("exact", "fast", "fast", "exact"):
        renderer = fast if arm == "fast" else exact
        renderer.render(scene, cam, seed=0)
        torch.cuda.synchronize()
        counts_zeroed()
        times, rays = [], []
        for i in range(TIMED_FRAMES):
            t0 = time.perf_counter()
            frame = renderer.render(scene, cam, seed=i + 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rays.append(int(frame.rays_traced))
        by = dict(render_tiles.launches_by)
        want_by = {(arm, 4): TIMED_FRAMES}
        if (by != want_by or render_tiles_reference.calls
                or renderer.last_mode != ("split", "candidates")
                or renderer.last_fuse != 4
                or renderer.last_exact_rng != (arm == "exact")):
            raise SystemExit(f"phase 7 {arm} headline: launches {by} (want "
                             f"{want_by}), {render_tiles_reference.calls} "
                             f"plain calls, mode {renderer.last_mode}, fuse "
                             f"{renderer.last_fuse}, exact_rng "
                             f"{renderer.last_exact_rng}")
        if arm == "fast":
            fast_launches += render_tiles.launches
            fused_launches += sum(n for (_, f), n in by.items() if f > 1)
        frames[arm] = frame
        times.sort()
        arms[arm].append({"p50_ms": times[len(times) // 2] * 1e3,
                          "segments": sum(rays) / len(rays)})
    kscene = fast.prepare(scene)
    sl, slmeta = fast.shortlists(kscene, cam)
    kernel = {arm: cuda_ms(lambda: render_tiles(
        kscene, cam, headline, 1, exact_rng=arm == "exact", sl=sl,
        slmeta=slmeta), 3) for arm in ("exact", "fast")}
    for arm, runs in arms.items():
        p50s = [r["p50_ms"] for r in runs]
        segs = runs[0]["segments"]
        print(f"phase 7 headline default config {arm} rng split/candidates "
              f"fuse 4 {WIDTH}x{HEIGHT} {SPP}spp {BOUNCES} bounces: p50 "
              f"{[round(p, 3) for p in p50s]} ms (arms in call order), "
              f"{segs / (min(p50s) * 1e-3) / 1e6:.2f} Mrays/s at the lower, "
              f"{segs:.0f} segments/frame, kernel {kernel[arm]:.3f} ms "
              f"| {card}", flush=True)
    work = {}
    head_stats, plain_ms = held(
        f"split/candidates fuse 4 main-path shapes, kernel "
        f"{kernel['fast']:.3f} ms | {card}", kscene, cam, headline, sl,
        slmeta, seed=1, work=work)
    nbx, nby = mk.block_grid(headline)
    b_ms, b_by = bound_ms(kscene, camera_rows(cam, headline).fused, sl, slmeta,
                          nbx * nby * mk.TILE, work)
    print(f"phase 7 fast headline: plain {plain_ms:.1f} ms, bound {b_ms:.3f} "
          f"ms ({b_by}), sphere tests {work['sphere_tests']}, slab tests "
          f"{work['slab_tests']}", flush=True)
    fast_max = max(fast_max, head_stats["max_abs"])
    fused_max = max(fused_max, head_stats["max_abs"])

    # (c) The fuse ladder on the fast path: kernel ms, and the same frame
    # and segments from every fuse.
    ladder, base = {}, None
    for want_fuse in FUSE_LADDER:
        mk.PHASE_FUSE = want_fuse
        fuse = mk.kernel_fuse(kscene, headline, sl)
        out = render_tiles(kscene, cam, headline, 1, exact_rng=False, sl=sl,
                           slmeta=slmeta)
        base = out if base is None else base
        if not all(torch.equal(x, y) for x, y in zip(out, base)):
            raise SystemExit(f"phase 7 fuse {want_fuse}: the frame differs "
                             "from fuse 1's")
        ladder[str(want_fuse)] = {"fuse": fuse, "kernel_ms": cuda_ms(
            lambda: render_tiles(kscene, cam, headline, 1, exact_rng=False,
                                 sl=sl, slmeta=slmeta), 3)}
    mk.PHASE_FUSE = "auto"
    print(f"phase 7 fuse ladder, fast path, headline (PHASE_FUSE: fuse, "
          f"kernel ms): {json.dumps(ladder)}; frames and segments "
          f"({int(base[4])}) bit-equal | {card}", flush=True)

    # (d) Statistics: the fast frame against the exact frame, same seed.
    fast_img, exact_img = frames["fast"].image, frames["exact"].image
    d_mean = abs(float(fast_img.mean()) - float(exact_img.mean()))
    d_box = box_mean_abs(fast_img, exact_img)
    print(f"phase 7 fast vs exact headline frame, {SPP} spp: mean "
          f"{float(fast_img.mean()):.6f} vs {float(exact_img.mean()):.6f} "
          f"(|d| {d_mean:.6f}, bar {STAT_MEAN_TOL}), {BOX}x{BOX} box mean |d| "
          f"{d_box:.6f} (bar {BOX_MEAN_TOL})", flush=True)
    if not (d_mean < STAT_MEAN_TOL and d_box < BOX_MEAN_TOL
            and bool(torch.isfinite(fast_img).all())):
        raise SystemExit("phase 7: the fast frame disagrees with the exact "
                         "frame beyond the statistical bars")

    # (e) BASELINE config 5 under the default (fast) against the exact path,
    # in the order exact, fast, fast, exact, with the kernel timed at the
    # rule's fuse and unfused; then the fast kernel against its plain
    # version at these shapes; then progressive passes under the default.
    world5, config5 = config5_world()
    cam5 = world5.camera_state(aspect=16 / 9)
    scene5 = world5.extract(with_bvh=False)
    rc, rd = raster_layer(world5, cam5, config5)
    renderers = {"exact": FusedRenderer(config5, exact_rng=True),
                 "fast": FusedRenderer(config5)}
    k5 = renderers["fast"].prepare(scene5)
    sl5, slmeta5 = renderers["fast"].shortlists(k5, cam5)
    fuse5 = mk.kernel_fuse(k5, config5, sl5)
    hybrid_launches = 0
    for arm in ("exact", "fast", "fast", "exact"):
        renderer = renderers[arm]
        renderer.render(scene5, cam5, seed=0, raster_color=rc, raster_depth=rd)
        torch.cuda.synchronize()
        counts_zeroed()
        times, rays = [], []
        for i in range(TIMED_FRAMES):
            t0 = time.perf_counter()
            frame = renderer.render(scene5, cam5, seed=i + 1, raster_color=rc,
                                    raster_depth=rd)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rays.append(int(frame.rays_traced))
        if (dict(render_tiles.launches_by) != {(arm, fuse5): TIMED_FRAMES}
                or render_tiles_reference.calls
                or not bool(torch.isfinite(frame.image).all())
                or min(rays) <= 0):
            raise SystemExit(f"phase 7 config 5 {arm}: launches "
                             f"{dict(render_tiles.launches_by)} or not a "
                             "finite frame")
        if arm == "fast":
            hybrid_launches += render_tiles.launches
        times.sort()
        p50 = times[len(times) // 2] * 1e3
        segs = sum(rays) / len(rays)
        k_ms = {}
        for want_fuse in (1, "auto"):
            mk.PHASE_FUSE = want_fuse
            k_ms[mk.kernel_fuse(k5, config5, sl5)] = cuda_ms(
                lambda: render_tiles(k5, cam5, config5, 1,
                                     exact_rng=arm == "exact", sl=sl5,
                                     slmeta=slmeta5), 3)
        mk.PHASE_FUSE = "auto"
        print(f"phase 7 BASELINE config 5 {arm} rng "
              f"{'/'.join(renderer.last_mode)} fuse {renderer.last_fuse}: p50 "
              f"{p50:.3f} ms, {segs / (p50 * 1e-3) / 1e6:.2f} Mrays/s, "
              f"{segs:.0f} segments/frame, kernel ms by fuse "
              f"{json.dumps(k_ms)} | {card}", flush=True)
    work5 = {}
    stats5, plain5_ms = held(
        f"{'/'.join(mk.kernel_mode(k5, config5, sl5))} fuse {fuse5} + "
        f"triangles config-5 shapes | {card}", k5, cam5, config5, sl5,
        slmeta5, seed=1, work=work5)
    nbx, nby = mk.block_grid(config5)
    b5_ms, b5_by = bound_ms(k5, camera_rows(cam5, config5).fused, sl5, slmeta5,
                            nbx * nby * mk.TILE, work5)
    if work5["triangle_hits"] <= 0:
        raise SystemExit("phase 7 config 5: no segment hits the cube mesh")
    k5_ms = cuda_ms(lambda: render_tiles(k5, cam5, config5, 1,
                                         exact_rng=False, sl=sl5,
                                         slmeta=slmeta5), 3)
    print(f"phase 7 fast config 5: kernel {k5_ms:.3f} ms, plain "
          f"{plain5_ms:.1f} ms, bound {b5_ms:.3f} ms ({b5_by}), sphere tests "
          f"{work5['sphere_tests']}, slab tests {work5['slab_tests']}, "
          f"triangle tests {work5['triangle_tests']}, triangle hits "
          f"{work5['triangle_hits']}", flush=True)
    fast_max = max(fast_max, stats5["max_abs"])
    if fuse5 > 1:
        fused_max = max(fused_max, stats5["max_abs"])

    prog = ProgressiveRenderer(headline, backend="pallas")
    prog.step(scene, cam, seed=0)
    prog.reset()
    counts_zeroed()
    passes = timed_passes(prog, scene, cam, range(1, 4))
    if dict(render_tiles.launches_by) != {("fast", 4): 3}:
        raise SystemExit(f"phase 7: the progressive passes launched "
                         f"{dict(render_tiles.launches_by)}, not the fast "
                         "path at fuse 4")
    pass_ms = sorted(ms for ms, _, _ in passes)
    segs = sum(n for _, n, _ in passes) / len(passes)
    print(f"phase 7 progressive {SPP} spp/pass under the default (fast), 3 "
          f"passes: p50 {pass_ms[1]:.3f} ms/pass, "
          f"{segs / (pass_ms[1] * 1e-3) / 1e6:.2f} Mrays/s | {card}",
          flush=True)

    return [
        {"name": "render_tiles[split,candidates,fast_rng]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": FAST_REPLACES,
         "launches": fast_launches, "max_abs_err": fast_max,
         "ms": kernel["fast"], "plain_ms": plain_ms, "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": None},
        {"name": "render_tiles[split,candidates,fast_rng,fuse=4]",
         "route": "cuda", "source": KERNEL_SOURCE, "replaces": FUSE_REPLACES,
         "launches": fused_launches, "max_abs_err": fused_max,
         "ms": ladder["4"]["kernel_ms"], "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
        {"name": "render_tiles[split,candidates,triangles,fast_rng]",
         "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:1346", "launches": hybrid_launches,
         "max_abs_err": stats5["max_abs"], "ms": k5_ms,
         "plain_ms": plain5_ms, "bound_ms": b5_ms, "bound_by": b5_by,
         "library_ms": None}]


def shard_phase(scene, cam, headline, card, head_bound, head_bound_by) -> dict:
    """Phase 8: the shard offsets (ROADMAP B11), the sharded frames (A10)
    and the wavefront renderer (A7). Returns the kernels-line entry of the
    shard offsets, whose bound is the headline's (``head_bound``): the
    shards of a mesh do the frame's work between them."""
    import torch

    from bevyray_tpu_torch import (FusedRenderer, RenderConfig, Renderer,
                                   rtiow)
    from bevyray_tpu_torch.kernels.cuda import megakernel as mk
    from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for
    from bevyray_tpu_torch.parallel.sharding import (
        make_mesh, render_frame_sharded_pallas)

    dev = torch.device("cuda", 0)
    render_tiles, render_tiles_reference = (mk.render_tiles,
                                            mk.render_tiles_reference)

    def counts_zeroed():
        render_tiles.launches = 0
        render_tiles.launches_by.clear()
        render_tiles_reference.calls = 0

    def bit_equal(name, got, want) -> float:
        """The kernel's outputs against the plain version's: max |d| 0 and
        equal segments."""
        max_abs = max(float((g - w).abs().max()) for g, w in
                      zip(got[:4], want[:4]))
        print(f"phase 8 {name}: max |d| {max_abs:.3g}, segments "
              f"{int(got[4])} / {int(want[4])}", flush=True)
        if max_abs != 0.0 or int(got[4]) != int(want[4]):
            raise SystemExit(f"phase 8 {name}: the kernel differs from its "
                             "plain version")
        return max_abs

    # (a) 128x192 is 2 x 3 blocks: 2 shards of 3 blocks under fuse 2, so
    # each shard's last instance pads a half whose global block is the
    # other shard's. Per shard the kernel against its plain version on both
    # draw paths, and the shards' segments summed against the whole frame's.
    small = RenderConfig(128, 128 + 64, 2, 4, level=3, pallas_primary="split",
                         pallas_intersect="candidates")
    max_err = 0.0
    mk.PHASE_FUSE = 2
    for name, world in (("material_test_scene",
                         rtiow.material_test_scene()),
                        ("simple_scene + cube mesh", mesh_scene())):
        kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False,
                                                       device=dev))
        cam_s = world.camera_state(aspect=128 / 192, device=dev)
        sl, slmeta = device_shortlists_for(kscene, cam_s, small, 2)
        for arm in ("exact", "fast"):
            run = dict(exact_rng=arm == "exact", normalize=False)
            whole = render_tiles(kscene, cam_s, small, 7, sl=sl,
                                 slmeta=slmeta, **run)
            total = 0
            for i in range(2):
                shard = dict(run, block_offset=3 * i, n_blocks_local=3,
                             sl=sl[3 * i:3 * i + 3],
                             slmeta=slmeta[3 * i:3 * i + 3])
                if mk.kernel_fuse(kscene, small, sl, 3) != 2:
                    raise SystemExit("phase 8: the small shards do not fuse 2")
                got = render_tiles(kscene, cam_s, small, 7, **shard)
                want = render_tiles_reference(kscene, cam_s, small, 7,
                                              **shard)
                max_err = max(max_err, bit_equal(
                    f"{name} {arm} rng shard {i} of 2, blocks {3 * i}-"
                    f"{3 * i + 2}, fuse 2", got, want))
                total += int(got[4])
            print(f"phase 8 {name} {arm} rng: shard segments sum {total}, "
                  f"whole frame {int(whole[4])}", flush=True)
            if total != int(whole[4]):
                raise SystemExit("phase 8: the shards' segments do not sum "
                                 "to the whole frame's")
    mk.PHASE_FUSE = "auto"

    # (b) The headline through render_frame_sharded_pallas on meshes over
    # the one card (the shards run one after another), each frame held to
    # the unsharded frame of its seed.
    fused = FusedRenderer(headline)
    fused.render(scene, cam, seed=0)
    torch.cuda.synchronize()
    want, times = {}, []
    for seed in range(1, SHARD_FRAMES + 1):
        t0 = time.perf_counter()
        want[seed] = fused.render(scene, cam, seed=seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    unsharded_p50 = sorted(times)[SHARD_FRAMES // 2] * 1e3
    kscene = fused.prepare(scene)
    print(f"phase 8 unsharded headline (default config, "
          f"{'/'.join(fused.last_mode)}, fuse {fused.last_fuse}): p50 "
          f"{unsharded_p50:.3f} ms | {card}", flush=True)
    nbx, nby = mk.block_grid(headline)
    n_blocks = nbx * nby
    shard_launches, p50s = 0, {}
    for sp, dp in SHARD_MESHES:
        mesh = make_mesh(sp, dp, devices=["cuda:0"] * (sp * dp))
        render_frame_sharded_pallas(mesh, scene, cam, headline, 0)
        torch.cuda.synchronize()
        counts_zeroed()
        times = []
        for seed in range(1, SHARD_FRAMES + 1):
            # A K12 a shard, then K15 before the tail.
            with pass_launches(f"phase 8 mesh ({sp}, {dp})",
                               {"camera_rows": sp * dp, "sum_shards": 1}):
                t0 = time.perf_counter()
                frame = render_frame_sharded_pallas(mesh, scene, cam,
                                                    headline, seed)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ref = want[seed]
            d_img = float((frame.image - ref.image).abs().max())
            d_depth = float(((frame.rt_depth - ref.rt_depth).abs()
                             / ref.rt_depth.abs().clamp(min=1e-30)).max())
            segs = (int(frame.rays_traced), int(ref.rays_traced))
            bar = 0.0 if dp == 1 else SHARD_TOL
            if segs[0] != segs[1] or d_img > bar or (
                    d_depth > (0.0 if dp == 1 else SHARD_DEPTH_RTOL)):
                raise SystemExit(
                    f"phase 8 mesh ({sp}, {dp}) seed {seed}: segments "
                    f"{segs}, image max |d| {d_img:.3g} (bar {bar}), depth "
                    f"max rel |d| {d_depth:.3g}")
        launches = render_tiles.launches
        if launches != SHARD_FRAMES * sp * dp or render_tiles_reference.calls:
            raise SystemExit(f"phase 8 mesh ({sp}, {dp}): {launches} kernel "
                             f"launches and {render_tiles_reference.calls} "
                             f"plain calls in {SHARD_FRAMES} frames")
        shard_launches += launches
        blocks_local = -(-n_blocks // sp)
        local_cfg = dataclasses.replace(headline,
                                        samples_per_pixel=SPP // dp)
        sl = device_shortlists_for(kscene, cam, headline, SPP // dp,
                                   n_blocks=blocks_local * sp)[0]
        fuse = mk.kernel_fuse(kscene, local_cfg, sl, blocks_local)
        p50s[sp, dp] = sorted(times)[SHARD_FRAMES // 2] * 1e3
        print(f"phase 8 headline mesh (sp={sp}, dp={dp}) on cuda:0: "
              f"{blocks_local} blocks a shard, fuse {fuse} "
              f"({-blocks_local % fuse} padded halves), {SPP // dp} spp a "
              f"shard, {'split' if sl is not None else 'off'}: p50 "
              f"{p50s[sp, dp]:.3f} ms (unsharded {unsharded_p50:.3f}), "
              f"frame ms {[round(t * 1e3, 3) for t in times]}, segments "
              f"{segs[0]} equal, image max |d| {d_img:.3g}, depth max rel "
              f"|d| {d_depth:.3g} | {card}", flush=True)

    # One headline mesh (3, 1) shard by shard: the kernel's ms on the
    # default path, and each shard against its plain version on the exact
    # path (shard 0 pads 2 halves aliasing shard 1's blocks).
    blocks_local = n_blocks // 3
    sl, slmeta = device_shortlists_for(kscene, cam, headline, SPP)
    shard_ms, plain_ms = 0.0, 0.0
    for i in range(3):
        rows = slice(i * blocks_local, (i + 1) * blocks_local)
        shard = dict(block_offset=i * blocks_local,
                     n_blocks_local=blocks_local, normalize=False,
                     sl=sl[rows], slmeta=slmeta[rows])
        shard_ms += cuda_ms(lambda: render_tiles(kscene, cam, headline, 1,
                                                 **shard), 3)
        got = render_tiles(kscene, cam, headline, 1, exact_rng=True, **shard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = render_tiles_reference(kscene, cam, headline, 1,
                                       exact_rng=True, **shard)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        max_err = max(max_err, bit_equal(
            f"headline mesh (3, 1) shard {i}, exact rng, fuse "
            f"{mk.kernel_fuse(kscene, headline, sl, blocks_local)}", got,
            plain))
    print(f"phase 8 headline mesh (3, 1) kernel, default path: {shard_ms:.3f} "
          f"ms over the 3 shards (bound {head_bound:.3f} ms); plain version, "
          f"exact path: {plain_ms:.1f} ms | {card}", flush=True)

    # (c) The wavefront Renderer at the headline (the exact PCG streams, its
    # only draw path) against the fused kernel's exact frame.
    wave = Renderer(headline)
    exact = FusedRenderer(headline, exact_rng=True).render(scene, cam, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    frame = wave.render(scene, cam, seed=1)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base_mem
    check_agreement(
        f"phase 8 wavefront Renderer {WIDTH}x{HEIGHT} {SPP}spp {BOUNCES} "
        f"bounces vs FusedRenderer(exact_rng=True): {wave_ms:.1f} ms, peak "
        f"{peak / 2**30:.3f} GiB above the inputs | {card}",
        compare_frames(frame, exact))

    # (d) The wavefront sharded step, with tp.
    wavefront_shard_phase(scene, cam, headline, card)

    return {"name": "render_tiles[shard_offsets]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": SHARD_REPLACES,
            "launches": shard_launches, "max_abs_err": max_err,
            "ms": shard_ms, "plain_ms": plain_ms, "bound_ms": head_bound,
            "bound_by": head_bound_by, "library_ms": None}


def wavefront_shard_phase(scene, cam, headline, card) -> None:
    """Phase 8(d): the wavefront sharded step (``render_frame_sharded``)
    with tp at the headline on TP_MESHES against the unsharded
    ``Renderer`` (within IDENTITY_TOL, segments equal, no host wait; K12,
    K15 and K16 counted), and the step at WAVE_SIZE on WAVE_MESHES (40
    parts: two K15 launches) and the wavefront film, against the unsharded
    frame."""
    import torch

    from bevyray_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                   Renderer, rtiow)
    from bevyray_tpu_torch.bench.timing import host_syncs
    from bevyray_tpu_torch.kernels import passes
    from bevyray_tpu_torch.parallel.sharding import (make_mesh,
                                                     render_frame_sharded)

    dev = torch.device("cuda", 0)

    # The headline on TP_MESHES against the unsharded Renderer's frame of
    # each seed: per bounce tp K1 launches and one K16 a shard, K12 a
    # shard, one K15; the first frame of each mesh under the census of host
    # waits.

    wave_ref = Renderer(headline)
    wave_ref.render(scene, cam, seed=0)
    wave_want, times = {}, []
    for seed in range(1, SHARD_FRAMES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave_want[seed] = wave_ref.render(scene, cam, seed=seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 8(d) unsharded wavefront headline: p50 "
          f"{sorted(times)[SHARD_FRAMES // 2]:.3f} ms, frame ms "
          f"{[round(t, 3) for t in times]} | {card}", flush=True)
    for sp, dp, tp in TP_MESHES:
        mesh = make_mesh(sp, dp, tp, devices=["cuda:0"] * (sp * dp * tp))
        torch.cuda.synchronize()
        sites = []
        with host_syncs(dev, sites):
            render_frame_sharded(mesh, scene, cam, headline, 0)
        torch.cuda.synchronize()
        times = []
        for seed in range(1, SHARD_FRAMES + 1):
            with pass_launches(f"phase 8(d) headline mesh ({sp}, {dp}, {tp})",
                               {"camera_rows": sp * dp, "sum_shards": 1,
                                "merge_tp_hits": sp * SPP * (BOUNCES + 1)}):
                t0 = time.perf_counter()
                got = render_frame_sharded(mesh, scene, cam, headline, seed)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ref = wave_want[seed]
            d_img = float((got.image - ref.image).abs().max())
            segs = (int(got.rays_traced), int(ref.rays_traced))
            if d_img > IDENTITY_TOL or segs[0] != segs[1] or sites:
                raise SystemExit(
                    f"phase 8(d) headline mesh ({sp}, {dp}, {tp}) seed "
                    f"{seed}: image max |d| {d_img:.3g} (bar {IDENTITY_TOL}), "
                    f"segments {segs}, host waits {sorted(set(sites))}")
        print(f"phase 8(d) wavefront sharded headline mesh ({sp}, {dp}, {tp}) "
              f"on cuda:0: p50 {sorted(times)[SHARD_FRAMES // 2]:.3f} ms, "
              f"frame ms {[round(t, 3) for t in times]}, segments {segs[0]} "
              f"equal, image max |d| {d_img:.3g}, bit-equal "
              f"{torch.equal(got.image, ref.image)}, host waits none | {card}",
              flush=True)

    # The step at WAVE_SIZE with tp, and on 40 parts (two K15 launches),
    # against the unsharded Renderer; then the wavefront film, 2 x 8 spp
    # against 16 spp.
    world = rtiow.final_scene(seed=42)
    small_scene = world.extract(with_bvh=False)
    small_cam = world.camera_state(aspect=WAVE_SIZE[0] / WAVE_SIZE[1])
    wave_cfg = RenderConfig(*WAVE_SIZE, SPP, BOUNCES, level=3)
    ref = Renderer(wave_cfg).render(small_scene, small_cam, seed=3)
    for sp, dp, tp in WAVE_MESHES:
        mesh = make_mesh(sp, dp, tp, devices=["cuda:0"] * (sp * dp * tp))
        expect = {"camera_rows": sp * dp,
                  "sum_shards": -(-(sp * dp) // passes.PARTS_PER_LAUNCH),
                  "merge_tp_hits": sp * SPP * (BOUNCES + 1) if tp > 1 else 0}
        with pass_launches(f"phase 8(d) mesh ({sp}, {dp}, {tp})", expect):
            t0 = time.perf_counter()
            got = render_frame_sharded(mesh, small_scene, small_cam, wave_cfg,
                                       3)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        d_img = float((got.image - ref.image).abs().max())
        print(f"phase 8 wavefront sharded {WAVE_SIZE[0]}x{WAVE_SIZE[1]} mesh "
              f"({sp}, {dp}, {tp}): {ms:.1f} ms, image max |d| {d_img:.3g}, "
              f"segments {int(got.rays_traced)} / {int(ref.rays_traced)}, "
              f"launches {expect}", flush=True)
        if d_img > IDENTITY_TOL or int(got.rays_traced) != int(
                ref.rays_traced):
            raise SystemExit(f"phase 8 wavefront mesh ({sp}, {dp}, {tp}): "
                             f"not within {IDENTITY_TOL} of the unsharded "
                             "frame with equal segments")
    half = dataclasses.replace(wave_cfg, samples_per_pixel=SPP // 2)
    prog = ProgressiveRenderer(half)
    prog.step(small_scene, small_cam, seed=3)
    film = prog.step(small_scene, small_cam, seed=3)
    d_img = float((film.image - ref.image).abs().max())
    print(f"phase 8 ProgressiveRenderer(backend=\"xla\") 2 x {SPP // 2} spp "
          f"vs Renderer {SPP} spp at {WAVE_SIZE[0]}x{WAVE_SIZE[1]}: image max "
          f"|d| {d_img:.3g}, segments {int(film.rays_traced)} / "
          f"{int(ref.rays_traced)}", flush=True)
    if d_img > IDENTITY_TOL or int(film.rays_traced) != int(ref.rays_traced):
        raise SystemExit("phase 8: the wavefront film differs from the frame")


def sass_function(library: Path, instance: str) -> str:
    """The SASS of ``instance`` (a mangled-name fragment) in the built
    ``library``, by the toolkit's ``cuobjdump -sass``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = sass.split("Function : ")
    return next(f for f in funcs if instance in f.splitlines()[0])


def sass_sqrt(body: str) -> dict:
    """Phase 9(c): in one instance's SASS (``sass_function``), its MUFU.RSQ
    (the seed of each IEEE sqrt), the range check that follows each (the
    inputs outside it leave the fast path), and the subroutines it calls."""
    lines = [ln.split("*/")[1].strip().rstrip(";").strip()
             if "*/" in ln else "" for ln in body.splitlines()]
    lines = [ln for ln in lines if ln]
    checks, calls = collections.Counter(), collections.Counter()
    for i, ln in enumerate(lines):
        if ln.startswith("MUFU.RSQ"):
            follow = [x for x in lines[i + 1:i + 4]
                      if x.startswith(("IADD3", "ISETP", "VIADD"))]
            checks[" ; ".join(" ".join(x.split()[:1] + x.split()[2:])
                              for x in follow)] += 1
        if "CALL" in ln:
            calls[ln.split()[-1]] += 1
    return {"instructions": len(lines),
            "mufu_rsq": sum(ln.startswith("MUFU.RSQ") for ln in lines),
            "range_checks": dict(checks), "calls": dict(calls)}


# FSETP's NaN tests and unordered compares (true where an operand is NaN).
UNORDERED = {"NAN", "NUM", "NEU", "LTU", "LEU", "GTU", "GEU", "EQU"}


def sass_walk(body: str) -> dict:
    """Phase 9(c): one group of the candidate walk in one instance's SASS
    (``sass_function``). The walk's loop is the innermost loop (a backward
    branch and its target) that holds a slab test's ten min/max (FMNMX);
    a group whose box is not entered, the common case, runs from the loop's
    head to the branch after them that skips the group's spheres, then the
    loop's tail. Gives that path's instructions (``per_group``), its FMNMX,
    FSETP (``unordered``: those true for a NaN operand, the NaN tests among
    them), FSEL and loads by opcode, and ``lines``, its SASS; empty where no
    such loop is found."""
    import re

    rows = []
    for ln in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s*(.*)$", ln)
        if m and m.group(2).split(";")[0].strip():
            rows.append((int(m.group(1), 16), m.group(2).split(";")[0].strip()))
    at = {addr: i for i, (addr, _) in enumerate(rows)}

    def opcode(k):
        words = rows[k][1].split()
        return words[1] if words[0].startswith("@") else words[0]

    def target(k):
        """The row a branch at row k jumps to (``BRA 0x...``), or None."""
        last = rows[k][1].split()[-1]
        if not (opcode(k).startswith("BRA") and last.startswith("0x")):
            return None
        return at.get(int(last, 16))

    loops = [(target(k), k) for k in range(len(rows))
             if target(k) is not None and target(k) <= k]
    walk = [(lo, hi) for lo, hi in loops if sum(
        opcode(k).startswith("FMNMX") for k in range(lo, hi + 1)) >= 10]
    if not walk:
        return {}
    lo, hi = min(walk, key=lambda r: r[1] - r[0])
    last = max(k for k in range(lo, hi + 1) if opcode(k).startswith("FMNMX"))
    skip = next((k for k in range(last, hi) if rows[k][1].startswith("@")
                 and target(k) is not None and k < target(k) <= hi), None)
    if skip is None:
        return {}
    path = list(range(lo, skip + 1)) + list(range(target(skip), hi + 1))
    ops = collections.Counter(opcode(k) for k in path)

    def count(prefix):
        return {op: n for op, n in sorted(ops.items()) if op.startswith(prefix)}

    fsetp = count("FSETP")
    return {"per_group": len(path), "FMNMX": count("FMNMX"), "FSETP": fsetp,
            "unordered": sum(n for op, n in fsetp.items()
                             if UNORDERED & set(op.split("."))),
            "nan_tests": sum(n for op, n in fsetp.items()
                             if {"NAN", "NUM"} & set(op.split("."))),
            "FSEL": sum(count("FSEL").values()),
            "loads": {op: n for op, n in sorted(ops.items())
                      if op.startswith(("LDS", "LDG", "LD.", "LDC"))
                      or op == "LD"},
            "lines": [rows[k][1] for k in path]}


def probe_phase(scene, cam, headline, card, map_pass) -> None:
    """Phase 9: what bounds the kernel on this card. (a) Registers, spills,
    shared memory and resident blocks per SM of every instance (and of the
    probe) at fuse 1, 4 and 8, and the work items each main-path grid holds
    against the resident blocks; (b) the probe instance (``clock64()`` per
    stage) at the headline, under the adaptive pass-3 map and at config 5,
    its outputs bit-equal to the default instance's, and the walk's cycles
    per candidate slab test; (c) the SASS of the default instance's IEEE
    sqrt and of its candidate walk's loop (FMNMX, FSETP, FSEL)."""
    import torch

    from bevyray_tpu_torch.kernels.cuda import build
    from bevyray_tpu_torch.kernels.cuda import megakernel as mk
    from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for

    dev = torch.device("cuda", 0)
    kscene = mk.prepare_kernel_scene(scene)
    sl, slmeta = device_shortlists_for(kscene, cam, headline, SPP)
    sl_cap = sl.shape[-1]

    # (a) Every instance, and the probe, at the headline's shortlist size.
    infos = {}
    for split in (False, True):
        for candidates in (False, True):
            mode = ("split" if split else "off",
                    "candidates" if candidates else "grouped")
            for fast_rng in (False, True):
                for probe in (False, True):
                    if probe and not (fast_rng and mode in mk.PROBE_MODES):
                        continue
                    name = ("/".join(mode)
                            + f"/{'fast' if fast_rng else 'exact'}"
                            + ("/probe" if probe else ""))
                    by_fuse = {f: mk.instance_info(dev, split, candidates,
                                                   fast_rng, f, sl_cap, probe)
                               for f in ((1, 4, 8) if split else (1,))}
                    first = by_fuse[1]
                    infos[name] = by_fuse
                    print(f"phase 9(a) {name}: {first['num_regs']} registers "
                          f"per thread, {first['local_bytes']} spill bytes, "
                          f"{first['static_smem']} B static shared, resident "
                          f"blocks per SM by fuse "
                          f"{ {f: i['blocks_per_sm'] for f, i in by_fuse.items()} } "
                          f"(dynamic shared "
                          f"{ {f: i['dynamic_smem'] for f, i in by_fuse.items()} } "
                          f"B), {first['n_sms']} SMs | {card}", flush=True)
    default = infos["split/candidates/fast"]
    n_sms = default[1]["n_sms"]
    for what, n_tiles, fuse in (("headline", 510, 4), ("headline fuse 1", 510, 1),
                                ("config 5", 240, 4), ("(3,1) shard", 170, 4)):
        per_sm = default[fuse]["blocks_per_sm"]
        resident = per_sm * n_sms
        grid = mk.persistent_grid(n_tiles, per_sm, n_sms)
        sizes = [hi - lo for lo, hi in mk.work_items(n_tiles, fuse, grid,
                                                     True)]
        old_grid = -(-n_tiles // fuse) * mk.SLICES
        print(f"phase 9(a) {what}: {n_tiles} blocks at fuse {fuse}; the grid "
              f"before the persistent kernel, {old_grid} CUDA blocks of "
              f"{256 * fuse} pixels, was {old_grid / resident:.3f} waves of "
              f"{resident} resident blocks; persistent grid {grid}, "
              f"{n_tiles * mk.SLICES} one-unit work items "
              f"({n_tiles * mk.SLICES / grid:.3f} a block), under a sample "
              f"map {len(sizes)} of {max(sizes)} to {min(sizes)} 256-lane "
              f"units ({len(sizes) / grid:.3f} a block)", flush=True)

    # (b) The probe at three cells, each launch against the default
    # instance's bits, with both kernels' ms.
    world5, config5 = config5_world()
    cam5 = world5.camera_state(aspect=16 / 9)
    k5 = mk.prepare_kernel_scene(world5.extract(with_bvh=False))
    sl5, slmeta5 = device_shortlists_for(k5, cam5, config5, SPP)
    spp_map, share = map_pass
    cells = [("headline", kscene, cam, headline, sl, slmeta, {}),
             (f"adaptive pass-{MAP_PASS} map ({share:.4f} sampled)", kscene,
              cam, headline, sl, slmeta,
              dict(spp_map=spp_map, sample_offset=MAP_OFFSET,
                   normalize=False)),
             ("config 5", k5, cam5, config5, sl5, slmeta5, {})]
    for what, ks, cm, cfg, s_l, s_m, extra in cells:
        want = mk.render_tiles(ks, cm, cfg, 1, exact_rng=False, sl=s_l,
                               slmeta=s_m, **extra)
        got, clk = mk.render_tiles_probe(ks, cm, cfg, 1, sl=s_l, slmeta=s_m,
                                         **extra)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)) or (
                clk["segments"] != int(want[4])):
            raise SystemExit(f"phase 9(b) {what}: the probe instance differs "
                             "from the default instance")
        ms = cuda_ms(lambda: mk.render_tiles(ks, cm, cfg, 1, exact_rng=False,
                                             sl=s_l, slmeta=s_m, **extra), 3)
        probe_ms = cuda_ms(lambda: mk.render_tiles_probe(
            ks, cm, cfg, 1, sl=s_l, slmeta=s_m, **extra), 3)
        print(f"phase 9(b) probe {what}, split/candidates fast fuse "
              f"{mk.kernel_fuse(ks, cfg, s_l)}: bit-equal to the default "
              f"instance, {clk['segments']} segments; mean active lanes per "
              f"segment iteration {clk['segments'] / clk['issues']:.2f} of "
              f"32; cycle shares {json.dumps(probe_shares(clk))}; "
              f"{clk['slab_tests']} slab tests "
              f"({clk['slab_tests'] / clk['segments']:.2f} a segment), "
              f"walk cycles per slab test "
              f"{clk['walk'] / max(clk['slab_tests'], 1):.2f}; kernel "
              f"{ms:.3f} ms, probe {probe_ms:.3f} ms | {card}", flush=True)

    # (c) The IEEE sqrt in the default instance's SASS.
    library = next(build.BUILD_DIR.glob("*.so"))
    body = sass_function(library, "render_kernelILb1ELb1ELb1ELb0E")
    found = sass_sqrt(body)
    print(f"phase 9(c) SASS of split/candidates/fast ({library.name}): "
          f"{json.dumps(found)}", flush=True)
    if not found["mufu_rsq"]:
        raise SystemExit("phase 9(c): no MUFU.RSQ in the default instance")
    walk = sass_walk(body)
    lines = walk.pop("lines", [])
    print(f"phase 9(c) candidate walk loop of split/candidates/fast: "
          f"{json.dumps(walk) if walk else 'not found'}", flush=True)
    for line in lines:
        print(f"phase 9(c) walk loop | {line}")


def probe_shares(clk, walk="walk (candidates)") -> dict:
    """The probe's clock sums as shares of the threads' total cycles, by
    stage; ``walk`` names the table walk."""
    total = clk["total"]
    shade = clk["segment"] - clk["walk0"] - clk["walk"] - clk["triangles"]
    parts = {"walk0 (bounce-0 shortlist)": clk["walk0"],
             walk: clk["walk"],
             "triangles": clk["triangles"],
             "shading, draws, raygen, harvest": shade,
             "taking pixels": clk["fetch"],
             "taking items, staging": clk["stage"],
             "lane idle in its warp": clk["warp_idle"]}
    # The clock reads around the item's barrier may be scheduled across it,
    # so its wait is counted with the loop's other overhead.
    parts["item barrier, other"] = total - sum(parts.values())
    return {k: round(v / total, 4) for k, v in parts.items()}


def book_inputs():
    """The book's final render as the benchmark's harness builds it
    (phase 9(d)): the scene of the configuration ``BOOK_CONFIG`` as a
    ``World``, the frame as a ``RenderConfig`` with the lens on, and the
    scene's arrays (``aperture``, ``focus_distance``, ...)."""
    bench = ROOT / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    import harness

    config = harness.load_json(bench / "configs" / f"{BOOK_CONFIG}.json")
    scene = harness.load_module("scenes", config["scene"]).build(
        config["scene_seed"])
    return (harness.port_world(scene), harness.render_config(config, scene),
            scene)


def book_phase(card) -> None:
    """Phase 9(d): the book's final render through ``FusedRenderer`` at its
    defaults, which must take the unsplit full walk (``BOOK_MODE``) on the
    fast draws, then the probe instance of that walk on the frame's inputs,
    bit-equal to the default instance: the threads' cycles by stage, lanes
    live per warp-level segment iteration and segments a sample, the SM
    clock the probe ran at and how long its blocks ran against the longest
    (the share of the launch after a block found no work left), beside the
    two instances' registers, resident blocks and kernel ms; then the full
    walk's schedule in one line (that tail share, lanes live per issue, the
    lanes' idle and the barrier's share), and the registers, spills and
    resident blocks of its exact and fast instances, held to
    ``BOOK_INSTANCE``; last, the kernel's launches on a shard of the book's
    bottom block rows at its samples and depth, bit-equal to the plain
    version."""
    import torch

    from bevyray_tpu_torch import FusedRenderer
    from bevyray_tpu_torch.kernels.cuda import megakernel as mk

    dev = torch.device("cuda", 0)
    world, config, arrays = book_inputs()
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=config.width / config.height, device=dev)
    renderer = FusedRenderer(config)
    renderer.render(scene, cam, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = renderer.render(scene, cam, 2)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    if (renderer.last_mode != BOOK_MODE or renderer.last_exact_rng
            is not False or renderer.last_fuse != 1):
        raise SystemExit(
            f"phase 9(d): the book's frame ran {renderer.last_mode}, fuse "
            f"{renderer.last_fuse}, exact_rng {renderer.last_exact_rng}, not "
            f"{BOOK_MODE} at fuse 1 on the fast draws")
    kscene = renderer.prepare(scene)
    want = mk.render_tiles(kscene, cam, config, 2, exact_rng=False)
    got, clk = mk.render_tiles_probe(kscene, cam, config, 2)
    torch.cuda.synchronize()
    # The probe's clocks are the last launch's, the main one after a pilot:
    # its segments that launch's own count, the launches' counts the frame's.
    launches = clk["launch_segments"]
    pilot = launches[0] if len(launches) > 1 else 0
    piloted = bool(mk.pilot_samples(BOOK_MODE, config.samples_per_pixel))
    if (not all(torch.equal(g, w) for g, w in zip(got, want))
            or clk["segments"] != launches[-1]
            or sum(launches) != int(want[4])
            or len(launches) != 1 + piloted
            or int(frame.rays_traced) != int(want[4])):
        raise SystemExit("phase 9(d) book frame: the probe instance differs "
                         "from the default instance")
    if clk["walk0"] or clk["slab_tests"]:
        raise SystemExit("phase 9(d): the unsplit full walk ran a shortlist "
                         "walk or a slab test")
    ms = cuda_ms(lambda: mk.render_tiles(kscene, cam, config, 2,
                                         exact_rng=False), 2)
    probe_ms = cuda_ms(lambda: mk.render_tiles_probe(kscene, cam, config,
                                                     2), 2)
    infos = {probe: mk.instance_info(dev, False, False, True, 1, 0, probe)
             for probe in (False, True)}
    exact_info = mk.instance_info(dev, False, False, False, 1, 0)
    grid = mk.persistent_grid(mk.local_blocks(config),
                              infos[True]["blocks_per_sm"],
                              infos[True]["n_sms"])
    block_ms = clk["block_ns"] / grid / 1e6
    after = 1 - block_ms * 1e6 / clk["max_ns"]
    lanes = clk["segments"] / clk["issues"]
    shares = probe_shares(clk, "walk (every sphere)")
    samples = config.width * config.height * config.samples_per_pixel
    print(f"phase 9(d) book frame {config.width}x{config.height}, "
          f"{config.samples_per_pixel} spp, {config.bounces} bounces, lens "
          f"{arrays['aperture']!r} at {arrays['focus_distance']}: "
          f"FusedRenderer {'/'.join(renderer.last_mode)} fuse "
          f"{renderer.last_fuse}, fast "
          f"draws, {frame_ms:.1f} ms a frame (host, synchronised), "
          f"{int(want[4])} segments ({int(want[4]) / samples:.4f} a sample), "
          f"{pilot} of them in the pilot launch of {mk.PILOT_SPP} samples a "
          f"pixel | {card}", flush=True)
    print(f"phase 9(d) probe book frame, off/grouped fast fuse 1: bit-equal "
          f"to the default instance; mean active lanes per segment "
          f"iteration {lanes:.2f} of 32; cycle shares {json.dumps(shares)}; "
          f"clock sums {json.dumps(clk)}; SM clock "
          f"{clk['block_cycles'] / clk['block_ns']:.4f} GHz; {grid} blocks "
          f"ran {block_ms:.1f} ms on average, the longest "
          f"{clk['max_ns'] / 1e6:.1f} ms: {after:.4f} of the launch's "
          f"block time after a block found no work left; the longest block "
          f"{clk['max_cycles']} cycles; kernel {ms:.3f} ms, probe "
          f"{probe_ms:.3f} ms; registers {infos[False]['num_regs']} / probe "
          f"{infos[True]['num_regs']}, resident blocks per SM "
          f"{infos[False]['blocks_per_sm']} / probe "
          f"{infos[True]['blocks_per_sm']} | {card}", flush=True)
    # The full walk's schedule: its threads take each pixel from the
    # launch's counter, so the blocks end together and lanes refill at once.
    print(f"phase 9(d) full walk schedule: tail share {after:.4f} (1 - mean "
          f"block run / longest), live lanes per issue {lanes:.2f} of 32, "
          f"lanes idle in their warp {shares['lane idle in its warp']:.4f}, "
          f"barrier and loop {shares['item barrier, other']:.4f} of the "
          f"threads' cycles | {card}", flush=True)
    for name, info in (("fast", infos[False]), ("exact", exact_info)):
        print(f"phase 9(d) off/grouped/{name}: {info['num_regs']} registers, "
              f"{info['local_bytes']} spill bytes, {info['blocks_per_sm']} "
              f"resident blocks per SM | {card}", flush=True)
        most = BOOK_INSTANCE[name]
        if (info["num_regs"] > most["num_regs"]
                or info["local_bytes"] > most["local_bytes"]
                or info["blocks_per_sm"] < most["blocks_per_sm"]):
            raise SystemExit(f"phase 9(d): off/grouped/{name} takes more "
                             f"than {most}")
    # The main path's launches (the pilot, then the rest of each pixel's
    # samples, costliest pixels first, its sums continued) against the
    # plain version at the book's samples, depth and lens, on a shard of its
    # two bottom block rows: more lanes than the grid has threads, so the
    # main launch's threads take several pixels in its order.
    nbx, nby = mk.block_grid(config)
    rows = dict(block_offset=(nby - 2) * nbx, n_blocks_local=2 * nbx,
                exact_rng=False)
    shard_grid = mk.persistent_grid(2 * nbx, infos[False]["blocks_per_sm"],
                                    infos[False]["n_sms"])
    shard = mk.render_tiles(kscene, cam, config, 3, **rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mk.render_tiles_reference(kscene, cam, config, 3, **rows)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if (not piloted or shard_grid * 256 >= 2 * nbx * mk.TILE
            or not all(torch.equal(g, w) for g, w in zip(shard, plain))):
        raise SystemExit("phase 9(d) book shard: the kernel's launches differ "
                         "from the plain version, or took no pilot or no "
                         "second pixel a thread")
    print(f"phase 9(d) book shard, block rows {nby - 2}-{nby - 1} (blocks "
          f"{rows['block_offset']}-{rows['block_offset'] + 2 * nbx - 1}), "
          f"{config.samples_per_pixel} spp, {config.bounces} bounces, lens, "
          f"fast draws: {2 * nbx * mk.TILE} lanes on {shard_grid * 256} "
          f"threads, pilot of {mk.PILOT_SPP} samples; bit-equal to the plain "
          f"version, {int(plain[4])} segments both; plain {plain_s:.1f} s "
          f"| {card}", flush=True)


def cli_phase(card, dev) -> tuple:
    """Phase 10: the port's command line in-process (``app.cli.main``) at
    its defaults, each run held against a direct call of the renderer it
    drives: (a) ``render`` (backend auto: a BVH is extracted, 508 spheres
    resolve to "brute"), bit-equal to ``Renderer.render``; (b) ``--backend
    bvh`` within BVH_TOL of (a) with equal segments; (c) ``--backend
    pallas``, which must launch the CUDA kernel, bit-equal to
    ``FusedRenderer.render``; (d) ``--denoise`` equal to ``atrous_denoise``
    of (a)'s frame with the CLI's guide, K7 launched once an iteration and
    its plain version never; (e) ``accumulate`` with adaptive sampling on a
    scene that carries a BVH, and ``bench --backend pallas``, whose JSON
    names the card; (f) through the API, 4,971 spheres, where "auto" walks
    the BVH built by the native builder, against "brute". Returns (d)'s
    denoiser inputs (the frame's image and depth) and its K7 launches."""
    import io
    import tempfile

    import torch

    from bevyray_tpu_torch import (FusedRenderer, RaytracedCamera,
                                   Raytracing, RenderConfig, Renderer, rtiow)
    from bevyray_tpu_torch.app import cli
    from bevyray_tpu_torch.bvh import build as bvh_build
    from bevyray_tpu_torch.engine import renderer as renderer_mod
    from bevyray_tpu_torch.engine import denoise as denoise_mod
    from bevyray_tpu_torch.engine.denoise import atrous_denoise
    from bevyray_tpu_torch.kernels.cuda.megakernel import render_tiles
    from bevyray_tpu_torch.utils import png

    t_phase = time.perf_counter()
    frames, written = [], []

    def spy(cls):
        real = cls.render

        def render(self, scene, cam, seed, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = real(self, scene, cam, seed, **kw)
            torch.cuda.synchronize()
            frames.append((frame, (time.perf_counter() - t0) * 1e3, scene,
                           renderer_mod.resolve_intersect_backend(
                               scene, self.config)))
            return frame
        return real, render

    def record_png(path, image):
        written.append(image)
        real_png(path, image)

    real_png = png.write_png
    spies = [(cls, *spy(cls)) for cls in (Renderer, FusedRenderer)]
    for cls, _, render in spies:
        cls.render = render
    png.write_png = record_png
    tmp = tempfile.TemporaryDirectory()

    def run(*argv) -> str:
        """``cli.main`` on argv (+ CLI_ARGV); its standard output."""
        frames.clear()
        written.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*argv, "--out", f"{tmp.name}/{argv[0]}.png",
                           *CLI_ARGV])
        if rc != 0:
            raise SystemExit(f"phase 10: {' '.join(argv)} exited {rc}")
        return out.getvalue().strip()

    try:
        w, h = CLI_FRAME["width"], CLI_FRAME["height"]
        spp = CLI_FRAME["samples_per_pixel"]
        # (a) the defaults.
        line = run("render")
        if f"rendered {w}x{h} spp={spp}" not in line:
            raise SystemExit(f"phase 10(a): the CLI's defaults are not "
                             f"{w}x{h} spp={spp}: {line}")
        frame_a, ms_a, scene_a, backend_a = frames[0]
        world = rtiow.final_scene(
            seed=CLI_SCENE_SEED,
            camera=RaytracedCamera(level=Raytracing(CLI_FRAME["level"]),
                                   sample_count=spp,
                                   bounces=CLI_FRAME["bounces"],
                                   aperture=0.0, focus_distance=3.0))
        config = RenderConfig(**CLI_FRAME)
        scene = world.extract(device=dev)
        cam = world.camera_state(aspect=w / h, device=dev)
        direct = Renderer(config).render(scene, cam, CLI_SEED)
        if scene_a.bvh is None or backend_a != "brute" or not torch.equal(
                frame_a.image, direct.image) or int(
                    frame_a.rays_traced) != int(direct.rays_traced):
            raise SystemExit(
                f"phase 10(a): BVH extracted {scene_a.bvh is not None}, "
                f"backend {backend_a} (must be brute), image bit-equal to "
                f"Renderer.render {torch.equal(frame_a.image, direct.image)}")
        if not torch.equal(torch.as_tensor(written[0]), direct.image.cpu()):
            raise SystemExit("phase 10(a): the PNG's image is not the frame")
        print(f"phase 10(a) render (defaults, backend auto -> {backend_a}, "
              f"{world.n_spheres} spheres, BVH of {int(scene_a.bvh.n_nodes)} "
              f"nodes extracted): bit-equal to Renderer.render; frame "
              f"{ms_a:.3f} ms, {int(frame_a.rays_traced)} segments | {line} "
              f"| {card}", flush=True)

        # (b) the BVH walk.
        line = run("render", "--backend", "bvh")
        frame_b, ms_b, _, backend_b = frames[0]
        diff = float((frame_b.image - frame_a.image).abs().max())
        segs = (int(frame_b.rays_traced), int(frame_a.rays_traced))
        print(f"phase 10(b) render --backend bvh ({backend_b}): max |d| "
              f"{diff:.3g} against (a), segments {segs[0]} / {segs[1]}; frame "
              f"{ms_b:.3f} ms against brute {ms_a:.3f} ms | {card}",
              flush=True)
        if backend_b != "bvh" or diff > BVH_TOL or segs[0] != segs[1]:
            bad = (frame_b.image - frame_a.image).abs().amax(-1) > BVH_TOL
            first = bad.nonzero()[:1].tolist()
            raise SystemExit(f"phase 10(b): {int(bad.sum())} pixels past "
                             f"{BVH_TOL} (first (y, x) {first}), segments "
                             f"{segs}")

        # (c) the fused CUDA kernel.
        render_tiles.launches = 0
        render_tiles.launches_by.clear()
        line = run("render", "--backend", "pallas")
        launches = dict(render_tiles.launches_by)
        frame_c, ms_c, scene_c, _ = frames[0]
        fused = FusedRenderer(config).render(
            world.extract(with_bvh=False, device=dev), cam, CLI_SEED)
        if render_tiles.launches < 1 or not torch.equal(frame_c.image,
                                                        fused.image):
            raise SystemExit(
                f"phase 10(c): launches {launches}, image bit-equal to "
                f"FusedRenderer.render {torch.equal(frame_c.image, fused.image)}")
        print(f"phase 10(c) render --backend pallas: kernel launches "
              f"{launches}; bit-equal to FusedRenderer.render; frame "
              f"{ms_c:.3f} ms (the first of the CLI's renderer) | {card}",
              flush=True)

        # (d) the denoiser, guided by rt_depth (level 3: no raster layer):
        # K7 once an iteration, no plain run.
        atrous_denoise.launches = 0
        with plain_calls(denoise_mod, ("atrous_denoise_reference",)) as plain:
            t0 = time.perf_counter()
            line = run("render", "--denoise", str(CLI_DENOISE))
            ms_d = (time.perf_counter() - t0) * 1e3
        denoise_launches = atrous_denoise.launches
        if (denoise_launches != CLI_DENOISE
                or plain["atrous_denoise_reference"]):
            raise SystemExit(f"phase 10(d): {denoise_launches} K7 launches "
                             f"and {plain['atrous_denoise_reference']} plain "
                             f"runs for {CLI_DENOISE} iterations")
        den = atrous_denoise(frame_a.image, frame_a.rt_depth,
                             iterations=CLI_DENOISE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atrous_denoise(frame_a.image, frame_a.rt_depth, iterations=CLI_DENOISE)
        torch.cuda.synchronize()
        ms_den = (time.perf_counter() - t0) * 1e3
        if not torch.equal(frames[0][0].image, frame_a.image) or not (
                torch.equal(torch.as_tensor(written[0]), den.cpu())):
            raise SystemExit("phase 10(d): the denoised PNG is not "
                             "atrous_denoise of the frame")
        denoise_inputs = (frame_a.image, frame_a.rt_depth)
        print(f"phase 10(d) render --denoise {CLI_DENOISE}: equal to "
              f"atrous_denoise of (a)'s frame, K7 launches "
              f"{denoise_launches}; denoise {ms_den:.3f} ms per call, the "
              f"whole command {ms_d:.1f} ms | {card}", flush=True)

        # (e) adaptive accumulation on a scene with a BVH, and the bench.
        render_tiles.launches = 0
        t0 = time.perf_counter()
        line = run("accumulate", "--passes", str(CLI_PASSES),
                   "--adaptive-tolerance", str(CLI_TOLERANCE))
        ms_e = (time.perf_counter() - t0) * 1e3
        if render_tiles.launches != CLI_PASSES or not bool(
                torch.isfinite(torch.as_tensor(written[0])).all()):
            raise SystemExit(f"phase 10(e): {render_tiles.launches} kernel "
                             f"launches for {CLI_PASSES} adaptive passes")
        print(f"phase 10(e) accumulate --passes {CLI_PASSES} "
              f"--adaptive-tolerance {CLI_TOLERANCE} (scene with a BVH): "
              f"{render_tiles.launches} kernel launches, {ms_e:.1f} ms in "
              f"all | {line.splitlines()[0]} | {card}", flush=True)
        render_tiles.launches = 0
        line = run("bench", "--backend", "pallas", "--frames",
                   str(CLI_BENCH_FRAMES))
        rec = json.loads(line.splitlines()[-1])
        if rec["device"] != torch.cuda.get_device_name(0) or (
                render_tiles.launches != CLI_BENCH_FRAMES + 1):
            raise SystemExit(f"phase 10(e) bench: device {rec['device']!r}, "
                             f"{render_tiles.launches} launches")
        print(f"phase 10(e) bench --backend pallas --frames "
              f"{CLI_BENCH_FRAMES}: {json.dumps(rec)} | {card}", flush=True)
    finally:
        for cls, real, _ in spies:
            cls.render = real
        png.write_png = real_png
        tmp.cleanup()

    # (f) 4,971 spheres through the API: "auto" walks the BVH.
    big = rtiow.final_scene(seed=CLI_SCENE_SEED, grid=BIG_GRID)
    t0 = time.perf_counter()
    big_scene = big.extract(device=dev)
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t0) * 1e3
    builder = bvh_build.last_builder
    centers, radii = big.extract_host()[:2]
    t0 = time.perf_counter()
    bvh_build.build_scene_bvh(centers, radii, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    big_cam = big.camera_state(aspect=BIG_SIZE[0] / BIG_SIZE[1], device=dev)
    out = {}
    for backend in ("auto", "brute"):
        cfg = RenderConfig(*BIG_SIZE, BIG_SPP, CLI_FRAME["bounces"],
                           level=CLI_FRAME["level"], intersect_backend=backend)
        renderer = Renderer(cfg)
        resolved = renderer_mod.resolve_intersect_backend(big_scene, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = renderer.render(big_scene, big_cam, CLI_SEED)
        torch.cuda.synchronize()
        out[resolved] = frame, (time.perf_counter() - t0) * 1e3
    (fb, ms_bvh), (fr, ms_brute) = out.get("bvh", (None, 0)), out["brute"]
    if fb is None or builder != "native":
        raise SystemExit(f"phase 10(f): auto resolved to {list(out)}, BVH "
                         f"builder {builder} (must be bvh, native)")
    diff = float((fb.image - fr.image).abs().max())
    segs = (int(fb.rays_traced), int(fr.rays_traced))
    print(f"phase 10(f) {big.n_spheres} spheres {BIG_SIZE[0]}x{BIG_SIZE[1]} "
          f"{BIG_SPP} spp: extract with BVH {extract_ms:.1f} ms, BVH build "
          f"{build_ms:.1f} ms ({builder} builder, "
          f"{int(big_scene.bvh.n_nodes)} nodes); auto -> bvh frame "
          f"{ms_bvh:.3f} ms, brute {ms_brute:.3f} ms; max |d| {diff:.3g}, "
          f"segments {segs[0]} / {segs[1]} | {card}", flush=True)
    if diff > BVH_TOL or segs[0] != segs[1]:
        raise SystemExit("phase 10(f): bvh against brute past the bar")
    print(f"phase 10 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return denoise_inputs, denoise_launches


def oracle_phase(card, dev) -> None:
    """Phase 11: the port on the card against its NumPy oracle on the host,
    on the exact draws, each check at the bars of the JAX golden test it
    mirrors: (a) the final scene, all 508 spheres, through the CUDA kernel in
    each of its four modes, forced (one oracle frame serves the four); (b)
    the mesh scene, the kernel in its default mode and the wavefront
    ``Renderer``; (c) hollow glass, the kernel and ``Renderer`` with the
    dense test and the BVH walk; (d) the kitchen sink at level 2 with the
    raster layer on the card, whose buffers the oracle takes:
    ``FusedRenderer`` and ``Renderer``, and the two within 5e-5 of each
    other; (e) the level-1 cube world through ``Renderer`` within
    ORACLE_ATOL; (f) 4,971 spheres, ``Renderer`` walking the BVH and the
    kernel's candidate walk. Every frame is rendered on ``dev``; the kernel
    must launch once per fused frame and its plain version never."""
    import numpy as np

    import bevyray_tpu_torch as port
    from bevyray_tpu_torch import FusedRenderer, RenderConfig, Renderer, rtiow
    from bevyray_tpu_torch.engine.raster import raster_layer
    from bevyray_tpu_torch.kernels.cuda.megakernel import (
        render_tiles, render_tiles_reference)

    t_phase = time.perf_counter()
    render_tiles.launches = 0
    render_tiles_reference.calls = 0
    fused_frames = 0

    def config(frame, **options):
        return RenderConfig(*frame[:5], **options)

    def render(renderer, world, frame, buffers=(None, None), with_bvh=False):
        """``renderer``'s frame of ``world`` on ``dev``, as NumPy."""
        nonlocal fused_frames
        scene = world.extract(with_bvh=with_bvh, device=dev)
        cam = world.camera_state(aspect=frame[0] / frame[1], device=dev)
        out = renderer.render(scene, cam, frame[5], raster_color=buffers[0],
                              raster_depth=buffers[1])
        if out.image.device != scene.spheres.cx.device:
            raise SystemExit("phase 11: a frame left the scene's device")
        if isinstance(renderer, FusedRenderer):
            fused_frames += 1
            if renderer.last_exact_rng is not True:
                raise SystemExit("phase 11: a fused frame left the exact "
                                 "draws")
        return out.image.cpu().numpy(), out.rt_depth.cpu().numpy()

    def raster(world, cfg):
        """The raster layer on ``dev``: the renderers' buffers, and the
        oracle's NumPy [H, W, 3] color and [H, W] depth of the same."""
        cam = world.camera_state(aspect=cfg.width / cfg.height, device=dev)
        rc, rd = raster_layer(world, cam, cfg, device=dev)
        shape = (cfg.height, cfg.width)
        return (rc, rd), (np.stack([c.cpu().numpy().reshape(shape)
                                    for c in rc], -1),
                          rd.cpu().numpy().reshape(shape))

    def check(label, got, want, bars=None, atol=None):
        stats = oracle_stats(*got, *want[:2])
        height, width = want[0].shape[:2]
        print(f"phase 11{label} {width}x{height}: image max |d| "
              f"{stats['max_abs']:.4g}, mean |d| {stats['mean_abs']:.4g}, "
              f"{stats['frac_past']:.4%} of pixels past {ORACLE_OUTLIER} "
              f"(first (y, x) {stats['first_past']}), depth max |d| "
              f"{stats['depth_max_abs']:.4g}; oracle {want[2]:.2f} s on the "
              f"host | {card}", flush=True)
        if atol is not None:
            ok, bar = stats["max_abs"] <= atol, f"max |d| <= {atol}"
        else:
            ok = stats["mean_abs"] < bars[0] and stats["frac_past"] < bars[1]
            bar = (f"mean |d| < {bars[0]}, under {bars[1]:.0%} of pixels "
                   f"past {ORACLE_OUTLIER}")
        if not (ok and stats["finite"]):
            raise SystemExit(f"phase 11{label}: off the oracle (bar: {bar})")

    # (a) The final scene through the kernel, each mode forced.
    world = rtiow.final_scene(seed=42)
    want = oracle_frame(world, ORACLE_FINAL)
    for mode in MODES:
        renderer = FusedRenderer(forced(config(ORACLE_FINAL), mode),
                                 exact_rng=True)
        got = render(renderer, world, ORACLE_FINAL)
        if renderer.last_mode != mode:
            raise SystemExit(f"phase 11(a): ran {renderer.last_mode}, not "
                             f"{mode}")
        check(f"(a) final_scene {world.n_spheres} spheres render_tiles "
              f"{'/'.join(mode)}", got, want, ORACLE_TIGHT)

    # (b) The mesh scene (triangles, B9) and (c) hollow glass: the kernel in
    # its default mode, and the wavefront renderer.
    for name, backends in (("mesh", ("brute",)),
                           ("hollow_glass", ("brute", "bvh"))):
        frame = ORACLE_FRAMES[name]
        label = "(b)" if name == "mesh" else "(c)"
        world = golden_world(port, name)
        want = oracle_frame(world, frame)
        renderer = FusedRenderer(config(frame), exact_rng=True)
        got = render(renderer, world, frame)
        check(f"{label} {name} render_tiles {'/'.join(renderer.last_mode)}",
              got, want, ORACLE_LOOSE)
        for backend in backends:
            got = render(Renderer(config(frame, intersect_backend=backend)),
                         world, frame, with_bvh=backend == "bvh")
            check(f"{label} {name} Renderer {backend}", got, want,
                  ORACLE_LOOSE)

    # (d) The kitchen sink at level 2, the raster layer on the card.
    frame = ORACLE_FRAMES["kitchen_sink"]
    world = golden_world(port, "kitchen_sink")
    cfg = config(frame, defocus=True, diffuse_sampling="cosine")
    buffers, buffers_np = raster(world, cfg)
    want = oracle_frame(world, frame, buffers_np, defocus=True,
                        diffuse_sampling="cosine")
    renderer = FusedRenderer(cfg, exact_rng=True)
    fused = render(renderer, world, frame, buffers)
    if not renderer.prepare(world.extract(with_bvh=False, device=dev)
                            ).has_emissive:
        raise SystemExit("phase 11(d): the kernel tables missed the "
                         "emissive sphere")
    check(f"(d) kitchen_sink level 2 FusedRenderer "
          f"{'/'.join(renderer.last_mode)}, 13 planes", fused, want,
          ORACLE_LOOSE)
    wave = render(Renderer(cfg), world, frame, buffers)
    check("(d) kitchen_sink level 2 Renderer", wave, want, ORACLE_LOOSE)
    gap = float(np.abs(fused[0] - wave[0]).max())
    print(f"phase 11(d) FusedRenderer against Renderer: max |d| {gap:.4g}",
          flush=True)
    if gap > 5e-5:
        raise SystemExit("phase 11(d): FusedRenderer and Renderer differ by "
                         "more than 5e-5 (tests/test_golden.py:250)")

    # (e) Level 1 over the raster cube.
    frame = ORACLE_FRAMES["cube"]
    world = golden_world(port, "cube")
    cfg = config(frame)
    buffers, buffers_np = raster(world, cfg)
    want = oracle_frame(world, frame, buffers_np)
    check("(e) cube level 1 Renderer",
          render(Renderer(cfg), world, frame, buffers), want, atol=ORACLE_ATOL)

    # (f) 4,971 spheres: the BVH walk and the kernel's candidate walk.
    world = rtiow.final_scene(seed=42, grid=BIG_GRID)
    want = oracle_frame(world, ORACLE_BIG)
    got = render(Renderer(config(ORACLE_BIG, intersect_backend="bvh")), world,
                 ORACLE_BIG, with_bvh=True)
    check(f"(f) final_scene {world.n_spheres} spheres Renderer bvh", got, want,
          ORACLE_TIGHT)
    renderer = FusedRenderer(config(ORACLE_BIG), exact_rng=True)
    got = render(renderer, world, ORACLE_BIG)
    if renderer.last_mode[1] != "candidates":
        raise SystemExit(f"phase 11(f): ran {renderer.last_mode}, not a "
                         "candidate walk")
    check(f"(f) final_scene {world.n_spheres} spheres render_tiles "
          f"{'/'.join(renderer.last_mode)}", got, want, ORACLE_TIGHT)

    if render_tiles.launches != fused_frames or render_tiles_reference.calls:
        raise SystemExit(f"phase 11: {render_tiles.launches} kernel launches "
                         f"and {render_tiles_reference.calls} plain calls for "
                         f"{fused_frames} fused frames")
    print(f"phase 11 done in {time.perf_counter() - t_phase:.1f} s: "
          f"{fused_frames} kernel launches, no plain call | {card}",
          flush=True)

def bench_phase(scene, cam, headline, card, dev) -> None:
    """Phase 12: the bench modules (``bevyray_tpu_torch/bench/``) in-process
    at the JAX scripts' own sizes, each printing its rows: the headline
    (1080p, 16 spp, 12 timed frames), the matrix (BASELINE configs 1-5 and
    the orbit at 720p, 16 spp, 12 frames), the orbit (1080p/16 spp and
    720p/4 spp, 24 frames, five arms each), the edit loop (both sizes, 12
    edits) and the scaling harness on 1, 2 and 4 shards of the card. Each
    module raises where one of its rows launched no kernel; the headline's
    rays at seed 1 must equal a direct ``FusedRenderer`` frame's, and every
    mesh of the scaling harness the one-shard frame. The pipelined arms'
    ``host_syncs`` (the host work's waits for the card) are printed."""
    import torch

    from bevyray_tpu_torch import FusedRenderer
    from bevyray_tpu_torch.bench import edit, headline as head_bench
    from bevyray_tpu_torch.bench import matrix, orbit, scaling
    from bevyray_tpu_torch.kernels.cuda.megakernel import render_tiles

    t_phase = time.perf_counter()
    render_tiles.launches = 0
    head = head_bench.main(device=dev)
    rows = [head, *matrix.main(device=dev), *orbit.main(device=dev),
            *edit.main(device=dev)]
    if scaling.main(n_max=4, device=dev) != 0:
        raise SystemExit("phase 12: a mesh of bench.scaling differs from "
                         "the one-shard frame")
    launches = render_tiles.launches
    if launches == 0 or any(row["launches"] < 1 for row in rows):
        raise SystemExit(f"phase 12: {launches} kernel launches in all; a "
                         "row launched none")
    frame = FusedRenderer(headline).render(scene, cam, seed=1)
    torch.cuda.synchronize()
    if int(frame.rays_traced) != head["timed_rays"][0]:
        raise SystemExit(f"phase 12: the headline bench read "
                         f"{head['timed_rays'][0]} segments at seed 1, a "
                         f"direct frame {int(frame.rays_traced)}")
    waits = sorted({site for row in rows
                    for site in row.get("host_syncs", ())})
    print(f"phase 12 pipelined arms' host waits for the card: "
          f"{', '.join(waits) or 'none'}", flush=True)
    print(f"phase 12 done in {time.perf_counter() - t_phase:.1f} s: "
          f"{len(rows)} rows, {launches} kernel launches, headline p50 "
          f"{head['p50_frame_ms']} ms, seed 1 {head['timed_rays'][0]} "
          f"segments as a direct frame | {card}", flush=True)


def capture_rays(scene, cam, config, dev, seed=1) -> list:
    """The (origin, direction, active) that each bounce of sample 0 of a
    wavefront frame hands its sphere test, through the frame's own test."""
    import torch

    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.engine import renderer as renderer_mod
    from bevyray_tpu_torch.kernels.raygen import pixel_uv

    real = renderer_mod.make_intersect_fn(scene, config)
    captured = []

    def record(o, d, active):
        captured.append((Vec3(*(c.clone() for c in o)),
                         Vec3(*(c.clone() for c in d)), active.clone()))
        return real(o, d, active)

    u, v = pixel_uv(config.width, config.height, device=dev)
    ids = torch.arange(config.n_pixels, device=dev)
    renderer_mod.trace_sample(scene, cam, config, ids, u, v, 0, seed,
                              intersect_fn=record)
    return captured


def capture_states(scene, cam, config, dev, seed=1,
                   bounces=SHADE_BOUNCES) -> tuple:
    """Sample 0 of a wavefront frame: the pixels its ray generation takes
    (ids, u, v) and, at each bounce of ``bounces``, a copy of the state and
    the ray tests' results that the frame hands its shading."""
    import torch

    from bevyray_tpu_torch.engine import renderer as renderer_mod
    from bevyray_tpu_torch.kernels.raygen import pixel_uv

    real = renderer_mod.shade_bounce
    captured = {}

    def record(state, b, t, idx, tt, ti, scn, cfg, *fold):
        if b in bounces:
            captured[b] = (clone_state(state), t.clone(), idx.clone(),
                           None if tt is None else tt.clone(),
                           None if ti is None else ti.clone())
        return real(state, b, t, idx, tt, ti, scn, cfg, *fold)

    u, v = pixel_uv(config.width, config.height, device=dev)
    ids = torch.arange(config.n_pixels, device=dev)
    renderer_mod.shade_bounce = record
    try:
        renderer_mod.trace_sample(scene, cam, config, ids, u, v, 0, seed)
    finally:
        renderer_mod.shade_bounce = real
    return (ids, u, v), captured


def clone_state(state, n=None):
    """A copy of a ``SampleState``, or of its first ``n`` lanes (the camera
    row and the segment count as they are, the camera and config shared)."""
    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.kernels.bounce import SampleState

    def lanes(x):
        return (x if n is None else x[:n]).clone()

    return SampleState(**{
        name: (Vec3(*(lanes(c) for c in x)) if isinstance(x, Vec3)
               else x if name in ("cam", "config")
               else x.clone() if name in ("segments", "camera") else lanes(x))
        for name, x in state._asdict().items()})


def state_diff(got, want) -> tuple:
    """(max |d| over the float32 columns where both are numbers, every
    column bit-equal) of two ``SampleState``s."""
    import torch

    err, same = 0.0, True
    for x, y in zip(got.columns(), want.columns()):
        if x.dtype == torch.float32:
            same = same and torch.equal(x.view(torch.int32),
                                        y.view(torch.int32))
            d = (x - y).abs()
            d = d[~torch.isnan(d)]
            if d.numel():
                err = max(err, float(d.max()))
        else:
            same = same and torch.equal(x, y)
    return err, same


def shade_bound(state, after, t, tt, bounce, last, scene,
                fold=None) -> tuple:
    """(ms, "bytes" | "operations") of one K6 call: each input byte read
    once and each output byte written once by the lanes this call's data
    needs (every lane's flag; at bounce 0 every lane's t and first depth;
    an active lane's direction, throughput, radiance and t (both tests'
    with triangles), its radiance and flag written; a hit's origin, the
    winning test's index, stream word, position and direction; a
    continuing path's throughput; on the last bounce every lane's harvest
    and the radiance and first depth it reads), the tables once; with sums
    (``fold`` "zero", "film" or "self") the total's 8 bytes, and on the
    last bounce the sums written and a base's read; against the operations
    of its hits and misses at the fp32 peak."""
    from bevyray_tpu_torch.core.constants import INF

    n = t.numel()
    tri = tt is not None
    active = state.active
    hit = active & ((t < INF) | (tt < INF) if tri else (t < INF))
    n_act, n_hit = int(active.sum()), int(hit.sum())
    n_cont = int(after.active.sum())
    n_bytes = n + n_act * (36 + (8 if tri else 4) + 13)
    n_bytes += n_hit * (12 + 8 + 4 + 24) + n_cont * 12
    if bounce == 0:
        n_bytes += (n - n_act) * (8 if tri else 4) + n * 4
    if last:
        n_bytes += n * 16 + (n - n_act) * 12 + (0 if bounce == 0 else n * 4)
        if fold is not None:
            n_bytes += n * 16 + (0 if fold == "zero" else n * 16)
    if fold is not None:
        n_bytes += 8
    n_bytes += scene.spheres.capacity * 16 + scene.materials.capacity * 40
    if tri:
        n_bytes += scene.triangles.capacity * 40
    ops = n_hit * SHADE_HIT_OPS + (n_act - n_hit) * SHADE_MISS_OPS
    by_ops, by_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                               "bytes")


def shade_sectors(state, after, t, tt, bounce, last, fold=None) -> tuple:
    """(ms, bytes): the 32-byte sectors of the state's columns that one K6
    call's lanes touch, each read once and each written once, at 3.35
    TB/s: the same lanes and columns as ``shade_bound`` counts, but a
    sector for every 8 lanes of a float32 column (4 of an int64 index, 32
    of a flag) that holds one of them. Where the live lanes are sparse,
    the sectors they share with dead lanes move too."""
    import torch

    from bevyray_tpu_torch.core.constants import INF

    n = t.numel()

    def sectors(mask, width) -> int:
        per = 32 // width
        pad = (-n) % per
        m = torch.nn.functional.pad(mask.to(torch.int8), (0, pad))
        return int(m.view(-1, per).any(dim=1).sum()) * 32

    every = torch.ones(n, dtype=torch.bool, device=t.device)
    live = state.active
    tri = tt is not None
    hit = live & ((t < INF) | (tt < INF) if tri else (t < INF))
    cont = after.active
    f4 = lambda mask, cols: cols * sectors(mask, 4)   # noqa: E731
    reads = sectors(every, 1) + f4(every if bounce == 0 else live,
                                   2 if tri else 1)
    # d and the throughput; the radiance (every lane's on the last
    # bounce); a hit's origin, stream word and index.
    reads += f4(live, 6) + f4(every if last else live, 3)
    reads += f4(hit, 4) + sectors(hit, 8)
    writes = sectors(live, 1) + f4(live, 3) + f4(hit, 6) + f4(cont, 3)
    if bounce == 0:
        writes += f4(every, 1)
    if last:
        reads += f4(every, 1)    # the first depth
        writes += f4(every, 4)   # the harvest
        if fold is not None:
            writes += f4(every, 4)
            reads += 0 if fold == "zero" else f4(every, 4)
    return (reads + writes) / PEAK_BYTES * 1e3, reads + writes


def shade_ms(shade, state, args, reps: int) -> float:
    """Mean device time in ms of ``shade(work, *args)`` over ``reps`` calls,
    each on a fresh copy of ``state`` (K6 updates its state in place), by
    CUDA events around each call alone, queued behind a spin kernel."""
    import torch

    work = clone_state(state)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(20_000_000)   # ~10 ms at 1.98 GHz
    for start, end in pairs:
        for dst, src in zip(work.columns(), state.columns()):
            dst.copy_(src)
        start.record()
        shade(work, *args)
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def seeded_sums(n, dev, seed):
    """``FrameSums`` of ``n`` lanes on the card, seeded (so that every
    write shows), with a segment total of 12345."""
    import numpy as np
    import torch

    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.kernels.bounce import FrameSums

    cols = torch.as_tensor(np.random.default_rng(seed).random(
        (4, n), dtype=np.float32) * 8, device=dev)
    return FrameSums(Vec3(cols[0], cols[1], cols[2]), cols[3],
                     torch.tensor(12345, dtype=torch.int64, device=dev))


def shade_probe_rows(scene, config, states, card) -> list:
    """K6 at each captured bounce of ``states`` ({bounce: (state, t, idx,
    tt, ti)}), folding into sums in place as a frame's later samples do:
    the probe instance (``bounce.shade_bounce_probe``) against the default
    instance and the plain version on copies of the same state and sums,
    every column as bits (a difference raises); the default's time
    (``shade_ms``) beside ``shade_bound`` and ``shade_sectors``; its tiles
    (``shade_tiles``); the live lanes; the probe's cycle shares by stage
    (of the threads' summed cycles) and, for each path and branch, the
    warps entering it and their mean active lanes. Prints a line a bounce
    and returns the rows."""
    import torch

    from bevyray_tpu_torch.kernels import bounce as bounce_mod

    rows = []
    for b, (state, t, idx, tt, ti) in sorted(states.items()):
        args = (b, t, idx, tt, ti, scene, config)
        n = t.numel()
        got, want, plain = (clone_state(state) for _ in range(3))
        g_sums, w_sums, p_sums = (seeded_sums(n, t.device, b)
                                  for _ in range(3))
        bounce_mod.shade_bounce(want, *args, w_sums, w_sums)
        clocks = bounce_mod.shade_bounce_probe(got, *args, g_sums, g_sums)
        bounce_mod.shade_bounce_reference(plain, *args, p_sums, p_sums)
        for what, x, x_sums in (("the probe instance", got, g_sums),
                                ("the plain version", plain, p_sums)):
            err, same = state_diff(x, want)
            s_err, s_same = state_diff(x_sums, w_sums)
            if not (same and s_same):
                raise SystemExit(f"K6 at bounce {b}: {what} differs from the "
                                 f"default instance (max |d| "
                                 f"{max(err, s_err):.3g})")
        ms = shade_ms(lambda st, *a: bounce_mod.shade_bounce(
            st, *a, w_sums, w_sums), state, args, WAVE_REPS)
        bound, bound_by = shade_bound(state, want, t, tt, b,
                                      b == config.bounces, scene, "self")
        sector_ms, _ = shade_sectors(state, want, t, tt, b,
                                     b == config.bounces, "self")
        stages = {k: clocks[k] for k in bounce_mod.SHADE_PROBE_SLOTS[1:9]}
        cycles = sum(stages.values()) or 1
        paths = {}
        for path in ("miss", "record", "metal", "glass", "diffuse"):
            warps = clocks[path + "_warps"]
            paths[path] = [warps, round(clocks[path + "_lanes"] / warps, 2)
                           if warps else 0.0]
        per, tiles = bounce_mod.shade_tiles(n, torch.cuda.get_device_properties(
            t.device).multi_processor_count, b)
        row = {"bounce": b, "lanes": n, "live": int(state.active.sum()),
               "per": per, "tiles": tiles,
               "ms": ms, "bound_ms": bound, "bound_by": bound_by,
               "share_of_bound": bound / ms, "sector_ms": sector_ms,
               "stage_shares": {k: round(v / cycles, 4)
                                for k, v in stages.items()},
               "thread_cycles": clocks["total"],
               "warps_and_lanes_a_warp": paths}
        print(f"K6 probe, bounce {b}: {json.dumps(row)}; the probe instance "
              f"and the plain version bit-equal to the default instance | "
              f"{card}", flush=True)
        rows.append(row)
    return rows


def ptxas_usage(source: str, names) -> dict:
    """{kernel name: {"registers", "spill_stores", "spill_loads"}} that
    ``nvcc -Xptxas -v`` reports for the kernels of ``source`` (a ``.cu``
    file of ``kernels/cuda/csrc``) whose names hold one of ``names``,
    compiled alone with the extension's flags into ``build/ptxas/``; the
    names demangled by the toolkit's ``cu++filt`` where it has one (up to
    the arguments)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from bevyray_tpu_torch.kernels.cuda import build

    src = ROOT / source
    out_dir = ROOT / "build" / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    run = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-c", str(src), "-o",
         str(out_dir / (src.stem + ".o")), "-std=c++17", "-I",
         str(src.parent), *build.CUDA_FLAGS, "-Xptxas", "-v"],
        capture_output=True, text=True, timeout=600, check=True)
    usage, entry = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in names) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(entry, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    filt = Path(CUDA_HOME) / "bin" / "cu++filt"
    if not filt.exists():
        return usage
    names = subprocess.run(
        [str(filt)], input="\n".join(usage), capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()
    out = {}
    for entry, name in zip(usage, names):
        name = name.replace("(anonymous namespace)::", "")
        out[name.split("(")[0].rsplit("::", 1)[-1]] = usage[entry]
    return out


def axis_rays(lo, hi, planes, n, seed, dev) -> tuple:
    """``n`` rays along +-x, +-y or +-z from origins uniform in the box
    [lo, hi], one coordinate of each moved onto a value of ``planes`` (a
    (3, k) array of box faces: min or max x, y, z of BVH nodes), so that a
    slab of a face through the origin meets a zero direction (0 * inf)."""
    import numpy as np
    import torch

    from bevyray_tpu_torch.core.vec import Vec3

    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    flat = (axis + rng.integers(1, 3, n)) % 3   # another axis than the ray's
    o[np.arange(n), flat] = planes[flat, rng.integers(0, planes.shape[1], n)]
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = rng.choice(np.float32([-1.0, 1.0]), n)
    return tuple(Vec3(*(torch.as_tensor(a[:, k].copy(), device=dev)
                        for k in range(3))) for a in (o, d))


def box_planes(bvh) -> "np.ndarray":
    """(3, 2 x nodes) float32: every node's min and max per axis."""
    import numpy as np

    cols = [np.asarray(c.cpu()) for c in (bvh.min_x, bvh.min_y, bvh.min_z,
                                           bvh.max_x, bvh.max_y, bvh.max_z)]
    return np.stack([np.concatenate([cols[k], cols[k + 3]])
                     for k in range(3)])


def wavefront_phase(scene, cam, headline, card, dev) -> list:
    """Phase 13: the wavefront renderer's kernels, the ray tests of
    ``csrc/wavefront.cu`` (K1 ``intersect_spheres``, K2
    ``intersect_triangles``, K3 ``intersect_bvh``, K4
    ``intersect_bvh_triangles``) and the bounce body of ``csrc/bounce.cu``
    (K5 ``raygen_sample``, K6 ``shade_bounce``). (a) The main path: the
    wavefront headline frame (K1), BASELINE config 5's mesh through
    ``Renderer`` with the dense tests (K1, K2) and with the BVH walks (K3,
    K4), 10(f)'s 4,971 spheres walking the BVH (K3), the cube field (K1,
    K2: one K2 launch a bounce), the wavefront sharded step and a film pass
    (K5 and K6 in each), each with the counts zeroed just before and read
    just after, timed, and equal (image, depth, segments) to the frame with
    the plain bounce body patched in; the headline frame again with every
    plain version patched in, equal too. (b) Each kernel against its plain
    version on the same CUDA tensors: the ray tests at bounces 0 and 2 of
    real frames (the bounce's own active mask) and on the layouts listed in
    the module's docstring, t max |d| 0 and index equal on every lane; K5
    and K6 on real frames' pixels and states, every column bit-equal.
    K6 also at every bounce of the headline with its time, bound and
    sector floor and its probe instance there, and ptxas's registers and
    spills. Each kernel's time by CUDA events beside its bound and its
    plain version's time. (c) ``host_syncs`` over ``Renderer.render``
    (brute, bvh, mesh) and over a config-5 round (``raster_layer`` +
    ``FusedRenderer``): the sites, which must be none. (d) The kernels of
    a 1-spp and a 16-spp headline frame and the card's busy time (torch's
    profiler, each frame in a process of its own, held to the wrappers'
    launches), and of a 1-spp headline frame through the wavefront
    sharded step on mesh (1, 1, 2), with K16 and with the plain merge
    patched in.
    Returns the kernels-line entries."""
    import numpy as np
    import torch

    import bevyray_tpu_torch
    from bevyray_tpu_torch import (FusedRenderer, ProgressiveRenderer,
                                   RenderConfig, Renderer, rtiow)
    from bevyray_tpu_torch.bench.matrix import matrix_configs
    from bevyray_tpu_torch.bench.timing import host_syncs
    from bevyray_tpu_torch.bvh import build as bvh_build
    from bevyray_tpu_torch.engine import renderer as renderer_mod
    from bevyray_tpu_torch.engine.raster import raster_layer
    from bevyray_tpu_torch.core.types import (make_sphere_walk, make_spheres_np,
                                              make_triangles_np)
    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.kernels import bounce as bounce_mod
    from bevyray_tpu_torch.kernels import frame as frame_mod
    from bevyray_tpu_torch.kernels import intersect, traverse
    from bevyray_tpu_torch.kernels.cuda import wavefront as wavefront_mod
    from bevyray_tpu_torch.kernels.intersect import on_active
    from bevyray_tpu_torch.kernels.raygen import generate_rays, pixel_uv
    from bevyray_tpu_torch.parallel.sharding import (make_mesh,
                                                     render_frame_sharded)

    t_phase = time.perf_counter()
    kernels = {"intersect_spheres": intersect.intersect_spheres,
               "intersect_triangles": intersect.intersect_triangles,
               "intersect_bvh": traverse.intersect_bvh,
               "intersect_bvh_triangles": traverse.intersect_bvh_triangles,
               "raygen_sample": bounce_mod.raygen_sample,
               "shade_bounce": bounce_mod.shade_bounce}
    plain = {"intersect_spheres": intersect.intersect_spheres_reference,
             "intersect_triangles": intersect.intersect_triangles_reference,
             "intersect_bvh": traverse.intersect_bvh_reference,
             "intersect_bvh_triangles":
                 traverse.intersect_bvh_triangles_reference,
             "raygen_sample": bounce_mod.raygen_sample_reference,
             "shade_bounce": bounce_mod.shade_bounce_reference}

    def zero():
        for fn in kernels.values():
            fn.launches = 0
        frame_mod.resolve_frame.launches = 0

    def counts():
        return {name: fn.launches for name, fn in
                {**kernels, "resolve_frame": frame_mod.resolve_frame}.items()}

    def frame_of(renderer, scn, camera, **kw):
        return lambda seed: renderer.render(scn, camera, seed=seed, **kw)

    def timed(render):
        """The frame of seed 1 and its ms, on the host's clock."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = render(1)
        torch.cuda.synchronize()
        return frame, (time.perf_counter() - t0) * 1e3

    world5, config5 = config5_world()
    cam5 = world5.camera_state(aspect=HYBRID_SIZE[0] / HYBRID_SIZE[1],
                               device=dev)
    scene5 = world5.extract(device=dev)
    rc, rd = raster_layer(world5, cam5, config5, device=dev)
    field = cube_field_world(bevyray_tpu_torch)
    cam_f = field.camera_state(aspect=HYBRID_SIZE[0] / HYBRID_SIZE[1],
                               device=dev)
    scene_f = field.extract(device=dev)
    rc_f, rd_f = raster_layer(field, cam_f, config5, device=dev)
    big = rtiow.final_scene(seed=CLI_SCENE_SEED, grid=BIG_GRID)
    big_scene = big.extract(device=dev)
    big_cam = big.camera_state(aspect=BIG_SIZE[0] / BIG_SIZE[1], device=dev)
    big_cfg = RenderConfig(*BIG_SIZE, BIG_SPP, BOUNCES, level=3)
    brute5 = dataclasses.replace(config5, intersect_backend="brute")
    bvh5 = dataclasses.replace(config5, intersect_backend="bvh")

    # (a) The main path, each run between a zeroing and a reading: frames
    # of the Renderer, a sharded step (2 pixel shards, 2 sphere shards) and
    # a film pass, each then again with the plain bounce body patched in.
    small = rtiow.final_scene(seed=42)
    small_scene = small.extract(with_bvh=False, device=dev)
    small_cam = small.camera_state(aspect=WAVE_SIZE[0] / WAVE_SIZE[1],
                                   device=dev)
    wave_cfg = RenderConfig(*WAVE_SIZE, SPP, BOUNCES, level=3)
    mesh = make_mesh(2, 1, 2, devices=["cuda:0"] * 4)
    main_runs = [
        ("headline", headline, scene, frame_of(Renderer(headline), scene,
                                               cam)),
        ("config 5 brute", brute5, scene5, frame_of(
            Renderer(brute5), scene5, cam5, raster_color=rc,
            raster_depth=rd)),
        ("config 5 bvh", bvh5, scene5, frame_of(
            Renderer(bvh5), scene5, cam5, raster_color=rc, raster_depth=rd)),
        (f"{big.n_spheres} spheres auto", big_cfg, big_scene, frame_of(
            Renderer(big_cfg), big_scene, big_cam)),
        (f"cube field ({CUBE_FIELD} cubes) auto", config5, scene_f, frame_of(
            Renderer(config5), scene_f, cam_f, raster_color=rc_f,
            raster_depth=rd_f)),
        ("sharded step, mesh (2, 1, 2)", wave_cfg, small_scene,
         lambda seed: render_frame_sharded(mesh, small_scene, small_cam,
                                           wave_cfg, seed)),
        ('film pass, ProgressiveRenderer(backend="xla")', wave_cfg,
         small_scene, lambda seed: ProgressiveRenderer(
             wave_cfg, device=dev).step(small_scene, small_cam, seed=seed)),
    ]

    # Each wrapper of the path, and its plain version in its place.
    patched = {
        "intersect_spheres": lambda o, d, sph, chunk=512, active=None:
            on_active(plain["intersect_spheres"], active, o, d, sph, chunk),
        "intersect_triangles": lambda o, d, tris, chunk=512, active=None:
            on_active(plain["intersect_triangles"], active, o, d, tris,
                      chunk),
        "intersect_bvh": lambda o, d, sph, bvh, stack_size=32,
        max_leaf_size=1, active=None, walk=None: on_active(
            plain["intersect_bvh"], active, o, d, sph, bvh, stack_size,
            max_leaf_size),
        "intersect_bvh_triangles": lambda o, d, tris, bvh, stack_size=32,
        max_leaf_size=1, active=None: on_active(
            plain["intersect_bvh_triangles"], active, o, d, tris, bvh,
            stack_size, max_leaf_size),
        "raygen_sample": plain["raygen_sample"],
        "shade_bounce": plain["shade_bounce"],
        "resolve_frame": frame_mod.resolve_frame_reference,
    }

    @contextlib.contextmanager
    def plain_in(names):
        """``names`` of ``engine.renderer`` replaced by their plain versions."""
        saved = {name: getattr(renderer_mod, name) for name in names}
        try:
            for name in names:
                setattr(renderer_mod, name, patched[name])
            yield
        finally:
            for name, fn in saved.items():
                setattr(renderer_mod, name, fn)

    launches = collections.Counter()
    frames = {}
    for name, config, scn, render in main_runs:
        render(0)   # warm-up
        zero()
        # A K12 a sample state (one a shard), K15 in the sharded step and
        # a K16 a bounce of each of its 2 shards.
        sharded = name.startswith("sharded")
        with pass_launches(f"phase 13(a) {name}", {
                "camera_rows": 2 if sharded else 1,
                "sum_shards": int(sharded),
                "merge_tp_hits": 2 * SPP * (BOUNCES + 1) if sharded else 0}):
            frame, ms = timed(render)
        got = counts()
        launches.update(got)
        TAIL_LAUNCHES["resolve_frame"] += got["resolve_frame"]
        frames[name] = frame
        if got["resolve_frame"] != 1:
            raise SystemExit(f"phase 13(a) {name}: {got['resolve_frame']} "
                             "tail launches (K10), not one")
        if not (bool(torch.isfinite(frame.image).all())
                and bool(torch.isfinite(frame.rt_depth).all())
                and int(frame.rays_traced) > 0):
            raise SystemExit(f"phase 13 {name}: not a finite frame")
        with plain_in(("raygen_sample", "shade_bounce")):
            plain_frame = render(1)
        same = (torch.equal(frame.image, plain_frame.image)
                and torch.equal(frame.rt_depth, plain_frame.rt_depth)
                and int(frame.rays_traced) == int(plain_frame.rays_traced))
        backend = renderer_mod.resolve_intersect_backend(scn, config)
        print(f"phase 13(a) {name} {config.width}x{config.height} "
              f"{config.samples_per_pixel} spp ({backend}): frame {ms:.3f} "
              f"ms, {int(frame.rays_traced)} segments, launches {got}; "
              f"equal to the frame with the plain bounce body: {same} | "
              f"{card}", flush=True)
        if not same:
            raise SystemExit(f"phase 13(a) {name}: the frame differs from the "
                             "one with the plain bounce body")
        if name.startswith("cube field") and (
                backend != "brute" or got["intersect_triangles"]
                != SPP * (BOUNCES + 1)):
            raise SystemExit(f"phase 13(a) {name}: not {SPP * (BOUNCES + 1)}"
                             f" dense triangle tests ({backend}, {got})")
    if min(launches[name] for name in kernels) < 1:
        raise SystemExit(f"phase 13(a): a kernel of the path launched no "
                         f"time: {dict(launches)}")

    # The headline frame with every plain version patched in.
    with plain_in(patched):
        zero()
        ref, ref_ms = timed(frame_of(Renderer(headline), scene, cam))
        stray = counts()
    head = frames["headline"]
    same = (torch.equal(head.image, ref.image)
            and torch.equal(head.rt_depth, ref.rt_depth)
            and int(head.rays_traced) == int(ref.rays_traced))
    print(f"phase 13(a) headline frame against the frame with every plain "
          f"version ({ref_ms:.1f} ms): image max |d| "
          f"{float((head.image - ref.image).abs().max()):.3g}, depth max |d| "
          f"{float((head.rt_depth - ref.rt_depth).abs().max()):.3g}, segments "
          f"{int(head.rays_traced)} / {int(ref.rays_traced)} | {card}",
          flush=True)
    if not same or any(stray.values()):
        raise SystemExit(f"phase 13(a): the kernels' frame differs from the "
                         f"plain versions' (launches in the plain frame "
                         f"{stray})")

    # (b) Each kernel against its plain version on the same CUDA tensors.
    max_err = collections.defaultdict(float)
    timing = {}

    def hold(case, name, args, o, d, active, time_it=False, walk=None,
             **kw):
        # K3 walks the record that the scene carries (``walk``), as the
        # renderer passes it; without one the wrapper builds it first.
        kernel_kw = kw if walk is None else dict(kw, walk=walk)
        got = kernels[name](o, d, *args, **kernel_kw, active=active)
        work = {}
        extra = dict(kw, work=work) if name.startswith("intersect_bvh") else kw
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = on_active(plain[name], active, o, d, *args, **extra)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got[0] - want[0]).abs().max())
        same_i = torch.equal(got[1], want[1])
        n_act = int(active.sum()) if active is not None else o.x.shape[0]
        max_err[name] = max(max_err[name], err)
        line = (f"phase 13(b) {name} {case}: {o.x.shape[0]} lanes, {n_act} "
                f"active, t max |d| {err:.3g}, index equal {same_i}, hits "
                f"{int((got[1] >= 0).sum())}")
        if time_it:   # the first timed case of a kernel is its entry's
            ms = cuda_ms(lambda: kernels[name](o, d, *args, **kernel_kw,
                                               active=active), WAVE_REPS)
            bound = wave_bound(name, args, o, n_act, work)
            timing.setdefault(name, (ms, plain_ms, bound[:2], case))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
            if bound[2] is not None:
                line += (f", {bound[2]:.4f} ms at the issue rate ("
                         f"{ms * 1e-3 * ISSUE_RATE / bound[3]:.1f} issue "
                         f"slots a pair)")
        print(line + f" | {card}", flush=True)
        if err != 0.0 or not same_i:
            raise SystemExit(f"phase 13(b) {name} {case}: the kernel differs "
                             "from its plain version")

    tris5 = scene5.triangles
    big_leaf4 = big.extract(bvh_leaf_size=4, device=dev)
    rays = {key: capture_rays(*args, dev) for key, args in (
        ("headline", (scene, cam, headline)),
        ("config 5", (scene5, cam5, brute5)),
        ("big", (big_scene, big_cam, big_cfg)),
        ("field", (scene_f, cam_f, config5)))}
    for b in WAVE_BOUNCES:
        first = b == WAVE_BOUNCES[0]
        o, d, act = rays["headline"][b]
        hold(f"headline bounce {b}", "intersect_spheres", (scene.spheres,),
             o, d, act, time_it=True)
        o, d, act = rays["config 5"][b]
        hold(f"config 5 bounce {b}", "intersect_spheres", (scene5.spheres,),
             o, d, act)
        hold(f"config 5 bounce {b}", "intersect_triangles", (tris5,), o, d,
             act, time_it=first)
        hold(f"config 5 mesh BVH bounce {b}", "intersect_bvh_triangles",
             (tris5, scene5.tri_bvh), o, d, act, time_it=first)
        hold(f"config 5 sphere BVH bounce {b}", "intersect_bvh",
             (scene5.spheres, scene5.bvh), o, d, act,
             walk=scene5.sphere_walk)
        o, d, act = rays["field"][b]
        hold(f"cube field bounce {b}", "intersect_triangles",
             (scene_f.triangles,), o, d, act, time_it=first)
        hold(f"cube field mesh BVH bounce {b}", "intersect_bvh_triangles",
             (scene_f.triangles, scene_f.tri_bvh), o, d, act, time_it=first)
        o, d, act = rays["big"][b]
        hold(f"{big.n_spheres} spheres leaf 1 bounce {b}", "intersect_bvh",
             (big_scene.spheres, big_scene.bvh), o, d, act, time_it=True,
             walk=big_scene.sphere_walk)
        hold(f"{big.n_spheres} spheres leaf 4 bounce {b}", "intersect_bvh",
             (big_leaf4.spheres, big_leaf4.bvh), o, d, act,
             max_leaf_size=4, time_it=True, walk=big_leaf4.sphere_walk)
        hold(f"{big.n_spheres} spheres 4-entry stack bounce {b}",
             "intersect_bvh", (big_scene.spheres, big_scene.bvh), o, d, act,
             stack_size=4, walk=big_scene.sphere_walk)
        hold(f"{big.n_spheres} spheres dense bounce {b}",
             "intersect_spheres", (big_scene.spheres,), o, d, act,
             time_it=True)
    centers, radii = big.extract_host()[:2]
    lo, hi = centers.min(0) - radii.max(), centers.max(0) + radii.max()
    o, d = axis_rays(lo, hi, box_planes(big_scene.bvh), AXIS_RAYS, 5, dev)
    for case, scn, leaf in (("leaf 1", big_scene, 1),
                            ("leaf 4", big_leaf4, 4)):
        hold(f"axis-aligned rays, {big.n_spheres} spheres {case}",
             "intersect_bvh", (scn.spheres, scn.bvh), o, d, None,
             max_leaf_size=leaf, walk=scn.sphere_walk)
    hold(f"axis-aligned rays, {big.n_spheres} spheres", "intersect_spheres",
         (big_scene.spheres,), o, d, None)
    live = np.asarray(tris5.valid.cpu())
    corners = np.stack([np.asarray(c.cpu())[live] for c in tris5[:9]])
    corners = corners.reshape(3, 3, -1)   # corner, axis, live row
    lo, hi = corners.min((0, 2)) - 1.0, corners.max((0, 2)) + 1.0
    o, d = axis_rays(lo, hi, box_planes(scene5.tri_bvh), AXIS_RAYS, 6, dev)
    hold("axis-aligned rays, config 5 mesh BVH", "intersect_bvh_triangles",
         (tris5, scene5.tri_bvh), o, d, None)
    hold("axis-aligned rays, config 5 mesh", "intersect_triangles",
         (tris5,), o, d, None)

    # The cases that reach the dense tests' and K3's layouts: a lane count
    # off a block of 256 x rays a thread, a few active lanes scattered over
    # many blocks (K1 and K2 compact each block's), every sphere and every
    # triangle twice in a row (exact ties: the dense tests keep the lower
    # index, the walk the first found), K1's table then past one staged
    # tile; every third triangle row invalid (K2 stages the valid rows of
    # a tile compacted); the raster layer's call (unmasked, 12 rows).
    for rows in sorted({tris5.capacity, scene.spheres.capacity,
                        scene_f.triangles.capacity,
                        2 * big_scene.spheres.capacity}):
        print(f"phase 13(b) K1, K2 and K3 instances, the dense tests over "
              f"{rows} rows: {json.dumps(wavefront_mod.kernel_info(dev, rows))}"
              f" | {card}", flush=True)

    def cut(v, n):
        return Vec3(*(c[:n] for c in v))

    def sparse(act):
        few = torch.zeros_like(act)
        few[SPARSE_FIRST::SPARSE_STEP] = act[SPARSE_FIRST::SPARSE_STEP]
        return few

    def twice(table):
        return type(table)(*(torch.repeat_interleave(c, 2) for c in table))

    o, d, act = rays["headline"][0]
    hold(f"headline bounce 0, first {ODD_LANES} lanes", "intersect_spheres",
         (scene.spheres,), cut(o, ODD_LANES), cut(d, ODD_LANES),
         act[:ODD_LANES], time_it=True)
    hold(f"headline bounce 0, every {SPARSE_STEP}th lane", "intersect_spheres",
         (scene.spheres,), o, d, sparse(act), time_it=True)
    hold("headline bounce 0, every sphere twice", "intersect_spheres",
         (twice(scene.spheres),), o, d, act, time_it=True)
    o, d, act = rays["big"][0]
    hold(f"{big.n_spheres} spheres leaf 1 bounce 0, first {ODD_LANES} lanes",
         "intersect_bvh", (big_scene.spheres, big_scene.bvh),
         cut(o, ODD_LANES), cut(d, ODD_LANES), act[:ODD_LANES], time_it=True,
         walk=big_scene.sphere_walk)
    hold(f"{big.n_spheres} spheres leaf 1 bounce 0, every {SPARSE_STEP}th "
         "lane", "intersect_bvh", (big_scene.spheres, big_scene.bvh), o, d,
         sparse(act), time_it=True, walk=big_scene.sphere_walk)
    hold(f"{big.n_spheres} spheres dense bounce 0, every {SPARSE_STEP}th "
         "lane", "intersect_spheres", (big_scene.spheres,), o, d,
         sparse(act))
    hold(f"{big.n_spheres} spheres twice, dense bounce 0",
         "intersect_spheres", (twice(big_scene.spheres),), o, d, act,
         time_it=True)
    tris_f = scene_f.triangles
    o, d, act = rays["field"][0]
    hold(f"cube field bounce 0, first {ODD_LANES} lanes",
         "intersect_triangles", (tris_f,), cut(o, ODD_LANES),
         cut(d, ODD_LANES), act[:ODD_LANES], time_it=True)
    hold(f"cube field bounce 0, every {SPARSE_STEP}th lane",
         "intersect_triangles", (tris_f,), o, d, sparse(act), time_it=True)
    hold("cube field bounce 0, every triangle twice", "intersect_triangles",
         (twice(tris_f),), o, d, act, time_it=True)
    third = tris_f._replace(valid=tris_f.valid & (torch.arange(
        tris_f.valid.numel(), device=dev) % 3 != 1))
    hold("cube field bounce 0, every third row invalid",
         "intersect_triangles", (third,), o, d, act, time_it=True)
    o, d, act = rays["config 5"][0]
    hold("config 5 bounce 0, every triangle twice", "intersect_triangles",
         (twice(tris5),), o, d, act)
    va, vb, vc, _ = world5.extract_raster_host()
    raster_tris = make_triangles_np(va, vb, vc,
                                    np.zeros(va.shape[0], np.int32),
                                    capacity=va.shape[0], device=dev)
    u, v = pixel_uv(*HYBRID_SIZE, device=dev)
    half = torch.full_like(u, 0.5)
    o, d = generate_rays(u, v, half, half, cam5, HYBRID_SIZE[1])
    hold("the raster layer's call (pixel centers, unmasked)",
         "intersect_triangles", (raster_tris,), o, d, None, time_it=True)
    centers2, radii2 = np.repeat(centers, 2, axis=0), np.repeat(radii, 2)
    spheres2 = make_spheres_np(centers2, radii2, np.arange(radii2.shape[0]),
                               device=dev)
    for leaf in (1, 4):
        tree = bvh_build.build_scene_bvh(centers2, radii2, max_leaf_size=leaf,
                                         device=dev)
        hold(f"{big.n_spheres} spheres twice, leaf {leaf} bounce 0",
             "intersect_bvh", (spheres2, tree), o, d, act,
             max_leaf_size=leaf, walk=make_sphere_walk(spheres2, tree))

    # K5 and K6 against their plain versions on the same CUDA tensors: K5
    # on a frame's pixels (all of the headline's, the first ODD_LANES, the
    # second half at sample 5 as a pixel shard takes it, the night scene
    # with the lens), by id tensor and by index (the lanes take the frame's
    # pixels in order from an offset, as every frame now does), the latter
    # folding into sums (FOLDS: from zero, from another film's, in place);
    # K6 on the state and the ray tests' results that each bounce of
    # SHADE_BOUNCES hands it in sample 0 of real frames, their own active
    # masks: the headline, config 5 (triangles; again at level 1), the cube
    # field, 4,971 spheres by the BVH, the night scene (lens, emission,
    # cosine lobes) and the headline's first ODD_LANES lanes, each without
    # sums and folding into sums in place (at the last bounce also from
    # zero and from another film's). Every column of the state and of the sums
    # bit-equal, the segment counts equal.
    def fold_pair(n, fold, seed):
        """Two equal (sums, base) pairs of ``n`` lanes on the card for
        ``fold``: None (no sums), "zero" (no base), "film" (another film's
        sums) or "self" (the sums are their own base); seeded sums and
        totals, so that every write shows."""
        if fold is None:
            return [(None, None), (None, None)]
        rng = np.random.default_rng(seed)
        host = rng.random((2, 4, n), dtype=np.float32) * 8

        def sums(k, total):
            cols = torch.as_tensor(host[k], device=dev)
            return bounce_mod.FrameSums(
                Vec3(cols[0], cols[1], cols[2]), cols[3],
                torch.tensor(total, dtype=torch.int64, device=dev))

        pairs = []
        for _ in range(2):
            out = sums(0, 12345)
            base = {"zero": None, "self": out,
                    "film": sums(1, 777)}[fold]
            pairs.append((out, base))
        return pairs

    def sums_diff(got, want) -> tuple:
        if got is None:
            return 0.0, True
        return state_diff(got, want)

    def hold_raygen(case, n, ids, u, v, camera, config, sample,
                    time_it=False, fold=None):
        base = bounce_mod.new_state(n, camera, config, dev)
        got, want = clone_state(base), clone_state(base)
        (g_sums, g_base), (w_sums, w_base) = fold_pair(n, fold, sample)
        bounce_mod.raygen_sample(got, ids, u, v, camera, config, sample, 1,
                                 g_sums, g_base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain["raygen_sample"](want, ids, u, v, camera, config, sample, 1,
                               w_sums, w_base)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, same = state_diff(got, want)
        s_err, s_same = sums_diff(g_sums, w_sums)
        err, same = max(err, s_err), same and s_same
        max_err["raygen_sample"] = max(max_err["raygen_sample"], err)
        by_index = not isinstance(ids, torch.Tensor)
        line = (f"phase 13(b) raygen_sample {case}: {n} lanes "
                f"{'by index' if by_index else 'by id'}, sums {fold}, max "
                f"|d| {err:.3g}, bit-equal {same}")
        if time_it:
            ms = cuda_ms(lambda: bounce_mod.raygen_sample(
                got, ids, u, v, camera, config, sample, 1, g_sums, g_base),
                WAVE_REPS)
            lane_bytes = RAYGEN_LANE_BYTES - (16 if by_index else 0)
            by_bytes = ((n * lane_bytes + 4 * bounce_mod.CAM_FLOATS + 8
                         + (8 if fold else 0)) / PEAK_BYTES * 1e3)
            by_ops = n * RAYGEN_LANE_OPS / PEAK_FP32 * 1e3
            bound = ((by_ops, "operations") if by_ops >= by_bytes
                     else (by_bytes, "bytes"))
            timing.setdefault("raygen_sample", (ms, plain_ms, bound, case))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
        print(line + f" | {card}", flush=True)
        if not same:
            raise SystemExit(f"phase 13(b) raygen_sample {case}: the kernel "
                             "differs from its plain version")

    def hold_shade(case, entry, scn, config, b, lanes=None, time_it=False,
                   fold=None):
        state, t, idx, tt, ti = entry
        if lanes is not None:
            state = clone_state(state, lanes)
            t, idx = t[:lanes].contiguous(), idx[:lanes].contiguous()
            if tt is not None:
                tt, ti = tt[:lanes].contiguous(), ti[:lanes].contiguous()
        args = (b, t, idx, tt, ti, scn, config)
        got, want = clone_state(state), clone_state(state)
        (g_sums, g_base), (w_sums, w_base) = fold_pair(t.numel(), fold, b)
        bounce_mod.shade_bounce(got, *args, g_sums, g_base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain["shade_bounce"](want, *args, w_sums, w_base)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, same = state_diff(got, want)
        s_err, s_same = sums_diff(g_sums, w_sums)
        err, same = max(err, s_err), same and s_same
        max_err["shade_bounce"] = max(max_err["shade_bounce"], err)
        line = (f"phase 13(b) shade_bounce {case} bounce {b}, sums {fold}: "
                f"{t.numel()} lanes, {int(state.active.sum())} active, max "
                f"|d| {err:.3g}, bit-equal {same}, segments "
                f"{int(got.segments)} / {int(want.segments)}")
        if fold is not None:
            line += (f", total {int(g_sums.segments)} / "
                     f"{int(w_sums.segments)}")
        if time_it:
            ms = shade_ms(lambda st, *a: bounce_mod.shade_bounce(
                st, *a, g_sums, g_base), state, args, WAVE_REPS)
            bound = shade_bound(state, want, t, tt, b, b == config.bounces,
                                scn, fold)
            timing.setdefault("shade_bounce", (ms, plain_ms, bound,
                                               f"{case} bounce {b}"))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
        print(line + f" | {card}", flush=True)
        if not same:
            raise SystemExit(f"phase 13(b) shade_bounce {case} bounce {b} "
                             f"(sums {fold}): the kernel differs from its "
                             "plain version")

    night = matrix_configs()[3]
    night_cfg = dataclasses.replace(night.config, width=NIGHT_SIZE[0],
                                    height=NIGHT_SIZE[1], samples_per_pixel=1)
    night_scene = night.world.extract(device=dev)
    night_cam = night.world.camera_state(aspect=night.aspect, device=dev)
    level1 = dataclasses.replace(brute5, level=1)
    (ids, u, v), _ = capture_states(scene, cam, headline, dev)
    n_head = ids.shape[0]
    half = n_head // 2
    hold_raygen("headline, the frame's pixels folding into its sums", n_head,
                0, None, None, cam, headline, 0, time_it=True, fold="zero")
    hold_raygen("headline", n_head, ids, u, v, cam, headline, 0)
    hold_raygen("headline at sample 3, the frame's pixels, sums in place",
                n_head, 0, None, None, cam, headline, 3, fold="self")
    hold_raygen(f"headline, first {ODD_LANES} lanes", ODD_LANES,
                ids[:ODD_LANES], u[:ODD_LANES], v[:ODD_LANES], cam, headline,
                0)
    hold_raygen(f"headline, first {ODD_LANES} lanes by index", ODD_LANES, 0,
                None, None, cam, headline, 0, fold="zero")
    hold_raygen("headline, second half at sample 5", n_head - half,
                ids[half:], u[half:], v[half:], cam, headline, 5)
    hold_raygen("headline, second half at sample 5 by index, a film's sums",
                n_head - half, half, None, None, cam, headline, 5,
                fold="film")
    (n_ids, n_u, n_v), _ = capture_states(night_scene, night_cam, night_cfg,
                                          dev)
    hold_raygen("night scene (lens)", n_ids.shape[0], n_ids, n_u, n_v,
                night_cam, night_cfg, 0)
    hold_raygen("night scene (lens) by index", n_ids.shape[0], 0, None, None,
                night_cam, night_cfg, 0, fold="zero")
    shade_cases = [
        ("headline", scene, cam, headline, {}),
        ("config 5", scene5, cam5, brute5, {}),
        ("config 5 at level 1", scene5, cam5, level1, {}),
        ("cube field", scene_f, cam_f, config5, {}),
        (f"{big.n_spheres} spheres bvh", big_scene, big_cam, big_cfg, {}),
        ("night scene (lens, emission, cosine)", night_scene, night_cam,
         night_cfg, {}),
        (f"headline, first {ODD_LANES} lanes", scene, cam, headline,
         dict(lanes=ODD_LANES)),
    ]
    for case, scn, camera, config, kw in shade_cases:
        # The headline at every bounce, the others at SHADE_BOUNCES.
        bounces = (tuple(range(config.bounces + 1)) if case == "headline"
                   else SHADE_BOUNCES)
        _, states = capture_states(scn, camera, config, dev,
                                   bounces=bounces)
        for b in bounces:
            folds = ((None, "film", "zero", "self") if b == config.bounces
                     else (None, "self"))
            for fold in folds:
                head = case == "headline" and fold == "self"
                hold_shade(case, states[b], scn, config, b,
                           time_it=head and b == 0, fold=fold, **kw)
            if case == "headline" and b == config.bounces:
                # The last bounce as a frame's later samples run it,
                # printed beside its bound (the entry's time is bounce 0's).
                state, t, idx, tt, ti = states[b]
                args = (b, t, idx, tt, ti, scn, config)
                (g_sums, _), _ = fold_pair(t.numel(), "self", b)
                ms = shade_ms(lambda st, *a: bounce_mod.shade_bounce(
                    st, *a, g_sums, g_sums), state, args, WAVE_REPS)
                after = clone_state(state)
                bounce_mod.shade_bounce(after, *args)
                b_ms, b_by = shade_bound(state, after, t, tt, b, True, scn,
                                         "self")
                print(f"phase 13(b) shade_bounce headline last bounce {b}, "
                      f"sums in place: kernel {ms:.4f} ms, bound {b_ms:.4f} "
                      f"ms ({b_by}) | {card}", flush=True)
        if case == "headline":
            # K6 at every bounce of the headline beside its bound, and
            # its probe instance there (each held to the default
            # instance and the plain version).
            shade_rows = shade_probe_rows(scn, config, states, card)
            print(f"phase 13(b) shade_bounce headline by bounce (ms, bound "
                  f"ms, live lanes): "
                  f"{[(r['ms'], r['bound_ms'], r['live']) for r in shade_rows]}"
                  f"; a sample's {sum(r['ms'] for r in shade_rows):.4f} ms "
                  f"against {sum(r['bound_ms'] for r in shade_rows):.4f} | "
                  f"{card}", flush=True)
        del states
    print(f"phase 13(b) K5 and K6 instances: "
          f"{json.dumps({k: v for k, v in wavefront_mod.kernel_info(dev, 1).items() if k.startswith(tuple(BOUNCE_REPLACES))})}"
          f"; ptxas -v of K6: "
          f"{json.dumps(ptxas_usage(BOUNCE_SOURCE, ('shade_kernel',)))}"
          f" | {card}", flush=True)

    # (c) Host waits for the card over each frame's work.
    rounds = [
        ("Renderer brute (headline, 1 spp)", lambda: Renderer(
            dataclasses.replace(headline, samples_per_pixel=1)).render(
                scene, cam, seed=2)),
        (f"Renderer bvh ({big.n_spheres} spheres)",
         lambda: Renderer(big_cfg).render(big_scene, big_cam, seed=2)),
        ("Renderer mesh brute (config 5)", lambda: Renderer(brute5).render(
            scene5, cam5, seed=2, raster_color=rc, raster_depth=rd)),
        ("Renderer mesh bvh (config 5)", lambda: Renderer(bvh5).render(
            scene5, cam5, seed=2, raster_color=rc, raster_depth=rd)),
    ]
    fused5 = FusedRenderer(config5)
    fused5.render(scene5, cam5, seed=0, raster_color=rc, raster_depth=rd)

    def config5_round():
        rc2, rd2 = raster_layer(world5, cam5, config5, device=dev)
        return fused5.render(scene5, cam5, seed=2, raster_color=rc2,
                             raster_depth=rd2)

    rounds.append(("config 5 round (raster_layer + FusedRenderer)",
                   config5_round))
    waits = {}
    for name, fn in rounds:
        torch.cuda.synchronize()
        sites = []
        with host_syncs(dev, sites):
            fn()
        torch.cuda.synchronize()
        waits[name] = sorted(set(sites))
        print(f"phase 13(c) host waits for the card, {name}: "
              f"{', '.join(waits[name]) or 'none'}", flush=True)
    if any(waits.values()):
        raise SystemExit("phase 13(c): a frame's host work waited for the "
                         "card")

    # (d) The kernels of wavefront frames, by torch's profiler, each frame
    # in a child process of its own (PROFILE_CHILD) and held to the
    # wrappers' launches in it: a 1-spp headline frame is K12, K5, 5 x K1,
    # 5 x K6 and K10; a short profile fails the run. Then a 1-spp tp = 2
    # headline frame (mesh (1, 1, 2), the wavefront sharded step), and
    # the same frame with the plain merge patched in (the torch ops that
    # K16 replaced). The card's busy time (the kernels' summed durations)
    # against the frame's time unprofiled, here: the rest is the card
    # waiting for launches.
    one_cfg = dataclasses.replace(headline, samples_per_pixel=1)
    one = Renderer(one_cfg)
    one.render(scene, cam, seed=3)
    _, one_ms = timed(frame_of(one, scene, cam))
    tp_mesh = make_mesh(1, 1, 2, devices=["cuda:0"] * 2)

    def tp_frame():
        return render_frame_sharded(tp_mesh, scene, cam, one_cfg, 3)

    tp_frame()
    _, tp_ms = timed(lambda seed: tp_frame())
    prof = {which: profile_child(which, headline.width, headline.height,
                                 SPP, BOUNCES)
            for which in ("headline", "full", "tp", "tp_plain_merge")}
    for which in ("headline", "full", "tp"):
        got = prof[which]
        if got["kernels"] != sum(got["launches"].values()):
            raise SystemExit(f"phase 13(d): the profile of the {which} frame "
                             f"holds {got['kernels']} kernels; the wrappers "
                             f"launched {got['launches']}")
    head = prof["headline"]
    want = {"camera_rows": 1, "raygen_sample": 1,
            "intersect_spheres": BOUNCES + 1, "shade_bounce": BOUNCES + 1,
            "resolve_frame": 1}
    if head["launches"] != want or head["kernels"] != sum(want.values()):
        raise SystemExit(f"phase 13(d): a 1-spp headline frame launched "
                         f"{head['launches']} ({head['kernels']} kernels "
                         f"profiled), not {want}")
    k6_ms = sum(ms for _, ms, name in head["by_kernel"]
                if "shade_kernel" in name)
    busy_ms = head["busy_ms"]
    print(f"phase 13(d) a 1-spp headline frame ({BOUNCES} bounces, "
          f"profiled in a process of its own): {head['kernels']} kernels on "
          f"the card, equal to the wrappers' launches {head['launches']}; "
          f"the card busy {busy_ms:.3f} ms of the unprofiled frame's "
          f"{one_ms:.3f} ms (idle share {1 - busy_ms / one_ms:.1%}), K6 "
          f"{k6_ms:.4f} ms of it ({k6_ms / busy_ms:.1%}); the {SPP} spp "
          f"frame {prof['full']['kernels']} kernels, busy "
          f"{prof['full']['busy_ms']:.3f} ms; by kernel (count, ms, name): "
          f"{head['by_kernel']} | {card}", flush=True)
    tp, plain_tp = prof["tp"], prof["tp_plain_merge"]
    print(f"phase 13(d) a 1-spp headline frame on mesh (1, 1, 2) ({BOUNCES} "
          f"bounces): {tp['kernels']} kernels on the card (the wrappers' "
          f"launches {tp['launches']}), busy {tp['busy_ms']:.3f} ms of the "
          f"unprofiled frame's {tp_ms:.3f} ms (idle share "
          f"{1 - tp['busy_ms'] / tp_ms:.1%}); with the plain merge patched "
          f"in {plain_tp['kernels']} kernels, busy "
          f"{plain_tp['busy_ms']:.3f} ms; by kernel (count, ms, name): "
          f"{tp['by_kernel']} | {card}", flush=True)
    if not 0 < tp["kernels"] < plain_tp["kernels"]:
        raise SystemExit("phase 13(d): the tp frame runs no fewer kernels "
                         "than with the plain merge")

    entries = []
    for name, fn in kernels.items():
        ms, plain_ms, (b_ms, b_by), case = timing[name]
        print(f"phase 13 {name}: {case}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), launches "
              f"on the main path {launches[name]} | {card}", flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": BOUNCE_SOURCE if name in BOUNCE_REPLACES else WAVE_SOURCE,
            "replaces": {**WAVE_REPLACES, **BOUNCE_REPLACES}[name],
            "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # No single PyTorch call computes a nearest-hit ray test, a
            # sample's ray generation or a bounce's shading.
            "library_ms": None})
    print(f"phase 13 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def wave_bound(name, args, o, n_active, work) -> tuple:
    """(ms, "operations" | "bytes", issue ms, pairs): the least time the
    card could take for one call of kernel ``name``: the tests this call's
    active rays need (the dense tests: every valid row; the walks: the box
    and prim tests that the plain walk counted) over the fp32 peak, or its
    bytes (each ray and table row read once, each (t, index) written once)
    over the memory rate; for a dense test also the operations at the
    ``--fmad=false`` issue rate and its (ray, row) pairs, else None."""
    n = o.x.shape[0]
    table = args[0]
    rows = table.valid.numel()
    if name == "intersect_spheres":
        ops = SPHERE_TEST_OPS * n_active * int(table.valid.sum())
    elif name == "intersect_triangles":
        ops = TRIANGLE_TEST_OPS * n_active * int(table.valid.sum())
    else:
        leaf = (SPHERE_TEST_OPS if name == "intersect_bvh"
                else TRIANGLE_TEST_OPS)
        ops = SLAB_TEST_OPS * work["slab_tests"] + leaf * work["leaf_tests"]
    table_key = ("intersect_spheres" if name in ("intersect_spheres",
                                                 "intersect_bvh")
                 else "intersect_triangles")
    n_bytes = n * RAY_BYTES + rows * ROW_BYTES[table_key]
    if name.startswith("intersect_bvh"):
        n_bytes += args[1].min_x.numel() * ROW_BYTES["bvh_node"]
    by_ops, by_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound = ((by_ops, "operations") if by_ops >= by_bytes
             else (by_bytes, "bytes"))
    if name not in ("intersect_spheres", "intersect_triangles"):
        return bound + (None, None)
    return bound + (ops / ISSUE_RATE * 1e3, n_active * int(table.valid.sum()))


def image_phase(card, dev, raster_launches, denoise_inputs,
                denoise_launches) -> list:
    """Phase 14: the image kernels against their plain versions on the
    same CUDA tensors, every output compared as bits. K7 ``atrous_pass``
    (csrc/denoise.cu, through ``engine.denoise.atrous_denoise``) on 10(d)'s
    frame and depth at 0, 1, 3 and 5 iterations, at an odd size, at sizes
    where the stride rule ends the filter after 1 and 2 iterations (least
    side 4 and 8), and on a depth with a band of misses at the far
    fallback, each with its launch count. K8 ``raster_rays`` and K9
    ``raster_shade`` (csrc/raster.cu, through ``engine.raster``) on config
    5's camera at 1280x720 and 1920x1080, the kitchen-sink world at level
    2, a rotated raster cube and a view in which every pixel misses: K8's
    rays against ``raster_rays_reference``, K9 on K2's hits against
    ``raster_shade_reference``, and the whole ``rasterize_impl`` against
    ``rasterize_impl_reference``. Then each kernel's time by CUDA events
    at 1280x720 and 1920x1080 beside its bound and its plain version's
    time. Returns the kernels-line entries; their launches are phase 6's
    (K8, K9) and 10(d)'s (K7)."""
    import numpy as np
    import torch

    import bevyray_tpu_torch as port
    from bevyray_tpu_torch.core.types import make_triangles_np, upload
    from bevyray_tpu_torch.engine import denoise, raster
    from bevyray_tpu_torch.kernels import intersect
    from bevyray_tpu_torch.kernels.camera import camera_rows
    from bevyray_tpu_torch.kernels.cuda.build import extension

    t_phase = time.perf_counter()
    max_err = dict.fromkeys(IMAGE_REPLACES, 0.0)

    def check_bits(name, label, got, want):
        for g, w in zip(got, want):
            w = w.expand_as(g).contiguous()
            err = float((g - w).abs().nan_to_num(0.0).max()) if g.numel() else 0.0
            max_err[name] = max(max_err[name], err)
            if g.shape != w.shape or not torch.equal(g.view(torch.int32),
                                                     w.view(torch.int32)):
                raise SystemExit(f"phase 14 {name} {label}: not bit-equal to "
                                 f"its plain version (max |d| {err})")

    def host_ms(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    # K7 on the CLI's frame and on seeded inputs.
    rng = np.random.default_rng(14)

    def seeded(h, w, misses=False):
        image = rng.random((h, w, 3), dtype=np.float32)
        depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
        depth[:, w // 2:] += 30.0
        if misses:
            depth[h // 3:h // 2] = 999.0
        return (torch.as_tensor(image, device=dev),
                torch.as_tensor(depth, device=dev))

    frame_image, frame_depth = denoise_inputs
    cases = [(f"10(d)'s frame {tuple(frame_image.shape[:2])}", frame_image,
              frame_depth, it) for it in (0, 1, 3, 5)]
    cases += [(f"odd {ODD_IMAGE}", *seeded(*ODD_IMAGE), 3),
              ("least side 4 (4, 9)", *seeded(4, 9), 3),
              ("least side 8 (11, 8)", *seeded(11, 8), 3),
              ("far-fallback misses (72, 128)", *seeded(72, 128, True), 3)]
    for label, image, depth, iterations in cases:
        h, w = image.shape[:2]
        runs = 0   # the iterations that the stride rule lets run
        while runs < iterations and 2 * (1 << runs) < min(h, w):
            runs += 1
        before = denoise.atrous_denoise.launches
        got = denoise.atrous_denoise(image, depth, iterations=iterations)
        launches = denoise.atrous_denoise.launches - before
        want = denoise.atrous_denoise_reference(image, depth,
                                                iterations=iterations)
        torch.cuda.synchronize()
        if launches != runs or (runs == 0 and got is not image):
            raise SystemExit(f"phase 14 atrous_pass {label}: {launches} "
                             f"launches for {runs} iterations that run")
        check_bits("atrous_pass", label, [got], [want])
        print(f"phase 14 atrous_pass {label}, {iterations} iterations: "
              f"{launches} launches, bit-equal", flush=True)

    # K8 and K9: config 5's camera at two sizes, the kitchen sink at level
    # 2, a rotated raster cube and an all-miss view.
    world5, config5 = config5_world()
    rotated = golden_world(port, "cube")
    rotated.spawn_raster_mesh(
        port.Transform.from_xyz(1.3, 0.4, 0.5).with_rotation(
            port.Transform.rotation_axis_angle((1.0, 1.0, 0.0), 0.7)),
        port.cube_mesh(0.6),
        port.StandardMaterial(base_color=(0.9, 0.6, 0.2), metallic=1.0,
                              perceptual_roughness=0.3, reflectance=0.8))
    away = golden_world(port, "cube")
    away.set_camera(port.Transform.from_xyz(0.0, 1.0, 4.0).looking_at(
        (0.0, 1.5, 9.0)))
    views = [(f"config 5 {w}x{h}", world5,
              dataclasses.replace(config5, width=w, height=h))
             for w, h in RASTER_SIZES]
    views += [("kitchen sink level 2", golden_world(port, "kitchen_sink"),
               port.RenderConfig(640, 360, 1, 1, level=2)),
              ("rotated raster cube", rotated,
               port.RenderConfig(640, 360, 1, 1, level=1)),
              ("all pixels miss", away,
               port.RenderConfig(640, 360, 1, 1, level=1))]
    clear = (1.0, 1.0, 1.0)
    timing = {}
    for label, world, config in views:
        cam = world.camera_state(aspect=config.width / config.height,
                                 device=dev)
        va, vb, vc, colors = world.extract_raster_host()
        tris = make_triangles_np(va, vb, vc, np.zeros(va.shape[0], np.int32),
                                 capacity=va.shape[0], device=dev)
        colors = upload(colors, dev)
        row = camera_rows(cam, config, fused=False, wavefront=True).wavefront
        origin, direction = raster.raster_rays(row, config)
        p_origin, p_direction = raster.raster_rays_reference(cam, config, dev)
        check_bits("raster_rays", label, [*origin, *direction],
                   [*p_origin, *p_direction])
        t, idx = intersect.intersect_triangles(origin, direction, tris)
        color, depth = raster.raster_shade(t, idx, direction, tris, colors,
                                           row, cam.near, clear)
        p_color, p_depth = raster.raster_shade_reference(
            t, idx, direction, tris, colors, cam, clear)
        check_bits("raster_shade", label, [*color, depth],
                   [*p_color, p_depth])
        got = raster.rasterize_impl(tris, colors, cam, config, clear)
        want = raster.rasterize_impl_reference(tris, colors, cam, config,
                                               clear)
        check_bits("raster_shade", label + " (whole call)",
                   [*got[0], got[1]], [*want[0], want[1]])
        hits = int((depth > 0).sum())
        if (hits == 0) != (label == "all pixels miss"):
            raise SystemExit(f"phase 14 {label}: {hits} raster hits")
        print(f"phase 14 raster_rays, raster_shade {label}: bit-equal, "
              f"{hits} of {config.width * config.height} pixels hit "
              f"{va.shape[0]} triangles", flush=True)
        if label.startswith("config 5"):
            n = config.width * config.height
            shade = lambda: raster.raster_shade(   # noqa: E731
                t, idx, direction, tris, colors, row, cam.near, clear)
            timing[(config.width, config.height)] = {
                "raster_rays": (
                    cuda_ms(lambda: raster.raster_rays(row, config),
                            IMAGE_REPS),
                    host_ms(lambda: raster.raster_rays_reference(
                        cam, config, dev)),
                    n * RAYS_PIXEL_BYTES + 4 * len(row),
                    n * RASTER_RAYS_OPS),
                "raster_shade": (
                    cuda_ms(shade, IMAGE_REPS),
                    host_ms(lambda: raster.raster_shade_reference(
                        t, idx, direction, tris, colors, cam, clear)),
                    n * SHADE_PIXEL_BYTES + hits * SHADE_HIT_BYTES
                    + va.shape[0] * SHADE_ROW_BYTES,
                    hits * RASTER_SHADE_OPS)}

    # K7's time at each size: a 3-iteration call (the CLI's), per launch.
    for w, h in RASTER_SIZES:
        image, depth = ((frame_image, frame_depth)
                        if tuple(frame_image.shape[:2]) == (h, w)
                        else seeded(h, w, True))
        call = lambda: denoise.atrous_denoise(   # noqa: E731
            image, depth, iterations=CLI_DENOISE)
        call()
        one_ms = cuda_ms(lambda: denoise.atrous_denoise(image, depth,
                                                        iterations=1),
                         IMAGE_REPS)
        call_ms = cuda_ms(call, IMAGE_REPS)
        plain_call = host_ms(lambda: denoise.atrous_denoise_reference(
            image, depth, iterations=CLI_DENOISE))
        timing[(w, h)]["atrous_pass"] = (
            call_ms / CLI_DENOISE, plain_call / CLI_DENOISE,
            w * h * ATROUS_PIXEL_BYTES, w * h * ATROUS_PIXEL_OPS)
        print(f"phase 14 atrous_pass {w}x{h}: a {CLI_DENOISE}-iteration call "
              f"{call_ms:.4f} ms ({call_ms / CLI_DENOISE:.4f} a launch), "
              f"iteration 1 alone {one_ms:.4f} ms; the plain call "
              f"{plain_call:.3f} ms; an iteration's bound "
              f"{w * h * ATROUS_PIXEL_OPS / PEAK_FP32 * 1e3:.4f} ms "
              f"(operations; {w * h * ATROUS_PIXEL_OPS / ISSUE_RATE * 1e3:.4f}"
              f" at the issue rate), bytes "
              f"{w * h * ATROUS_PIXEL_BYTES / PEAK_BYTES * 1e3:.4f} ms | {card}",
              flush=True)

    info = extension().image_info(dev.index or 0)
    launches = {"atrous_pass": denoise_launches, **raster_launches}
    entries = []
    for name in IMAGE_REPLACES:
        for size in RASTER_SIZES:
            ms, plain_ms, n_bytes, ops = timing[size][name]
            by_ops, by_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
            b_ms, b_by = ((by_ops, "operations") if by_ops >= by_bytes
                          else (by_bytes, "bytes"))
            print(f"phase 14 {name} {size[0]}x{size[1]}: kernel {ms:.4f} ms "
                  f"a launch, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}; the other {min(by_ops, by_bytes):.4f}), "
                  f"{json.dumps(dict(info[name]))}, launches on the main "
                  f"path {launches[name]}, max |d| {max_err[name]} | {card}",
                  flush=True)
            if size == RASTER_SIZES[0]:   # the main path's (10(d), phase 6)
                entry = {
                    "name": name, "route": "cuda",
                    "source": IMAGE_SOURCES[name],
                    "replaces": IMAGE_REPLACES[name],
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by,
                    # No single PyTorch call computes a bilateral a-trous
                    # pass, a frame's centre rays or Bevy's ambient shade.
                    "library_ms": None}
        entries.append(entry)
    print(f"phase 14 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def tail_phase(world, scene, cam, headline, card, dev) -> list:
    """Phase 15: K10 ``resolve_frame`` and K11 ``fold_pass``
    (csrc/frame.cu, through ``kernels.frame``) against their plain versions
    on the same CUDA tensors, every output compared as bits, with one
    launch a call: K10 on the fused headline's tail (block order, means,
    level 3), the wavefront headline's sums (row-major, 1/spp), BASELINE
    config 4's film after two passes (a count a frame) and a fresh film
    (count 0), an ``AdaptiveFilm`` fresh and after three passes (a count a
    pixel), config 5's fused and wavefront sums at levels 2, 1 and 0 over
    its raster layer (a value a pixel), and ODD_IMAGE's fused and wavefront
    sums at every level over white, over a raster layer of one value and of
    one a pixel; K11 on config 4's second film pass (the film unchanged)
    and at ODD_IMAGE. Each kernel's time by CUDA events beside its bound
    (bytes) and its plain version's time, and the kernels and busy time of
    a fused headline frame and of a config-4 film pass (torch's profiler).
    Returns the kernels-line entries; their launches are the main-path
    runs' (phases 3, 5 and 13(a))."""
    import numpy as np
    import torch

    from bevyray_tpu_torch import (AdaptiveRenderer, FusedRenderer,
                                   ProgressiveRenderer, RenderConfig)
    from bevyray_tpu_torch.bench.matrix import matrix_configs
    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.engine import film as film_mod
    from bevyray_tpu_torch.engine import renderer as renderer_mod
    from bevyray_tpu_torch.engine.raster import raster_layer
    from bevyray_tpu_torch.kernels import frame as frame_mod
    from bevyray_tpu_torch.kernels.bounce import new_state, new_sums
    from bevyray_tpu_torch.kernels.cuda.build import extension
    from bevyray_tpu_torch.kernels.cuda.megakernel import render_tiles

    t_phase = time.perf_counter()
    max_err = dict.fromkeys(TAIL_REPLACES, 0.0)
    timing = {}

    def bits(got, want) -> tuple:
        """(max |d| where both are numbers, every tensor bit-equal)."""
        err, same = 0.0, True
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                same = same and g.shape == w.shape and torch.equal(
                    g.view(torch.int32), w.view(torch.int32))
                d = (g - w).abs()
                d = d[~torch.isnan(d)]
                if d.numel():
                    err = max(err, float(d.max()))
            else:
                same = same and torch.equal(g, w)
        return err, same

    def tail_bytes(config, camera, scale, rc, rd, depth) -> int:
        """K10's bytes: each input byte read once and each output byte
        written once, the raster colour where the raster layer wins."""
        n = config.n_pixels
        n_bytes = n * TAIL_PIXEL_BYTES + 8
        if isinstance(scale, torch.Tensor):
            n_bytes += 4 * scale.numel()
        wins = n if config.level == 0 else 0
        if config.level in (1, 2):
            rdv = (torch.zeros((), device=dev) if rd is None else rd)
            n_bytes += 4 * rdv.numel()
            t = depth.reshape(-1)
            rz = torch.where(t > camera.far, -1.0, camera.near / t)
            wins = int((rdv > rz).sum())
        if rc is not None:
            n_bytes += sum(4 * (wins if c.numel() > 1 else 1) for c in rc)
        return n_bytes

    def hold_resolve(case, config, camera, sums, scale=None, rc=None,
                     rd=None, blocks=False, time_it=False):
        args = (config, camera.near, camera.far, sums, scale, rc, rd, blocks)
        before = frame_mod.resolve_frame.launches
        got = frame_mod.resolve_frame(*args)
        launched = frame_mod.resolve_frame.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = frame_mod.resolve_frame_reference(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, same = bits(got, want)
        max_err["resolve_frame"] = max(max_err["resolve_frame"], err)
        kind = ("none" if scale is None else f"{scale:.6g}"
                if isinstance(scale, float)
                else f"count {'a pixel' if scale.numel() > 1 else 'a frame'}")
        raster = ("white" if rc is None else
                  "a value a pixel" if rc[0].numel() > 1 else "one value")
        line = (f"phase 15 resolve_frame {case}: {config.width}x"
                f"{config.height} level {config.level}, "
                f"{'block order' if blocks else 'row-major'}, scale {kind}, "
                f"raster {raster}: max |d| {err:.3g}, bit-equal {same}")
        if time_it:
            ms = cuda_ms(lambda: frame_mod.resolve_frame(*args), TAIL_REPS)
            bound = (tail_bytes(config, camera, scale, rc, rd, want[1])
                     / PEAK_BYTES * 1e3, "bytes")
            timing.setdefault("resolve_frame", (ms, plain_ms, bound, case))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
        print(line + f" | {card}", flush=True)
        if not same or launched != 1:
            raise SystemExit(f"phase 15 resolve_frame {case}: {launched} "
                             "launches, or the kernel differs from its plain "
                             "version")

    def hold_fold(case, config, film, pass_sums, segs, time_it=False):
        args = (film.color_sum, film.depth_sum, film.n_samples,
                film.rays_traced, pass_sums, segs, config)
        old = [*film.color_sum, film.depth_sum, film.n_samples,
               film.rays_traced]
        kept = [x.clone() for x in old]
        before = frame_mod.fold_pass.launches
        got = frame_mod.fold_pass(*args)
        launched = frame_mod.fold_pass.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = frame_mod.fold_pass_reference(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, same = bits((*got[0], *got[1:]), (*want[0], *want[1:]))
        untouched = bits(old, kept)[1]
        max_err["fold_pass"] = max(max_err["fold_pass"], err)
        line = (f"phase 15 fold_pass {case}: {config.width}x{config.height}, "
                f"{config.samples_per_pixel} spp: max |d| {err:.3g}, "
                f"bit-equal {same}, the old film unchanged {untouched}, "
                f"count {float(got[2]):g}, segments {int(got[3])}")
        if time_it:
            ms = cuda_ms(lambda: frame_mod.fold_pass(*args), TAIL_REPS)
            bound = ((config.n_pixels * FOLD_PIXEL_BYTES + 24)
                     / PEAK_BYTES * 1e3, "bytes")
            timing.setdefault("fold_pass", (ms, plain_ms, bound, case))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
        print(line + f" | {card}", flush=True)
        if not (same and untouched) or launched != 1:
            raise SystemExit(f"phase 15 fold_pass {case}: {launched} "
                             "launches, or the kernel differs from its plain "
                             "version, or it changed the old film")
        return film_mod.Film(*got)

    def fused_sums(config, scn, camera, normalize=True, sample_offset=0):
        renderer = FusedRenderer(config)
        kscene = renderer.prepare(scn)
        sl, slmeta = renderer.shortlists(kscene, camera)
        return render_tiles(kscene, camera, config, 1, sl=sl, slmeta=slmeta,
                            normalize=normalize, sample_offset=sample_offset)

    def wave_sums(config, scn, camera):
        """A wavefront frame's sums, folded as ``render_impl`` folds them."""
        n = config.n_pixels
        state, sums = new_state(n, camera, config, dev), new_sums(n, dev)
        for i in range(config.samples_per_pixel):
            renderer_mod.trace_sample(scn, camera, config, 0, None, None, i,
                                      1, state=state, sums=sums,
                                      base=sums if i else None)
        return (*sums.color, sums.depth)

    def inv_spp(config):
        return float(np.float32(1.0 / config.samples_per_pixel))

    def seeded(n, seed, scale=1.0):
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.random(n, dtype=np.float32) * scale,
                               device=dev)

    print(f"phase 15 K10 and K11 instances: "
          f"{json.dumps(extension().frame_info(dev.index or 0))} | {card}",
          flush=True)

    # The fused and the wavefront headline.
    hold_resolve("fused headline", headline, cam,
                 fused_sums(headline, scene, cam)[:4], blocks=True,
                 time_it=True)
    hold_resolve("wavefront headline", headline, cam,
                 wave_sums(headline, scene, cam), inv_spp(headline),
                 time_it=True)

    # BASELINE config 4's film: a pass folded by K11, then resolved.
    night = matrix_configs()[3]
    cfg4 = night.config
    scene4 = night.world.extract(device=dev)
    cam4 = night.world.camera_state(aspect=night.aspect, device=dev)
    fresh = film_mod.new_film(cfg4, dev)
    hold_resolve("config 4, a fresh film (count 0)", cfg4, cam4,
                 (*fresh.color_sum, fresh.depth_sum), fresh.n_samples)
    r, g, b, d, segs = fused_sums(cfg4, scene4, cam4, normalize=False)
    film = hold_fold("config 4 film, pass 1", cfg4, fresh, (r, g, b, d),
                     segs)
    r, g, b, d, segs = fused_sums(cfg4, scene4, cam4, normalize=False,
                                  sample_offset=cfg4.samples_per_pixel)
    film = hold_fold("config 4 film, pass 2", cfg4, film, (r, g, b, d), segs,
                     time_it=True)
    hold_resolve("config 4 film after 2 passes", cfg4, cam4,
                 (*film.color_sum, film.depth_sum), film.n_samples,
                 time_it=True)

    # An adaptive film: a count a pixel, 0 before its first pass.
    adap = AdaptiveRenderer(headline, tolerance=TOLERANCE,
                            reprobe_every=REPROBE_EVERY)
    hold_resolve("a fresh adaptive film (counts 0)", headline, cam,
                 (*adap.film.color_sum, adap.film.depth_sum),
                 adap.film.n_samples)
    for seed in range(1, 4):
        adap.step(scene, cam, seed=seed)
    counts = adap.film.n_samples
    hold_resolve(f"adaptive film after 3 passes (counts "
                 f"{float(counts.min()):g}-{float(counts.max()):g})",
                 headline, cam, (*adap.film.color_sum, adap.film.depth_sum),
                 counts, time_it=True)

    # Config 5: a raster layer of a value a pixel at levels 2, 1 and 0.
    world5, config5 = config5_world()
    cam5 = world5.camera_state(aspect=HYBRID_SIZE[0] / HYBRID_SIZE[1],
                               device=dev)
    scene5 = world5.extract(device=dev)
    rc5, rd5 = raster_layer(world5, cam5, config5, device=dev)
    fused5 = fused_sums(config5, scene5, cam5)[:4]
    wave5 = wave_sums(config5, scene5, cam5)
    for level in (2, 1, 0):
        cfg = dataclasses.replace(config5, level=level)
        hold_resolve("config 5 fused", cfg, cam5, fused5, rc=rc5, rd=rd5,
                     blocks=True, time_it=level == 2)
        hold_resolve("config 5 wavefront", cfg, cam5, wave5,
                     inv_spp(config5), rc=rc5, rd=rd5)

    # ODD_IMAGE: off every block, every level, three raster layers.
    w, h = ODD_PIXELS
    odd = RenderConfig(w, h, 4, BOUNCES, level=3)
    cam_odd = world.camera_state(aspect=w / h)
    fused_odd = fused_sums(odd, scene, cam_odd)[:4]
    wave_odd = wave_sums(odd, scene, cam_odd)
    one = Vec3(*(torch.tensor(v, device=dev) for v in (0.25, 0.5, 0.75)))
    per_pixel = Vec3(*(seeded(w * h, k) for k in range(3)))
    rd_pixel = seeded(w * h, 3, 1.2) - 0.1
    rd_pixel[3::19] = float("nan")
    layers = ((None, None), (one, torch.tensor(0.02, device=dev)),
              (per_pixel, rd_pixel))
    for level in range(4):
        cfg = dataclasses.replace(odd, level=level)
        for rc, rd in layers:
            hold_resolve(f"ODD_IMAGE {ODD_IMAGE} fused", cfg, cam_odd,
                         fused_odd, rc=rc, rd=rd, blocks=True)
            hold_resolve(f"ODD_IMAGE {ODD_IMAGE} wavefront", cfg, cam_odd,
                         wave_odd, inv_spp(odd), rc=rc, rd=rd)
    film_odd = film_mod.Film(
        Vec3(*(seeded(w * h, 10 + k, 8.0) for k in range(3))),
        seeded(w * h, 13, 50.0), torch.tensor(8.0, device=dev),
        torch.tensor(1234, dtype=torch.int64, device=dev))
    r, g, b, d, segs = fused_sums(odd, scene, cam_odd, normalize=False)
    hold_fold(f"ODD_IMAGE {ODD_IMAGE}", odd, film_odd, (r, g, b, d), segs)

    # What a fused headline frame and a config-4 film pass run on the card.
    fused = FusedRenderer(headline)
    n_kernels, busy, by_name = profiled(
        lambda: fused.render(scene, cam, seed=3))
    print(f"phase 15 a fused headline frame: {n_kernels} kernels on the "
          f"card, busy {busy:.3f} ms; by kernel (count, ms, name): "
          f"{by_name} | {card}", flush=True)
    prog = ProgressiveRenderer(cfg4, backend="pallas")
    n_kernels, busy, by_name = profiled(
        lambda: prog.step(scene4, cam4, seed=3))
    print(f"phase 15 a config-4 film pass and its resolve: {n_kernels} "
          f"kernels on the card, busy {busy:.3f} ms; by kernel (count, ms, "
          f"name): {by_name} | {card}", flush=True)

    entries = []
    for name in TAIL_REPLACES:
        ms, plain_ms, (b_ms, b_by), case = timing[name]
        print(f"phase 15 {name}: {case}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), launches on "
              f"the main path {TAIL_LAUNCHES[name]} | {card}", flush=True)
        entries.append({
            "name": name, "route": "cuda", "source": TAIL_SOURCE,
            "replaces": TAIL_REPLACES[name],
            "launches": TAIL_LAUNCHES[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            # No single PyTorch call un-shuffles, scales and composites a
            # frame's sums, or folds a block-ordered pass into a film.
            "library_ms": None})
    if min(TAIL_LAUNCHES[name] for name in TAIL_REPLACES) < 1:
        raise SystemExit(f"phase 15: a kernel of the path launched no time: "
                         f"{dict(TAIL_LAUNCHES)}")
    print(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def pass_phase(world, scene, cam, headline, card, dev) -> list:
    """Phase 16: K12 ``camera_rows`` (csrc/camera.cu, through
    ``kernels.camera``) and K13 ``adaptive_map``, K14 ``fold_adaptive``,
    K15 ``sum_shards`` and K16 ``merge_tp_hits`` (csrc/passes.cu, through
    ``kernels.passes``) against their plain versions on the same CUDA
    tensors, every output compared as bits, one launch a call (K15 two
    past 32 parts): K12 on the headline camera, the night scene's
    (BASELINE config 4: the lens) and config 5's at level 1, both rows;
    K13 and K14 on ADAPT_PASSES adaptive passes at the headline, the last a
    re-probe, each pass's map and fold (the old film unchanged) and the
    film carried on with the kernels'; K15 on the parts of a headline frame
    on each of K15_MESHES (fused; dp 2 and 4 add parts) and of WAVE_SIZE
    frames on mesh (2, 1, 2) and K15_LARGE (wavefront), caught on their way
    to the reduction, timed at K15_TIMED; K16 on the slices' hits of bounce
    0 of a 1-spp headline frame on mesh (1, 1, tp) for each of K16_TPS,
    caught on their way to the merge, timed at K16_TIMED, beside the torch
    stack, min and gather that give its bits (its library call). Each
    kernel's time by CUDA events beside its bound and its plain version's
    time, and the kernels and busy time of an adaptive pass and of a mesh
    (3, 1) frame (torch's profiler). Returns the kernels-line entries;
    their launches are the main-path runs' (phases 3, 5, 8(b), 8(d) and
    13(a))."""
    import torch

    from bevyray_tpu_torch import AdaptiveRenderer, RenderConfig, rtiow
    from bevyray_tpu_torch.bench.matrix import matrix_configs
    from bevyray_tpu_torch.core.vec import Vec3
    from bevyray_tpu_torch.engine.adaptive import AdaptiveFilm
    from bevyray_tpu_torch.engine.film import begin_pass, trace_pass
    from bevyray_tpu_torch.core.constants import INF
    from bevyray_tpu_torch.kernels import camera, passes
    from bevyray_tpu_torch.kernels.cuda.build import extension
    from bevyray_tpu_torch.kernels.cuda.megakernel import TILE, block_grid
    from bevyray_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    max_err = dict.fromkeys(PASS_REPLACES, 0.0)
    timing, library_ms = {}, dict.fromkeys(PASS_REPLACES)

    def bits(got, want) -> tuple:
        """(max |d| where both are numbers, every tensor bit-equal)."""
        err, same = 0.0, True
        for g, w in zip(got, want):
            same = same and g.shape == w.shape and g.dtype == w.dtype
            if g.dtype == torch.float32:
                same = same and torch.equal(g.view(torch.int32),
                                            w.view(torch.int32))
                d = (g - w).abs()
                d = d[~torch.isnan(d)]
                if d.numel():
                    err = max(err, float(d.max()))
            else:
                same = same and torch.equal(g, w)
        return err, same

    def plain_ms_of(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def bound(n_bytes, ops=0) -> tuple:
        by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                                 "bytes")

    def hold(name, case, run, plain, n_bytes, ops=0, time_it=False,
             extra="", launches=1):
        """One call of K``name`` (``run``) against its plain version
        (``plain``), as bits, in ``launches`` launches; with ``time_it``
        its time and bound."""
        kernel = pass_kernels()[name]
        before = kernel.launches
        got = run()
        launched = kernel.launches - before
        torch.cuda.synchronize()
        want, p_ms = plain_ms_of(plain)
        err, same = bits(got, want)
        max_err[name] = max(max_err[name], err)
        line = (f"phase 16 {name} {case}: max |d| {err:.3g}, bit-equal "
                f"{same}{extra}")
        if time_it:
            ms = cuda_ms(run, PASS_REPS)
            b = bound(n_bytes, ops)
            timing.setdefault(name, (ms, p_ms, b, case))
            line += (f"; kernel {ms:.4f} ms, plain {p_ms:.2f} ms, bound "
                     f"{b[0]:.3g} ms ({b[1]})")
        print(line + f" | {card}", flush=True)
        if not same or launched != launches:
            raise SystemExit(f"phase 16 {name} {case}: {launched} launches "
                             f"(not {launches}), or the kernel differs from "
                             "its plain version")
        return got

    print(f"phase 16 K12-K16 instances: "
          f"{json.dumps(extension().passes_info(dev.index or 0))} | {card}",
          flush=True)

    # K12: the headline, the night scene's lens, config 5 at level 1.
    night = matrix_configs()[3]
    cam4 = night.world.camera_state(aspect=night.aspect, device=dev)
    world5, config5 = config5_world()
    cam5 = world5.camera_state(aspect=HYBRID_SIZE[0] / HYBRID_SIZE[1],
                               device=dev)
    for case, camera_, config, time_it in (
            ("headline", cam, headline, True),
            ("night (config 4, lens)", cam4, night.config, False),
            ("config 5 at level 1", cam5,
             dataclasses.replace(config5, level=1), False)):
        hold("camera_rows", case,
                    lambda c=camera_, k=config: camera.camera_rows(
                        c, k, True, True),
                    lambda c=camera_, k=config: camera.camera_rows_reference(
                        c, k, True, True),
                    CAMERA_BYTES, CAMERA_OPS, time_it,
                    f", tan(fov / 2) {float(camera.half_fov_tan(camera_.fov)):.9g}")
    # What bounds K12 in practice: a launch. An empty kernel (torch's
    # spin kernel for 0 cycles) timed as K12 is.
    print(f"phase 16 an empty kernel's launch, timed as the kernels are: "
          f"{cuda_ms(lambda: torch.cuda._sleep(0), PASS_REPS):.4f} ms | "
          f"{card}", flush=True)

    # K13 and K14: adaptive passes at the headline, the last a re-probe.
    adap = AdaptiveRenderer(headline, tolerance=TOLERANCE,
                            reprobe_every=ADAPT_REPROBE, device=dev)
    n = headline.n_pixels
    nbx, nby = block_grid(headline)
    lanes = nbx * nby * TILE
    for k in range(ADAPT_PASSES):
        kscene, sl, slmeta = begin_pass(adap, scene, cam)
        reprobe = adap._pass_count > 0 and (
            adap._pass_count % adap.reprobe_every == 0)
        film = adap.film
        case = f"pass {k + 1}{' (re-probe)' if reprobe else ''}"
        spp_map = hold(
            "adaptive_map", case,
            lambda f=film, r=reprobe: [passes.adaptive_map(
                f.err, TOLERANCE, r, headline)],
            lambda f=film, r=reprobe: [passes.adaptive_map_reference(
                f.err, TOLERANCE, r, headline)],
            n * MAP_PIXEL_BYTES + lanes * MAP_LANE_BYTES, time_it=k == 1,
            extra=f", {float((film.err >= TOLERANCE).float().mean()):.4f} "
                  "of pixels at or above the tolerance")
        color, depth, segs = trace_pass(kscene, cam, headline, k + 1,
                                        adap._sample_offset, sl, slmeta,
                                        spp_map[0], blocks=True)
        sums = (*color, depth)
        old = [*film.color_sum, film.depth_sum, film.n_samples, film.err,
               film.rays_traced]
        kept = [x.clone() for x in old]
        got = hold(
            "fold_adaptive", case,
            lambda f=film, r=reprobe: flat(passes.fold_adaptive(
                f, sums, segs, TOLERANCE, r, headline)),
            lambda f=film, r=reprobe: flat(passes.fold_adaptive_reference(
                f, sums, segs, TOLERANCE, r, headline)),
            n * ADAPT_PIXEL_BYTES + 24, time_it=k == 1)
        if not bits(old, kept)[1]:
            raise SystemExit(f"phase 16 fold_adaptive {case}: the old film "
                             "changed")
        adap.film = AdaptiveFilm(Vec3(*got[:3]), *got[3:])
        adap._sample_offset += headline.samples_per_pixel
        adap._pass_count += 1
    counts = adap.film.n_samples
    print(f"phase 16 after {ADAPT_PASSES} adaptive passes: samples a pixel "
          f"{float(counts.min()):g}-{float(counts.max()):g}, "
          f"{int(adap.film.rays_traced)} segments | {card}", flush=True)

    # K15: the parts of sharded frames, caught on their way in: the
    # headline on phase 8(b)'s meshes (3, 1), (2, 2) and (1, 4), the last two
    # adding 2 and 4 dp parts a lane, and the wavefront step on (2, 1, 2)
    # and on K15_LARGE's 36 and 40 parts.
    caught = []
    real = sharding.sum_shards

    def catch(parts, sp, dp, dev0):
        caught.append((parts, sp, dp, dev0))
        return real(parts, sp, dp, dev0)

    small = rtiow.final_scene(seed=42)
    small_scene = small.extract(with_bvh=False, device=dev)
    small_cam = small.camera_state(aspect=WAVE_SIZE[0] / WAVE_SIZE[1],
                                   device=dev)
    wave_cfg = RenderConfig(*WAVE_SIZE, SPP, BOUNCES, level=3)
    meshes = {(sp, dp): sharding.make_mesh(sp, dp,
                                           devices=["cuda:0"] * (sp * dp))
              for sp, dp in K15_MESHES}
    wave_meshes = [((2, 1, 2), wave_cfg)] + [
        ((sp, dp, tp), dataclasses.replace(wave_cfg, samples_per_pixel=spp))
        for sp, dp, tp, spp in K15_LARGE]
    sharding.sum_shards = catch
    try:
        for mesh in meshes.values():
            sharding.render_frame_sharded_pallas(mesh, scene, cam, headline, 1)
        for shape, config in wave_meshes:
            sharding.render_frame_sharded(
                sharding.make_mesh(*shape, devices=["cuda:0"] * (
                    shape[0] * shape[1] * shape[2])), small_scene, small_cam,
                config, 1)
    finally:
        sharding.sum_shards = real
    cases = [(f"mesh ({sp}, {dp}) fused headline", (sp, dp) == K15_TIMED)
             for sp, dp in K15_MESHES]
    cases += [(f"mesh {shape} wavefront {WAVE_SIZE} "
               f"{config.samples_per_pixel} spp", False)
              for shape, config in wave_meshes]
    if len(caught) != len(cases):
        raise SystemExit(f"phase 16 sum_shards: {len(caught)} reductions in "
                         f"{len(cases)} sharded frames")
    for (parts, sp, dp, dev0), (case, time_it) in zip(caught, cases):
        m = parts[0, 0][1].numel()
        hold("sum_shards", case,
             lambda p=parts, a=sp, b=dp, d=dev0: flat(passes.sum_shards(
                 p, a, b, d)),
             lambda p=parts, a=sp, b=dp, d=dev0: flat(
                 passes.sum_shards_reference(p, a, b, d)),
             sp * dp * (16 * m + 8) + 16 * sp * m + 8, time_it=time_it,
             extra=f", {sp} x {dp} parts of {m} lanes",
             launches=-(-(sp * dp) // passes.PARTS_PER_LAUNCH))
    mesh31 = meshes[3, 1]

    # K16: the slices' hits of bounce 0 of a 1-spp headline frame on mesh
    # (1, 1, tp), caught on their way to the merge. Its library call: the
    # t's stacked, their min over the slices and a gather of the winning
    # slice's index. The slices hold ascending index ranges and torch's
    # min takes the first slice of a tie, which holds the lowest index; the
    # sequence must give K16's bits before its time is used.
    merges = {}   # tp: the first merge of its frame
    real_merge = sharding.merge_tp_hits

    def catch_merge(ts, indices, offsets):
        merges.setdefault(len(ts), (ts, indices, offsets))
        return real_merge(ts, indices, offsets)

    one = dataclasses.replace(headline, samples_per_pixel=1)
    sharding.merge_tp_hits = catch_merge
    try:
        for tp in K16_TPS:
            sharding.render_frame_sharded(
                sharding.make_mesh(1, 1, tp, devices=["cuda:0"] * tp), scene,
                cam, one, 1)
    finally:
        sharding.merge_tp_hits = real_merge
    for tp in K16_TPS:
        ts, indices, offsets = merges[tp]
        n_lanes = ts[0].numel()
        offs = torch.tensor(offsets, device=dev)

        def library(ts=ts, indices=indices, offs=offs):
            t_min, k = torch.stack(ts).min(dim=0)
            i = torch.stack(indices).gather(0, k[None])[0]
            return [t_min, torch.where((i >= 0) & (t_min < INF), i + offs[k],
                                       -1)]

        got = hold("merge_tp_hits", f"tp {tp}, headline bounce 0, 1 spp",
                   lambda a=ts, b=indices, c=offsets: list(
                       passes.merge_tp_hits(a, b, c)),
                   lambda a=ts, b=indices, c=offsets: list(
                       passes.merge_tp_hits_reference(a, b, c)),
                   (tp + 1) * TP_LANE_BYTES * n_lanes,
                   time_it=tp == K16_TIMED,
                   extra=f", {n_lanes} lanes, hits "
                         f"{int((indices[0] >= 0).sum())} in slice 0")
        if tp == K16_TIMED:
            lib = library()
            torch.cuda.synchronize()
            if not bits(lib, got)[1]:
                raise SystemExit("phase 16 merge_tp_hits: the torch stack, "
                                 "min and gather do not give K16's bits")
            library_ms["merge_tp_hits"] = cuda_ms(library, PASS_REPS)
            print(f"phase 16 merge_tp_hits library call (stack, min, gather) "
                  f"tp {tp}: {library_ms['merge_tp_hits']:.4f} ms, K16's "
                  f"bits | {card}", flush=True)

    # What an adaptive pass and a mesh (3, 1) frame run on the card.
    prof_adap = AdaptiveRenderer(headline, tolerance=TOLERANCE,
                                 reprobe_every=REPROBE_EVERY, device=dev)
    prof_adap.step(scene, cam, seed=1)
    n_kernels, busy, by_name = profiled(
        lambda: prof_adap.step(scene, cam, seed=2))
    print(f"phase 16 an adaptive headline pass: {n_kernels} kernels on the "
          f"card, busy {busy:.3f} ms; by kernel (count, ms, name): "
          f"{by_name} | {card}", flush=True)
    n_kernels, busy, by_name = profiled(
        lambda: sharding.render_frame_sharded_pallas(mesh31, scene, cam,
                                                     headline, 2))
    print(f"phase 16 a mesh (3, 1) headline frame: {n_kernels} kernels on "
          f"the card, busy {busy:.3f} ms; by kernel (count, ms, name): "
          f"{by_name} | {card}", flush=True)

    entries = []
    for name in PASS_REPLACES:
        ms, p_ms, (b_ms, b_by), case = timing[name]
        print(f"phase 16 {name}: {case}, kernel {ms:.4f} ms, plain "
              f"{p_ms:.2f} ms, bound {b_ms:.3g} ms ({b_by}), launches on the "
              f"main path {TAIL_LAUNCHES[name]} | {card}", flush=True)
        entries.append({
            "name": name, "route": "cuda", "source": PASS_SOURCES[name],
            "replaces": PASS_REPLACES[name],
            "launches": TAIL_LAUNCHES[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            # No single PyTorch call packs a camera row, maps or folds an
            # adaptive pass, or adds shards in this order and joins them;
            # the tp merge's yardstick is a short torch sequence (above).
            "library_ms": library_ms[name]})
    if min(TAIL_LAUNCHES[name] for name in PASS_REPLACES) < 1:
        raise SystemExit(f"phase 16: a kernel of the path launched no time: "
                         f"{dict(TAIL_LAUNCHES)}")
    print(f"phase 16 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def flat(out) -> list:
    """The tensors of a nested tuple of tensors and Vec3s, in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in flat(x)]


if __name__ == "__main__":
    sys.exit(main())
