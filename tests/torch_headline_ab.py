#!/usr/bin/env python3
"""Frame and kernel times of two trees of the port on one CUDA card, in turns.

    python3 tests/torch_headline_ab.py OTHER_TREE [--frames 5] [--exact-rng]
                                      [--phase-fuse N]

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). In separate processes, in the order other, this, this, other, each
arm builds its tree's CUDA kernel (into that tree's ``build/torch_ext/``)
and runs three cells, each once to warm up and then ``--frames`` frames
with seeds 1, 2, ...: the default-config headline frame through
``FusedRenderer`` (RTiOW final scene, 1920x1080, 16 spp, 4 bounces, level
3); BASELINE config 5 (the final scene with a metallic cube mesh, 1280x720,
16 spp, 4 bounces, level 2, over the raster layer); and the headline on the
block-split mesh (3, 1) through ``render_frame_sharded_pallas`` on
``cuda:0``. Per cell it prints the p50 ms, the segments per frame and the
kernel's ms (CUDA events, mean of 3 launches of ``render_tiles`` on the
cell's inputs; for the mesh the sum over its 3 shards) as JSON, and the
card's busy time and kernel count over one headline frame (torch's
profiler: the summed durations of its kernels); the first arm of each tree
saves its seed-1 frames.
``--exact-rng`` passes ``exact_rng=True`` to both trees' renderers and
kernel launches, which holds the exact PCG path of a tree whose default
draws from the fast path against an older tree's. ``--phase-fuse N`` sets
the block fusion ``PHASE_FUSE`` of both trees' kernels (a tree from before
its port has none and ignores it). The last lines give the card (name,
power limit), each tree's p50s, kernel ms and headline busy time and
kernel count, and each cell's max |d| (image, depth), whether its image
and depth are bit-equal, and its segments between the trees. Needs one CUDA
card; the two trees must share the public API.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ARM = """
import dataclasses, json, sys, time
sys.path.insert(0, ".")
import torch
from bevyray_tpu_torch import (FusedRenderer, RenderConfig, StandardMaterial,
                               Transform, cube_mesh, rtiow)
from bevyray_tpu_torch.engine.raster import raster_layer
from bevyray_tpu_torch.kernels.cuda import build, megakernel
from bevyray_tpu_torch.kernels.cuda.primary import device_shortlists_for
from bevyray_tpu_torch.parallel.sharding import (make_mesh,
                                                 render_frame_sharded_pallas)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
{fuse}
t0 = time.perf_counter()
build.extension()
build_s = time.perf_counter() - t0
rng = dict({rng})
saved = {{}}


def frames(name, render):
    render(0)
    torch.cuda.synchronize()
    times, segments = [], []
    for i in range({frames}):
        t0 = time.perf_counter()
        frame = render(i + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        segments.append(int(frame.rays_traced))
        if i == 0:
            saved[name] = (frame.image.cpu(), frame.rt_depth.cpu(),
                           segments[0])
    return {{"p50_ms": sorted(times)[len(times) // 2], "ms": times,
             "segments": segments}}


def kernel_ms(kscene, cam, config, shards=((0, None),)):
    sl = device_shortlists_for(kscene, cam, config,
                               config.samples_per_pixel)
    total = 0.0
    for lo, n in shards:
        rows = slice(lo, None if n is None else lo + n)
        run = dict(rng, block_offset=lo, n_blocks_local=n,
                   sl=None if sl[0] is None else sl[0][rows],
                   slmeta=None if sl[1] is None else sl[1][rows])
        megakernel.render_tiles(kscene, cam, config, 1, **run)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            megakernel.render_tiles(kscene, cam, config, 1, **run)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) / 3
    return total


world = rtiow.final_scene(seed=42)
scene = world.extract(with_bvh=False)
cam = world.camera_state(aspect=1920 / 1080)
headline = RenderConfig(1920, 1080, 16, 4, level=3)
renderer = FusedRenderer(headline, **rng)
cells = {{"headline": frames("headline", lambda s: renderer.render(
    scene, cam, seed=s))}}
kscene = renderer.prepare(scene)
renderer.render(scene, cam, seed=3)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    renderer.render(scene, cam, seed=3)
    torch.cuda.synchronize()
device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
busy = [sum(e.self_device_time_total for e in device) / 1e3,
        sum(e.count for e in device)]
cells["headline"].update(mode=renderer.last_mode,
                         fuse=getattr(renderer, "last_fuse", 1),
                         exact_rng=getattr(renderer, "last_exact_rng",
                                           renderer.exact_rng),
                         kernel_ms=kernel_ms(kscene, cam, headline))

world5 = rtiow.final_scene(seed=42)
world5.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                  StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                   perceptual_roughness=0.15))
config5 = RenderConfig(1280, 720, 16, 4, level=2)
cam5 = world5.camera_state(aspect=16 / 9)
scene5 = world5.extract(with_bvh=False)
rc, rd = raster_layer(world5, cam5, config5)
renderer5 = FusedRenderer(config5, **rng)
cells["config5"] = frames("config5", lambda s: renderer5.render(
    scene5, cam5, seed=s, raster_color=rc, raster_depth=rd))
cells["config5"].update(fuse=getattr(renderer5, "last_fuse", 1),
                        kernel_ms=kernel_ms(renderer5.prepare(scene5), cam5,
                                            config5))

mesh = make_mesh(3, 1, devices=["cuda:0"] * 3)
cells["mesh31"] = frames("mesh31", lambda s: render_frame_sharded_pallas(
    mesh, scene, cam, headline, s))
cells["mesh31"]["kernel_ms"] = kernel_ms(
    kscene, cam, headline, [(170 * i, 170) for i in range(3)])
if {save!r}:
    torch.save(saved, {save!r})
print(json.dumps({{"cells": cells, "build_s": build_s,
                   "headline_busy_ms_and_kernels": busy}}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--exact-rng", action="store_true")
    parser.add_argument("--phase-fuse", type=int)
    args = parser.parse_args()
    other = args.other.resolve()
    if not (other / "bevyray_tpu_torch").is_dir():
        print(f"torch_headline_ab: no port in {other}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "headline_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {"other": [], "this": []}
    for arm, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        save = str(out_dir / f"{arm}.pt") if not runs[arm] else ""
        out = subprocess.run([sys.executable, "-c",
                              ARM.format(frames=args.frames, save=save, rng=(
                                  "exact_rng=True" if args.exact_rng
                                  else ""), fuse=(
                                  f"megakernel.PHASE_FUSE = {args.phase_fuse}"
                                  if args.phase_fuse else ""))], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        result = json.loads(out.stdout.strip().splitlines()[-1])
        runs[arm].append(result)
        print(f"{arm} ({tree}): {json.dumps(result)}", flush=True)
    print(f"card: {card}")
    print(json.dumps({arm: {**{cell: {key: [r["cells"][cell][key]
                                            for r in rs]
                                      for key in ("p50_ms", "kernel_ms")}
                               for cell in rs[0]["cells"]},
                            "headline_busy_ms_and_kernels": [
                                r["headline_busy_ms_and_kernels"]
                                for r in rs]}
                      for arm, rs in runs.items()}))
    import torch

    got, want = (torch.load(out_dir / f"{arm}.pt") for arm in ("this",
                                                               "other"))
    print(json.dumps({"max_abs_diff_this_vs_other": {
        cell: {"image": float((got[cell][0] - want[cell][0]).abs().max()),
               "depth": float((got[cell][1] - want[cell][1]).abs().max()),
               "bit_equal": all(torch.equal(g.view(torch.int32),
                                            w.view(torch.int32))
                                for g, w in zip(got[cell][:2],
                                                want[cell][:2])),
               "segments": [got[cell][2], want[cell][2]]}
        for cell in got}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
