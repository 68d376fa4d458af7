#!/usr/bin/env python3
"""The wavefront path of two trees of the port on one CUDA card, in turns.

    python3 tests/torch_wavefront_ab.py OTHER_TREE [--frames 2]

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). In separate processes, in the order other, this, this, other, each
arm builds its tree's CUDA extension and runs the wavefront ``Renderer``
(seed 1, 2, ... after a warm-up frame at seed 0) on six cells: the
headline (RTiOW final scene, 1920x1080, 16 spp, 4 bounces, level 3); the
CLI's default ``render`` (1280x720, 16 spp, backend auto: "brute"); 4,971
spheres (``final_scene(seed=42, grid=35)``, 640x360, 4 spp) walking the
BVH and with the dense test; BASELINE config 5 (the final scene with a
metallic cube mesh, 1280x720, 16 spp, level 2) over its raster layer; and
the cube field (``chip_smoke.cube_field_world`` of this tree, built with
each arm's package: 4,092 triangles, "auto" taking the dense test) at
config 5's settings over its raster layer; and the headline through the
wavefront sharded step on mesh (1, 1, 2) over the card (the sphere table
in two tp slices, their nearest hits merged each bounce). It
times the raster layer (p50 of 5 calls after a first) and takes the census
of host waits for the card (``bench/timing.py`` ``host_syncs``) over one
headline frame at 1 spp, one 4,971-sphere "bvh" frame and one config-5
round (``raster_layer`` + ``FusedRenderer.render``), and the card's busy
time (torch's profiler: the summed durations of its kernels), which the
host's launch rate does not enter, the kernels it ran and K6's share, over
one 1-spp frame of the headline, config 5, the cube field and the tp headline. Then it times the
ray tests alone (K1-K4 of ``kernels/cuda/csrc/wavefront.cu``) through the
calls a frame makes (``engine.renderer.make_intersect_fn``, the
triangle wrappers), on the rays that bounces 0 and 2 of sample 0 hand
them (``chip_smoke.capture_rays``), by CUDA events (the mean of 20
launches after one, queued behind a spin kernel so that the host's
launch time stays out of the reading): K1 at the headline and at 4,971
spheres, K3 at 4,971 spheres (leaf 1 and 4), K2 and K4 at config 5 and on
the cube field; and K6 alone at every bounce of sample 0 of the headline
and of the 4,971-sphere frame (``chip_smoke.capture_states`` of this
tree), folding into sums in place.
The first arm of each tree saves its seed-1 frames, raster buffers, ray
test results and a digest of K6's outputs; the last lines give the card
(name, power limit), each tree's p50s, census, ray test and K6 times (and
the dense tests' issue slots a (ray, row) pair at the ``--fmad=false``
issue rate, 132 SMs x 128 lanes x 1.98 GHz), and each cell's and ray
test's max |d| between the trees, with whether each cell's image and
depth and each bounce's K6 outputs are bit-equal.
Needs one CUDA card; the two trees must share the public API.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILING = str(ROOT / "bevyray_tpu_torch" / "utils" / "profiling.py")
ISSUE_RATE = 132 * 128 * 1.98e9   # fp32 instructions a second, no contraction

ARM = """
import dataclasses, importlib.util, json, runpy, sys, time
sys.path.insert(0, ".")
import torch
import bevyray_tpu_torch
from bevyray_tpu_torch import (FusedRenderer, RenderConfig, Renderer,
                               StandardMaterial, Transform, cube_mesh, rtiow)
from bevyray_tpu_torch.bench.timing import host_syncs
from bevyray_tpu_torch.engine.raster import raster_layer
from bevyray_tpu_torch.kernels.cuda import build
from bevyray_tpu_torch.parallel.sharding import make_mesh, render_frame_sharded
from torch.profiler import ProfilerActivity, profile
# The card's work in a profile, by this script's tree's helper: a tree
# under test may predate it.
device_kernels = runpy.run_path({profiling!r})["device_kernels"]

dev = torch.device("cuda", 0)
t0 = time.perf_counter()
build.extension()
build_s = time.perf_counter() - t0
saved = {{}}


def frames(name, render):
    render(0)
    torch.cuda.synchronize()
    times = []
    for i in range({frames}):
        t0 = time.perf_counter()
        frame = render(i + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            saved[name] = (frame.image.cpu(), frame.rt_depth.cpu(),
                           int(frame.rays_traced))
    return {{"p50_ms": sorted(times)[len(times) // 2], "ms": times,
             "segments": saved[name][2]}}


def census(fn):
    torch.cuda.synchronize()
    sites = []
    with host_syncs(dev, sites):
        fn()
    torch.cuda.synchronize()
    return sorted(set(sites))


world = rtiow.final_scene(seed=42)
scene = world.extract(with_bvh=False)
cam = world.camera_state(aspect=1920 / 1080)
headline = RenderConfig(1920, 1080, 16, 4, level=3)
cells = {{"headline": frames("headline", lambda s: Renderer(headline).render(
    scene, cam, seed=s))}}

cli_scene = world.extract()
cli_cam = world.camera_state(aspect=1280 / 720)
cli_cfg = RenderConfig(1280, 720, 16, 4, level=3)
cells["cli_render"] = frames("cli_render", lambda s: Renderer(cli_cfg).render(
    cli_scene, cli_cam, seed=s))

big = rtiow.final_scene(seed=42, grid=35)
big_scene = big.extract()
big_cam = big.camera_state(aspect=640 / 360)
for backend in ("bvh", "brute"):
    cfg = RenderConfig(640, 360, 4, 4, level=3, intersect_backend=backend)
    cells["big_" + backend] = frames("big_" + backend, lambda s: Renderer(
        cfg).render(big_scene, big_cam, seed=s))

world5 = rtiow.final_scene(seed=42)
world5.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                  StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                   perceptual_roughness=0.15))
config5 = RenderConfig(1280, 720, 16, 4, level=2)
cam5 = world5.camera_state(aspect=16 / 9)
scene5 = world5.extract(with_bvh=False)
raster_ms = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, rd = raster_layer(world5, cam5, config5)
    torch.cuda.synchronize()
    raster_ms.append((time.perf_counter() - t0) * 1e3)
saved["raster"] = (torch.stack(list(rc), -1).cpu(), rd.cpu(), 0)
cells["config5"] = frames("config5", lambda s: Renderer(config5).render(
    scene5, cam5, seed=s, raster_color=rc, raster_depth=rd))
fused5 = FusedRenderer(config5)
fused5.render(scene5, cam5, seed=0, raster_color=rc, raster_depth=rd)

# The cube field: this tree's scene, built with the arm's package.
spec = importlib.util.spec_from_file_location("ab_scenes", {smoke!r})
ab_scenes = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab_scenes)
field = ab_scenes.cube_field_world(bevyray_tpu_torch)
field_scene = field.extract()
field_cam = field.camera_state(aspect=16 / 9)
rc_f, rd_f = raster_layer(field, field_cam, config5)
cells["cube_field"] = frames("cube_field", lambda s: Renderer(config5).render(
    field_scene, field_cam, seed=s, raster_color=rc_f, raster_depth=rd_f))
tp_mesh = make_mesh(1, 1, 2, devices=["cuda:0"] * 2)
cells["tp_headline"] = frames("tp_headline", lambda s: render_frame_sharded(
    tp_mesh, scene, cam, headline, s))


def config5_round():
    rc2, rd2 = raster_layer(world5, cam5, config5)
    fused5.render(scene5, cam5, seed=2, raster_color=rc2, raster_depth=rd2)


one = dataclasses.replace(headline, samples_per_pixel=1)
one5 = dataclasses.replace(config5, samples_per_pixel=1)


# [the card's busy ms, the kernels it ran, K6's ms] over one frame.
def busy_ms(render):
    render(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(3)
        torch.cuda.synchronize()
    device = device_kernels(prof)
    return [sum(e.self_device_time_total for e in device) / 1e3,
            sum(e.count for e in device),
            sum(e.self_device_time_total for e in device
                if "shade_kernel" in e.key) / 1e3]


busy = {{
    "headline": busy_ms(lambda s: Renderer(one).render(scene, cam, seed=s)),
    "config5": busy_ms(lambda s: Renderer(one5).render(
        scene5, cam5, seed=s, raster_color=rc, raster_depth=rd)),
    "cube_field": busy_ms(lambda s: Renderer(one5).render(
        field_scene, field_cam, seed=s, raster_color=rc_f,
        raster_depth=rd_f)),
    "tp_headline": busy_ms(lambda s: render_frame_sharded(
        tp_mesh, scene, cam, one, s)),
}}
syncs = {{
    "Renderer headline 1 spp": census(
        lambda: Renderer(one).render(scene, cam, seed=2)),
    "Renderer 4,971 spheres bvh": census(
        lambda: Renderer(RenderConfig(640, 360, 4, 4, level=3,
                                      intersect_backend="bvh")).render(
            big_scene, big_cam, seed=2)),
    "config 5 round": census(config5_round),
}}

# The ray tests alone, called as a frame calls them.
import chip_smoke
from bevyray_tpu_torch.engine.renderer import make_intersect_fn
from bevyray_tpu_torch.kernels import intersect, traverse


# chip_smoke.cuda_ms of this tree, here so that both trees are timed alike.
def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms: the launches queue meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def walk(leaf):
    return RenderConfig(640, 360, 4, 4, level=3, intersect_backend="bvh",
                        bvh_leaf_size=leaf)


brute_big = RenderConfig(640, 360, 4, 4, level=3, intersect_backend="brute")
big4 = big.extract(bvh_leaf_size=4)
mesh5 = world5.extract()
rays = {{"headline": chip_smoke.capture_rays(scene, cam, headline, dev),
        "big": chip_smoke.capture_rays(big_scene, big_cam, brute_big, dev),
        "config5": chip_smoke.capture_rays(scene5, cam5, config5, dev),
        "field": chip_smoke.capture_rays(field_scene, field_cam, config5, dev)}}
tests = [
    ("K1 headline bounce 0", make_intersect_fn(scene, headline),
     "headline", 0, scene.spheres),
    ("K1 headline bounce 2", make_intersect_fn(scene, headline),
     "headline", 2, scene.spheres),
    ("K1 4,971 spheres bounce 0", make_intersect_fn(big_scene, brute_big),
     "big", 0, big_scene.spheres),
    ("K3 4,971 spheres leaf 1 bounce 0", make_intersect_fn(big_scene, walk(1)),
     "big", 0, None),
    ("K3 4,971 spheres leaf 4 bounce 0", make_intersect_fn(big4, walk(4)),
     "big", 0, None),
    ("K3 4,971 spheres leaf 1 bounce 2", make_intersect_fn(big_scene, walk(1)),
     "big", 2, None),
    ("K2 config 5 bounce 0", lambda o, d, a: intersect.intersect_triangles(
        o, d, scene5.triangles, active=a), "config5", 0, scene5.triangles),
    ("K4 config 5 bounce 0", lambda o, d, a: traverse.intersect_bvh_triangles(
        o, d, mesh5.triangles, mesh5.tri_bvh, active=a), "config5", 0, None),
    ("K2 cube field bounce 0", lambda o, d, a: intersect.intersect_triangles(
        o, d, field_scene.triangles, active=a), "field", 0,
     field_scene.triangles),
    ("K2 cube field bounce 2", lambda o, d, a: intersect.intersect_triangles(
        o, d, field_scene.triangles, active=a), "field", 2,
     field_scene.triangles),
    ("K4 cube field bounce 0", lambda o, d, a: traverse.intersect_bvh_triangles(
        o, d, field_scene.triangles, field_scene.tri_bvh, active=a), "field",
     0, None),
]
# K6 alone at every bounce of sample 0 of the headline and of the 4,971-
# sphere frame, folding into sums in place as a frame's later samples do:
# its ms and a digest of every column it writes.
import hashlib
from bevyray_tpu_torch.kernels import bounce as bounce_mod


def digest(tensors):
    h = hashlib.sha256()
    for c in tensors:
        h.update(c.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


shade = {{}}
saved["shade"] = {{}}
for cell, scn, camera, cfg in (("headline", scene, cam, headline),
                               ("4,971 spheres", big_scene, big_cam,
                                brute_big)):
    _, states = ab_scenes.capture_states(
        scn, camera, cfg, dev, bounces=tuple(range(cfg.bounces + 1)))
    for b, (state, t, idx, tt, ti) in sorted(states.items()):
        args = (b, t, idx, tt, ti, scn, cfg)
        sums = ab_scenes.seeded_sums(t.numel(), dev, b)
        got = ab_scenes.clone_state(state)
        bounce_mod.shade_bounce(got, *args, sums, sums)
        key = f"{{cell}} bounce {{b}}"
        saved["shade"][key] = digest(got.columns() + sums.columns())
        shade[key] = {{
            "live": int(state.active.sum()),
            "ms": ab_scenes.shade_ms(lambda st, *a: bounce_mod.shade_bounce(
                st, *a, sums, sums), state, args, 20)}}
    del states

kernels = {{}}
saved["ray tests"] = {{}}
for name, fn, cell, bounce, table in tests:
    o, d, act = rays[cell][bounce]
    t, i = fn(o, d, act)
    saved["ray tests"][name] = (t.cpu(), i.cpu())
    kernels[name] = {{"ms": device_ms(lambda: fn(o, d, act)),
                     "active": int(act.sum()),
                     "rows": None if table is None else int(table.valid.sum())}}
if {save!r}:
    torch.save(saved, {save!r})
print(json.dumps({{"cells": cells, "raster_p50_ms": sorted(raster_ms[1:])[2],
                   "host_syncs": syncs, "busy_ms_1spp": busy,
                   "ray_tests": kernels, "shade_by_bounce": shade,
                   "build_s": build_s}}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--frames", type=int, default=2)
    args = parser.parse_args()
    other = args.other.resolve()
    if not (other / "bevyray_tpu_torch").is_dir():
        print(f"torch_wavefront_ab: no port in {other}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "wavefront_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {"other": [], "this": []}
    for arm, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        save = str(out_dir / f"{arm}.pt") if not runs[arm] else ""
        out = subprocess.run([sys.executable, "-c",
                              ARM.format(frames=args.frames, save=save,
                                         smoke=str(ROOT / "chip_smoke.py"),
                                         profiling=PROFILING)],
                             cwd=tree, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        result = json.loads(out.stdout.strip().splitlines()[-1])
        runs[arm].append(result)
        print(f"{arm} ({tree}): {json.dumps(result)}", flush=True)

    import torch

    got, want = (torch.load(out_dir / f"{arm}.pt") for arm in ("this",
                                                               "other"))
    tests_got, tests_want = got.pop("ray tests"), want.pop("ray tests")
    shade_got, shade_want = got.pop("shade"), want.pop("shade")
    diffs = {cell: {"image": float((got[cell][0] - want[cell][0]).abs().max()),
                    "depth": float((got[cell][1] - want[cell][1]).abs().max()),
                    "bit_equal": all(torch.equal(g.view(torch.int32),
                                                 w.view(torch.int32))
                                     for g, w in zip(got[cell][:2],
                                                     want[cell][:2])),
                    "segments": [got[cell][2], want[cell][2]]}
             for cell in got}
    diffs.update({f"K6 {key}": {"bit_equal": shade_got[key] == shade_want[key]}
                  for key in shade_got})
    diffs.update({name: {"t": float((tests_got[name][0]
                                     - tests_want[name][0]).abs().max()),
                         "index_equal": torch.equal(tests_got[name][1],
                                                    tests_want[name][1])}
                  for name in tests_got})
    print(f"card: {card}")
    print(json.dumps({arm: {"p50_ms": {cell: [r["cells"][cell]["p50_ms"]
                                              for r in rs]
                                       for cell in rs[0]["cells"]},
                            "raster_p50_ms": [r["raster_p50_ms"] for r in rs],
                            "busy_ms_and_kernels_1spp": {
                                cell: [r["busy_ms_1spp"][cell] for r in rs]
                                for cell in rs[0]["busy_ms_1spp"]},
                            "host_syncs": rs[0]["host_syncs"],
                            "ray_test_ms": {name: [r["ray_tests"][name]["ms"]
                                                   for r in rs]
                                            for name in rs[0]["ray_tests"]},
                            "shade_ms_by_bounce": {
                                b: [r["shade_by_bounce"][b]["ms"] for r in rs]
                                for b in rs[0]["shade_by_bounce"]},
                            "dense_slots_a_pair": {
                                name: [r["ray_tests"][name]["ms"] * 1e-3
                                       * ISSUE_RATE / (test["active"]
                                                       * test["rows"])
                                       for r in rs]
                                for name, test in rs[0]["ray_tests"].items()
                                if test["rows"]}}
                      for arm, rs in runs.items()}))
    print(json.dumps({"max_abs_diff_this_vs_other": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
