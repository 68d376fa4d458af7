#!/usr/bin/env python3
"""The raster layer and the denoiser of two trees of the port on one CUDA
card, in turns.

    python3 tests/torch_image_ab.py OTHER_TREE [--reps 5]

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists; this tree itself gives four arms of one tree, the spread). In
separate processes, in the order other, this, this, other, each arm builds
its tree's CUDA extension and, at 1280x720 and 1920x1080:

- the raster layer (``engine.raster.raster_layer``) of BASELINE config 5
  (the final scene with a metallic cube mesh, level 2, over the reference's
  raster cube): the whole call (host clock around a synchronised call, p50
  of ``--reps`` after a first) split into the host's extraction and upload
  (``World.extract_raster_host``, ``make_triangles_np``, ``upload``), the
  host's time to queue ``rasterize_impl`` (no wait), and the card's busy
  time and kernel count over one call (torch's profiler: the summed
  durations of its kernels);
- the denoiser (``engine.denoise.atrous_denoise``, 3 iterations, the CLI's
  sigmas) on a seeded image and depth (a depth edge and misses at the far
  fallback): the whole call (host clock, synchronised, p50), the card's
  time by CUDA events queued behind a spin kernel (mean of ``--reps``), and
  the card's busy time and kernel count over one call;

and the CLI's ``render`` at its defaults (1280x720, 16 spp, level 3) with
and without ``--denoise 3`` (a warm-up round, then 3 rounds of the two in
turns: p50 of 3 each, the whole command). The first
arm of each tree saves its raster buffers and denoised images; the last
lines give the card (name, power limit), each tree's numbers and the max
|d| of every saved buffer between the trees. Needs one CUDA card; the two
trees must share the public API.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILING = str(ROOT / "bevyray_tpu_torch" / "utils" / "profiling.py")
SIZES = ((1280, 720), (1920, 1080))

ARM = """
import contextlib, io, json, runpy, sys, tempfile, time
sys.path.insert(0, ".")
import numpy as np
import torch
from bevyray_tpu_torch import (RenderConfig, StandardMaterial, Transform,
                               cube_mesh, rtiow)
from bevyray_tpu_torch.app import cli
from bevyray_tpu_torch.core.types import make_triangles_np, upload
from bevyray_tpu_torch.engine import raster
from bevyray_tpu_torch.engine.denoise import atrous_denoise
from bevyray_tpu_torch.kernels.cuda import build
from torch.profiler import ProfilerActivity, profile
# The card's work in a profile, by this script's tree's helper: a tree
# under test may predate it.
device_kernels = runpy.run_path({profiling!r})["device_kernels"]

dev = torch.device("cuda", 0)
t0 = time.perf_counter()
build.extension()
build_s = time.perf_counter() - t0
reps = {reps}
saved = {{}}


def p50(values):
    return sorted(values)[len(values) // 2]


def synced_ms(fn, n):
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# [the card's busy ms, the kernels it ran] over one call.
def busy(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = device_kernels(prof)
    return [sum(e.self_device_time_total for e in device) / 1e3,
            sum(e.count for e in device)]


def device_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms: the launches queue meanwhile
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


world5 = rtiow.final_scene(seed=42)
world5.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                  StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                   perceptual_roughness=0.15))
clear = (1.0, 1.0, 1.0)
out = {{"raster": {{}}, "denoise": {{}}}}
for w, h in {sizes}:
    config = RenderConfig(w, h, 16, 4, level=2)
    cam = world5.camera_state(aspect=w / h)
    whole = synced_ms(lambda: raster.raster_layer(world5, cam, config), reps)
    host, queue = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        va, vb, vc, colors = world5.extract_raster_host()
        tris = make_triangles_np(va, vb, vc, np.zeros(va.shape[0], np.int32),
                                 capacity=va.shape[0], device=dev)
        cols = upload(colors, dev)
        t1 = time.perf_counter()
        color, depth = raster.rasterize_impl(tris, cols, cam, config, clear)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        queue.append((t2 - t1) * 1e3)
    saved[f"raster {{w}}x{{h}}"] = torch.cat(
        [torch.stack(list(color)), depth[None]]).cpu()
    out["raster"][f"{{w}}x{{h}}"] = {{
        "whole_p50_ms": p50(whole), "whole_ms": whole,
        "extract_upload_p50_ms": p50(host), "queue_p50_ms": p50(queue),
        "busy_ms_and_kernels": busy(
            lambda: raster.raster_layer(world5, cam, config))}}

    rng = np.random.default_rng(w)
    image = rng.random((h, w, 3), dtype=np.float32)
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    depth[:, w // 2:] += 30.0
    depth[h // 3:h // 2] = 999.0      # misses: the far fallback
    img_d, z_d = (torch.as_tensor(a, device=dev) for a in (image, depth))
    call = lambda: atrous_denoise(img_d, z_d, iterations=3)   # noqa: E731
    saved[f"denoise {{w}}x{{h}}"] = call().cpu()
    whole = synced_ms(call, reps)
    out["denoise"][f"{{w}}x{{h}}"] = {{
        "whole_p50_ms": p50(whole), "whole_ms": whole,
        "device_ms": device_ms(call, reps), "busy_ms_and_kernels": busy(call)}}

tmp = tempfile.TemporaryDirectory()
cli_ms = {{"render": [], "render --denoise 3": []}}
for k in range(4):   # the first round warms up; then the two in turns
    for arm, extra in (("render", []),
                       ("render --denoise 3", ["--denoise", "3"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["render", *extra, "--out", tmp.name + "/x.png"])
        assert rc == 0, rc
        if k:
            cli_ms[arm].append((time.perf_counter() - t0) * 1e3)
out["cli"] = {{arm: {{"p50_ms": p50(times), "ms": times}}
              for arm, times in cli_ms.items()}}
out["build_s"] = build_s
if {save!r}:
    torch.save(saved, {save!r})
print(json.dumps(out))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    other = args.other.resolve()
    if not (other / "bevyray_tpu_torch").is_dir():
        print(f"torch_image_ab: no port in {other}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "image_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {"other": [], "this": []}
    for arm, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        save = str(out_dir / f"{arm}.pt") if not runs[arm] else ""
        out = subprocess.run([sys.executable, "-c",
                              ARM.format(reps=args.reps, sizes=SIZES,
                                         save=save, profiling=PROFILING)],
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
    diffs = {name: float((got[name] - want[name]).abs().max())
             for name in got}
    print(f"card: {card}")
    print(json.dumps({arm: {
        "raster_whole_p50_ms": {s: [r["raster"][s]["whole_p50_ms"]
                                    for r in rs] for s in rs[0]["raster"]},
        "raster_extract_upload_p50_ms": {
            s: [r["raster"][s]["extract_upload_p50_ms"] for r in rs]
            for s in rs[0]["raster"]},
        "raster_queue_p50_ms": {s: [r["raster"][s]["queue_p50_ms"]
                                    for r in rs] for s in rs[0]["raster"]},
        "raster_busy_ms_and_kernels": {
            s: [r["raster"][s]["busy_ms_and_kernels"] for r in rs]
            for s in rs[0]["raster"]},
        "denoise_whole_p50_ms": {s: [r["denoise"][s]["whole_p50_ms"]
                                     for r in rs] for s in rs[0]["denoise"]},
        "denoise_device_ms": {s: [r["denoise"][s]["device_ms"] for r in rs]
                              for s in rs[0]["denoise"]},
        "denoise_busy_ms_and_kernels": {
            s: [r["denoise"][s]["busy_ms_and_kernels"] for r in rs]
            for s in rs[0]["denoise"]},
        "cli_p50_ms": {c: [r["cli"][c]["p50_ms"] for r in rs]
                       for c in rs[0]["cli"]}}
        for arm, rs in runs.items()}))
    print(json.dumps({"max_abs_diff_this_vs_other": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
