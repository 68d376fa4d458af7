"""Interactive edit-loop benchmark: what an edit costs, stage by stage.

Counterpart of the JAX repository's ``scripts/bench_edit.py``. An unchanged
scene costs no host work per frame (extraction, kernel tables and
shortlists are cached), but an edit pays the whole pipeline: the world's
mutation, the revision-keyed re-extract, a miss of the kernel tables, the
host shortlists, then the frame. This drives that loop (the analog of
dragging a gizmo in the reference's window) and reports, per stage and end
to end, as p50 ms:

- ``steady_ms``: the unchanged scene's frame (every cache hits);
- ``edit_ms``: the whole edit-to-frame latency (every cache misses);
- ``stage_ms``: ``extract``, ``prepare``, ``shortlists``, ``render``, as
  JAX splits them, and ``prepare`` split in two: ``prepare_kd_order``, the
  host kd order of the sphere table (``kernels/cuda/grouping.py``), and
  ``prepare_tables``, the table build (``prepare_kernel_scene``); per edit
  ``prepare`` is their sum.

Each stage ends with ``torch.cuda.synchronize()`` where JAX blocked on the
stage's arrays.

    python -m bevyray_tpu_torch.bench.edit [--device cpu]

One JSON line per config (1080p/16 spp, 720p/4 spp) and a summary line.
"""

from __future__ import annotations

import json
import sys
import time

from ..core.types import RenderConfig, resolve_device
from ..engine.fused_renderer import FusedRenderer
from ..kernels.cuda import grouping
from ..scene import rtiow
from .orbit import edit_sequence
from .timing import (card_fields, device_arg, launch_count, launches_since,
                     p50_ms, sync)


def bench_edit_loop(width=1920, height=1080, spp=16, bounces=4, frames=12,
                    device=None):
    dev = resolve_device(device)
    world = rtiow.final_scene(seed=42)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    renderer = FusedRenderer(config)
    cam = world.camera_state(aspect=width / height, device=dev)

    # Warm up: the kernel's first launch and the first tables.
    renderer.render(world.extract(with_bvh=False, device=dev), cam, seed=0)
    sync(dev)

    # Steady state: unchanged scene, only the seed varies.
    before = launch_count()
    steady = []
    for i in range(frames):
        t0 = time.perf_counter()
        renderer.render(world.extract(with_bvh=False, device=dev), cam,
                        seed=i + 1)
        sync(dev)
        steady.append(time.perf_counter() - t0)

    # Edit loop: move one sphere every frame. Every stage misses its cache;
    # time each stage, then the whole edit-to-frame path.
    stage = {"extract": [], "prepare": [], "prepare_kd_order": [],
             "prepare_tables": [], "shortlists": [], "render": []}
    edit = []
    apply_edit = edit_sequence(world, dev)
    for i in range(frames):
        t_all = time.perf_counter()

        t0 = time.perf_counter()
        scene = apply_edit(i)
        sync(dev)
        stage["extract"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        if config.pallas_grouping == "kd":
            grouping.cached_order(scene, config.pallas_cand_size)
            sync(dev)
        t1 = time.perf_counter()
        pscene = renderer.prepare(scene)
        sync(dev)
        t2 = time.perf_counter()
        stage["prepare_kd_order"].append(t1 - t0)
        stage["prepare_tables"].append(t2 - t1)
        stage["prepare"].append(t2 - t0)

        t0 = time.perf_counter()
        renderer.shortlists(pscene, cam)
        sync(dev)
        stage["shortlists"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        renderer.render(scene, cam, seed=100 + i)
        sync(dev)
        stage["render"].append(time.perf_counter() - t0)

        edit.append(time.perf_counter() - t_all)
    launches = launches_since(before, "edit-loop", dev)

    row = {
        "config": f"edit-loop final scene {width}x{height}/{spp}spp",
        "steady_ms": p50_ms(steady),
        "edit_ms": p50_ms(edit),
        "edit_overhead_ms": round(p50_ms(edit) - p50_ms(steady), 2),
        "stage_ms": {k: p50_ms(v) for k, v in stage.items()},
        "edit_fps": round(1e3 / p50_ms(edit), 2),
        "n_spheres": world.n_spheres,
        "device": card_fields(dev),
        "launches": launches,
    }
    print(json.dumps(row), flush=True)
    return row


def main(device=None):
    dev = resolve_device(device)
    rows = [bench_edit_loop(device=dev),
            bench_edit_loop(width=1280, height=720, spp=4, frames=12,
                            device=dev)]
    print(json.dumps({"summary": "edit-path latency recorded alongside "
                                 "render latency", "rows": len(rows)}))
    return rows


if __name__ == "__main__":
    main(device_arg(__doc__.splitlines()[0]))
    sys.exit(0)
