"""Moving-camera (orbit) and per-frame-edit benches for the fused path.

Counterpart of the JAX repository's ``scripts/bench_orbit.py``. The
reference is an interactive app: a flycam moves the camera every frame and
edits re-extract the scene. The phase split needs per-block primary
shortlists, built on the host per (scene, camera), so a moving camera pays
host work and an upload that the static headline never sees. Each mutation
runs two ways:

- ``synced``: mutate, render, wait for the frame;
- ``pipelined``: queue frame i on the card, do frame i+1's host work (the
  camera's shortlists, or the edit, extract, prepare and shortlists) while
  the card renders, then wait for frame i. A frame then costs max(device,
  host) if nothing in the host work waits for the card, device + host if
  something does. Each pipelined row also gives ``host_ms`` (p50 of the host
  work alone), ``device_ms`` (p50 of CUDA events around the frame; null off
  a card) and ``host_syncs``: where one more round, untimed (the frame's
  dispatch and the host work), waited for the card (file:line, by torch's
  sync debug mode; empty off a card).

The static camera's p50 is measured in the same run as the reference point.
``n_capacities`` counts the distinct shortlist capacities the orbit touched.
In the JAX package each one is a recompile of the TPU kernel; here a
capacity is an argument of the one built kernel, so it costs no build.

    python -m bevyray_tpu_torch.bench.orbit [--device cpu]

One JSON line per row, 1080p/16 spp then 720p/4 spp, and a summary line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..core.types import RenderConfig, resolve_device
from ..engine.fused_renderer import FusedRenderer
from ..scene import rtiow
from ..scene.components import Transform
from .timing import (card_fields, device_arg, host_syncs, launch_count,
                     launches_since, p50_ms, sync)


def orbit_cams(world, frames, aspect, arc_deg=40.0, device=None):
    """Camera states along a horizontal arc about the look-at target (the
    gentle flycam analog; a full circle would point the camera out of the
    scene half the time), on ``device`` (None: the CUDA card)."""
    base = np.asarray(world.camera_transform.translation, np.float64)
    target = base + np.asarray(world.camera_transform.forward, np.float64)
    rel = base - target
    radius = np.hypot(rel[0], rel[2])
    th0 = np.arctan2(rel[2], rel[0])
    cams = []
    for i in range(frames):
        th = th0 + np.deg2rad(arc_deg) * (i / max(frames - 1, 1) - 0.5)
        pos = target + np.array([radius * np.cos(th), rel[1],
                                 radius * np.sin(th)])
        world.set_camera(Transform.from_xyz(*pos).looking_at(tuple(target)))
        cams.append(world.camera_state(aspect=aspect, device=device))
    return cams


def edit_sequence(world, device, seed=7):
    """``apply_edit(i)``: move a random sphere to a random spot on the
    ground (the gizmo-drag analog) and re-extract; the draws come from one
    ``default_rng(seed)``, in JAX's order."""
    rng = np.random.default_rng(seed)

    def apply_edit(i):
        eid = int(rng.integers(0, world.n_spheres))
        world.set_translation(eid, (float(rng.uniform(-8, 8)), 0.2,
                                    float(rng.uniform(-8, 8))))
        return world.extract(with_bvh=False, device=device)

    return apply_edit


def _pipelined(render, host_work, frames, dev):
    """Frame i queued, then ``host_work(i)`` (frame i+1's) while the card
    renders, then the wait. Returns the frame times, the host work's and
    the frames' device times (None off a card), and the sync sites of one
    more untimed round: the last frame again, with ``host_work(-1)``."""
    on_card = dev.type == "cuda"
    ts, host, device_ts = [], [], []
    for i in range(frames):
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        if on_card:
            events[0].record()
        render(i)
        if on_card:
            events[1].record()
        if i + 1 < frames:
            th = time.perf_counter()
            host_work(i)
            host.append(time.perf_counter() - th)
        sync(dev)
        ts.append(time.perf_counter() - t0)
        if on_card:
            device_ts.append(events[0].elapsed_time(events[1]) / 1e3)
    sites = []
    with host_syncs(dev, sites):
        render(frames - 1)
        host_work(-1)
    sync(dev)
    return ts, host, device_ts or None, sorted(set(sites))


def bench(width=1920, height=1080, spp=16, bounces=4, frames=24, seed=42,
          device=None):
    dev = resolve_device(device)
    world = rtiow.final_scene(seed=seed)
    aspect = width / height
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    renderer = FusedRenderer(config)
    scene = world.extract(with_bvh=False, device=dev)
    cams = orbit_cams(world, frames, aspect, device=dev)
    static_cam = cams[frames // 2]

    # Warm-up: one frame at each distinct shortlist capacity of the orbit.
    pscene = renderer.prepare(scene)
    by_cap = {}
    for cam in cams:
        sl, _ = renderer.shortlists(pscene, cam)
        by_cap.setdefault(None if sl is None else int(sl.shape[-1]), cam)
    for cap_cam in by_cap.values():
        renderer.render(scene, cap_cam, seed=0)
    sync(dev)

    rows = []

    def record(name, ts, before, **kw):
        row = {"config": f"{name} {width}x{height}/{spp}spp",
               "p50_ms": p50_ms(ts), **kw,
               "launches": launches_since(before, name, dev)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    def overhead(ts):
        return round(100 * (p50_ms(ts) / static["p50_ms"] - 1), 1)

    def arms(host, device_ts, sites):
        return {"host_ms": p50_ms(host) if host else None,
                "device_ms": p50_ms(device_ts) if device_ts else None,
                "host_syncs": sites}

    # -- static reference ----------------------------------------------------
    renderer.render(scene, static_cam, seed=0)
    sync(dev)
    before = launch_count()
    ts = []
    for i in range(frames):
        t0 = time.perf_counter()
        renderer.render(scene, static_cam, seed=i + 1)
        sync(dev)
        ts.append(time.perf_counter() - t0)
    static = record("static", ts, before)

    # -- orbit, synced -------------------------------------------------------
    before = launch_count()
    ts = []
    for i, cam in enumerate(cams):
        renderer._sl_cache = None       # every frame pays the rebuild
        t0 = time.perf_counter()
        renderer.render(scene, cam, seed=i + 1)
        sync(dev)
        ts.append(time.perf_counter() - t0)
    record("orbit-synced", ts, before, n_capacities=len(by_cap),
           overhead_pct=overhead(ts))

    # -- orbit, pipelined ----------------------------------------------------
    renderer._sl_cache = None
    renderer.shortlists(pscene, cams[0])
    sync(dev)

    def orbit_host(i):
        renderer._sl_cache = None
        renderer.shortlists(pscene, cams[i + 1])

    before = launch_count()
    ts, host, device_ts, sites = _pipelined(
        lambda i: renderer.render(scene, cams[i], seed=i + 1), orbit_host,
        frames, dev)
    record("orbit-pipelined", ts, before, overhead_pct=overhead(ts),
           **arms(host, device_ts, sites))

    # -- per-frame sphere edit, synced (gizmo-drag analog) -------------------
    apply_edit = edit_sequence(world, dev)
    before = launch_count()
    ts = []
    for i in range(frames):
        t0 = time.perf_counter()
        sc = apply_edit(i)
        renderer.render(sc, static_cam, seed=i + 1)
        sync(dev)
        ts.append(time.perf_counter() - t0)
    record("edit-synced", ts, before, overhead_pct=overhead(ts))

    # -- per-frame sphere edit, pipelined ------------------------------------
    scenes = [apply_edit(-1)]
    renderer.prepare(scenes[0])
    sync(dev)

    def edit_host(i):
        scenes.append(apply_edit(i))
        ps = renderer.prepare(scenes[-1])
        renderer.shortlists(ps, static_cam)

    before = launch_count()
    ts, host, device_ts, sites = _pipelined(
        lambda i: renderer.render(scenes[i], static_cam, seed=i + 1),
        edit_host, frames, dev)
    record("edit-pipelined", ts, before, overhead_pct=overhead(ts),
           **arms(host, device_ts, sites))
    return rows


def main(device=None):
    dev = resolve_device(device)
    rows = bench(device=dev)
    rows += bench(width=1280, height=720, spp=4, frames=24, device=dev)
    print(json.dumps({"device": card_fields(dev), "rows": len(rows)}))
    return rows


if __name__ == "__main__":
    main(device_arg(__doc__.splitlines()[0]))
    sys.exit(0)
