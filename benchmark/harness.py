"""One run of one cell: set-up, the measured window, the reference check and
the result line, all found by name.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``: the
parameters of its kind, ``traffic/<kind>.py``, the loop and the entry the
frames go through, ``entries/<entry>.py``), how many frames it compares and
the limits of its checks; the configuration names its scene
(``scenes/<scene>.py``) and its reference (``reference/<module>.py``). A
scene with an ``aperture`` above 0 and a ``focus_distance`` has a thin lens:
the program's camera and frame take it (:func:`lens`), and so does the
reference, which reads both from the scene's arrays. Each
metric that ``BENCHMARK.json`` lists for the cell is read by
``metrics/<metric>.py`` from the run's records. Nothing here names a cell,
a configuration, a traffic kind or a metric.

A traffic kind yields ``(frame_seed, pose, edits)`` a frame. Edits change
the scene through the program's public scene API (a sphere's ``"center"``,
by its index in the scene's arrays); the program's scene is then extracted
anew and the camera's host work redone, as it is when the pose moves. The window runs frames until
``seconds`` have passed: one frame in flight, each waited for (``loop:
closed``), or the next frame's host work done while the card renders
(``loop: pipelined``). A frame's latency runs from the moment the host
takes up its inputs to its completion on the card, read from CUDA events
recorded against one at the window's synchronised start. Frames to compare
are drawn from the seed over the whole window (a reservoir sample), kept as
the program returned them, and held to the reference, over the scene as
that frame's edits left it, once the window has closed and the program is
freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from timeline import SPAN_PREFIX, breakdown, busy_s

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bevyray_tpu")
# A pixel whose colour or depth differs from the reference's by more than
# these counts as a mismatch: far above float32 rounding (~1e-6), far below
# what one sample's path taking another branch moves (~1 / spp).
PIXEL_TOL = 1e-3
DEPTH_TOL = 1e-3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    modname = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload: str):
    """(BENCHMARK.json, the cell's file, its configuration's file, its
    end-to-end metrics, its per-layer metrics). A cell with a file that
    BENCHMARK.json does not list yet runs too, and reports the metrics
    listed for every cell."""
    bench = load_json(ROOT / "BENCHMARK.json")
    path = HERE / "workloads" / f"{workload}.json"
    if not path.is_file():
        raise KeyError(f"no workload {workload!r} ({path})")
    cell = load_json(path)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return (bench, cell, config, mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark never loads."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def material(m):
    """A row of the scene's ``materials`` as the program's material."""
    from bevyray_tpu_torch import StandardMaterial

    m = [float(x) for x in m]
    return StandardMaterial(
        base_color=tuple(m[0:3]), metallic=m[3], perceptual_roughness=m[4],
        reflectance=m[5], ior=m[6], specular_transmission=m[7],
        emissive=tuple(m[8:11]))


# A sphere's edit: the column of the scene's arrays it sets, and the
# program's World method that takes it.
EDITS = {"center": ("centers", lambda w, i, v: w.set_translation(i, v))}


def edit_world(world, edits) -> None:
    """``edits`` through the program's public scene API; a sphere's index in
    the scene's arrays is its entity id, as :func:`port_world` spawns
    them."""
    for index, key, value in edits:
        EDITS[key][1](world, index, value)


def edited(scene: dict, edits) -> dict:
    """A copy of the scene's arrays with ``edits`` applied."""
    out = dict(scene)
    for index, key, value in edits:
        column = EDITS[key][0]
        if out[column] is scene[column]:
            out[column] = scene[column].copy()
        out[column][index] = value
    return out


def lens(scene: dict):
    """The scene's thin lens as the program's ``RaytracedCamera``, or None:
    a pinhole where the scene gives no ``aperture`` (the lens's diameter)
    above 0."""
    from bevyray_tpu_torch import RaytracedCamera

    aperture = float(scene.get("aperture", 0.0))
    if aperture <= 0.0:
        return None
    return RaytracedCamera(aperture=aperture,
                           focus_distance=float(scene["focus_distance"]))


def render_config(config: dict, scene: dict):
    """The configuration's frame as the program's ``RenderConfig``, with
    the thin lens on where the scene has one."""
    from bevyray_tpu_torch import RenderConfig

    width, height = config["resolution"]
    return RenderConfig(width=width, height=height,
                        samples_per_pixel=config["samples_per_pixel"],
                        bounces=config["bounces"], level=config["level"],
                        defocus=lens(scene) is not None)


def port_world(scene: dict):
    """The scene's arrays and camera as a ``World`` of the program, through
    its public scene API."""
    from bevyray_tpu_torch import (PerspectiveProjection, RaytracedMesh,
                                   RaytracedSphere, Transform, World)

    world = World()
    for c, r, m in zip(scene["centers"], scene["radii"], scene["materials"]):
        world.spawn_sphere(Transform.from_xyz(*(float(x) for x in c)),
                           RaytracedSphere(float(r)), material(m))
    for translation, vertices, indices, m in scene.get("raster_meshes", ()):
        world.spawn_raster_mesh(Transform.from_xyz(*translation),
                                RaytracedMesh(vertices, indices), material(m))
    world.set_camera(
        Transform.from_xyz(*scene["eye"]).looking_at(scene["target"]),
        PerspectiveProjection(fov=scene["fov"], near=scene["near"],
                              far=scene["far"]), lens(scene))
    return world


class Clock:
    """Host time, and on a card CUDA events against one recorded at the
    window's synchronised start."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.device = device

    def start(self):
        self.sync()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev0 = self.torch.cuda.Event(enable_timing=True)
            self.ev0.record()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def done_s(self, mark) -> float:
        """When ``mark``'s work completed, on the window's clock (after
        :meth:`wait`)."""
        if not self.cuda:
            return self.now()
        return self.ev0.elapsed_time(mark) / 1e3


class Phases:
    """Seconds from process start at the end of each stage of set-up."""

    def __init__(self, t_start: float):
        self.t_start, self.marks = t_start, []

    def __call__(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def __str__(self) -> str:
        out, last = [], 0.0
        for name, t in self.marks:
            out.append(f"{name} {t - last:.3f}")
            last = t
        return ", ".join(out) + " s"


class Spans:
    """The benchmark's host spans: profiler ranges in a traced run, nothing
    otherwise."""

    def __init__(self, tracing: bool):
        self.tracing = tracing

    def __call__(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)


class Inputs:
    """A frame's inputs to the entry, brought up to date with each frame the
    traffic yields: its edits applied to the program's scene, which is then
    extracted anew (span ``scene_host``), and the camera's host work redone
    where the pose moved or the scene changed (span ``camera_host``).
    ``arrays`` follows the edits on the scene's arrays, copied on write, so
    that each frame keeps the arrays it was rendered from."""

    def __init__(self, arrays, world, take_camera, take_scene, span):
        self.arrays, self.world, self.span = arrays, world, span
        self.take_camera, self.take_scene = take_camera, take_scene
        self.pose, self.args = None, None

    def take(self, pose, edits):
        if edits:
            with self.span("scene_host"):
                self.arrays = edited(self.arrays, edits)
                edit_world(self.world, edits)
                self.take_scene()
        if edits or pose != self.pose:
            with self.span("camera_host"):
                self.args = self.take_camera(pose)
            self.pose = pose
        return self.args


def window(entry, inputs, frames, loop: str, seconds: float, clock, span,
           keep: int, rnd: random.Random):
    """Run frames for ``seconds``; returns (window_s, latencies ms, rays
    tensors, the kept frames as (frame_seed, pose, scene arrays,
    FrameResult))."""
    latencies, rays, kept = [], [], []

    def take():
        seed, pose, edits = next(frames)
        t_in = clock.now()
        args = inputs.take(pose, edits)
        return (seed, pose, inputs.arrays, t_in), args

    def finish(j, seed, pose, arrays, t_in, frame, mark):
        with span("wait"):
            clock.wait(mark)
        latencies.append((clock.done_s(mark) - t_in) * 1e3)
        rays.append(frame.rays_traced)
        item = (seed, pose, arrays, frame)
        if j < keep:
            kept.append(item)
        else:
            r = rnd.randrange(j + 1)
            if r < keep:
                kept[r] = item

    clock.start()
    j = 0
    done, args = take()
    while True:
        with span("dispatch"):
            frame = entry.render(*args, done[0])
        mark = clock.mark()
        if loop == "pipelined":
            following = take()
        finish(j, *done, frame, mark)
        j += 1
        if clock.now() >= seconds:
            break
        done, args = following if loop == "pipelined" else take()
    return clock.now(), latencies, rays, kept


def trace_records(prof) -> dict:
    """Spans and device activities of a profiled window, in seconds from
    the window's start on the profiler's clock."""
    from torch.autograd import DeviceType

    events = prof.events()
    start = min((e.time_range.start for e in events
                 if e.name == SPAN_PREFIX + "window"), default=None)
    if start is None:
        raise RuntimeError("the trace holds no window span")
    spans, device = [], []
    for e in events:
        s = (e.time_range.start - start) / 1e6
        t = (e.time_range.end - start) / 1e6
        if e.name.startswith(SPAN_PREFIX):
            # A span shows on the host and again on the device's timeline.
            if (e.device_type != DeviceType.CUDA
                    and e.name != SPAN_PREFIX + "window"):
                spans.append((e.name[len(SPAN_PREFIX):], s, t))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
    return {"spans": spans, "device": device}


def compare(frame, reference) -> dict:
    """Mismatched pixels and the segment count's gap of one frame against
    the reference's (image [P, 3], depth [P], segments)."""
    image, depth, rays = frame
    ref_image, ref_depth, ref_rays = reference
    d_img = np.abs(image.reshape(-1, 3) - ref_image).max(axis=1)
    d_depth = np.abs(depth.reshape(-1) - ref_depth)
    bad = ((~np.isfinite(d_img)) | (~np.isfinite(d_depth)) | (d_img > PIXEL_TOL)
           | (d_depth > DEPTH_TOL * np.maximum(1.0, np.abs(ref_depth))))
    return {"pixels": int(bad.size), "mismatched": int(bad.sum()),
            "rays_gap": abs(int(rays) - int(ref_rays)) / max(int(ref_rays), 1)}


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start,
             device=None, overrides=None, wrap_entry=None,
             scene_overrides=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``device`` None is the card. ``overrides`` replace numbers of the
    configuration, ``scene_overrides`` keys of the scene's arrays, and
    ``wrap_entry`` wraps the entry: the harness's own tests use them to run
    on the CPU at a small size, to give the scene a lens, to break the
    timed path, and to put the reference in the program's place."""
    import torch

    from bevyray_tpu_torch import Transform
    from bevyray_tpu_torch.engine.raster import raster_layer

    phases = Phases(t_start)
    dev = torch.device(device or "cuda")
    _, cell, config, e2e, per_layer = cell_spec(workload)
    config = dict(config, **(overrides or {}))
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    kind = load_module("traffic", mix["kind"])
    entry_mod = load_module("entries", mix["entry"])
    reference = importlib.import_module(f"reference.{config['reference']}")
    phases("imports")
    scene = dict(load_module("scenes", config["scene"]).build(
        config["scene_seed"]), **(scene_overrides or {}))
    width, height = config["resolution"]
    level = config["level"]
    rconfig = render_config(config, scene)

    world = port_world(scene)
    phases("world")
    buffers = world.extract(with_bvh=False, device=dev)
    phases("extract")
    entry = entry_mod.Entry(rconfig, buffers, dev)
    phases("entry")
    if wrap_entry is not None:
        entry = wrap_entry(entry, {
            "config": config, "rconfig": rconfig, "draws": entry_mod.DRAWS,
            "device": dev, "arrays": lambda: inputs.arrays,
            "make_entry": lambda rc: entry_mod.Entry(rc, buffers, dev)})

    def take_camera(pose):
        world.set_camera(Transform.from_xyz(*pose["eye"])
                         .looking_at(pose["target"]))
        cam = world.camera_state(aspect=width / height, device=dev)
        rc, rd = ((raster_layer(world, cam, rconfig, device=dev))
                  if level in (1, 2) else (None, None))
        entry.camera(cam, pose)
        return cam, rc, rd

    def take_scene():
        entry.scene(world.extract(with_bvh=False, device=dev))

    span = Spans(trace)
    inputs = Inputs(scene, world, take_camera, take_scene, span)
    frames = kind.frames(mix, seed, scene)
    warm_seed, warm_pose, warm_edits = next(frames)
    args = inputs.take(warm_pose, warm_edits)
    phases("camera")
    entry.render(*args, warm_seed)
    entry.check()
    clock = Clock(dev)
    clock.sync()
    phases("warm-up")
    rnd = random.Random(f"{seed}/compare")
    setup_s = time.perf_counter() - t_start

    records = {"setup_s": setup_s}
    loop = mix["loop"]
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(SPAN_PREFIX + "window"):
                window_s, latencies, rays, kept = window(
                    entry, inputs, frames, loop, seconds, clock, span,
                    cell["compare_frames"], rnd)
        records.update(trace_records(prof))
        del prof
    else:
        window_s, latencies, rays, kept = window(
            entry, inputs, frames, loop, seconds, clock, span,
            cell["compare_frames"], rnd)
    records.update(window_s=window_s, frames=len(latencies),
                   latency_ms=latencies)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    rays_total = int(torch.stack(rays).sum())
    print(f"rays_per_s {rays_total / window_s / 1e6:.6f} Mrays/s "
          f"({rays_total} segments in {len(latencies)} frames, "
          f"{window_s:.6f} s)", flush=True)
    print(f"setup {phases}", file=sys.stderr, flush=True)

    # The program's outputs to the host, then the program freed.
    outputs = [(s, p, a, (f.image.cpu().numpy(), f.rt_depth.cpu().numpy(),
                          int(f.rays_traced))) for s, p, a, f in kept]
    del entry, buffers, world, kept, rays, take_camera, take_scene, inputs
    del args
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pixels = mismatched = 0
    rays_gap = 0.0
    t_ref = time.perf_counter()
    for frame_seed, pose, arrays, out in outputs:
        ref = reference.render(arrays, pose, width, height,
                               config["samples_per_pixel"], config["bounces"],
                               level, frame_seed, entry_mod.DRAWS,
                               device=dev)
        c = compare(out, ref)
        pixels += c["pixels"]
        mismatched += c["mismatched"]
        rays_gap = max(rays_gap, c["rays_gap"])
    print(f"reference {len(outputs)} frames in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    values = {"mismatch_share": mismatched / max(pixels, 1),
              "rays_gap": rays_gap}
    checks = {k: {"value": v, "limit": cell["checks"][k]}
              for k, v in values.items()}
    correct = bool(outputs) and all(c["value"] <= c["limit"]
                                    for c in checks.values())

    metrics = {}
    for m in (per_layer if trace else e2e):
        value = load_module("metrics", m["name"]).read(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else dev.type),
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(latencies), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info.update(busy_s=busy_s(records),
                        window_s=records["window_s"])
        if records["device"]:
            result["breakdown"] = breakdown(records)
    result["checks"] = checks
    if dev.type == "cuda":
        print(f"card {card_line(dev)}", file=sys.stderr, flush=True)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    return result
