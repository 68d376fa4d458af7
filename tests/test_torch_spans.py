"""The port's spans (``utils/profiling.py`` ``span``) under torch's profiler
on the CPU: each renderer's frame is ``frame_setup`` then ``queue``, the
fused renderer's cache builds are ``tables_build`` and ``shortlists_build``
inside ``frame_setup``, every range the port opens carries
``SPAN_PREFIX``, the prefix the benchmark's trace reader collects, and with
no profiler running no range is opened at all; the card's work in a profile
(``device_kernels``) leaves the spans out."""

import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bevyray_tpu_torch as bt
from bevyray_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = bt.RenderConfig(width=16, height=16, samples_per_pixel=1, bounces=1,
                         level=3)
RENDERERS = {"fused": lambda cfg: bt.FusedRenderer(cfg, exact_rng=False),
             "wavefront": bt.Renderer}


def _world():
    world = bt.rtiow.material_test_scene()
    return world, world.extract(with_bvh=False, device="cpu")


def _camera(world, x=0.0):
    world.set_camera(bt.Transform.from_xyz(x, 1.0, 5.0)
                     .looking_at((0.0, 0.0, -1.0)))
    return world.camera_state(aspect=1.0, device="cpu")


def _ranges(fn) -> list:
    """``(name, start, end)`` of every profiler range opened in ``fn()``,
    in the order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.is_user_annotation),
                  key=lambda r: r[1])


def _names(ranges) -> list:
    return [name[len(profiling.SPAN_PREFIX):] for name, _, _ in ranges]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


@pytest.mark.parametrize("kind", sorted(RENDERERS))
def test_frame_is_setup_then_queue(kind):
    world, scene = _world()
    cam = _camera(world)
    renderer = RENDERERS[kind](CONFIG)
    renderer.render(scene, cam, seed=1)
    ranges = _ranges(lambda: renderer.render(scene, cam, seed=2))
    assert all(name.startswith(profiling.SPAN_PREFIX)
               for name, _, _ in ranges)
    assert _names(ranges) == ["frame_setup", "queue"]
    setup, queue = ranges
    assert setup[2] <= queue[1]


@pytest.mark.parametrize("kind", sorted(RENDERERS))
def test_passthrough_frame_is_setup_only(kind):
    world, scene = _world()
    cam = _camera(world)
    renderer = RENDERERS[kind](dataclasses.replace(CONFIG, level=0))
    ranges = _ranges(lambda: renderer.render(scene, cam, seed=1))
    assert _names(ranges)[0] == "frame_setup"
    assert "queue" not in _names(ranges)


def test_fused_cache_builds_lie_inside_frame_setup():
    world, scene = _world()
    cam = _camera(world)
    renderer = RENDERERS["fused"](CONFIG)
    first = _ranges(lambda: renderer.render(scene, cam, seed=1))
    assert _names(first) == ["frame_setup", "tables_build",
                             "shortlists_build", "queue"]
    assert all(_inside(r, first[0]) for r in first[1:3])
    again = _ranges(lambda: renderer.render(scene, cam, seed=2))
    assert _names(again) == ["frame_setup", "queue"]
    moved = _camera(world, x=0.5)
    after = _ranges(lambda: renderer.render(scene, moved, seed=3))
    assert _names(after) == ["frame_setup", "shortlists_build", "queue"]
    assert _inside(after[1], after[0])


def test_prefix_is_the_trace_readers():
    spec = importlib.util.spec_from_file_location(
        "bench_timeline", ROOT / "benchmark" / "timeline.py")
    timeline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timeline)
    assert profiling.SPAN_PREFIX == timeline.SPAN_PREFIX


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("frame_setup") is profiling.span("queue")
    world, scene = _world()
    cam = _camera(world)
    for make in RENDERERS.values():
        frame = make(CONFIG).render(scene, cam, seed=1)
        assert int(frame.rays_traced) > 0


def test_device_kernels_leave_the_spans_out():
    # On a card the profiler lists each span again on the CUDA timeline.
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def entry(key, device_type, user):
        return SimpleNamespace(key=key, device_type=device_type,
                               is_user_annotation=user)

    entries = [entry("render_kernel", cuda, False),
               entry(profiling.SPAN_PREFIX + "queue", cuda, True),
               entry(profiling.SPAN_PREFIX + "queue", cpu, True),
               entry("aten::zeros", cpu, False),
               entry("Memset (Device)", cuda, False)]
    prof = SimpleNamespace(key_averages=lambda: entries)
    assert [e.key for e in profiling.device_kernels(prof)] == [
        "render_kernel", "Memset (Device)"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("frame"):
            torch.zeros(4).sum()
    assert profiling.device_kernels(prof) == []
