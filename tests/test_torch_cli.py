"""The port's command line (``app/cli.py``), inspector, PNG writer and
profiling helpers, on the CPU, against the JAX package's: twins of
tests/test_cli.py and tests/test_inspector.py with ``--platform cpu``, the
same PNG bytes for the same array, the same ``pick`` ids and ``describe``
text for the same world, and one command line through both packages'
CLIs (decoded PNGs within one 8-bit level: the frames agree to 5e-5).
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.app import cli as jcli
from bevyray_tpu.app import inspector as jinspector
from bevyray_tpu.utils import png as jpng
from bevyray_tpu.utils import profiling as jprofiling
from bevyray_tpu_torch.app import inspector
from bevyray_tpu_torch.app.cli import main
from bevyray_tpu_torch.engine import fused_renderer as pfused
from bevyray_tpu_torch.engine import renderer as prenderer
from bevyray_tpu_torch.engine.denoise import atrous_denoise
from bevyray_tpu_torch.engine.film import ProgressiveRenderer
from bevyray_tpu_torch.utils import png, profiling

torch.set_num_threads(2)

CPU = ["--platform", "cpu"]


def _read_png(path):
    """The RGB pixels of a PNG written by ``write_png`` (one IDAT stream,
    filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _spy(monkeypatch, cls):
    """Record every frame ``cls.render`` returns, by seed."""
    seen = {}
    real = cls.render

    def render(self, scene, cam, seed=0, **kw):
        frame = real(self, scene, cam, seed=seed, **kw)
        seen[seed] = frame
        return frame

    monkeypatch.setattr(cls, "render", render)
    return seen


# -- twins of tests/test_cli.py -----------------------------------------------

def test_cli_render(tmp_path, capsys):
    out = str(tmp_path / "x.png")
    rc = main(["render", "--scene", "material", "--width", "32", "--height",
               "24", "--spp", "1", "--bounces", "2", "--out", out, *CPU])
    assert rc == 0
    assert os.path.getsize(out) > 100
    assert "Mrays/s" in capsys.readouterr().out


def test_cli_accumulate(tmp_path, capsys):
    out = str(tmp_path / "acc.png")
    rc = main(["accumulate", "--scene", "simple", "--width", "16", "--height",
               "16", "--spp", "1", "--bounces", "2", "--passes", "2", "--out",
               out, *CPU])
    assert rc == 0
    assert "accumulated 2 spp" in capsys.readouterr().out


def test_cli_bench_json(capsys):
    rc = main(["bench", "--scene", "simple", "--width", "16", "--height", "16",
               "--spp", "1", "--bounces", "1", "--frames", "2", *CPU])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "p50_frame_ms",
                        "rays_per_frame", "device"}
    assert rec["device"] == "cpu" and rec["value"] > 0
    np.testing.assert_allclose(
        rec["value"], rec["rays_per_frame"] / rec["p50_frame_ms"] / 1e3,
        rtol=0.02, atol=0.006)   # value/p50 are rounded to 2 decimals


def test_cli_bench_rays_come_from_timed_frames(capsys, monkeypatch):
    seen = _spy(monkeypatch, prenderer.Renderer)
    rc = main(["bench", "--scene", "material", "--width", "32", "--height",
               "32", "--spp", "2", "--bounces", "4", "--frames", "3",
               "--backend", "brute", *CPU])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    timed = [float(seen[s].rays_traced) for s in (1, 2, 3)]
    assert rec["rays_per_frame"] == int(np.mean(timed))


def test_cli_render_pallas_backend(tmp_path, monkeypatch):
    seen = _spy(monkeypatch, pfused.FusedRenderer)
    out = str(tmp_path / "p.png")
    rc = main(["render", "--scene", "material", "--width", "16", "--height",
               "16", "--spp", "1", "--bounces", "2", "--backend", "pallas",
               "--out", out, *CPU])
    assert rc == 0
    assert os.path.getsize(out) > 100
    assert list(seen) == [1]


def test_cli_platform_flag(tmp_path, capsys):
    """``--platform cpu`` runs on the CPU; the default (auto) is the card
    and raises without one, never falling back to the CPU."""
    out = str(tmp_path / "p.png")
    argv = ["render", "--scene", "simple", "--width", "16", "--height", "16",
            "--spp", "1", "--bounces", "1", "--out", out]
    assert main(argv + CPU) == 0
    assert os.path.getsize(out) > 100
    assert "Mrays/s" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(argv)


def test_cli_denoise_flag(tmp_path, monkeypatch):
    """Twin of tests/test_denoise.py's CLI test, at level 2 over the final
    scene's raster cube: the image written is ``atrous_denoise`` of the
    frame, with the raster layer's depth (as view-z) folded into the
    guide."""
    from bevyray_tpu_torch.engine.raster import raster_layer

    seen = _spy(monkeypatch, prenderer.Renderer)
    written = {}
    monkeypatch.setattr(png, "write_png",
                        lambda path, image: written.update(image=image))
    argv = ["render", "--scene", "final", "--width", "32", "--height", "18",
            "--spp", "2", "--bounces", "2", "--level", "2", "--backend",
            "brute", "--denoise", "2", "--out", str(tmp_path / "d.png"), *CPU]
    assert main(argv) == 0
    frame = seen[1]
    world = bt.rtiow.final_scene(seed=42)
    cam = world.camera_state(aspect=32 / 18, device="cpu")
    _, rd = raster_layer(world, cam, bt.RenderConfig(width=32, height=18,
                                                     level=2), device="cpu")
    rd = rd.reshape(18, 32)
    assert bool((rd > 0).any())
    guide = torch.where(rd > 0, torch.minimum(
        frame.rt_depth, cam.near / torch.clamp(rd, min=1e-8)), frame.rt_depth)
    want = atrous_denoise(frame.image, guide, iterations=2)
    np.testing.assert_array_equal(written["image"], want.numpy())
    assert not np.array_equal(written["image"], frame.image.numpy())


def test_cli_adaptive_accumulate_takes_a_bvh_scene(tmp_path, capsys):
    """``--backend auto`` extracts a BVH; the adaptive controller runs the
    fused path on that scene. Other wavefront backends are refused."""
    argv = ["accumulate", "--scene", "simple", "--width", "16", "--height",
            "16", "--spp", "2", "--bounces", "2", "--passes", "3",
            "--adaptive-tolerance", "0.05", "--out", str(tmp_path / "a.png"),
            *CPU]
    assert main(argv) == 0
    assert "mean (adaptive) spp" in capsys.readouterr().out
    assert main(argv + ["--backend", "bvh"]) == 2


@pytest.mark.parametrize("extra", [["--backend", "brute"],
                                   ["--backend", "bvh"],
                                   ["--level", "2", "--denoise", "2"]],
                         ids=["brute", "bvh", "level2_denoise"])
def test_cli_matches_jax_cli(tmp_path, extra):
    """One command line through both CLIs: the same PNG to within one 8-bit
    level per channel (the frames agree to atol 5e-5)."""
    argv = ["render", "--scene", "final", "--width", "32", "--height", "18",
            "--spp", "2", "--bounces", "2", "--seed", "3", *extra]
    assert main(argv + ["--out", str(tmp_path / "p.png"), *CPU]) == 0
    assert jcli.main(argv + ["--out", str(tmp_path / "j.png"),
                             "--platform", "cpu"]) == 0
    got = _read_png(tmp_path / "p.png").astype(int)
    want = _read_png(tmp_path / "j.png").astype(int)
    assert np.abs(got - want).max() <= 1


# -- PNG, inspector, profiling --------------------------------------------------

def test_write_png_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    floats = rng.uniform(-0.2, 1.2, (13, 17, 3)).astype(np.float32)
    bytes_ = rng.randint(0, 256, (5, 9, 3)).astype(np.uint8)
    for i, image in enumerate((floats, bytes_)):
        png.write_png(str(tmp_path / f"p{i}.png"), image)
        jpng.write_png(str(tmp_path / f"j{i}.png"), image)
        assert ((tmp_path / f"p{i}.png").read_bytes()
                == (tmp_path / f"j{i}.png").read_bytes())
    assert (_read_png(tmp_path / "p1.png") == bytes_).all()


def _edited(pkg):
    w = pkg.rtiow.final_scene(seed=42)
    w.despawn(3)
    w.set_translation(5, (0.5, 1.0, -1.0))
    w.set_radius(6, -0.3)
    return w


@pytest.mark.parametrize("world_fn", [lambda pkg: pkg.rtiow.final_scene(seed=42),
                                      lambda pkg: pkg.rtiow.night_scene(),
                                      _edited],
                         ids=["final", "night", "edited"])
def test_pick_and_describe_equal_jax(world_fn):
    pw, jw = world_fn(bt), world_fn(jb)
    assert inspector.describe(pw) == jinspector.describe(jw)
    for px in range(0, 96, 7):
        for py in range(0, 54, 5):
            assert (inspector.pick(pw, px, py, 96, 54)
                    == jinspector.pick(jw, px, py, 96, 54))


def test_pick_center_sphere():
    assert inspector.pick(bt.rtiow.material_test_scene(), px=64, py=64,
                          width=128, height=128) == 1


def test_pick_sky_returns_none():
    assert inspector.pick(bt.rtiow.material_test_scene(), px=64, py=1,
                          width=128, height=128) is None


def test_pick_respects_despawn():
    world = bt.World()
    a = world.spawn_sphere(bt.Transform.from_xyz(0, 0, -5),
                           bt.RaytracedSphere(1.0), bt.StandardMaterial())
    b = world.spawn_sphere(bt.Transform.from_xyz(0, 0, -10),
                           bt.RaytracedSphere(1.0), bt.StandardMaterial())
    assert inspector.pick(world, 16, 16, 32, 32) == a
    world.despawn(a)
    assert inspector.pick(world, 16, 16, 32, 32) == b


def test_describe_lists_entities():
    text = inspector.describe(bt.rtiow.simple_scene())
    assert "4 live spheres" in text
    assert "diffuse" in text and "Camera:" in text


def test_film_checkpoint_roundtrip(tmp_path):
    world = bt.rtiow.simple_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=2,
                          bounces=2, level=3)
    prog = ProgressiveRenderer(cfg, device="cpu")
    prog.step(scene, cam, seed=1)
    path = str(tmp_path / "film.npz")
    prog.save(path)
    resumed = ProgressiveRenderer(cfg, device="cpu")
    resumed.load(path, cam)
    assert resumed.samples_accumulated == 2
    a = resumed.step(scene, cam, seed=1)
    straight = ProgressiveRenderer(cfg, device="cpu")
    straight.step(scene, cam, seed=1)
    b = straight.step(scene, cam, seed=1)
    np.testing.assert_allclose(a.image.numpy(), b.image.numpy(), atol=1e-6)


def test_profiling_helpers(tmp_path):
    """``time_frames`` takes its rays from the warm-up frame and reports
    JAX's summary keys; ``device_trace`` writes a trace into its directory
    and ``named_scope`` ranges show in it."""
    world = bt.rtiow.simple_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    r = bt.Renderer(bt.RenderConfig(width=8, height=8, samples_per_pixel=1,
                                    bounces=1, level=3))
    stats = profiling.time_frames(lambda s: r.render(scene, cam, seed=s),
                                  n_frames=3)
    assert len(stats.times_s) == 3
    assert stats.rays_per_frame == float(r.render(scene, cam,
                                                  seed=0).rays_traced)
    want = jprofiling.FrameStats(stats.times_s, stats.rays_per_frame)
    assert stats.summary() == want.summary()
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.named_scope("frame"):
            r.render(scene, cam, seed=1)
    assert any(e.key == "frame" for e in prof.key_averages())
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())


@pytest.mark.cuda
def test_cuda_cli_backends_match_direct_renderers(tmp_path, monkeypatch):
    """On the card, chip_smoke.py phase 10 (a)-(c) at 128x72, 4 spp: the
    default platform and backend ("auto" -> "brute" with a BVH extracted)
    bit-equal to ``Renderer.render``; "bvh" within 1e-6 with equal
    segments; "pallas" launches the CUDA kernel, bit-equal to
    ``FusedRenderer.render``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from bevyray_tpu_torch.kernels.cuda import megakernel

    seen = _spy(monkeypatch, prenderer.Renderer)
    fused = _spy(monkeypatch, pfused.FusedRenderer)
    argv = ["render", "--width", "128", "--height", "72", "--spp", "4",
            "--out", str(tmp_path / "x.png")]
    world = bt.rtiow.final_scene(seed=42)
    cfg = bt.RenderConfig(width=128, height=72, samples_per_pixel=4,
                          bounces=4, level=3)
    cam = world.camera_state(aspect=128 / 72, device="cuda")
    assert main(argv) == 0
    auto = seen.pop(1)
    want = bt.Renderer(cfg).render(world.extract(device="cuda"), cam, seed=1)
    assert auto.image.is_cuda and torch.equal(auto.image, want.image)
    assert main(argv + ["--backend", "bvh"]) == 0
    bvh = seen.pop(1)
    assert float((bvh.image - auto.image).abs().max()) <= 1e-6
    assert int(bvh.rays_traced) == int(auto.rays_traced)
    launches = megakernel.render_tiles.launches
    assert main(argv + ["--backend", "pallas"]) == 0
    assert megakernel.render_tiles.launches == launches + 1
    want = bt.FusedRenderer(cfg).render(
        world.extract(with_bvh=False, device="cuda"), cam, seed=1)
    assert torch.equal(fused[1].image, want.image)
