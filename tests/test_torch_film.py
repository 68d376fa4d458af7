"""The port's progressive film (``engine/film.py``) and its accumulating
kernel inputs, against the JAX package on the CPU: the JAX fused kernel in
Pallas interpret mode, the port through its plain version.

- ``render_tiles`` with a per-lane sample map and a sample offset, in all
  four sphere-walk modes, against JAX ``render_tiles`` (bars of
  tests/test_pallas.py:24-28: r/g/b atol 5e-5, depth atol 1e-3, segments
  equal), each mode also bit-equal to the port's off/grouped mode;
- ``ProgressiveRenderer(backend="pallas")`` and the default wavefront
  backend against JAX's, pass by pass, and films saved by either package
  resumed in the other;
- the JAX package's own film tests, run in the port.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.engine.film import ProgressiveRenderer as JProgressive
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.engine import film as bfilm
from bevyray_tpu_torch.kernels.cuda import megakernel as mk

from test_torch_megakernel import _check_against_jax, _inputs

torch.set_num_threads(2)

MODES = [("off", "grouped"), ("split", "grouped"), ("off", "candidates"),
         ("split", "candidates")]


def _both(jworld, aspect=1.0):
    js, jcam = jworld.extract(with_bvh=False), jworld.camera_state(aspect=aspect)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam


def _close(got, want, depth=True):
    """The bars: image atol 5e-5, depth atol 1e-3, segment counts equal."""
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    if depth:
        np.testing.assert_allclose(got.rt_depth.numpy(),
                                   np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


# -- the kernel's accumulation inputs ----------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=["/".join(m) for m in MODES])
def test_render_tiles_spp_map_and_offset_match_jax(mode):
    """A seeded random map of targets 0..spp (0: the lane traces nothing)
    and ``sample_offset=5``: the port's sums equal JAX's at the bars, and
    every mode gives the port's off/grouped bits. On frame seed 5 the two
    packages and a float64 replay agree on every pixel; on other seeds of
    0-15 up to 2 pixels differ, each package as often off the float64 path
    as the other (tests/torch_float64_witness.py --map, ROADMAP §C)."""
    w, h, spp = 96, 64, 2
    spp_map = np.random.default_rng(3).integers(
        0, spp + 1, (2, mk.TILE // 128, 128)).astype(np.int32)
    got = _check_against_jax(
        jrtiow.final_scene(seed=42, grid=4), w, h, 5, mode=mode,
        split=mode[0] == "split", spp_map=spp_map, sample_offset=5,
        pallas_primary=mode[0], pallas_intersect=mode[1])
    # Lanes with target 0 trace nothing and hold zero sums.
    cfg = bt.RenderConfig(w, h, spp, 4, level=3)
    zero = mk.unshuffle_blocks(torch.as_tensor(spp_map).reshape(-1),
                               cfg) == 0
    assert bool(zero.any()) and bool((~zero).any())
    for out in got[:4]:
        assert not bool(mk.unshuffle_blocks(out, cfg)[zero].any())


def test_offset_and_map_pick_the_samples():
    """Sample k of pixel p under ``sample_offset=o`` is sample o + k of a
    frame without one: a map that lets every lane trace its first sample,
    at offset 1, gives the second sample of a 2 spp frame (the sums of
    samples 0 and 1 minus the sums of sample 0 alone)."""
    _, _, kscene, pcam = _inputs(jrtiow.material_test_scene(), 32, 32)
    cfg = bt.RenderConfig(32, 32, 2, 4, level=3, pallas_primary="off",
                          pallas_intersect="grouped")
    ones = torch.ones((1, mk.TILE // 128, 128), dtype=torch.int32)
    both = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False)
    first = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False,
                            spp_map=ones)
    second = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False,
                             spp_map=ones, sample_offset=1)
    for b, f, s in zip(both[:4], first[:4], second[:4]):
        np.testing.assert_allclose(f + s, b, atol=1e-6)
    assert int(first[4]) + int(second[4]) == int(both[4])
    # The offset wraps mod 2^32, as the kernel's uint32 add does.
    last = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False,
                           spp_map=ones, sample_offset=0xFFFFFFFF)
    wrapped = mk.render_tiles(kscene, pcam, dataclasses.replace(
        cfg, samples_per_pixel=1), 3, normalize=False, sample_offset=0)
    assert not torch.equal(last[0], first[0])
    nxt = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False,
                          sample_offset=0xFFFFFFFF)
    for n, l, wr in zip(nxt[:4], last[:4], wrapped[:4]):
        np.testing.assert_allclose(n, l + wr, atol=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(spp_map=np.ones((1, 32, 128), np.int32)), "spp_map"),
    (dict(spp_map=torch.ones((1, 32, 128), dtype=torch.int64)), "spp_map"),
    (dict(spp_map=torch.ones((2, 32, 128), dtype=torch.int32)), "spp_map"),
    (dict(spp_map=torch.ones((1, 4096), dtype=torch.int32)), "spp_map"),
    (dict(sample_offset=-1), "sample_offset"),
    (dict(sample_offset=1 << 32), "sample_offset"),
    (dict(sample_offset=1.0), "sample_offset"),
    (dict(sample_offset=True), "sample_offset"),
], ids=["numpy_map", "int64_map", "map_tiles", "flat_map", "negative_offset",
        "offset_2_32", "float_offset", "bool_offset"])
def test_accumulation_input_checks(kwargs, match):
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=2,
                          bounces=2, level=3)
    with pytest.raises(ValueError, match=match):
        mk.render_tiles(kscene, pcam, cfg, 1, normalize=False, **kwargs)


@pytest.mark.parametrize("backend", [None, "auto"], ids=["default", "auto"])
def test_default_backend_accumulates_like_jax(backend):
    """``ProgressiveRenderer(cfg)`` (the JAX package's default "xla") and
    ``backend="auto"`` take the wavefront ``trace_sample``: 2 passes of 8
    spp against JAX's default ``ProgressiveRenderer``, pass by pass at the
    bars, and the film equals the 16 spp ``Renderer`` frame (the same
    samples, summed in the same order)."""
    js, jcam, ps, pcam = _both(jrtiow.material_test_scene())
    cfg = dict(FILM, samples_per_pixel=8)
    jprog = JProgressive(JRenderConfig(**cfg))
    kwargs = {} if backend is None else {"backend": backend}
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**cfg), device="cpu",
                                  **kwargs)
    for seed in (9, 9):
        frame = prog.step(ps, pcam, seed=seed)
        _close(frame, jprog.step(js, jcam, seed=seed))
    assert prog.samples_accumulated == jprog.samples_accumulated == 16
    assert prog.film.rays_traced.dtype == torch.int64
    want = bt.Renderer(bt.RenderConfig(**dict(cfg, samples_per_pixel=16))
                       ).render(ps, pcam, seed=9)
    np.testing.assert_allclose(frame.image.numpy(), want.image.numpy(),
                               atol=1e-6)
    assert int(frame.rays_traced) == int(want.rays_traced)


# -- ProgressiveRenderer against the JAX package ------------------------------

FILM = dict(width=24, height=24, samples_per_pixel=2, bounces=4, level=3)


@pytest.fixture(scope="module")
def material_pair():
    """The material test scene in both packages, and one JAX pallas
    progressive renderer at FILM (its compiled pass serves every test)."""
    js, jcam, ps, pcam = _both(jrtiow.material_test_scene())
    return js, jcam, ps, pcam, JProgressive(JRenderConfig(**FILM),
                                            backend="pallas")


def test_progressive_matches_jax_pass_by_pass(material_pair):
    js, jcam, ps, pcam, jprog = material_pair
    jprog.reset()
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**FILM), backend="pallas",
                                  device="cpu")
    for seed in (9, 9, 4):
        _close(prog.step(ps, pcam, seed=seed), jprog.step(js, jcam, seed=seed))
    assert prog.samples_accumulated == jprog.samples_accumulated == 6
    assert prog.film.rays_traced.dtype == torch.int64
    assert prog.film.n_samples.dtype == torch.float32


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_film_checkpoint_crosses_packages(material_pair, tmp_path, saved_by):
    """Two passes in one package, saved, loaded in the other, then one more
    pass in both: the same image at the bars."""
    js, jcam, ps, pcam, jprog = material_pair
    jprog.reset()
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**FILM), backend="pallas",
                                  device="cpu")
    path = str(tmp_path / "film.npz")
    if saved_by == "jax":
        jprog.step(js, jcam, seed=1)
        jprog.step(js, jcam, seed=2)
        jprog.save(path)
        prog.load(path, pcam)
    else:
        prog.step(ps, pcam, seed=1)
        prog.step(ps, pcam, seed=2)
        prog.save(path)
        jprog.load(path, jcam)
    assert prog.samples_accumulated == jprog.samples_accumulated == 4
    _close(prog.step(ps, pcam, seed=3), jprog.step(js, jcam, seed=3))
    assert prog.film.rays_traced.dtype == torch.int64


# -- the JAX package's film tests, in the port -------------------------------

def _port_scene(world_fn=bt.rtiow.material_test_scene):
    world = world_fn()
    return (world, world.extract(with_bvh=False, device="cpu"),
            world.camera_state(aspect=1.0, device="cpu"))


@pytest.mark.parametrize("mode", MODES, ids=["/".join(m) for m in MODES])
def test_two_passes_equal_one_double_spp_frame(mode):
    """2 passes x 2 spp give the frame of 1 x 4 spp with the same seed: the
    film offsets the sample index, so the streams line up; only the order
    of the sums differs."""
    _, scene, cam = _port_scene(
        lambda: bt.rtiow.final_scene(seed=42, grid=4))
    cfg2 = bt.RenderConfig(64, 64, 2, 4, level=3, pallas_primary=mode[0],
                           pallas_intersect=mode[1])
    prog = bt.ProgressiveRenderer(cfg2, backend="pallas", device="cpu")
    prog.step(scene, cam, seed=9)
    frame = prog.step(scene, cam, seed=9)
    kscene = prog._renderer.prepare(scene)
    assert mk.kernel_mode(kscene, cfg2,
                          prog._renderer.shortlists(kscene, cam)[0]) == mode
    fused = bt.FusedRenderer(dataclasses.replace(cfg2, samples_per_pixel=4))
    want = fused.render(scene, cam, seed=9)
    assert fused.last_mode == mode
    np.testing.assert_allclose(frame.image.numpy(), want.image.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(frame.rt_depth.numpy(), want.rt_depth.numpy(),
                               rtol=1e-6)
    assert int(frame.rays_traced) == int(want.rays_traced)
    assert prog.samples_accumulated == 4


def test_reset_on_camera_move():
    world, scene, cam1 = _port_scene()
    cfg = bt.RenderConfig(16, 16, 1, 2, level=3)
    prog = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    prog.step(scene, cam1, seed=1)
    prog.step(scene, cam1, seed=2)
    assert prog.samples_accumulated == 2
    # Equal camera values in new tensors keep the film.
    prog.step(scene, world.camera_state(aspect=1.0, device="cpu"), seed=3)
    assert prog.samples_accumulated == 3
    world.set_camera(bt.Transform.from_xyz(0.5, 0.5, 4.0).looking_at(
        (0, 0.5, 0)))
    prog.step(scene, world.camera_state(aspect=1.0, device="cpu"), seed=3)
    assert prog.samples_accumulated == 1   # the film was reset


def test_variance_decreases_with_accumulation():
    _, scene, cam = _port_scene()
    cfg = bt.RenderConfig(24, 24, 2, 4, level=3)
    prog = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    first = prog.step(scene, cam, seed=1).image
    last = first
    for i in range(7):
        last = prog.step(scene, cam, seed=2 + i).image
    ref = bt.FusedRenderer(dataclasses.replace(cfg, samples_per_pixel=32)
                           ).render(scene, cam, seed=99).image
    assert float((last - ref).abs().mean()) < float((first - ref).abs().mean())


def test_load_rejects_mismatched_resolution(tmp_path):
    """A checkpoint of one frame size does not resume into another, even
    with the same pixel count."""
    _, scene, cam = _port_scene()
    cfg = bt.RenderConfig(24, 12, 1, 2, level=3)
    prog = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    prog.step(scene, cam, seed=1)
    path = str(tmp_path / "film.npz")
    prog.save(path)
    other = bt.ProgressiveRenderer(bt.RenderConfig(12, 24, 1, 2, level=3),
                                   backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="24x12"):
        other.load(path, cam)
    again = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    again.load(path, cam)
    assert again.samples_accumulated == 1
    # A film saved without a config is checked by its pixel count.
    bfilm.save_film(str(tmp_path / "bare.npz"), prog.film)
    with pytest.raises(ValueError, match="pixels"):
        bfilm.load_film(str(tmp_path / "bare.npz"),
                        bt.RenderConfig(16, 16), device="cpu")


def test_checkpoint_resume_continues_exactly(tmp_path):
    _, scene, cam = _port_scene()
    cfg = bt.RenderConfig(24, 24, 2, 3, level=3)
    a = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    a.step(scene, cam, seed=0)
    a.step(scene, cam, seed=1)
    path = str(tmp_path / "film.npz")
    a.save(path)
    b = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    b.load(path, cam)
    fa, fb = a.step(scene, cam, seed=2), b.step(scene, cam, seed=2)
    assert torch.equal(fa.image, fb.image)
    assert int(fa.rays_traced) == int(fb.rays_traced)


def test_film_cache_sees_material_swap():
    """New material tensors with the same sphere tensors rebuild the
    prepared scene."""
    _, scene, cam = _port_scene()
    cfg = bt.RenderConfig(16, 16, 1, 2, level=3)
    prog = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    a = prog.step(scene, cam, seed=5).image
    black = scene._replace(materials=type(scene.materials)(
        *(x * 0.0 for x in scene.materials)))
    prog.reset()
    b = prog.step(black, cam, seed=5).image
    assert float((a - b).abs().max()) > 0.1


def test_film_rejects_a_scene_on_another_device():
    _, scene, cam = _port_scene()
    prog = bt.ProgressiveRenderer(bt.RenderConfig(8, 8), backend="pallas",
                                  device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        prog.step(scene, cam, seed=1)


@pytest.mark.cuda
def test_two_passes_equal_one_double_spp_frame_on_card():
    """On the card: 2 passes x 2 spp of the kernel against its 4 spp frame:
    segments equal, image within 1e-5 (chip_smoke.py phase 5 at the
    headline)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene, cam = world.extract(with_bvh=False), world.camera_state(aspect=1.0)
    cfg2 = bt.RenderConfig(128, 128, 2, 4, level=3)
    prog = bt.ProgressiveRenderer(cfg2, backend="pallas")
    launches = mk.render_tiles.launches
    prog.step(scene, cam, seed=9)
    frame = prog.step(scene, cam, seed=9)
    assert mk.render_tiles.launches == launches + 2
    want = bt.FusedRenderer(dataclasses.replace(cfg2, samples_per_pixel=4)
                            ).render(scene, cam, seed=9)
    assert int(frame.rays_traced) == int(want.rays_traced)
    assert float((frame.image - want.image).abs().max()) <= 1e-5
