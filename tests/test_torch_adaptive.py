"""The port's adaptive sampling (``engine/adaptive.py``) against the JAX
package's on the CPU (the JAX fused kernel in Pallas interpret mode, the
port's through its plain version), checkpoints that cross the packages, and
the JAX package's own adaptive tests run in the port.

Bars: image atol 5e-5, depth atol 1e-3, segment counts equal, and the same
per-pixel sample counts."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.engine.adaptive import AdaptiveRenderer as JAdaptive
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary

torch.set_num_threads(2)

ADAPT = dict(width=64, height=64, samples_per_pixel=2, bounces=3, level=3)
TOL, REPROBE = 0.05, 2


@pytest.fixture(scope="module")
def pair():
    """The material test scene in both packages and one JAX adaptive
    renderer at ADAPT (its compiled pass serves every test)."""
    jw = jrtiow.material_test_scene()
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam, JAdaptive(JRenderConfig(**ADAPT),
                                         tolerance=TOL, reprobe_every=REPROBE)


def _port(**kw):
    return bt.AdaptiveRenderer(bt.RenderConfig(**ADAPT), **{
        "tolerance": TOL, "reprobe_every": REPROBE, **kw}, device="cpu")


def _same_state(got, want, pcam, jcam):
    """Sample maps identical; the resolved frames at the bars."""
    np.testing.assert_array_equal(got.samples_map(), want.samples_map())
    assert got.converged_fraction() == want.converged_fraction()
    fg, fw = got.resolve(pcam), want.resolve(jcam)
    np.testing.assert_allclose(fg.image.numpy(), np.asarray(fw.image),
                               atol=5e-5)
    np.testing.assert_allclose(fg.rt_depth.numpy(), np.asarray(fw.rt_depth),
                               atol=1e-3)
    assert int(fg.rays_traced) == int(fw.rays_traced) > 0


def test_adaptive_matches_jax_pass_by_pass(pair):
    """Five passes, the re-probe on pass 2 and 4: after every pass the same
    sample map, converged fraction and image as the JAX package."""
    js, jcam, ps, pcam, jad = pair
    jad.reset()
    got = _port()
    for seed in range(5):
        got.step(ps, pcam, seed=seed)
        jad.step(js, jcam, seed=seed)
        _same_state(got, jad, pcam, jcam)
    counts = got.samples_map()
    assert counts.min() < counts.max() == 5 * ADAPT["samples_per_pixel"]
    assert got.film.rays_traced.dtype == torch.int64


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_adaptive_checkpoint_crosses_packages(pair, tmp_path, saved_by):
    """Two passes in one package, saved, loaded in the other, then one more
    pass in both (a re-probe pass) and one after it."""
    js, jcam, ps, pcam, jad = pair
    jad.reset()
    got = _port()
    path = str(tmp_path / "adaptive.npz")
    src, dst = (jad, got) if saved_by == "jax" else (got, jad)
    scene, cam = (js, jcam) if saved_by == "jax" else (ps, pcam)
    for seed in range(2):
        src.step(scene, cam, seed=seed)
    src.save(path)
    dst.load(path)
    for seed in (2, 3):
        got.step(ps, pcam, seed=seed)
        jad.step(js, jcam, seed=seed)
        _same_state(got, jad, pcam, jcam)
    assert got._sample_offset == jad._sample_offset == 8


# -- the JAX package's adaptive tests, in the port ----------------------------

def _scene():
    world = bt.rtiow.material_test_scene()
    return (world.extract(with_bvh=False, device="cpu"),
            world.camera_state(aspect=1.0, device="cpu"))


def test_tolerance_zero_matches_uniform_progressive():
    scene, cam = _scene()
    cfg = bt.RenderConfig(**ADAPT)
    prog = bt.ProgressiveRenderer(cfg, backend="pallas", device="cpu")
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.0, device="cpu")
    for i in range(3):
        f_ref = prog.step(scene, cam, seed=i)
        adap.step(scene, cam, seed=i)
    f = adap.resolve(cam)
    assert float(adap.film.n_samples.min()) == 6.0
    np.testing.assert_allclose(f.image.numpy(), f_ref.image.numpy(),
                               atol=1e-5)
    assert int(f.rays_traced) == int(f_ref.rays_traced)


def test_adaptive_stops_converged_pixels_and_stays_unbiased():
    scene, cam = _scene()
    cfg = bt.RenderConfig(**ADAPT)
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=0,
                               device="cpu")
    for i in range(5):
        adap.step(scene, cam, seed=i)
    counts = adap.samples_map()
    assert counts.max() == 5 * cfg.samples_per_pixel
    assert counts.min() >= 2 * cfg.samples_per_pixel  # warm-up + second look
    assert (counts < counts.max()).mean() > 0.2
    assert adap.converged_fraction() > 0.2
    uni = bt.AdaptiveRenderer(cfg, tolerance=0.0, reprobe_every=0,
                              device="cpu")
    for i in range(5):
        uni.step(scene, cam, seed=i)
    assert int(adap.film.rays_traced) < 0.9 * int(uni.film.rays_traced)
    a, u = adap.resolve(cam).image, uni.resolve(cam).image
    assert float((a - u).abs().mean()) < 0.02


def test_spp_map_roundtrip():
    cfg = bt.RenderConfig(width=100, height=72, samples_per_pixel=1,
                          bounces=1, level=3)
    vals = torch.arange(100 * 72, dtype=torch.float32)
    blocked = mk.shuffle_blocks(vals, cfg, fill=-1)
    assert tuple(blocked.shape) == (4, mk.TILE // 128, 128)
    assert torch.equal(mk.unshuffle_blocks(blocked.reshape(-1), cfg), vals)
    assert int((blocked == -1).sum()) == 4 * mk.TILE - 100 * 72


def test_adaptive_checkpoint_resume(tmp_path):
    scene, cam = _scene()
    cfg = bt.RenderConfig(48, 48, 2, 2, level=3)
    a = bt.AdaptiveRenderer(cfg, tolerance=0.05, device="cpu")
    a.step(scene, cam, seed=0)
    a.step(scene, cam, seed=1)
    path = str(tmp_path / "a.npz")
    a.save(path)
    b = bt.AdaptiveRenderer(cfg, tolerance=0.05, device="cpu")
    b.load(path)
    a.step(scene, cam, seed=2)
    b.step(scene, cam, seed=2)
    assert torch.equal(a.resolve(cam).image, b.resolve(cam).image)
    wrong = bt.AdaptiveRenderer(bt.RenderConfig(32, 32, 2, 2, level=3),
                                tolerance=0.05, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        wrong.load(path)


def test_camera_change_resets_film_and_shortlists():
    """A moved camera resets the film and rebuilds the camera-keyed
    shortlists (forced split, so a stale shortlist would cull spheres)."""
    world = bt.rtiow.material_test_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam_a = world.camera_state(aspect=1.0, device="cpu")
    world.set_camera(bt.Transform.from_xyz(2.0, 1.5, 6.0).looking_at(
        (0, 0.5, 0)), bt.PerspectiveProjection(), bt.RaytracedCamera())
    cam_b = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(48, 48, 2, 2, level=3, pallas_primary="split")
    moved = bt.AdaptiveRenderer(cfg, tolerance=0.0, device="cpu")
    moved.step(scene, cam_a, seed=0)
    moved.step(scene, cam_b, seed=0)
    fresh = bt.AdaptiveRenderer(cfg, tolerance=0.0, device="cpu")
    fresh.step(scene, cam_b, seed=0)
    assert torch.equal(moved.resolve(cam_b).image,
                       fresh.resolve(cam_b).image)
    kscene = moved._renderer.prepare(scene)
    sl, _ = moved._renderer.shortlists(kscene, cam_b)
    want, _ = primary.device_shortlists_for(kscene, cam_b, cfg, 2)
    assert torch.equal(sl, want)


def test_reprobe_recovers_artificially_frozen_pixels():
    scene, cam = _scene()
    cfg = bt.RenderConfig(**ADAPT)
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=2,
                               device="cpu")
    adap.step(scene, cam, seed=0)
    adap.step(scene, cam, seed=1)
    # Freeze every pixel, as if each had had one lucky agreeing pass.
    adap.film = adap.film._replace(err=torch.zeros_like(adap.film.err))
    assert adap.converged_fraction() == 1.0
    before = adap.samples_map().copy()
    adap.step(scene, cam, seed=2)   # pass 2: a re-probe
    after = adap.samples_map()
    np.testing.assert_array_equal(after, before + cfg.samples_per_pixel)
    frac = adap.converged_fraction()
    assert 0.01 < 1.0 - frac and frac > 0.05
    adap.step(scene, cam, seed=3)   # samples exactly the recovered pixels
    sampled = adap.samples_map() - after
    np.testing.assert_allclose((sampled > 0).mean(), 1.0 - frac, atol=1e-6)


def test_reprobe_keeps_density_shape_on_converged_scene():
    """A sky-only view converges everywhere: the re-probes add a uniform
    floor and the allocation stays flat."""
    world = bt.World()
    world.set_camera(bt.Transform.from_xyz(0.0, 0.0, 0.0).looking_at(
        (0, 0, -1)))
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(32, 32, 2, 2, level=3)
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=2,
                               device="cpu")
    for i in range(5):                  # passes 2 and 4 are re-probes
        adap.step(scene, cam, seed=i)
    counts = adap.samples_map()
    assert counts.min() == counts.max() == 4 * cfg.samples_per_pixel
    assert adap.converged_fraction() == 1.0


def test_each_pass_hands_the_kernel_its_map(monkeypatch):
    """Every step makes one kernel call, with ``spp`` for the pixels whose
    err is at or above the tolerance (all of them on the re-probe pass) and
    0 for the rest, in the kernel's block order, at the advancing offset."""
    from bevyray_tpu_torch.engine import film as bfilm

    scene, cam = _scene()
    cfg = bt.RenderConfig(32, 32, 2, 2, level=3)
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=2,
                               device="cpu")
    calls = []

    def spy(*args, spp_map=None, sample_offset=0, **kw):
        calls.append((mk.unshuffle_blocks(spp_map.reshape(-1), cfg),
                      sample_offset))
        return mk.render_tiles(*args, spp_map=spp_map,
                               sample_offset=sample_offset, **kw)

    monkeypatch.setattr(bfilm, "render_tiles", spy)
    wants = []
    for i in range(4):
        wants.append(torch.where(adap.film.err >= 0.05, 2, 0))
        adap.step(scene, cam, seed=i)
    wants[2] = torch.full_like(wants[2], 2)      # pass 2 re-probes
    assert [off for _, off in calls] == [0, 2, 4, 6]
    for (got, _), want in zip(calls, wants):
        assert torch.equal(got, want.to(torch.int32))
    assert 0 < int((wants[3] == 0).sum()) < cfg.n_pixels


@pytest.mark.cuda
def test_kernel_matches_plain_version_under_a_map_on_card():
    """On the card: the kernel against its plain version with a seeded
    random map and ``sample_offset=32``, every mode (chip_smoke.py phase 5
    at the headline, with the adaptive run's own map)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = bt.rtiow.final_scene(seed=42, grid=4)
    dev = torch.device("cuda", 0)
    base = bt.RenderConfig(128, 128, 4, 4, level=3)
    spp_map = torch.as_tensor(np.random.default_rng(3).integers(
        0, 5, (4, mk.TILE // 128, 128)).astype(np.int32), device=dev)
    for primary_mode in ("off", "split"):
        for intersect in ("grouped", "candidates"):
            cfg = dataclasses.replace(base, pallas_primary=primary_mode,
                                      pallas_intersect=intersect)
            kscene = mk.prepare_kernel_scene(
                world.extract(with_bvh=False, device=dev))
            cam = world.camera_state(aspect=1.0, device=dev)
            sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg, 4)
            got = mk.render_tiles(kscene, cam, cfg, 7, sl=sl, slmeta=slmeta,
                                  normalize=False, spp_map=spp_map,
                                  sample_offset=32)
            want = mk.render_tiles_reference(
                kscene, cam, cfg, 7, sl=sl, slmeta=slmeta, normalize=False,
                spp_map=spp_map, sample_offset=32)
            zero = spp_map.reshape(-1) == 0
            for g, w in zip(got[:4], want[:4]):
                assert not bool(g[zero].any())
                diff = (g - w).abs()
                assert float((diff <= 1e-3 * 4).float().mean()) >= 0.999
            assert abs(int(got[4]) - int(want[4])) <= 1e-3 * int(want[4])
