"""The port's per-block primary shortlists (``kernels/cuda/primary.py``)
against the JAX package's (``kernels/pallas/primary.py``): both are NumPy, so
the same sphere table and camera must give equal arrays and the same gate
decisions."""

import dataclasses

import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RaytracedCamera as JRaytracedCamera
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu.kernels.pallas import primary as jprimary
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary


def _sph_and_cam(jworld, w, h):
    """The JAX kernel's sphere table (the port's is pinned equal to it in
    test_torch_scene.py) and the JAX camera."""
    js = jworld.extract(with_bvh=False)
    return (np.asarray(jmk.jitted_prepare(0, "kd")(js).sph),
            jworld.camera_state(aspect=w / h))


@pytest.mark.parametrize("scene_fn,size,options", [
    (lambda: jrtiow.final_scene(seed=42, grid=4), (96, 64), {}),
    (lambda: jrtiow.final_scene(seed=7, grid=3), (40, 24), {}),   # ragged
    (lambda: jrtiow.final_scene(seed=11, grid=3, camera=JRaytracedCamera(
        aperture=0.3, focus_distance=6.0)), (100, 72), dict(defocus=True)),
    (lambda: jrtiow.final_scene(seed=42), (256, 192), {}),
], ids=["final_grid4", "ragged_40x24", "defocus", "final_512"])
def test_build_block_shortlists_equal(scene_fn, size, options):
    w, h = size
    sph, cam = _sph_and_cam(scene_fn(), w, h)
    cfg = dict(width=w, height=h, samples_per_pixel=2, bounces=2, level=3,
               **options)
    want = jprimary.build_block_shortlists(sph, cam, JRenderConfig(**cfg))
    got = primary.build_block_shortlists(sph, cam, bt.RenderConfig(**cfg))
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype == np.float32
        np.testing.assert_array_equal(g, wnt)
    sl, meta = got
    nbx, nby = mk.block_grid(bt.RenderConfig(**cfg))
    assert sl.shape[:2] == (nbx * nby, primary.N_SL_ROWS)
    assert meta.shape == (nbx * nby, 1 + sl.shape[2] // primary.SL_CHUNK)
    np.testing.assert_array_equal(primary.live_mask(sph),
                                  jprimary.live_mask(sph))
    assert primary.live_sphere_count(sph) == jprimary.live_sphere_count(sph)


def test_shortlists_match_on_a_camera_the_port_built():
    """The port's own World camera (torch tensors) gives the JAX builder's
    shortlists for the JAX camera of the same world."""
    cfg = dict(width=128, height=64, samples_per_pixel=2, bounces=2, level=3)
    sph, jcam = _sph_and_cam(jrtiow.final_scene(seed=42, grid=4), 128, 64)
    pcam = bt.rtiow.final_scene(seed=42, grid=4).camera_state(aspect=2.0,
                                                              device="cpu")
    for g, wnt in zip(
            primary.build_block_shortlists(sph, pcam, bt.RenderConfig(**cfg)),
            jprimary.build_block_shortlists(sph, jcam, JRenderConfig(**cfg))):
        np.testing.assert_array_equal(g, wnt)


def test_shortlist_capacity_pow2_buckets():
    cases = {0: 8, 1: 8, 8: 8, 9: 16, 23: 32, 33: 64, 64: 64, 65: 128,
             300: 512, 512: 512, 5000: 512}
    for need, want in cases.items():
        counts = np.array([need, need // 2])
        assert primary.shortlist_capacity(counts) == want
        assert jprimary.shortlist_capacity(counts) == want
    assert primary.shortlist_capacity(np.zeros(0, np.int64)) == primary.SL_CHUNK
    assert (primary.SL_CHUNK, primary.SL_MAX, primary.N_SL_ROWS) == (
        jprimary.SL_CHUNK, jprimary.SL_MAX, jprimary.N_SL_ROWS)
    assert mk.MAX_SPLIT_SPP == jmk.MAX_SPLIT_SPP


def test_split_worthwhile_matches():
    rng = np.random.default_rng(3)
    sph, cam = _sph_and_cam(jrtiow.final_scene(seed=42, grid=4), 256, 128)
    cfg = dict(width=256, height=128, samples_per_pixel=16, bounces=2, level=3)
    sl, meta = primary.build_block_shortlists(sph, cam, bt.RenderConfig(**cfg))
    cases = [(sl, meta)]
    for frac in (0.25, 0.5, 0.75, 1.0):   # blocks flagged as overflowed
        m = meta.copy()
        m[rng.random(m.shape[0]) < frac, 0] = 1.0
        cases.append((sl, m))
    crowded = sl.copy()                   # every shortlist row live
    crowded[:, 3, :] = 1.0
    cases.append((crowded, meta))
    for s, m in cases:
        for spp in (1, 4, 5, 16):
            assert (primary.split_worthwhile(s, m, sph, spp)
                    == jprimary.split_worthwhile(s, m, sph, spp))
    full = meta.copy()
    full[:, 0] = 1.0
    assert not primary.split_worthwhile(sl, full, sph, 1)


GATE_CASES = [
    ("material_test_scene", dict(samples_per_pixel=16), None),
    ("material_test_scene", dict(samples_per_pixel=4), "split"),
    ("material_test_scene", dict(samples_per_pixel=16,
                                 pallas_primary="split"), "split"),
    ("final_scene", dict(samples_per_pixel=16), "split"),
    ("final_scene", dict(samples_per_pixel=33), None),
    ("final_scene", dict(pallas_primary="off"), None),
    ("final_scene", dict(level=0), None),
    ("final_scene", dict(samples_per_pixel=33, pallas_primary="split"),
     ValueError),
    ("final_scene", dict(level=0, pallas_primary="split"), ValueError),
]


@pytest.mark.parametrize("scene,options,want", GATE_CASES)
def test_shortlists_for_gate_matches(scene, options, want):
    jworld = (jrtiow.material_test_scene() if scene == "material_test_scene"
              else jrtiow.final_scene(seed=42))
    sph, cam = _sph_and_cam(jworld, 64, 64)
    cfg = dict(dict(width=64, height=64, samples_per_pixel=2, bounces=2,
                    level=3), **options)
    spp = cfg["samples_per_pixel"]
    if want is ValueError:
        for mod, config in ((primary, bt.RenderConfig(**cfg)),
                            (jprimary, JRenderConfig(**cfg))):
            with pytest.raises(ValueError, match="samples_per_pixel"):
                mod.shortlists_for(sph, cam, config, spp)
        return
    sl, meta = primary.shortlists_for(sph, cam, bt.RenderConfig(**cfg), spp)
    jsl, jmeta, _ = jprimary.shortlists_for(sph, cam, JRenderConfig(**cfg), spp)
    assert (sl is None) == (jsl is None) == (want is None)
    if sl is not None:
        np.testing.assert_array_equal(sl, jsl)
        np.testing.assert_array_equal(meta, jmeta)


def test_device_shortlists_for_gives_tensors_on_the_scene_device():
    world = bt.rtiow.final_scene(seed=42, grid=4)
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False,
                                                   device="cpu"))
    cam = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(width=96, height=96, samples_per_pixel=2,
                          bounces=2, level=3)
    sl, meta = primary.device_shortlists_for(kscene, cam, cfg, 2)
    want = primary.shortlists_for(kscene.sph.numpy(), cam, cfg, 2)
    for g, wnt in zip((sl, meta), want):
        assert g.dtype == torch.float32 and g.device == kscene.sph.device
        np.testing.assert_array_equal(g.numpy(), wnt)
    off = dataclasses.replace(cfg, pallas_primary="off")
    assert primary.device_shortlists_for(kscene, cam, off, 2) == (None, None)
