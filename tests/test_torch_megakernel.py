"""The port's ``render_tiles`` (its plain version, on the CPU) against the JAX
package's ``render_tiles`` under the slice's configuration
(``pallas_primary="off"``, ``pallas_intersect="grouped"``, ``exact_rng=True``),
run in Pallas interpret mode as tests/test_pallas.py runs it.

Bars (tests/test_pallas.py:24-28, bf16 hi/lo attributes against float32):
r/g/b atol 5e-5, depth atol 1e-3, segment counts equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RaytracedCamera as JRaytracedCamera
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import build
from bevyray_tpu_torch.kernels.cuda import megakernel as mk

torch.set_num_threads(2)

SLICE = dict(samples_per_pixel=2, bounces=4, level=3, pallas_primary="off",
             pallas_intersect="grouped")


def _inputs(jworld, w, h):
    js = jworld.extract(with_bvh=False)
    jcam = jworld.camera_state(aspect=w / h)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam))
    return js, jcam, mk.prepare_kernel_scene(ps), pcam


def _check_against_jax(jworld, w, h, seed, **options):
    js, jcam, kscene, pcam = _inputs(jworld, w, h)
    cfg = {**SLICE, **options}
    want = jmk.render_tiles(jmk.jitted_prepare(0, "kd")(js), jcam,
                            JRenderConfig(width=w, height=h, **cfg),
                            np.uint32(seed), exact_rng=True)
    got = mk.render_tiles(kscene, pcam,
                          bt.RenderConfig(width=w, height=h, **cfg), seed)
    for g, wnt in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=5e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-3)
    assert got[4].dtype == torch.int64
    assert int(got[4]) == int(want[4]) > 0
    return got


@pytest.mark.parametrize("scene_fn,size,seed", [
    (lambda: jrtiow.final_scene(seed=42, grid=4), (64, 64), 11),
    (jrtiow.material_test_scene, (40, 24), 5),   # a ragged block
])
def test_render_tiles_matches_jax(scene_fn, size, seed):
    _check_against_jax(scene_fn(), *size, seed)


LENS = dict(aperture=0.2, focus_distance=4.0)


@pytest.mark.parametrize("scene_fn,options", [
    # The emissive lamps, and level 1's far + 10 fallback depth.
    (jrtiow.night_scene, dict(level=1)),
    # The thin-lens raygen and cosine-weighted diffuse bounces.
    (lambda: jrtiow.material_test_scene(JRaytracedCamera(**LENS)),
     dict(defocus=True, diffuse_sampling="cosine")),
], ids=["night_level1", "defocus_cosine"])
def test_render_tiles_branches_match_jax(scene_fn, options):
    got = _check_against_jax(scene_fn(), 48, 32, 3, **options)
    if options.get("level") == 1:
        # Sky pixels (every sample's first segment missed) carry far + 10.
        assert float(got[3].max()) == pytest.approx(1010.0)


def test_normalize_false_gives_sample_sums():
    _, _, kscene, pcam = _inputs(jrtiow.material_test_scene(), 32, 32)
    cfg = bt.RenderConfig(width=32, height=32, **SLICE)
    mean = mk.render_tiles(kscene, pcam, cfg, 3)
    sums = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False)
    for m, s in zip(mean[:4], sums[:4]):
        np.testing.assert_allclose(s.numpy() * np.float32(0.5), m.numpy(),
                                   rtol=1e-6)
    assert int(mean[4]) == int(sums[4])


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never builds or
    launches the CUDA kernel."""
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    launches = mk.render_tiles.launches
    calls = mk.render_tiles_reference.calls
    got = mk.render_tiles(kscene, pcam, cfg, 1)
    want = mk.render_tiles_reference(kscene, pcam, cfg, 1)
    assert mk.render_tiles.launches == launches
    assert mk.render_tiles_reference.calls == calls + 2
    assert build._extension is None
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


@pytest.mark.parametrize("kwargs,item", [
    (dict(sl=np.zeros((1, 4, 8), np.float32)), "B3"),
    (dict(spp_map=np.ones((1, 32, 128), np.int32)), "B2"),
    (dict(block_offset=1), "A10"),
    (dict(sample_offset=4), "A10"),
    (dict(n_blocks_local=1), "A10"),
    (dict(exact_rng=False), "B8"),
])
def test_unported_branches_raise(kwargs, item):
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        mk.render_tiles(kscene, pcam, cfg, 1, **kwargs)


def test_triangles_raise():
    jw = jrtiow.simple_scene()
    from bevyray_tpu.scene import components as jcomp
    jw.spawn_mesh(jcomp.Transform.from_xyz(0.0, 0.5, 1.0), jcomp.cube_mesh(0.3),
                  jcomp.StandardMaterial())
    _, _, kscene, pcam = _inputs(jw, 16, 16)
    assert kscene.tri.shape == (10, 128)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    with pytest.raises(NotImplementedError, match="ROADMAP B9"):
        mk.render_tiles(kscene, pcam, cfg, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_fn,options", [
    (lambda: bt.rtiow.final_scene(seed=42, grid=4), {}),
    (lambda: bt.rtiow.final_scene(seed=42, grid=4), dict(level=1)),
    (bt.rtiow.night_scene, {}),
    (lambda: bt.rtiow.material_test_scene(bt.RaytracedCamera(**LENS)),
     dict(defocus=True, diffuse_sampling="cosine")),
], ids=["final", "final_level1", "night", "defocus_cosine"])
def test_cuda_kernel_matches_plain_version_on_card(scene_fn, options):
    """On the card: the kernel against its plain version on the same CUDA
    tensors, color and depth (the bars of chip_smoke.py phase 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = scene_fn()
    dev = torch.device("cuda", 0)
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=1.0, device=dev)
    cfg = dataclasses.replace(bt.RenderConfig(width=128, height=128, **SLICE),
                              samples_per_pixel=4, **options)
    launches = mk.render_tiles.launches
    got = mk.render_tiles(kscene, cam, cfg, 7)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7)
    assert mk.render_tiles.launches == launches + 1
    diff = torch.stack([(g - w).abs() for g, w in zip(got[:3], want[:3])])
    assert float((diff.amax(0) <= 1e-3).float().mean()) >= 0.999
    assert float(diff.mean()) < 5e-5
    depth = (got[3] - want[3]).abs()
    assert float((depth <= 1e-3).float().mean()) >= 0.999
    assert float(depth.mean() / want[3].abs().mean()) < 1e-4
    assert abs(int(got[4]) - int(want[4])) <= 1e-3 * int(want[4])
