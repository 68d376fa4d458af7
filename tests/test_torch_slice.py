"""The port's fused-renderer slice end to end against the JAX package's
``PallasRenderer`` under the same configuration, on the CPU (the JAX kernel
in Pallas interpret mode, the port's kernel through its plain version).

Bars (tests/test_pallas.py:24-28): image atol 5e-5, depth atol 1e-3,
``rays_traced`` equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.engine.pallas_renderer import PallasRenderer
from bevyray_tpu_torch.core.types import scene_from_numpy

torch.set_num_threads(2)

SLICE = dict(width=32, height=32, samples_per_pixel=2, bounces=4,
             pallas_primary="off", pallas_intersect="grouped")


def _both(scene_fn):
    jw = scene_fn()
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam))
    return js, jcam, ps, pcam


@pytest.mark.parametrize("scene_fn,level", [
    (jrtiow.material_test_scene, 3),
    (jrtiow.simple_scene, 2),
])
def test_fused_renderer_matches_pallas_renderer(scene_fn, level):
    js, jcam, ps, pcam = _both(scene_fn)
    want = PallasRenderer(JRenderConfig(level=level, **SLICE)).render(
        js, jcam, seed=5)
    got = bt.FusedRenderer(bt.RenderConfig(level=level, **SLICE)).render(
        ps, pcam, seed=5)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(), np.asarray(want.rt_depth),
                               atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


def test_level0_passthrough():
    js, jcam, ps, pcam = _both(jrtiow.simple_scene)
    color = np.random.RandomState(0).rand(3, 32 * 32).astype(np.float32)
    want = PallasRenderer(JRenderConfig(level=0, **SLICE)).render(
        js, jcam, seed=1, raster_color=JVec3(*color))
    got = bt.FusedRenderer(bt.RenderConfig(level=0, **SLICE)).render(
        ps, pcam, seed=1, raster_color=bt.Vec3(*map(torch.as_tensor, color)))
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    np.testing.assert_array_equal(got.rt_depth.numpy(),
                                  np.asarray(want.rt_depth))
    assert int(got.rays_traced) == 0


def test_world_to_frame_on_the_port_alone():
    """The public path with no JAX involved: World -> FusedRenderer, the
    prepared-scene cache, determinism and the morton order."""
    world = bt.rtiow.final_scene(seed=42, grid=2)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = bt.RenderConfig(level=3, **SLICE)
    r = bt.FusedRenderer(cfg)
    a = r.render(scene, cam, seed=9)
    assert r.prepare(scene) is r.prepare(scene)
    b = r.render(scene, cam, seed=9)
    assert torch.equal(a.image, b.image) and int(a.rays_traced) > 0
    assert not torch.equal(a.image, r.render(scene, cam, seed=10).image)
    m = bt.FusedRenderer(dataclasses.replace(cfg, pallas_grouping="morton"))
    c = m.render(scene, cam, seed=9)
    np.testing.assert_allclose(c.image.numpy(), a.image.numpy(), atol=5e-5)
    assert int(c.rays_traced) == int(a.rays_traced)
    world.set_translation(1, (0.5, 0.2, 0.5))
    moved = world.extract(with_bvh=False)
    assert r.prepare(moved) is not r.prepare(scene)


@pytest.mark.parametrize("kwargs,item", [
    (dict(pallas_primary="split"), "B3"),
    (dict(pallas_intersect="candidates"), "B5"),
])
def test_unported_schedules_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        bt.FusedRenderer(bt.RenderConfig(width=8, height=8, **kwargs))


def test_exact_rng_resolution():
    cfg = bt.RenderConfig(width=8, height=8)
    assert bt.FusedRenderer(cfg).exact_rng is True
    with pytest.raises(NotImplementedError, match="ROADMAP B8"):
        bt.FusedRenderer(cfg, exact_rng=False)


def test_render_config_validation_matches():
    for bad in (dict(width=0), dict(samples_per_pixel=0), dict(level=4),
                dict(pallas_cand_size=12), dict(pallas_primary="x")):
        args = {"width": 8, "height": 8, **bad}
        with pytest.raises(ValueError):
            JRenderConfig(**args)
        with pytest.raises(ValueError):
            bt.RenderConfig(**args)
    assert ([f.name for f in dataclasses.fields(bt.RenderConfig)]
            == [f.name for f in dataclasses.fields(JRenderConfig)])
    assert ({f.name: f.default for f in dataclasses.fields(bt.RenderConfig)}
            == {f.name: f.default for f in dataclasses.fields(JRenderConfig)})
