"""The port's ``View``/``ViewSet`` (``engine/views.py``): twins of
tests/test_views.py, and the views' frames against the JAX package's
``ViewSet`` on the same cameras (image atol 5e-5, depth atol 1e-3, segment
counts equal, the bars of tests/test_pallas.py:24-28)."""

import jax
import numpy as np
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.engine import views as jviews
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.engine.views import View, ViewSet

torch.set_num_threads(2)

CFG = dict(width=24, height=24, samples_per_pixel=2, bounces=3, level=3)


def _front_and_side(pkg, device=None):
    """The material test scene and its front and side cameras."""
    world = pkg.rtiow.material_test_scene()
    kw = {} if device is None else {"device": device}
    front = world.camera_state(aspect=1.0, **kw)
    world.set_camera(pkg.Transform.from_xyz(4.0, 1.0, 0.0)
                     .looking_at((0, 0.5, 0)))
    side = world.camera_state(aspect=1.0, **kw)
    return world, front, side


def test_two_views_share_scene_and_differ_by_camera():
    world, front, side = _front_and_side(bt, device="cpu")
    scene = world.extract(with_bvh=False, device="cpu")
    cfg = bt.RenderConfig(**CFG)
    vs = ViewSet([View("front", cfg, front), View("side", cfg, side)])
    frames = vs.render_all(scene, seed=5)
    assert [n for n, _ in frames] == ["front", "side"]
    a, b = frames[0][1].image, frames[1][1].image
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    assert float((a - b).abs().mean()) > 0.01   # other viewpoints
    # Renderers are shared per config.
    assert len(vs._renderers) == 1


def test_views_match_jax_viewset():
    """Two configs (one view at level 2 with a per-pixel raster layer), so
    each package builds two renderers; view i renders seed + i."""
    jworld, jfront, jside = _front_and_side(jb)
    js = jworld.extract(with_bvh=False)
    n = CFG["width"] * CFG["height"]
    rng = np.random.default_rng(2)
    color = rng.random((3, n)).astype(np.float32)
    depth = np.where(np.arange(n) % 24 < 12, 0.9, 0.0).astype(np.float32)

    def views(view_cls, cfg_cls, cams, raster):
        return [view_cls("front", cfg_cls(**CFG), cams[0]),
                view_cls("side", cfg_cls(**dict(CFG, level=2)), cams[1],
                         *raster)]

    jraster = (jb.Vec3(*map(jax.numpy.asarray, color)),
               jax.numpy.asarray(depth))
    want_set = jviews.ViewSet(views(jviews.View, jb.RenderConfig,
                                    (jfront, jside), jraster))
    want = want_set.render_all(js, seed=11)
    ps, pfront = scene_from_numpy(jax.tree.map(np.asarray, js),
                                  jax.tree.map(np.asarray, jfront),
                                  device="cpu")
    _, pside = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jside), device="cpu")
    praster = (bt.Vec3(*map(torch.as_tensor, color)), torch.as_tensor(depth))
    got_set = ViewSet(views(View, bt.RenderConfig, (pfront, pside), praster))
    got = got_set.render_all(ps, seed=11)
    assert len(got_set._renderers) == len(want_set._renderers) == 2
    for (gn, g), (wn, w) in zip(got, want):
        assert gn == wn
        np.testing.assert_allclose(g.image.numpy(), np.asarray(w.image),
                                   atol=5e-5)
        np.testing.assert_allclose(g.rt_depth.numpy(), np.asarray(w.rt_depth),
                                   atol=1e-3)
        assert int(g.rays_traced) == int(w.rays_traced) > 0


def test_viewset_takes_another_renderer_class():
    world, front, _ = _front_and_side(bt, device="cpu")
    scene = world.extract(with_bvh=False, device="cpu")
    cfg = bt.RenderConfig(**CFG)
    got = ViewSet([View("front", cfg, front)],
                  renderer_cls=bt.FusedRenderer).render_all(scene, seed=3)
    want = bt.FusedRenderer(cfg).render(scene, front, seed=3)
    assert torch.equal(got[0][1].image, want.image)
