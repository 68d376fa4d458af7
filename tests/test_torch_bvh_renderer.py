"""The BVH in the port's scene and renderer against the JAX package's, on
the CPU: ``World.extract(with_bvh=True)``, ``scene_from_numpy`` of a JAX
scene with its BVHs, the backend rule and the wavefront ``Renderer`` on the
"bvh" backend.

Bars: extracted tables equal element for element; frames at the bars of
tests/test_pallas.py:24-28 (image atol 5e-5, depth atol 1e-3, segment counts
equal) against JAX's frames, and, as tests/test_bvh.py:181-203 holds JAX's
own, the port's "bvh" frame within 1e-6 of its "brute" frame.
"""

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.engine import renderer as jrenderer
from bevyray_tpu_torch.core.types import (SceneBuffers, make_sphere_walk,
                                         scene_from_numpy)
from bevyray_tpu_torch.engine import renderer as prenderer

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_native_builder():
    """JAX's native builder loaded in this process. Its library is built at
    first use into its source directory, and other test processes may be
    building it at the same moment; a load that met a half-written file is
    retried (JAX's ``ensure_built`` tries once), so that per-builder
    comparisons never meet JAX's silent NumPy fallback."""
    import time

    from bevyray_tpu.bvh import native as jax_native

    for _ in range(20):
        if jax_native.ensure_built() is not None:
            return
        jax_native._TRIED = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native PLOC builder did not load")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want):
    """Port NamedTuples of tensors vs JAX NamedTuples of arrays, leaf by
    leaf. A port scene's ``sphere_walk`` (its own layout of the sphere BVH,
    with no JAX counterpart) must be the record of its own tables."""
    if isinstance(got, SceneBuffers):
        walk = got.sphere_walk
        assert (walk is None) == (got.bvh is None)
        if walk is not None:
            fresh = make_sphere_walk(got.spheres, got.bvh)
            assert all(torch.equal(x, y) for x, y in zip(walk, fresh))
        got = got._replace(sphere_walk=None)
    g_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    w_leaves = jax.tree.leaves(_np(want))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _mesh(pkg):
    """A blue sphere and a yellow cube mesh (tests/test_bvh.py:181-203)."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 0.5, 6).looking_at((0, 0.5, 0)),
                 camera=pkg.RaytracedCamera(level=pkg.Raytracing.PURE))
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, 0),
                   pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(pkg.Transform.from_xyz(1.2, 0.5, 0), pkg.cube_mesh(1.0),
                 pkg.StandardMaterial(base_color=(1, 1, 0)))
    return w


def _big(pkg):
    """4,971 spheres (capacity 4,992 > 4,096): "auto" walks the BVH."""
    return pkg.rtiow.final_scene(seed=42, grid=35)


WORLDS = {"final": lambda pkg: pkg.rtiow.final_scene(seed=42),
          "material": lambda pkg: pkg.rtiow.material_test_scene(),
          "mesh": _mesh}


def _close(got, want):
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(),
                               np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


@pytest.mark.parametrize("leaf", [1, 4])
@pytest.mark.parametrize("name", list(WORLDS))
def test_extract_with_bvh_matches_jax(name, leaf):
    pw, jw = WORLDS[name](bt), WORLDS[name](jb)
    got = pw.extract(bvh_leaf_size=leaf, device="cpu")
    want = jw.extract(bvh_leaf_size=leaf)
    assert got.bvh is not None and (got.tri_bvh is None) == (name != "mesh")
    _assert_tree_equal(got, want)
    # The JAX scene carried across is the same scene.
    carried, _ = scene_from_numpy(_np(want), _np(jw.camera_state()),
                                  device="cpu")
    _assert_tree_equal(carried, want)


def test_backend_rule_matches_jax():
    """"auto" walks the BVH when the scene carries one and a table holds
    over 4096 rows, else runs the dense test; an explicit "bvh" without a
    sphere BVH raises."""
    cases = [(_big, True, "bvh"), (_big, False, "brute"),
             (WORLDS["final"], True, "brute"), (_mesh, True, "brute")]
    for world_fn, with_bvh, expected in cases:
        ps = world_fn(bt).extract(with_bvh=with_bvh, device="cpu")
        js = world_fn(jb).extract(with_bvh=with_bvh)
        for backend in ("auto", "brute", "bvh"):
            cfg = dict(width=8, height=8, intersect_backend=backend)
            got = prenderer.resolve_intersect_backend(ps, bt.RenderConfig(**cfg))
            assert got == jrenderer.resolve_intersect_backend(
                js, jb.RenderConfig(**cfg))
            assert got == (expected if backend == "auto" else backend)
    no_bvh = WORLDS["final"](bt).extract(with_bvh=False, device="cpu")
    with pytest.raises(ValueError, match="no BVH"):
        prenderer.make_intersect_fn(
            no_bvh, bt.RenderConfig(width=8, height=8,
                                    intersect_backend="bvh"))


@pytest.mark.parametrize("leaf", [1, 4])
def test_mesh_scene_bvh_frame_matches_jax(leaf):
    """The mesh scene of tests/test_bvh.py:181-203 on the "bvh" backend (the
    sphere and the triangle BVH) against JAX's "bvh" frame, and against the
    port's "brute" frame within 1e-6."""
    pw, jw = _mesh(bt), _mesh(jb)
    ps = pw.extract(bvh_leaf_size=leaf, device="cpu")
    pcam = pw.camera_state(aspect=1.0, device="cpu")
    js, jcam = jw.extract(bvh_leaf_size=leaf), jw.camera_state(aspect=1.0)
    kw = dict(width=32, height=32, samples_per_pixel=2, bounces=3, level=3)
    bvh = dict(kw, intersect_backend="bvh", bvh_leaf_size=leaf)
    got = bt.Renderer(bt.RenderConfig(**bvh)).render(ps, pcam, seed=4)
    want = jb.Renderer(jb.RenderConfig(**bvh)).render(js, jcam, seed=4)
    _close(got, want)
    brute = bt.Renderer(bt.RenderConfig(**kw, intersect_backend="brute")
                        ).render(ps, pcam, seed=4)
    np.testing.assert_allclose(got.image.numpy(), brute.image.numpy(),
                               atol=1e-6)
    assert int(got.rays_traced) == int(brute.rays_traced)


def test_auto_walks_the_bvh_of_a_large_scene():
    """4,971 spheres: "auto" resolves to the BVH in both packages; the
    frames agree at the bars, and the port's frame is bit-equal to its
    "brute" frame."""
    pw, jw = _big(bt), _big(jb)
    ps, pcam = pw.extract(device="cpu"), pw.camera_state(aspect=1.5,
                                                         device="cpu")
    js, jcam = jw.extract(), jw.camera_state(aspect=1.5)
    kw = dict(width=24, height=16, samples_per_pixel=1, bounces=2, level=3)
    cfg = bt.RenderConfig(**kw)
    assert prenderer.resolve_intersect_backend(ps, cfg) == "bvh"
    got = bt.Renderer(cfg).render(ps, pcam, seed=2)
    _close(got, jb.Renderer(jb.RenderConfig(**kw)).render(js, jcam, seed=2))
    brute = bt.Renderer(bt.RenderConfig(**kw, intersect_backend="brute")
                        ).render(ps, pcam, seed=2)
    assert torch.equal(got.image, brute.image)
    assert int(got.rays_traced) == int(brute.rays_traced)


def test_films_and_sharded_step_take_a_bvh_scene():
    """A scene that carries a BVH runs through the accumulating renderers
    (the fused path ignores the BVH) and the wavefront sharded step, which
    moves the BVH tables with the scene."""
    from bevyray_tpu_torch.parallel.sharding import (make_mesh,
                                                     render_frame_sharded)

    w = bt.rtiow.material_test_scene()
    scene, cam = w.extract(device="cpu"), w.camera_state(aspect=1.0,
                                                          device="cpu")
    plain = w.extract(with_bvh=False, device="cpu")
    cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=2,
                          bounces=2, level=3)
    adap = bt.AdaptiveRenderer(cfg, tolerance=0.05, device="cpu")
    adap.step(scene, cam, seed=1)
    ref = bt.AdaptiveRenderer(cfg, tolerance=0.05, device="cpu")
    ref.step(plain, cam, seed=1)
    assert torch.equal(adap.resolve(cam).image, ref.resolve(cam).image)
    bvh_cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=2,
                              bounces=2, level=3, intersect_backend="bvh")
    mesh = make_mesh(sp=2, devices=["cpu"] * 2)
    got = render_frame_sharded(mesh, scene, cam, bvh_cfg, 3)
    want = bt.Renderer(bvh_cfg).render(scene, cam, seed=3)
    assert torch.equal(got.image, want.image)
