"""Golden-image tests of the port: its renderers against its own NumPy oracle
(``bevyray_tpu_torch/testing/oracle.py``), and that oracle against the JAX
package's, on the CPU.

- The port's ``render_oracle`` and ``render_oracle_fast`` give the same bits
  as JAX's on the same NumPy inputs, on every scene of JAX's oracle tests
  (``np.testing.assert_array_equal``): the copy is faithful.
- ``oracle_inputs_from_world`` and ``extract_meshes_host`` give the same
  arrays from each package's ``World`` of the same scene.
- Counterparts of the JAX package's 15 oracle tests (tests/test_golden.py,
  tests/test_extensions.py:30,61, tests/test_raster.py:54,
  tests/test_fuse.py:172) with the same scenes, sizes and seeds, holding the
  port's wavefront ``Renderer`` ("brute", and "bvh" for hollow glass) and
  its ``FusedRenderer(exact_rng=True)`` (the kernel's plain version on the
  CPU; the four modes on the small final scene) to the port's oracle.

Bars, JAX's own: image mean |d| < 2e-3 with under 1% of pixels past 5e-3
(tests/test_golden.py:39-44), 4e-3 / 2% for the material, final, mesh,
hollow-glass, lens, cosine and kitchen-sink scenes; depth atol 1e-2 where
both hit; the fast oracle within atol 2e-5 (depth rtol 1e-4) of the scalar
one; level 1 within atol 2e-5 of the scalar oracle; ``FusedRenderer`` within
atol 5e-5 of ``Renderer`` on the kitchen sink. The renderers and the oracle
differ by libm and by the rounding of torch's CPU float32 sqrt, which can
flip a grazing hit or a branch on a measure-zero set of rays.
"""

import functools

import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from chip_smoke import golden_world as _golden
from bevyray_tpu.testing import oracle as joracle
from bevyray_tpu_torch.engine.raster import raster_layer
from bevyray_tpu_torch.kernels.cuda.megakernel import st_planes
from bevyray_tpu_torch.testing.oracle import (oracle_inputs_from_world,
                                              render_oracle,
                                              render_oracle_fast)

torch.set_num_threads(2)

MODES = [("off", "grouped"), ("split", "grouped"), ("off", "candidates"),
         ("split", "candidates")]


# -- the scenes of JAX's oracle tests, built in either package -----------------

def _simple(pkg):
    return pkg.rtiow.simple_scene()


def _material(pkg):
    return pkg.rtiow.material_test_scene()


def _final_small(pkg):
    return pkg.rtiow.final_scene(seed=5, grid=2)


def _defocus_emissive(pkg):
    """tests/test_golden.py:91-104."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 1.0, 5).looking_at((0, 0.5, 0)),
                 camera=pkg.RaytracedCamera(level=pkg.Raytracing.PURE,
                                            aperture=0.25, focus_distance=5.0))
    w.spawn_sphere(pkg.Transform.from_xyz(0, -1000, 0),
                   pkg.RaytracedSphere(1000.0),
                   pkg.StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_sphere(pkg.Transform.from_xyz(0, 0.5, 0), pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0.0, 0.0, 0.0),
                                        emissive=(4.0, 2.0, 1.0)))
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, -2.0),
                   pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0.2, 0.4, 0.8)))
    return w


def _emissive(pkg):
    """tests/test_extensions.py:14-27: one emissive sphere lights a diffuse
    one."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 1, 6).looking_at((0, 1, 0)),
                 camera=pkg.RaytracedCamera(level=pkg.Raytracing.PURE))
    w.spawn_sphere(pkg.Transform.from_xyz(0, -1000, 0),
                   pkg.RaytracedSphere(1000.0),
                   pkg.StandardMaterial(base_color=(0.6, 0.6, 0.6)))
    w.spawn_sphere(pkg.Transform.from_xyz(-1, 1, 0), pkg.RaytracedSphere(0.8),
                   pkg.StandardMaterial(base_color=(0.8, 0.3, 0.3)))
    w.spawn_sphere(pkg.Transform.from_xyz(1.5, 2.5, 0), pkg.RaytracedSphere(0.6),
                   pkg.StandardMaterial(base_color=(0, 0, 0),
                                        emissive=(4.0, 3.5, 3.0)))
    return w


# chip_smoke.golden_world builds the mesh (tests/test_golden.py:133-144),
# hollow-glass (:166-177), kitchen-sink (:201-225) and level-1 cube
# (tests/test_raster.py:14-25) scenes, which phase 11 holds on the card.
_mesh, _hollow_glass, _kitchen_sink, _cube = (
    functools.partial(_golden, name=name)
    for name in ("mesh", "hollow_glass", "kitchen_sink", "cube"))
WORLDS = {"simple": _simple, "material": _material,
          "final_small": _final_small, "defocus_emissive": _defocus_emissive,
          "mesh": _mesh, "hollow_glass": _hollow_glass,
          "kitchen_sink": _kitchen_sink, "cube": _cube, "emissive": _emissive}


def _oracle_args(world, aspect=1.0):
    """The oracle's scene arguments from ``world``: spheres, then the mesh
    records appended to the material table and the corners as triangles,
    as JAX's tests pass them."""
    centers, radii, mats, camera = oracle_inputs_from_world(world)
    camera["aspect"] = aspect
    triangles = None
    meshes = world.extract_meshes_host(first_material_id=len(radii))
    if meshes is not None:
        va, vb, vc, tri_mids, tri_mats = meshes
        mats = np.concatenate([mats, tri_mats], axis=0)
        triangles = (va, vb, vc, tri_mids)
    return (centers, radii, mats, camera), triangles


def _raster_np(world, config):
    """The port's raster layer on the CPU: the renderers' (Vec3, depth) and
    the oracle's ([H, W, 3], [H, W]) arrays of the same buffers."""
    cam = world.camera_state(aspect=config.width / config.height, device="cpu")
    rc, rd = raster_layer(world, cam, config, device="cpu")
    h, w = config.height, config.width
    color = np.stack([c.numpy().reshape(h, w) for c in rc], axis=-1)
    return (rc, rd), (color, rd.numpy().reshape(h, w))


def _frame(renderer, world, with_bvh=False, raster=(None, None), seed=0):
    cfg = renderer.config
    scene = world.extract(with_bvh=with_bvh, device="cpu")
    cam = world.camera_state(aspect=cfg.width / cfg.height, device="cpu")
    return renderer.render(scene, cam, seed=seed, raster_color=raster[0],
                           raster_depth=raster[1])


def _render_pair(world, width, height, spp, bounces, level, seed, **oracle_kw):
    """tests/test_golden.py:18-35: the port's ``Renderer`` and the fast
    oracle on the same frame."""
    cfg = bt.RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=level,
                          defocus=oracle_kw.get("defocus", False),
                          diffuse_sampling=oracle_kw.get("diffuse_sampling",
                                                         "reference"))
    frame = _frame(bt.Renderer(cfg), world, seed=seed)
    args, _ = _oracle_args(world, width / height)
    want, want_depth = render_oracle_fast(*args, width, height, spp, bounces,
                                          level, seed, **oracle_kw)
    return frame.image.numpy(), frame.rt_depth.numpy(), want, want_depth


def _assert_images_match(got, want, mean_tol=2e-3, outlier_tol=5e-3,
                         max_outlier_frac=0.01):
    err = np.abs(got - want)
    assert err.mean() < mean_tol, f"mean err {err.mean()}"
    frac = (err.max(axis=-1) > outlier_tol).mean()
    assert frac < max_outlier_frac, f"outlier fraction {frac}"


# -- (i) the port's oracle is JAX's, bit for bit ----------------------------------

# scene -> (level, oracle options); the levels 1 and 2 frames take the port's
# raster buffers, the same arrays for both oracles.
ORACLE_CASES = {
    "simple": (3, {}), "material": (3, {}), "final_small": (3, {}),
    "mesh": (3, {}), "hollow_glass": (3, {}),
    "defocus_emissive": (3, dict(defocus=True)),
    "cosine": (3, dict(diffuse_sampling="cosine")),
    "level1_raster": (1, {}),
    "level2_raster": (2, dict(defocus=True, diffuse_sampling="cosine")),
}
ORACLE_WORLDS = {"cosine": "material", "level1_raster": "cube",
                 "level2_raster": "kitchen_sink"}


@pytest.mark.parametrize("fast", [False, True], ids=["scalar", "fast"])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_is_jax_oracle_bit_for_bit(case, fast):
    level, options = ORACLE_CASES[case]
    world = WORLDS[ORACLE_WORLDS.get(case, case)](bt)
    size, spp, bounces, seed = (32, 2, 4, 17) if fast else (12, 2, 4, 17)
    args, triangles = _oracle_args(world)
    kw = dict(options, triangles=triangles)
    if level in (1, 2):
        cfg = bt.RenderConfig(size, size, spp, bounces, level=level)
        kw["raster_color"], kw["raster_depth"] = _raster_np(world, cfg)[1]
    port, jax_ = ((render_oracle_fast, joracle.render_oracle_fast) if fast
                  else (render_oracle, joracle.render_oracle))
    got = port(*args, size, size, spp, bounces, level, seed, **kw)
    want = jax_(*args, size, size, spp, bounces, level, seed, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # Every material kind, the sky and (at levels 1-2) the raster layer show.
    assert len(np.unique(got[0].reshape(-1, 3), axis=0)) > size


# -- (ii) both packages' Worlds give the oracle the same arrays ------------------

@pytest.mark.parametrize("scene", list(WORLDS))
def test_oracle_inputs_match_jax(scene):
    pw, jw = WORLDS[scene](bt), WORLDS[scene](jb)
    got, want = oracle_inputs_from_world(pw), joracle.oracle_inputs_from_world(jw)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        np.testing.assert_array_equal(np.asarray(got[3][k], np.float32),
                                      np.asarray(want[3][k], np.float32))
    first = len(want[1])
    pmeshes = pw.extract_meshes_host(first_material_id=first)
    jmeshes = jw.extract_meshes_host(first_material_id=first)
    assert (pmeshes is None) == (jmeshes is None)
    for g, w in zip(pmeshes or (), jmeshes or ()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- (iii) the fast oracle is the scalar oracle ---------------------------------

def test_fast_oracle_is_the_scalar_oracle():
    """The twin of tests/test_golden.py:47: every code path (sky, all three
    materials, depth) to float ulps."""
    world = bt.rtiow.final_scene(seed=5, grid=2)
    centers, radii, mats, camera = oracle_inputs_from_world(world)
    a, da = render_oracle(centers, radii, mats, camera, 24, 24, 2, 4, 3, 11)
    b, db = render_oracle_fast(centers, radii, mats, camera, 24, 24, 2, 4, 3, 11)
    np.testing.assert_allclose(a, b, atol=2e-5)
    np.testing.assert_allclose(da, db, rtol=1e-4)   # summation-order ulps


# -- (iv) the port's renderers against its oracle --------------------------------

@pytest.mark.parametrize("level", [3, 2])
def test_simple_scene_matches_oracle(level):
    """BASELINE config 1: Lambertian spheres + ground."""
    got, got_depth, want, want_depth = _render_pair(
        _simple(bt), 96, 96, spp=4, bounces=8, level=level, seed=7)
    _assert_images_match(got, want)
    # Depth: compare where both agree it's a hit (the miss fallback is huge).
    both_hit = (want_depth < 900) & (got_depth < 900)
    assert both_hit.mean() > 0.5
    np.testing.assert_allclose(got_depth[both_hit], want_depth[both_hit],
                               atol=1e-2)


def test_material_scene_matches_oracle():
    """BASELINE config 2: metal fuzz + dielectric with Schlick."""
    got, _, want, _ = _render_pair(_material(bt), 96, 96, spp=4, bounces=8,
                                   level=3, seed=3)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


def test_final_scene_small_matches_oracle():
    """A shrunk RTiOW final scene (grid=2), all material kinds."""
    got, _, want, _ = _render_pair(_final_small(bt), 80, 80, spp=4, bounces=4,
                                   level=3, seed=11)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


@pytest.mark.parametrize("mode", MODES, ids=["/".join(m) for m in MODES])
def test_fused_renderer_matches_oracle_in_every_mode(mode):
    """The fused kernel's plain version, each (primary, intersect) mode
    forced, on the exact draws, against the oracle of the frame above."""
    world = _final_small(bt)
    cfg = bt.RenderConfig(80, 80, 4, 4, level=3, pallas_primary=mode[0],
                          pallas_intersect=mode[1])
    renderer = bt.FusedRenderer(cfg, exact_rng=True)
    got = _frame(renderer, world, seed=11).image.numpy()
    assert renderer.last_mode == mode and renderer.last_exact_rng is True
    args, _ = _oracle_args(world)
    want, _ = render_oracle_fast(*args, 80, 80, 4, 4, 3, 11)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


def test_defocus_emissive_combo_matches_oracle():
    """Defocus blur + emissive lighting together."""
    got, _, want, _ = _render_pair(_defocus_emissive(bt), 64, 64, spp=4,
                                   bounces=4, level=3, seed=9, defocus=True)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


def test_cosine_sampling_matches_oracle():
    """The cosine-weighted diffuse extension draw-for-draw vs the oracle."""
    got, _, want, _ = _render_pair(_material(bt), 64, 64, spp=4, bounces=6,
                                   level=3, seed=13, diffuse_sampling="cosine")
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


def test_skip_level_passthrough():
    """Level 0 returns the raster layer untouched (raytrace.wgsl:97-99): the
    clear color, as the oracle's level 0 does."""
    cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=1, bounces=1,
                          level=0)
    world = _simple(bt)
    got = _frame(bt.Renderer(cfg), world).image.numpy()
    np.testing.assert_allclose(got, 1.0)
    args, _ = _oracle_args(world)
    want, _ = render_oracle_fast(*args, 16, 16, 1, 1, 0, 0)
    np.testing.assert_array_equal(got, want)


def test_mesh_scene_matches_oracle():
    """Triangle meshes against the scalar oracle's serial control flow and
    its own Möller–Trumbore."""
    world = _mesh(bt)
    cfg = bt.RenderConfig(width=40, height=40, samples_per_pixel=2, bounces=4,
                          level=3)
    got = _frame(bt.Renderer(cfg), world, seed=6).image.numpy()
    args, triangles = _oracle_args(world)
    want, _ = render_oracle(*args, 40, 40, 2, 4, 3, 6, triangles=triangles)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)


def test_hollow_glass_matches_oracle():
    """The negative-radius inner shell (hit_sphere only squares r,
    wgsl:375), through the dense test and the BVH walk."""
    world = _hollow_glass(bt)
    args, _ = _oracle_args(world)
    want, _ = render_oracle(*args, 32, 32, 2, 6, 3, 4)
    for backend, with_bvh in (("brute", False), ("bvh", True)):
        cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=2,
                              bounces=6, level=3, intersect_backend=backend)
        got = _frame(bt.Renderer(cfg), world, with_bvh=with_bvh, seed=4)
        _assert_images_match(got.image.numpy(), want, mean_tol=4e-3,
                             max_outlier_frac=0.02)


def test_kitchen_sink_hybrid_all_features_vs_oracle():
    """Hybrid level 2 with the raster cube, a traced mesh, an emissive
    sphere, hollow glass, the thin lens and cosine diffuse sampling:
    ``Renderer`` against the fast oracle fed the same raster buffers, and
    ``FusedRenderer`` (phase split, exact draws) against ``Renderer``."""
    world = _kitchen_sink(bt)
    w_, h_ = 48, 48
    cfg = bt.RenderConfig(width=w_, height=h_, samples_per_pixel=3, bounces=4,
                          level=2, defocus=True, diffuse_sampling="cosine")
    raster, (raster_color, raster_depth) = _raster_np(world, cfg)
    got = _frame(bt.Renderer(cfg), world, raster=raster, seed=21).image.numpy()
    fused = bt.FusedRenderer(cfg, exact_rng=True)
    got_fused = _frame(fused, world, raster=raster, seed=21).image.numpy()
    assert fused.prepare(world.extract(with_bvh=False, device="cpu")
                         ).has_emissive is True
    args, triangles = _oracle_args(world)
    want, _ = render_oracle_fast(*args, w_, h_, 3, 4, 2, 21,
                                 raster_color=raster_color,
                                 raster_depth=raster_depth, defocus=True,
                                 diffuse_sampling="cosine",
                                 triangles=triangles)
    _assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)
    np.testing.assert_allclose(got_fused, got, atol=5e-5)


def test_emissive_sphere_glows_and_matches_oracle():
    """tests/test_extensions.py:30."""
    world = _emissive(bt)
    cfg = bt.RenderConfig(width=40, height=40, samples_per_pixel=2, bounces=4,
                          level=3)
    got = _frame(bt.Renderer(cfg), world, seed=4).image.numpy()
    args, _ = _oracle_args(world)
    want, _ = render_oracle(*args, 40, 40, 2, 4, 3, 4)
    assert np.abs(got - want).mean() < 4e-3
    # The emissive sphere (upper right) must be the brightest region.
    bright = got.reshape(-1, 3).sum(-1)
    ys, xs = np.mgrid[0:40, 0:40]
    emissive_region = ((xs > 22) & (xs < 34) & (ys > 6) & (ys < 20)).reshape(-1)
    assert bright[emissive_region].mean() > 1.5 * bright[~emissive_region].mean()


def test_emissive_zero_matches_oracle():
    """tests/test_extensions.py:61: emissive (0, 0, 0) is the radiance-free
    formulation of the oracle."""
    world = _material(bt)
    cfg = bt.RenderConfig(width=24, height=24, samples_per_pixel=2, bounces=4,
                          level=3)
    got = _frame(bt.Renderer(cfg), world, seed=7).image.numpy()
    args, _ = _oracle_args(world)
    want, _ = render_oracle(*args, 24, 24, 2, 4, 3, 7)
    assert np.abs(got - want).mean() < 2e-3


def test_hybrid_level1_golden_vs_oracle():
    """tests/test_raster.py:54: level 1 with the raster cube against the
    scalar oracle fed the same buffers (near/t against the prepass's
    reverse-Z, level 1's fallback far)."""
    world = _cube(bt)
    w_ = h_ = 32
    cfg = bt.RenderConfig(width=w_, height=h_, samples_per_pixel=2, bounces=3,
                          level=1)
    raster, (raster_color, raster_depth) = _raster_np(world, cfg)
    got = _frame(bt.Renderer(cfg), world, raster=raster, seed=5).image.numpy()
    args, _ = _oracle_args(world)
    want, _ = render_oracle(*args, w_, h_, samples_per_pixel=2, bounces=3,
                            level=1, frame_seed=5, raster_color=raster_color,
                            raster_depth=raster_depth)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_emissive_scene_uses_full_layout_and_matches_oracle():
    """tests/test_fuse.py:172: an emissive scene takes the 13-plane layout
    that parks radiance, and the phase split still matches the oracle."""
    world = _emissive(bt)
    cfg = bt.RenderConfig(width=64, height=64, samples_per_pixel=2, bounces=4,
                          level=3, pallas_primary="split")
    renderer = bt.FusedRenderer(cfg, exact_rng=True)
    got = _frame(renderer, world, seed=4).image.numpy()
    kscene = renderer.prepare(world.extract(with_bvh=False, device="cpu"))
    assert kscene.has_emissive is True and st_planes(kscene.has_emissive) == 13
    assert renderer.last_mode[0] == "split"
    args, _ = _oracle_args(world)
    want, _ = render_oracle_fast(*args, 64, 64, 2, 4, 3, 4)
    assert np.abs(got - want).mean() < 4e-3
