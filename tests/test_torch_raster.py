"""The port's raster layer (``engine/raster.py``, ``World.extract_raster_host``,
``kernels/raygen.py``, ``kernels/intersect.py``'s triangle test) against the
JAX package's on the CPU, and hybrid frames through ``FusedRenderer`` against
JAX ``PallasRenderer`` (the JAX kernel in Pallas interpret mode).

Bars: the raster host arrays are equal element for element; raster color
within atol 1e-6 and depth within rtol 1e-6 on identical hit masks (XLA on
the CPU contracts multiply-adds, the port rounds each operation); frames at
tests/test_pallas.py:24-28's bars (image atol 5e-5, depth atol 1e-3,
segments equal).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.engine.film import ProgressiveRenderer as JProgressive
from bevyray_tpu.engine.pallas_renderer import PallasRenderer
from bevyray_tpu.engine.raster import raster_layer as jraster_layer
from bevyray_tpu.kernels.raygen import generate_rays as jgenerate_rays
from bevyray_tpu.kernels.raygen import pixel_uv as jpixel_uv
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.engine.raster import raster_layer
from bevyray_tpu_torch.kernels.raygen import generate_rays, pixel_uv

torch.set_num_threads(2)


def _cube_world(pkg, rotation=None, mesh=False):
    """tests/test_raster.py's scene: ground, a blue sphere and the raster cube
    (rotated by ``rotation``); with ``mesh``, a traced metallic cube mesh too
    (raster layer plus triangle mesh, as BASELINE config 5)."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0.0, 1.0, 4.0).looking_at((0.0, 0.5, 0.0)))
    w.spawn_sphere(pkg.Transform.from_xyz(0.0, -1000.0, 0.0),
                   pkg.RaytracedSphere(1000.0),
                   pkg.StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_sphere(pkg.Transform.from_xyz(-1.2, 0.5, 0.0), pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0.1, 0.2, 0.5)))
    t = pkg.Transform.from_xyz(0.0, 0.5, 0.0)
    if rotation is not None:
        t = t.with_rotation(rotation)
    w.spawn_raster_mesh(t, pkg.cube_mesh(1.0),
                        pkg.StandardMaterial(base_color=(0.8, 0.7, 0.6)))
    if mesh:
        w.spawn_mesh(pkg.Transform.from_xyz(1.1, 0.35, 0.4), pkg.cube_mesh(0.7),
                     pkg.StandardMaterial(base_color=(0.2, 0.5, 0.9),
                                          metallic=1.0,
                                          perceptual_roughness=0.15))
    return w


def _rotated(pkg):
    q = pkg.Transform.rotation_axis_angle((0.0, 1.0, 0.0), np.pi / 5)
    return _cube_world(pkg, rotation=q)


def _metal_raster(pkg):
    w = _cube_world(pkg)
    w.spawn_raster_mesh(pkg.Transform.from_xyz(1.4, 0.3, 0.6), pkg.cube_mesh(0.6),
                        pkg.StandardMaterial(base_color=(0.9, 0.6, 0.2),
                                             metallic=1.0,
                                             perceptual_roughness=0.3,
                                             reflectance=0.8))
    return w


SCENES = {
    "cube": _cube_world,
    "rotated_cube": _rotated,
    "metal_and_cube": _metal_raster,
    "final_scene": lambda pkg: pkg.rtiow.final_scene(seed=42),
}


@pytest.mark.parametrize("name", SCENES)
def test_extract_raster_host_matches_jax(name):
    got = SCENES[name](bt).extract_raster_host()
    want = SCENES[name](jb).extract_raster_host()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,size,level", [
    ("cube", (64, 64), 1), ("rotated_cube", (48, 32), 1),
    ("metal_and_cube", (40, 40), 2), ("final_scene", (64, 36), 2)])
def test_raster_layer_matches_jax(name, size, level):
    w, h = size
    jw, pw = SCENES[name](jb), SCENES[name](bt)
    want_c, want_d = jraster_layer(jw, jw.camera_state(aspect=w / h),
                                   jb.RenderConfig(w, h, 1, 1, level=level))
    got_c, got_d = raster_layer(pw, pw.camera_state(aspect=w / h, device="cpu"),
                                bt.RenderConfig(w, h, 1, 1, level=level),
                                device="cpu")
    want_d = np.asarray(want_d)
    hit = want_d > 0
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got_d.numpy() > 0, hit)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-6)
    for g, wc in zip(got_c, want_c):
        assert g.shape == (w * h,)
        np.testing.assert_allclose(g.numpy(), np.asarray(wc), atol=1e-6)


def test_rays_match_jax():
    """``pixel_uv`` equals JAX's; ``generate_rays`` with jitter and the thin
    lens agrees with JAX's to float32 rounding."""
    jw = jb.rtiow.material_test_scene(jb.RaytracedCamera(aperture=0.2,
                                                         focus_distance=4.0))
    jcam = jw.camera_state(aspect=1.5)
    _, pcam = scene_from_numpy(jax.tree.map(np.asarray,
                                            jw.extract(with_bvh=False)),
                               jax.tree.map(np.asarray, jcam), device="cpu")
    ju, jv = jpixel_uv(24, 16)
    u, v = pixel_uv(24, 16, device="cpu")
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    draws = np.random.default_rng(7).random((4, 24 * 16)).astype(np.float32)
    want = jgenerate_rays(ju, jv, *draws[:2], jcam, 16, *draws[2:])
    got = generate_rays(u, v, *map(torch.as_tensor, draws[:2]), pcam, 16,
                        *map(torch.as_tensor, draws[2:]))
    for gv, wv in zip(got, want):
        for g, wc in zip(gv, wv):
            np.testing.assert_allclose(g.numpy(), np.asarray(wc), rtol=1e-6,
                                       atol=1e-6)


# -- tests/test_raster.py and tests/test_hybrid.py, in the port ----------------

def _port_raster(world, w, h, level=1):
    cam = world.camera_state(aspect=w / h, device="cpu")
    cfg = bt.RenderConfig(w, h, 1, 1, level=level)
    return cam, raster_layer(world, cam, cfg, device="cpu")


def test_depth_convention():
    """Raster depth is reverse-Z ``near / view_z``: 0 where nothing
    rasterizes, in (0, near/dist] on the cube; misses take the clear
    color."""
    _, (color, depth) = _port_raster(_cube_world(bt), 64, 64)
    d = depth.numpy().reshape(64, 64)
    hit = d > 0
    assert hit.any() and not hit.all()
    assert d[hit].max() <= 0.1 / 2.5
    assert d[hit].min() >= 0.1 / 10.0
    assert (color.x.numpy().reshape(64, 64)[~hit] == 1.0).all()


def test_no_raster_entities_returns_none():
    world = bt.World()
    world.spawn_sphere(bt.Transform.from_xyz(0, 0, 0), bt.RaytracedSphere(1.0),
                       bt.StandardMaterial())
    assert _port_raster(world, 8, 8)[1] == (None, None)


def test_cube_wins_where_nearer():
    """Where the cube's reverse-Z depth beats the traced depth, the image is
    exactly the raster color; level 3 ignores the raster layer."""
    world = _cube_world(bt)
    cam, (rc, rd) = _port_raster(world, 48, 48)
    scene = world.extract(with_bvh=False, device="cpu")
    cfg1 = bt.RenderConfig(width=48, height=48, samples_per_pixel=2, bounces=3,
                           level=1)
    f1 = bt.FusedRenderer(cfg1).render(scene, cam, seed=3, raster_color=rc,
                                       raster_depth=rd)
    img = f1.image.numpy()
    rz = np.where(f1.rt_depth.numpy() > float(cam.far), -1.0,
                  float(cam.near) / f1.rt_depth.numpy())
    wins = rd.numpy().reshape(48, 48) > rz
    assert wins.any()
    for ch, comp in enumerate(rc):
        np.testing.assert_array_equal(img[..., ch][wins],
                                      comp.numpy().reshape(48, 48)[wins])
    f3 = bt.FusedRenderer(dataclasses.replace(cfg1, level=3)).render(
        scene, cam, seed=3, raster_color=rc, raster_depth=rd)
    assert np.abs(f3.image.numpy() - img).max() > 0.05


def test_rotated_raster_cube_changes_silhouette():
    """A 45-degree cube shows a wider silhouette than the axis-aligned one,
    and traced meshes rotate through the same transform."""
    def cube_world(rot):
        w = bt.World()
        w.set_camera(bt.Transform.from_xyz(0.0, 0.5, 4.0).looking_at(
            (0.0, 0.5, 0.0)))
        t = bt.Transform.from_xyz(0.0, 0.5, 0.0)
        if rot is not None:
            t = t.with_rotation(rot)
        w.spawn_raster_mesh(t, bt.cube_mesh(1.0), bt.StandardMaterial())
        return w

    q = bt.Transform.rotation_axis_angle((0.0, 1.0, 0.0), np.pi / 4)
    cover0 = float((_port_raster(cube_world(None), 64, 64)[1][1] > 0)
                   .float().mean())
    cover1 = float((_port_raster(cube_world(q), 64, 64)[1][1] > 0)
                   .float().mean())
    assert cover1 > cover0 * 1.05   # the diagonal spans sqrt(2) face widths
    wt = bt.World()
    wt.spawn_mesh(bt.Transform.from_xyz(0.0, 0.5, 0.0).with_rotation(q),
                  bt.cube_mesh(1.0), bt.StandardMaterial())
    va, vb, vc, _, _ = wt.extract_meshes_host(first_material_id=0)
    corners = np.concatenate([va, vb, vc])
    assert np.isclose(np.abs(corners[:, 0]).max(), np.sqrt(2) / 2, atol=1e-5)


def test_raster_ambient_matches_bevy_formula():
    """The raster shading equals Bevy 0.14's ``ambient_light`` evaluated by
    hand at normal incidence for the default cube material, and the depth
    holds near / view_z of the front face (tests/test_hybrid.py:83)."""
    w = h = 17   # odd: the center pixel's ray runs along cam.direction
    world = bt.World()
    world.set_camera(bt.Transform.from_xyz(0, 0, 4).looking_at((0, 0, 0)),
                     camera=bt.RaytracedCamera(
                         level=bt.Raytracing.FALLBACK_RASTER))
    world.spawn_raster_mesh(bt.Transform.from_xyz(0, 0, 0), bt.cube_mesh(1.0),
                            bt.StandardMaterial(base_color=(0.8, 0.3, 0.2)))
    _, (rc, rd) = _port_raster(world, w, h, level=2)
    center = (h // 2) * w + (w // 2)
    got = np.array([float(c[center]) for c in rc])
    from bevyray_tpu_torch.scene.components import srgb_to_linear
    base = np.array([srgb_to_linear(c) for c in (0.8, 0.3, 0.2)])
    f0 = 0.16 * 0.5 ** 2          # metallic 0, reflectance 0.5
    d_scale, d_bias = 0.468 - 1.04 * 0.015, 1.04 * 0.015 - 0.018
    a004 = min(0.25, 2.0 ** -9.28) * 0.5 + 0.02875
    s_scale, s_bias = 0.754 - 1.04 * a004, 1.04 * a004 - 0.029
    spec_occ = min(1.0, 3 * f0 * 50.0 * 0.33)
    ambient = 80.0 / (125.0 * 1.2)
    want = (base * d_scale + d_bias + (f0 * s_scale + s_bias) * spec_occ) * ambient
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(float(rd[center]), world.projection.near / 3.5,
                               rtol=1e-4)


# -- hybrid frames against the JAX package ---------------------------------------

@pytest.mark.parametrize("level", [1, 2])
def test_hybrid_frame_matches_pallas_renderer(level):
    """Levels 1 and 2 with the raster cube over a scene with a traced cube
    mesh (raster layer plus triangles, as BASELINE config 5), each package
    compositing its own raster buffers. Where every sample missed and the
    raster layer too, level 1 shows the clear color, level 2 the traced
    sky."""
    w = h = 32
    jw, pw = _cube_world(jb, mesh=True), _cube_world(bt, mesh=True)
    cfg = dict(width=w, height=h, samples_per_pixel=2, bounces=3, level=level)
    jcam = jw.camera_state(aspect=1.0)
    js = jw.extract(with_bvh=False)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    jrc, jrd = jraster_layer(jw, jcam, jb.RenderConfig(**cfg))
    rc, rd = raster_layer(pw, pcam, bt.RenderConfig(**cfg), device="cpu")
    want = PallasRenderer(jb.RenderConfig(**cfg), exact_rng=True).render(
        js, jcam, seed=5, raster_color=jrc, raster_depth=jrd)
    got = bt.FusedRenderer(bt.RenderConfig(**cfg)).render(
        ps, pcam, seed=5, raster_color=rc, raster_depth=rd)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(), np.asarray(want.rt_depth),
                               atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0
    img = got.image.numpy().reshape(-1, 3)
    raster = np.stack([c.numpy() for c in rc], -1)
    wins = (img == raster).all(-1)
    assert wins.sum() > 20   # the raster cube shows
    sky = (got.rt_depth.numpy().reshape(-1) > 900) & (rd.numpy() == 0.0)
    assert sky.any()
    if level == 1:
        np.testing.assert_array_equal(img[sky], 1.0)
    else:
        assert (img[sky, 2] > 0.9).all() and not (img[sky] == 1.0).all()


def test_progressive_composites_the_raster_layer_like_jax():
    """``ProgressiveRenderer.step`` composites each package's per-pixel
    raster buffers over the running film at level 1, pass by pass."""
    w = h = 24
    jw, pw = _cube_world(jb, mesh=True), _cube_world(bt, mesh=True)
    cfg = dict(width=w, height=h, samples_per_pixel=2, bounces=3, level=1)
    jcam = jw.camera_state(aspect=1.0)
    js = jw.extract(with_bvh=False)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    jrc, jrd = jraster_layer(jw, jcam, jb.RenderConfig(**cfg))
    rc, rd = raster_layer(pw, pcam, bt.RenderConfig(**cfg), device="cpu")
    jprog = JProgressive(jb.RenderConfig(**cfg), backend="pallas")
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**cfg), backend="pallas",
                                  device="cpu")
    for seed in (2, 3):
        want = jprog.step(js, jcam, seed=seed, raster_color=jrc,
                          raster_depth=jrd)
        got = prog.step(ps, pcam, seed=seed, raster_color=rc, raster_depth=rd)
        np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                                   atol=5e-5)
        np.testing.assert_allclose(got.rt_depth.numpy(),
                                   np.asarray(want.rt_depth), atol=1e-3)
        assert int(got.rays_traced) == int(want.rays_traced) > 0
    raster = np.stack([c.numpy() for c in rc], -1)
    assert (got.image.numpy().reshape(-1, 3) == raster).all(-1).sum() > 20
