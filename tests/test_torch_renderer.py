"""The port's wavefront renderer (``engine/renderer.py``) and its per-lane
pieces (``kernels/intersect.py``) against the JAX package's on the CPU.

- ``intersect_spheres``, ``make_hit_info``, ``triangle_hit_info``,
  ``merge_hits`` and ``gather_materials`` op by op on the same rays: the
  lowest index wins a tie between duplicate spheres, several chunks give one
  chunk's hits, triangles merge with spheres;
- ``Renderer`` against JAX's ``Renderer`` on five scenes at levels 0-3, and
  against the port's ``FusedRenderer(exact_rng=True)`` (JAX's own
  Pallas-against-Renderer check), at the bars of tests/test_pallas.py:24-28:
  image atol 5e-5, depth atol 1e-3, segment counts equal;
- ``resolve_intersect_backend``, and "bvh" raising on a scene without a
  BVH (the BVH backend itself is in ``test_torch_bvh_renderer.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.engine import renderer as jrenderer
from bevyray_tpu.kernels import intersect as jint
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.engine import renderer as prenderer
from bevyray_tpu_torch.kernels import intersect as pint

torch.set_num_threads(2)

SIZE = dict(width=24, height=24, samples_per_pixel=2, bounces=3)
LENS = dict(aperture=0.2, focus_distance=4.0)


def _material(pkg):
    return pkg.rtiow.material_test_scene()


def _grid4(pkg):
    return pkg.rtiow.final_scene(seed=42, grid=4)


def _night(pkg):
    return pkg.rtiow.night_scene()


def _mesh(pkg):
    """A blue sphere and a yellow cube mesh (tests/test_triangles.py)."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 0.5, 6).looking_at((0, 0.5, 0)))
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, 0),
                   pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(pkg.Transform.from_xyz(1.2, 0.5, 0), pkg.cube_mesh(1.0),
                 pkg.StandardMaterial(base_color=(1, 1, 0)))
    return w


def _lens(pkg):
    return pkg.rtiow.material_test_scene(pkg.RaytracedCamera(**LENS))


SCENES = {"material": (_material, {}), "final_grid4": (_grid4, {}),
          "night": (_night, {}), "mesh": (_mesh, {}),
          "defocus_cosine": (_lens, dict(defocus=True,
                                         diffuse_sampling="cosine"))}


def _both(world_fn):
    jw = world_fn(jb)
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam


def _close(got, want):
    """The bars: image atol 5e-5, depth atol 1e-3, segment counts equal."""
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(),
                               np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


# -- the per-lane pieces ------------------------------------------------------

def _rays(cam_pos, n=2048, seed=3):
    """``n`` rays from near the camera, aimed around the scene, with
    directions of random length (scatter directions are not unit)."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(cam_pos, np.float32)[:, None]
         + rng.normal(scale=0.2, size=(3, n)).astype(np.float32))
    target = rng.uniform([-4, -0.5, -4], [4, 2, 4], (n, 3)).T
    d = (target - o) * rng.uniform(0.5, 2.0, n)
    return o.astype(np.float32), d.astype(np.float32)


def _vecs(o, d):
    return (JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
            bt.Vec3(*map(torch.as_tensor, o)), bt.Vec3(*map(torch.as_tensor, d)))


def _with_duplicates(pkg):
    """The grid-4 final scene with two of its spheres spawned again in
    another material: both copies give the same t."""
    w = _grid4(pkg)
    for pos in ((0.0, 1.0, 0.0), (4.0, 1.0, 0.0)):
        w.spawn_sphere(pkg.Transform.from_xyz(*pos),
                       pkg.RaytracedSphere(radius=1.0),
                       pkg.StandardMaterial(base_color=(1.0, 0.0, 0.0)))
    return w


@pytest.fixture(scope="module")
def duplicate_scene():
    js, _, ps, _ = _both(_with_duplicates)
    cx = np.asarray(js.spheres.cx)
    valid = np.asarray(js.spheres.valid)
    dup = [(i, j) for i in range(cx.size) for j in range(i + 1, cx.size)
           if valid[i] and valid[j] and all(
               np.asarray(getattr(js.spheres, f))[i]
               == np.asarray(getattr(js.spheres, f))[j]
               for f in ("cx", "cy", "cz", "radius"))]
    assert len(dup) == 2
    return js, ps, dup


def test_intersect_spheres_matches_jax(duplicate_scene):
    """Random rays plus rays at the two duplicated spheres: the same
    winners (the lower index of each pair) and t within the rounding of
    the near root's cancellation."""
    js, ps, dup = duplicate_scene
    o, d = _rays((0.0, 1.0, 5.0))
    cam = np.array([0.0, 1.0, 5.0], np.float32)
    for k, (i, _) in enumerate(dup):
        center = np.array([js.spheres.cx[i], js.spheres.cy[i],
                           js.spheres.cz[i]], np.float32)
        o[:, k::8] = cam[:, None]
        d[:, k::8] = (center - cam)[:, None]
    jo, jd, po, pd = _vecs(o, d)
    want_t, want_i = jint.intersect_spheres(jo, jd, js.spheres)
    got_t, got_i = pint.intersect_spheres(po, pd, ps.spheres)
    want_t, want_i = np.asarray(want_t), np.asarray(want_i)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-5)
    assert (want_i >= 0).mean() > 0.3
    for k, (i, _) in enumerate(dup):
        assert (got_i.numpy()[k::8] == i).all()


def test_several_chunks_give_one_chunks_hits(duplicate_scene):
    _, ps, _ = duplicate_scene
    o, d = _rays((0.0, 1.0, 5.0), seed=4)
    _, _, po, pd = _vecs(o, d)
    one = pint.intersect_spheres(po, pd, ps.spheres, chunk=512)
    assert ps.spheres.capacity % 512     # falls back to one chunk
    for chunk in (8, 32):
        got = pint.intersect_spheres(po, pd, ps.spheres, chunk=chunk)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def test_hit_records_and_materials_match_jax():
    """``make_hit_info``, ``triangle_hit_info``, ``merge_hits`` and
    ``gather_materials`` on the mesh scene, fed JAX's (t, index) so that
    both packages build their records from the same winners."""
    js, jcam, ps, _ = _both(_mesh)
    o, d = _rays(np.asarray(jcam.position.to_array()), seed=5)
    jo, jd, po, pd = _vecs(o, d)
    st, si = jint.intersect_spheres(jo, jd, js.spheres)
    tt, ti = jint.intersect_triangles(jo, jd, js.triangles)
    want = jint.merge_hits(
        jint.make_hit_info(jo, jd, st, si, js.spheres),
        jint.triangle_hit_info(jo, jd, tt, ti, js.triangles))
    pst, pti = (torch.as_tensor(np.array(x)) for x in (st, tt))
    psi, ptii = (torch.as_tensor(np.array(x)).long() for x in (si, ti))
    got = pint.merge_hits(
        pint.make_hit_info(po, pd, pst, psi, ps.spheres),
        pint.triangle_hit_info(po, pd, pti, ptii, ps.triangles))
    assert int((~got.miss).sum()) > 200 and bool((ptii >= 0).any())
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    np.testing.assert_array_equal(got.miss.numpy(), np.asarray(want.miss))
    np.testing.assert_array_equal(got.material_id.numpy(),
                                  np.asarray(want.material_id))
    for g, w in ((got.position, want.position), (got.normal, want.normal)):
        for gc, wc in zip(g, w):
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)
    grazing = np.abs(np.asarray(jd.dot(want.normal))) < 1e-5
    np.testing.assert_array_equal(got.front_face.numpy()[~grazing],
                                  np.asarray(want.front_face)[~grazing])
    want_m = jint.gather_materials(js.materials, want.material_id)
    got_m = pint.gather_materials(ps.materials, got.material_id)
    for g, w in zip(jax.tree.leaves(tuple(got_m)),
                    jax.tree.leaves(tuple(want_m))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- Renderer -----------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("scene", list(SCENES))
def test_renderer_matches_jax(scene, level):
    world_fn, options = SCENES[scene]
    js, jcam, ps, pcam = _both(world_fn)
    cfg = dict(SIZE, level=level, **options)
    want = jb.Renderer(jb.RenderConfig(**cfg)).render(js, jcam, seed=5)
    got = bt.Renderer(bt.RenderConfig(**cfg)).render(ps, pcam, seed=5)
    if level == 0:
        np.testing.assert_array_equal(got.image.numpy(),
                                      np.asarray(want.image))
        assert int(got.rays_traced) == int(want.rays_traced) == 0
        return
    _close(got, want)
    if level == 1 and scene == "material":
        # Sky pixels (every sample's first segment missed) carry far + 10.
        assert float(got.rt_depth.max()) == pytest.approx(1010.0)


def test_cube_field_matches_jax():
    """``chip_smoke.cube_field_world`` built and extracted by each package:
    4,092 triangles in a table of 4,096 rows, eight chunks of the dense
    test, at config 5's bounces and level at 64x36, 1 spp."""
    from chip_smoke import cube_field_world

    jw, pw = cube_field_world(jb), cube_field_world(bt)
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=64 / 36)
    ps = pw.extract(with_bvh=False, device="cpu")
    pcam = pw.camera_state(aspect=64 / 36, device="cpu")
    assert ps.triangles.capacity == js.triangles.capacity == 4096
    cfg = dict(width=64, height=36, samples_per_pixel=1, bounces=4, level=2)
    assert prenderer.resolve_intersect_backend(
        ps, bt.RenderConfig(**cfg)) == "brute"
    want = jb.Renderer(jb.RenderConfig(**cfg)).render(js, jcam, seed=5)
    got = bt.Renderer(bt.RenderConfig(**cfg)).render(ps, pcam, seed=5)
    _close(got, want)


@pytest.mark.parametrize("scene", list(SCENES))
def test_renderer_matches_fused_renderer(scene):
    """The wavefront step against the fused kernel's plain version on the
    exact path: the same draws, the near root taken as (h - sqrt(disc)) / a
    by the one and compared as a·t by the other."""
    world_fn, options = SCENES[scene]
    _, _, ps, pcam = _both(world_fn)
    cfg = bt.RenderConfig(**SIZE, level=3, **options)
    want = bt.FusedRenderer(cfg, exact_rng=True).render(ps, pcam, seed=9)
    got = bt.Renderer(cfg).render(ps, pcam, seed=9)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(), want.rt_depth.numpy(),
                               atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


def test_fixed_trip_count_changes_no_value():
    _, _, ps, pcam = _both(_material)
    cfg = bt.RenderConfig(**SIZE, level=3)
    u, v = bt.engine.renderer.pixel_uv(cfg.width, cfg.height)
    ids = torch.arange(cfg.n_pixels)
    early = prenderer.trace_sample(ps, pcam, cfg, ids, u, v, 1, 7)
    fixed = prenderer.trace_sample(ps, pcam, cfg, ids, u, v, 1, 7,
                                   fixed_trip_count=True)
    for e, f in zip((*early[0], *early[1:]), (*fixed[0], *fixed[1:])):
        assert torch.equal(e, f)


def test_resolve_intersect_backend():
    js, _, ps, _ = _both(_mesh)
    for backend in ("auto", "brute"):
        cfg = dict(SIZE, intersect_backend=backend)
        assert prenderer.resolve_intersect_backend(
            ps, bt.RenderConfig(**cfg)) == jrenderer.resolve_intersect_backend(
                js, jb.RenderConfig(**cfg)) == "brute"
    cfg = bt.RenderConfig(**SIZE, intersect_backend="bvh")
    assert prenderer.resolve_intersect_backend(ps, cfg) == "bvh"
    with pytest.raises(ValueError, match="no BVH"):
        bt.Renderer(cfg).render(ps, _both(_mesh)[3], seed=1)


def test_renderer_is_deterministic_and_seeded():
    _, _, ps, pcam = _both(_material)
    r = bt.Renderer(dataclasses.replace(bt.RenderConfig(**SIZE), level=3))
    a, b = r.render(ps, pcam, seed=3), r.render(ps, pcam, seed=3)
    c = r.render(ps, pcam, seed=4)
    assert torch.equal(a.image, b.image) and int(a.rays_traced) == int(
        b.rays_traced)
    assert not torch.equal(a.image, c.image)
    assert a.rays_traced.dtype == torch.int64
