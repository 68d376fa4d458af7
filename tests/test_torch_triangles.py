"""Triangle meshes in the port's fused path (the kernel's B9 branch) against
the JAX package on the CPU: the JAX kernel in Pallas interpret mode, the
port through its plain version.

- The mixed scene of tests/test_triangles.py (a sphere and a cube mesh,
  32x32, 2 spp, 3 bounces) in every (primary, intersect) mode: the port's
  ``FusedRenderer`` against JAX ``PallasRenderer`` and the port's
  ``render_tiles`` against JAX's (a level-3 ``PallasRenderer`` frame is its
  ``render_tiles`` output unshuffled: composite passes the traced layer), at
  the bars of tests/test_pallas.py:24-28 (image atol 5e-5, depth atol 1e-3,
  segments equal), each mode bit-equal to the port's off/grouped mode;
- the triangle table and attribute columns against JAX's prepared scene;
- exact ties: the lowest triangle index wins among triangles, a sphere wins
  against a triangle;
- ``ProgressiveRenderer(backend="pallas")`` on the mesh scene against JAX's;
- the JAX package's own triangle tests, run through ``FusedRenderer``.
"""

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.engine.film import ProgressiveRenderer as JProgressive
from bevyray_tpu.engine.pallas_renderer import PallasRenderer
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core.types import Triangles, scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary
from bevyray_tpu_torch.kernels.intersect import intersect_triangles

from test_torch_scene import _decoded_attr

torch.set_num_threads(2)

MODES = [("off", "grouped"), ("split", "grouped"), ("off", "candidates"),
         ("split", "candidates")]
MIXED = dict(width=32, height=32, samples_per_pixel=2, bounces=3, level=3)
SEEDS = (4, 5, 6)


def _camera_world(pkg):
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 0.5, 6).looking_at((0, 0.5, 0)),
                 camera=pkg.RaytracedCamera(level=pkg.Raytracing.PURE))
    return w


def _mixed(pkg):
    """tests/test_triangles.py's mixed scene: a blue sphere, a yellow cube."""
    w = _camera_world(pkg)
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, 0), pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(pkg.Transform.from_xyz(1.2, 0.5, 0), pkg.cube_mesh(1.0),
                 pkg.StandardMaterial(base_color=(1, 1, 0)))
    return w


def _both(world_fn, aspect=1.0):
    jw = world_fn(jb)
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=aspect)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam


def _close(got, want):
    """The bars: image atol 5e-5, depth atol 1e-3, segment counts equal."""
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(), np.asarray(want.rt_depth),
                               atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


def _forced(mode, **extra):
    return dict(MIXED, pallas_primary=mode[0], pallas_intersect=mode[1],
                **extra)


@pytest.mark.parametrize("mode", MODES, ids=["/".join(m) for m in MODES])
def test_mesh_scene_matches_jax_in_every_mode(mode):
    js, jcam, ps, pcam = _both(_mixed)
    jr = PallasRenderer(jb.RenderConfig(**_forced(mode)), exact_rng=True)
    r = bt.FusedRenderer(bt.RenderConfig(**_forced(mode)))
    kscene = r.prepare(ps)
    sl, slmeta = r.shortlists(kscene, pcam)
    base = bt.RenderConfig(**_forced(("off", "grouped")))
    for seed in SEEDS:
        want = jr.render(js, jcam, seed=seed)
        got = r.render(ps, pcam, seed=seed)
        assert r.last_mode == mode
        _close(got, want)
        work = {}
        tiles = mk.render_tiles_reference(kscene, pcam, r.config, seed, sl=sl,
                                          slmeta=slmeta, work=work)
        frame = bt.FrameResult(
            image=torch.stack([mk.unshuffle_blocks(c, r.config)
                               for c in tiles[:3]], -1).reshape(32, 32, 3),
            rt_depth=mk.unshuffle_blocks(tiles[3], r.config).reshape(32, 32),
            rays_traced=tiles[4])
        _close(frame, want)
        # Every segment tests the 12 live rows, never the 116 padding rows.
        assert work["triangle_tests"] == 12 * int(tiles[4])
        for a, b in zip(tiles, mk.render_tiles(kscene, pcam, base, seed)):
            assert torch.equal(a, b)


def test_triangle_tables_match_jax():
    """The (10, T) triangle rows equal JAX's prepared rows; the triangle
    columns of ``attr`` (unit normals, materials) agree with JAX's bf16
    hi+lo table decoded to float32, at test_torch_scene.py's bar; the live
    count stops at the last valid row."""
    js, _, ps, _ = _both(_mixed)
    want = jmk.jitted_prepare(0, "kd")(js)
    got = mk.prepare_kernel_scene(ps)
    s = got.sph.shape[1]
    assert got.tri.shape == (10, 128) and got.n_tris == 12
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.attr[:, s:].numpy(),
                               _decoded_attr(want.attr)[:, s:], rtol=1e-4,
                               atol=1e-7)
    normals = got.attr[:3, s:s + 12]
    np.testing.assert_allclose(normals.square().sum(0).numpy(), 1.0,
                               rtol=1e-6)
    empty = mk.prepare_kernel_scene(bt.rtiow.simple_scene().extract(
        with_bvh=False, device="cpu"))
    assert empty.tri.shape == (10, 0) and empty.n_tris == 0


def _duplicates(pkg):
    """One cube mesh spawned twice at the same place, emissive red then
    emissive green, beside a grey sphere: the copies hit at the same t."""
    w = _camera_world(pkg)
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, 0), pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    for color in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)):
        w.spawn_mesh(pkg.Transform.from_xyz(0.6, 0.5, 0), pkg.cube_mesh(1.2),
                     pkg.StandardMaterial(base_color=(0, 0, 0),
                                          emissive=color))
    return w


def test_duplicate_meshes_keep_the_lower_triangle_index():
    """The first cube's triangles win every exact tie with the second's, in
    every mode: with no bounce, no pixel whose samples all hit shows the
    second cube's green emission, many show the first cube's red, and
    every mode gives the off/grouped bits."""
    world = _duplicates(bt)
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    frames = []
    for mode in MODES:
        r = bt.FusedRenderer(bt.RenderConfig(**_forced(mode, bounces=0)))
        frames.append(r.render(scene, cam, seed=3))
        assert r.last_mode == mode
    for f in frames[1:]:
        assert torch.equal(f.image, frames[0].image)
        assert torch.equal(f.rt_depth, frames[0].rt_depth)
        assert int(f.rays_traced) == int(frames[0].rays_traced)
    assert mk.prepare_kernel_scene(scene).n_tris == 24
    img = frames[0].image[frames[0].rt_depth < 100.0]   # every sample hit
    assert bool((img[:, 1] == 0.0).all())
    assert int((img[:, 0] == 1.0).sum()) > 50


def test_sphere_wins_an_exact_tie_with_a_triangle():
    """The plain version's merge with a hand-set sphere hit at exactly the
    triangle's t keeps the sphere; one ulp farther, the triangle wins with
    its row offset past the padded sphere table."""
    _, _, ps, _ = _both(_mixed)
    kscene = mk.prepare_kernel_scene(ps)
    o = bt.Vec3(*(torch.tensor([v, v]) for v in (1.2, 0.5, 6.0)))
    d = bt.Vec3(*(torch.tensor([v, v]) for v in (0.05, 0.02, -1.0)))
    rows = kscene.tri[:, :kscene.n_tris]
    t, i = intersect_triangles(o, d, Triangles(*rows[:9], material_id=None,
                                               valid=rows[9] > 0.0))
    assert bool((i >= 0).all())
    sphere = torch.tensor([7, 7])
    best_t = torch.stack([t[0], torch.nextafter(t[1], torch.tensor(np.inf,
                                                                 dtype=t.dtype))])
    work = {"triangle_tests": 0}
    got_t, got_i = mk._merge_triangles(o, d, best_t, sphere, kscene, work)
    assert got_i.tolist() == [7, int(i[1]) + kscene.sph.shape[1]]
    assert torch.equal(got_t, t)
    assert work["triangle_tests"] == 2 * 12


def test_progressive_on_mesh_scene_matches_jax():
    js, jcam, ps, pcam = _both(_mixed)
    jprog = JProgressive(jb.RenderConfig(**MIXED), backend="pallas")
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**MIXED), backend="pallas",
                                  device="cpu")
    for seed in (9, 9, 4):
        _close(prog.step(ps, pcam, seed=seed), jprog.step(js, jcam, seed=seed))
    assert prog.samples_accumulated == jprog.samples_accumulated == 6


# -- tests/test_triangles.py, through FusedRenderer -----------------------------

def _render(world, width, height, spp, bounces, seed):
    cfg = bt.RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    frame = bt.FusedRenderer(cfg).render(
        world.extract(with_bvh=False, device="cpu"),
        world.camera_state(aspect=width / height, device="cpu"), seed=seed)
    return frame.image.numpy(), frame.rt_depth.numpy()


def test_single_triangle_hit_region_and_depth():
    w = _camera_world(bt)
    tri = bt.RaytracedMesh(
        vertices=np.array([[-1, -0.5, 0], [1, -0.5, 0], [0, 1.5, 0]],
                          np.float32),
        indices=np.array([[0, 1, 2]], np.int32))
    w.spawn_mesh(bt.Transform.from_xyz(0, 0, 0), tri,
                 bt.StandardMaterial(base_color=(1.0, 0.1, 0.1)))
    img, depth = _render(w, 48, 48, 2, 2, 1)
    # Center of the triangle: a red hit at distance 6; corners: sky.
    assert img[22, 24, 0] > 0.3 and img[22, 24, 1] < 0.15
    assert abs(depth[22, 24] - 6.0) < 0.05
    assert img[2, 2, 2] > 0.9
    assert depth[2, 2] > 900


@pytest.mark.parametrize("cube_z,expect_cube", [(2.0, True), (-4.0, False)])
def test_cube_occludes_sphere(cube_z, expect_cube):
    w = _camera_world(bt)
    w.spawn_sphere(bt.Transform.from_xyz(0, 0.5, 0), bt.RaytracedSphere(0.8),
                   bt.StandardMaterial(base_color=(0.1, 0.9, 0.1)))
    w.spawn_mesh(bt.Transform.from_xyz(0, 0.5, cube_z), bt.cube_mesh(1.2),
                 bt.StandardMaterial(base_color=(0.9, 0.1, 0.1)))
    center = _render(w, 32, 32, 4, 2, 2)[0][16, 16]
    if expect_cube:
        assert center[0] > center[1], f"cube in front: {center}"
    else:
        assert center[1] > center[0], f"sphere in front: {center}"


def test_mesh_materials_share_table_with_spheres():
    w = _camera_world(bt)
    w.spawn_sphere(bt.Transform.from_xyz(-1.5, 0.5, 0), bt.RaytracedSphere(0.5),
                   bt.StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(bt.Transform.from_xyz(1.2, 0.5, 0), bt.cube_mesh(1.0),
                 bt.StandardMaterial(base_color=(1, 1, 0)))
    img = _render(w, 48, 48, 4, 2, 3)[0]
    left, right = img[24, 12], img[24, 36]
    assert left[2] > left[0] and left[2] > left[1], left
    assert right[0] > 0.3 and right[1] > 0.3 and right[2] < 0.2, right


def test_metallic_cube_reflects():
    w = _camera_world(bt)
    w.spawn_sphere(bt.Transform.from_xyz(0, -1000, 0), bt.RaytracedSphere(999.6),
                   bt.StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_mesh(bt.Transform.from_xyz(0, 0.7, 0), bt.cube_mesh(1.4),
                 bt.StandardMaterial(base_color=(0.9, 0.9, 0.9), metallic=1.0,
                                     perceptual_roughness=0.0))
    img = _render(w, 32, 32, 8, 4, 4)[0]
    assert np.isfinite(img).all()
    # The front face mirrors what lies behind the camera (sky): bright.
    assert img[18, 16].mean() > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("world_fn,mode", [
    (_mixed, mode) for mode in MODES] + [(_duplicates, ("split", "candidates"))],
    ids=["/".join(m) for m in MODES] + ["duplicates"])
def test_cuda_triangle_branch_matches_plain_version_on_card(world_fn, mode):
    """On the card: the kernel's triangle branch against its plain version
    on the same CUDA tensors, at the bars of chip_smoke.py phase 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = world_fn(bt)
    dev = torch.device("cuda", 0)
    cfg = bt.RenderConfig(**_forced(mode, width=128, height=128,
                                    samples_per_pixel=4))
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=1.0, device=dev)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg, 4)
    launches = mk.render_tiles.launches
    got = mk.render_tiles(kscene, cam, cfg, 7, sl=sl, slmeta=slmeta)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7, sl=sl, slmeta=slmeta)
    assert mk.render_tiles.launches == launches + 1
    assert mk.kernel_mode(kscene, cfg, sl) == mode
    diff = torch.stack([(g - w).abs() for g, w in zip(got[:3], want[:3])])
    assert float((diff.amax(0) <= 1e-3).float().mean()) >= 0.999
    assert float(diff.mean()) < 5e-5
    depth = (got[3] - want[3]).abs()
    assert float((depth <= 1e-3).float().mean()) >= 0.999
    assert float(depth.mean() / want[3].abs().mean()) < 1e-4
    assert abs(int(got[4]) - int(want[4])) <= 1e-3 * int(want[4])
