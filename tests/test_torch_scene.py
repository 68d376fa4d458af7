"""The port's scene extraction and kernel-table preparation against the JAX
package's, on the CPU.

Bars: extracted tables, camera uniforms, sphere rows, group, supergroup and
candidate-group AABBs, orders and the packed camera row are equal element
for element. The port stores hit attributes in float32 where the JAX kernel
keeps bf16 hi+lo pairs (~16 mantissa bits), so attributes agree to rtol
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.kernels.pallas import grouping as jgrouping
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu.scene import components as jcomp
from bevyray_tpu.scene.world import World as JWorld
from bevyray_tpu_torch.core.types import (SceneBuffers, make_sphere_walk,
                                         scene_from_numpy)
from bevyray_tpu_torch.kernels.camera import camera_rows
from bevyray_tpu_torch.kernels.cuda import grouping
from bevyray_tpu_torch.kernels.cuda import megakernel as mk

torch.set_num_threads(2)

SCENES = ["final_scene", "simple_scene", "material_test_scene", "night_scene"]


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
    g_leaves, w_leaves = jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), got)), jax.tree.leaves(_np(want))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", SCENES)
def test_extract_and_camera_equal(name):
    pw, jw = getattr(bt.rtiow, name)(), getattr(jrtiow, name)()
    _assert_tree_equal(pw.extract(with_bvh=False, device="cpu"), jw.extract(with_bvh=False))
    for aspect in (None, 16 / 9):
        _assert_tree_equal(pw.camera_state(aspect=aspect, device="cpu"),
                           jw.camera_state(aspect=aspect))
    assert pw.n_spheres == jw.n_spheres and pw.n_raster == jw.n_raster


def test_extract_cache_and_bvh_guard():
    """The cache holds per revision, and ``with_bvh`` is part of its key (as
    in the JAX package): a scene extracted without a BVH is never handed
    out for one that asks for it, nor the other way round."""
    w = bt.rtiow.simple_scene()
    s1 = w.extract(with_bvh=False, device="cpu")
    assert w.extract(with_bvh=False, device="cpu") is s1
    w.set_translation(1, (0.0, 2.0, 0.0))
    s2 = w.extract(with_bvh=False, device="cpu")
    assert s2 is not s1 and float(s2.spheres.cy[1]) == 2.0
    assert s2.bvh is None and s2.tri_bvh is None
    s3 = w.extract(device="cpu")
    assert s3 is not s2 and s3.bvh is not None
    assert int(s3.bvh.n_nodes) == 2 * w.n_spheres - 1
    assert w.extract(device="cpu") is s3
    assert w.extract(with_bvh=False, device="cpu").bvh is None


def test_scene_from_numpy_round_trips():
    jw = jrtiow.final_scene(seed=3, grid=2)
    jw.spawn_mesh(jcomp.Transform.from_xyz(0.0, 1.0, 2.0), jcomp.cube_mesh(0.5),
                  jcomp.StandardMaterial(base_color=(0.3, 0.6, 0.9)))
    js, jc = jw.extract(with_bvh=False), jw.camera_state(aspect=1.5)
    ps, pc = scene_from_numpy(_np(js), _np(jc), device="cpu")
    _assert_tree_equal(ps, js)
    _assert_tree_equal(pc, jc)
    back, back_cam = scene_from_numpy(
        jax.tree.map(lambda t: t.numpy(), ps),
        jax.tree.map(lambda t: t.numpy(), pc), device="cpu")
    _assert_tree_equal(back, js)
    _assert_tree_equal(back_cam, jc)
    # A scene with its BVHs (spheres and mesh; multi-prim leaves carry
    # prim_ids) crosses over table for table.
    for leaf in (1, 4):
        jb = jw.extract(bvh_leaf_size=leaf)
        pb, _ = scene_from_numpy(_np(jb), _np(jc), device="cpu")
        assert pb.bvh is not None and pb.tri_bvh is not None
        assert (pb.bvh.prim_ids is None) == (leaf == 1)
        _assert_tree_equal(pb, jb)


def _random_world(seed, n):
    """A JAX-package world of ``n`` random spheres (overlaps, tiny radii)."""
    r = np.random.RandomState(seed)
    w = JWorld()
    for _ in range(n):
        w.spawn_sphere(jcomp.Transform.from_xyz(*(r.rand(3) * 20 - 10)),
                       jcomp.RaytracedSphere(radius=float(r.rand() * 0.8
                                                          + 1e-3)),
                       jcomp.StandardMaterial(base_color=tuple(r.rand(3)),
                                              metallic=float(r.rand() < 0.3)))
    return w


def _decoded_attr(attr):
    """The JAX kernel's bf16 attribute table as float32 rows: center hi+lo
    (rows 0-5) then materials hi+lo (rows 6-25)."""
    a = np.asarray(jnp.asarray(attr, jnp.float32))
    return np.concatenate([a[0:3] + a[3:6], a[6:16] + a[16:26]])


@pytest.mark.parametrize("case", ["final", "random1100", "mesh"])
def test_prepare_kernel_scene_matches(case):
    if case == "final":
        jw = jrtiow.final_scene(seed=42)
    elif case == "random1100":   # 1152 padded spheres: 36 groups, supergroups
        jw = _random_world(2, 1100)
    else:
        jw = jrtiow.material_test_scene()
        jw.spawn_mesh(jcomp.Transform.from_xyz(0.0, 0.3, 1.0),
                      jcomp.cube_mesh(0.4),
                      jcomp.StandardMaterial(base_color=(0.9, 0.1, 0.1)))
    js = jw.extract(with_bvh=False)
    want = jmk.jitted_prepare(0, "kd")(js)
    ps, _ = scene_from_numpy(_np(js), _np(jw.camera_state()),
                             device="cpu")
    got = mk.prepare_kernel_scene(ps)
    np.testing.assert_array_equal(got.sph.numpy(), np.asarray(want.sph))
    # [groups | supergroups | candidate groups]; the JAX kernel reads the
    # candidate geometry off its gather table (4 * gc rows).
    n_groups = got.sph.shape[1] // mk.GROUP
    n_super = -(-n_groups // mk.SUPER) if n_groups >= 4 * mk.SUPER else 0
    assert got.gc == want.grp.shape[0] // 4
    assert got.n_cand == -(-got.sph.shape[1] // got.gc)
    assert got.cand_off == (0 if got.gc == mk.GROUP else n_groups + n_super)
    np.testing.assert_array_equal(got.gaabb.numpy(), np.asarray(want.gaabb))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert got.attr.shape == (mk.N_ATTR, want.attr.shape[1])
    np.testing.assert_allclose(got.attr.numpy(), _decoded_attr(want.attr),
                               rtol=1e-4)


@pytest.mark.parametrize("case,gc", [
    ("final", 8), ("final", 16), ("final", 32), ("random1100", 8),
    ("random1100", 24)])
def test_candidate_tables_match(case, gc):
    """The candidate-group AABB columns (after [groups | supergroups], or the
    group columns themselves at gc == GROUP) and their geometry."""
    jw = (jrtiow.final_scene(seed=42) if case == "final"
          else _random_world(2, 1100))
    js = jw.extract(with_bvh=False)
    want = jmk.jitted_prepare(gc, "kd")(js)
    ps, _ = scene_from_numpy(_np(js), _np(jw.camera_state()), device="cpu")
    got = mk.prepare_kernel_scene(ps, gc)
    s = got.sph.shape[1]
    n_groups = s // mk.GROUP
    n_super = -(-n_groups // mk.SUPER) if n_groups >= 4 * mk.SUPER else 0
    assert (got.gc, got.n_cand) == (gc, -(-s // gc))
    assert got.cand_off == (0 if gc == mk.GROUP else n_groups + n_super)
    assert got.gaabb.shape[1] == (n_groups + n_super
                                  + (0 if gc == mk.GROUP else got.n_cand))
    np.testing.assert_array_equal(got.gaabb.numpy(), np.asarray(want.gaabb))
    np.testing.assert_array_equal(got.sph.numpy(), np.asarray(want.sph))


def test_candidate_size_errors():
    jw = _random_world(5, 1500)    # 1536 padded spheres
    ps, _ = scene_from_numpy(_np(jw.extract(with_bvh=False)),
                             _np(jw.camera_state()), device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        mk.prepare_kernel_scene(ps, 12)
    with pytest.raises(ValueError, match="at most 186"):
        mk.prepare_kernel_scene(ps, 8)      # 192 groups
    assert mk.prepare_kernel_scene(ps, 16).n_cand == 96


def test_entry_points_default_to_the_card():
    """With no device, World.extract, World.camera_state and
    scene_from_numpy take the CUDA card; without one they raise and tell the
    caller to ask for the CPU, never falling back to it."""
    w, jw = bt.rtiow.simple_scene(), jrtiow.simple_scene()
    calls = [lambda: w.extract(with_bvh=False), w.camera_state,
             lambda: scene_from_numpy(_np(jw.extract(with_bvh=False)),
                                      _np(jw.camera_state()))]
    for call in calls:
        if torch.cuda.is_available():
            leaves = jax.tree.leaves(call())
            assert leaves and all(t.device.type == "cuda" for t in leaves)
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()


def test_orders_match():
    jw = _random_world(4, 300)
    js = jw.extract(with_bvh=False)
    sp = _np(js.spheres)
    for gc in (16, 32):
        np.testing.assert_array_equal(
            grouping.kd_order(sp.cx, sp.cy, sp.cz, sp.radius, sp.valid, gc),
            jgrouping.kd_order(sp.cx, sp.cy, sp.cz, sp.radius, sp.valid, gc))
    ps, _ = scene_from_numpy(_np(js), _np(jw.camera_state()),
                             device="cpu")
    want = jnp.argsort(jmk._morton_key(*(js.spheres[i] for i in (0, 1, 2, 3, 5))))
    np.testing.assert_array_equal(mk.morton_order(ps.spheres).numpy(),
                                  np.asarray(want))
    assert grouping.cached_order(ps) is grouping.cached_order(ps)
    assert mk.auto_cand_size(512) == jmk._auto_cand_size(512)
    assert mk.auto_cand_size(5120) == jmk._auto_cand_size(5120)


@pytest.mark.parametrize("size", [(64, 64), (40, 24), (200, 130)])
def test_camera_row_and_block_shuffles_match(size):
    w, h = size
    jw = jrtiow.final_scene(seed=1, grid=1)
    jcam = jw.camera_state(aspect=w / h)
    jcfg = JRenderConfig(width=w, height=h)
    _, pcam = scene_from_numpy(_np(jw.extract(with_bvh=False)), _np(jcam),
                               device="cpu")
    cfg = bt.RenderConfig(width=w, height=h)
    want_cam = np.asarray(jax.jit(lambda c: jmk._pack_camera(c, jcfg))(jcam))
    np.testing.assert_array_equal(camera_rows(pcam, cfg).fused.numpy(),
                                  want_cam[0])
    assert mk.block_grid(cfg) == jmk.block_grid(jcfg)
    img = np.random.RandomState(0).rand(h * w).astype(np.float32)
    blocks = mk.shuffle_blocks(torch.as_tensor(img), cfg, fill=-1.0)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(jmk.shuffle_blocks(img, jcfg, fill=-1.0)))
    np.testing.assert_array_equal(
        mk.unshuffle_blocks(blocks.reshape(-1), cfg).numpy(), img)
