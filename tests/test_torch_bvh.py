"""The port's BVH (``bvh/``) and BVH walk (``kernels/traverse.py``) against
the JAX package's, on the CPU.

Bars:
- builder tables are bit-equal per builder: the port's native (C++) build
  against JAX's native build, the NumPy build against JAX's NumPy build (the
  two builders give different trees, so they are never mixed);
- traversal against JAX's walk run op by op (``jax.disable_jit``): t to
  rtol 1e-6 and the index equal on every lane. They are not bit-equal only
  because torch's CPU float32 sqrt is now and then 1 ulp off (ROADMAP §C),
  which ``h - sqrt(disc)`` magnifies (4.2e-7 relative at most here); the
  port's walk is bit-equal to the port's dense test. Under ``jit`` XLA-CPU
  also contracts multiply-adds inside the loop body (JAX's jitted walk then
  differs from JAX's own dense test by up to 3.5e-6 relative), so against
  the jitted walk t is held to rtol 1e-5, the bar of tests/test_bvh.py, and
  the index equal on every lane;
- truncation: a small stack drops the same pushes in both packages;
- twins of tests/test_bvh.py's invariants.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevyray_tpu.bvh import build as jbuild
from bevyray_tpu.bvh import native as jnative
from bevyray_tpu.core.types import make_spheres_np as jmake_spheres
from bevyray_tpu.core.types import make_triangles_np as jmake_triangles
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.kernels import traverse as jtraverse
from bevyray_tpu_torch.bvh import build as pbuild
from bevyray_tpu_torch.bvh import native as pnative
from bevyray_tpu_torch.core.types import make_spheres_np, make_triangles_np
from bevyray_tpu_torch.core.vec import Vec3
from bevyray_tpu_torch.kernels import traverse
from bevyray_tpu_torch.kernels.intersect import (intersect_spheres,
                                                 intersect_triangles)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


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


def _random_scene(n, seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.5, n).astype(np.float32)
    return centers, radii


def _random_tris(n, seed):
    rng = np.random.RandomState(seed)
    va = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    vb = va + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vc = va + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return va, vb, vc


def _rays(n, seed, span=12.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _pvec(a):
    return Vec3(*(torch.as_tensor(a[:, i]) for i in range(3)))


def _assert_nodes_equal(got, want):
    """The port's BvhNodes (tensors) against JAX's (arrays), field by field."""
    assert got._fields == want._fields
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert (g is None) == (w is None), f
        if w is not None:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def _no_native(monkeypatch):
    """Both packages on their NumPy builders."""
    monkeypatch.setattr(pnative, "build_ploc_native", lambda *a: None)
    monkeypatch.setattr(jnative, "build_ploc_native", lambda *a: None)


# -- builders -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 60, 300])
@pytest.mark.parametrize("leaf", [1, 4])
def test_numpy_builder_bit_equal(n, leaf):
    centers, radii = _random_scene(n, seed=n)
    bmin, bmax = pbuild.sphere_aabbs(centers, radii)
    jmin, jmax = jbuild.sphere_aabbs(centers, radii)
    np.testing.assert_array_equal(bmin, jmin)
    np.testing.assert_array_equal(bmax, jmax)
    tree, jtree = pbuild.build_ploc_np(bmin, bmax), jbuild.build_ploc_np(
        bmin, bmax)
    for g, w in zip(tree, jtree):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(pbuild.flatten_tree(*tree, max_leaf_size=leaf),
                    jbuild.flatten_tree(*jtree, max_leaf_size=leaf)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 5, 60, 300])
@pytest.mark.parametrize("leaf", [1, 4])
def test_scene_bvh_bit_equal_per_builder(n, leaf, monkeypatch):
    centers, radii = _random_scene(n, seed=n)
    assert jnative.ensure_built() is not None
    got = pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf)
    assert pbuild.last_builder == "native"
    _assert_nodes_equal(got, jbuild.build_scene_bvh(centers, radii,
                                                    max_leaf_size=leaf))
    _no_native(monkeypatch)
    got = pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf)
    assert pbuild.last_builder == "numpy"
    _assert_nodes_equal(got, jbuild.build_scene_bvh(centers, radii,
                                                    max_leaf_size=leaf))


def test_native_tree_bit_equal():
    centers, radii = _random_scene(300, seed=1)
    bmin, bmax = pbuild.sphere_aabbs(centers, radii)
    got = pnative.build_ploc_native(bmin, bmax, pbuild.SEARCH_RADIUS)
    want = jnative.build_ploc_native(bmin, bmax, jbuild.SEARCH_RADIUS)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("leaf", [1, 4])
def test_triangle_bvh_bit_equal_per_builder(leaf, monkeypatch):
    va, vb, vc = _random_tris(200, seed=11)
    for g, w in zip(pbuild.triangle_aabbs(va, vb, vc),
                    jbuild.triangle_aabbs(va, vb, vc)):
        np.testing.assert_array_equal(g, w)
    _assert_nodes_equal(pbuild.build_triangle_bvh(va, vb, vc,
                                                  max_leaf_size=leaf),
                        jbuild.build_triangle_bvh(va, vb, vc,
                                                  max_leaf_size=leaf))
    assert pbuild.last_builder == "native"
    _no_native(monkeypatch)
    _assert_nodes_equal(pbuild.build_triangle_bvh(va, vb, vc,
                                                  max_leaf_size=leaf),
                        jbuild.build_triangle_bvh(va, vb, vc,
                                                  max_leaf_size=leaf))
    assert pbuild.last_builder == "numpy"


def test_negative_radius_bounds_match():
    centers = np.array([[0.0, 0.5, 0.0], [1.0, 2.0, 3.0]], np.float32)
    radii = np.array([-0.4, 0.7], np.float32)
    bmin, bmax = pbuild.sphere_aabbs(centers, radii)
    assert (bmax[0] - bmin[0] > 0.9).all()   # 2*(0.4+0.1) per axis
    for g, w in zip((bmin, bmax), jbuild.sphere_aabbs(centers, radii)):
        np.testing.assert_array_equal(g, w)
    _assert_nodes_equal(pbuild.build_scene_bvh(centers, radii),
                        jbuild.build_scene_bvh(centers, radii))


def test_native_library_is_the_ports_own():
    """The port builds its own copy of the source into build/ploc/ (under
    the repository root) and never loads the JAX package's library."""
    lib = pnative.ensure_built()
    assert lib is not None, "native PLOC builder failed to build"
    path = Path(lib._name).resolve()
    assert path == pnative.library_path().resolve()
    assert path.parent == ROOT / "build" / "ploc"
    assert pnative._SRC.read_bytes() == (
        ROOT / "bevyray_tpu/bvh/csrc/ploc.cpp").read_bytes()


# -- traversal ----------------------------------------------------------------

def _sphere_walks(n, leaf, n_rays, seed, stack_size=traverse.STACK_SIZE,
                  rays=None):
    centers, radii = _random_scene(n, seed=n + 7)
    o, d = rays if rays is not None else _rays(n_rays, seed)
    pbvh = pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf)
    jbvh = jbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf)
    ps = make_spheres_np(centers, radii, np.arange(n))
    js = jmake_spheres(centers, radii, np.arange(n))
    got = traverse.intersect_bvh(_pvec(o), _pvec(d), ps, pbvh,
                                 stack_size=stack_size, max_leaf_size=leaf)
    return (got, lambda: jtraverse.intersect_bvh(
        _jvec(o), _jvec(d), js, jbvh, stack_size=stack_size,
        max_leaf_size=leaf), (o, d, ps))


def _assert_walks_match(got, want, rtol=1e-6):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=rtol)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,leaf", [(1, 1), (5, 4), (60, 1), (60, 4),
                                    (300, 1), (300, 4)])
def test_traversal_matches_jax_op_by_op(n, leaf):
    got, jax_walk, _ = _sphere_walks(n, leaf, 128, seed=n)
    with jax.disable_jit():
        want = jax_walk()
    _assert_walks_match(got, want)


@pytest.mark.parametrize("leaf", [1, 4])
def test_traversal_matches_jitted_jax(leaf):
    got, jax_walk, (o, d, ps) = _sphere_walks(300, leaf, 512, seed=3)
    _assert_walks_match(got, jax_walk(), rtol=1e-5)
    t = got[0].numpy()
    assert (t < 1e30).sum() > 100
    # The port's walk computes the dense test's t exactly.
    dense_t, _ = intersect_spheres(_pvec(o), _pvec(d), ps)
    np.testing.assert_array_equal(t, dense_t.numpy())


def test_truncation_drops_the_same_pushes():
    """A 4-entry stack overflows on most rays: both packages stop those
    lanes and drop the same pushes (SURVEY.md quirk #9)."""
    got, jax_walk, (o, d, ps) = _sphere_walks(300, 1, 256, seed=5,
                                              stack_size=4)
    with jax.disable_jit():
        want = jax_walk()
    _assert_walks_match(got, want)
    full = traverse.intersect_bvh(_pvec(o), _pvec(d), ps,
                                  pbuild.build_scene_bvh(
                                      *_random_scene(300, seed=307)))
    lost = (got[0] > full[0]).sum()
    assert lost > 10, "the small stack truncated no walk"


def test_axis_aligned_rays_take_nan_slabs_like_jax():
    """Zero direction components make ``inv_dir`` inf; a box face through
    the ray origin then gives NaN in the slab test, which min/max carry."""
    centers = np.array([[0, 0, 5], [0, 2, 0], [3, 0, 0], [0, 0, -4],
                        [1, 1, 1]], np.float32)
    radii = np.full(5, 0.9, np.float32)
    bmin, _ = pbuild.sphere_aabbs(centers, radii)
    o = np.zeros((12, 3), np.float32)
    o[6:, 0] = bmin[2, 0]          # on a face of sphere 2's box
    d = np.tile(np.eye(3, dtype=np.float32), (4, 1))
    d[3:6] *= -1
    d[9:] *= -1
    ps = make_spheres_np(centers, radii, np.arange(5))
    js = jmake_spheres(centers, radii, np.arange(5))
    got = traverse.intersect_bvh(_pvec(o), _pvec(d), ps,
                                 pbuild.build_scene_bvh(centers, radii))
    with jax.disable_jit():
        want = jtraverse.intersect_bvh(_jvec(o), _jvec(d), js,
                                       jbuild.build_scene_bvh(centers, radii))
    _assert_walks_match(got, want)
    assert (got[0] < 1e30).sum() >= 4


@pytest.mark.parametrize("leaf", [1, 4])
def test_triangle_traversal_matches_jax(leaf):
    va, vb, vc = _random_tris(200, seed=11)
    o, d = _rays(256, seed=12, span=10.0)
    tris = make_triangles_np(va, vb, vc, np.zeros(200, np.int32))
    jtris = jmake_triangles(va, vb, vc, np.zeros(200, np.int32))
    got = traverse.intersect_bvh_triangles(
        _pvec(o), _pvec(d), tris,
        pbuild.build_triangle_bvh(va, vb, vc, max_leaf_size=leaf),
        max_leaf_size=leaf)
    jbvh = jbuild.build_triangle_bvh(va, vb, vc, max_leaf_size=leaf)
    with jax.disable_jit():
        want = jtraverse.intersect_bvh_triangles(_jvec(o), _jvec(d), jtris,
                                                 jbvh, max_leaf_size=leaf)
    _assert_walks_match(got, want)
    _assert_walks_match(got, jtraverse.intersect_bvh_triangles(
        _jvec(o), _jvec(d), jtris, jbvh, max_leaf_size=leaf), rtol=1e-5)
    assert (got[0] < 1e30).sum() >= 5


def test_loop_test_interval_changes_no_value(monkeypatch):
    """Testing for walking lanes every CHECK_EVERY iterations (and dropping
    the lanes that stopped) gives the (t, index) of a test every iteration."""
    got = _sphere_walks(300, 4, 256, seed=9)[0]
    monkeypatch.setattr(traverse, "CHECK_EVERY", 1)
    every = _sphere_walks(300, 4, 256, seed=9)[0]
    assert traverse.CHECK_EVERY == 1
    for g, e in zip(got, every):
        assert torch.equal(g, e)


# -- twins of tests/test_bvh.py -----------------------------------------------

def _check_flat_bvh(fmin, fmax, index, count, prim_ids, n_prims,
                    max_leaf_size=1):
    n_nodes = fmin.shape[0]
    leaves = count > 0
    assert count.max() <= max_leaf_size
    if max_leaf_size == 1:
        prims = index[leaves]
    else:
        prims = np.concatenate([prim_ids[index[i]:index[i] + count[i]]
                                for i in np.nonzero(leaves)[0]])
    assert sorted(prims.tolist()) == list(range(n_prims))
    for i in np.nonzero(~leaves)[0]:
        c = index[i]
        assert 0 < c and c + 1 < n_nodes
        for ch in (c, c + 1):
            assert (fmin[i] <= fmin[ch] + 1e-5).all()
            assert (fmax[i] >= fmax[ch] - 1e-5).all()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 485])
@pytest.mark.parametrize("k", [1, 4])
def test_flat_tree_invariants(n, k):
    centers, radii = _random_scene(n, seed=n)
    bmin, bmax = pbuild.sphere_aabbs(centers, radii)
    for tree in (pbuild.build_ploc_np(bmin, bmax),
                 pnative.build_ploc_native(bmin, bmax, pbuild.SEARCH_RADIUS)):
        flat = pbuild.flatten_tree(*tree, max_leaf_size=k)
        _check_flat_bvh(*flat, n_prims=n, max_leaf_size=k)


def test_native_and_numpy_same_sah_quality():
    centers, radii = _random_scene(200, seed=3)
    bmin, bmax = pbuild.sphere_aabbs(centers, radii)

    def total_sa(node_min, node_max):
        d = np.maximum(node_max - node_min, 0)
        return (2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                     + d[:, 2] * d[:, 0])).sum()

    nm, nx, *_ = pnative.build_ploc_native(bmin, bmax, pbuild.SEARCH_RADIUS)
    pm, px, *_ = pbuild.build_ploc_np(bmin, bmax)
    assert 0.8 < total_sa(nm, nx) / total_sa(pm, px) < 1.25


@pytest.mark.parametrize("n_spheres", [1, 5, 60, 300])
@pytest.mark.parametrize("leaf_size", [1, 4])
def test_traversal_matches_brute_force(n_spheres, leaf_size):
    got, _, (o, d, ps) = _sphere_walks(n_spheres, leaf_size, 256, seed=0)
    t_brute, i_brute = intersect_spheres(_pvec(o), _pvec(d), ps)
    np.testing.assert_array_equal(got[0].numpy(), t_brute.numpy())
    hit = t_brute.numpy() < 1e30
    if hit.any():
        same = got[1].numpy()[hit] == i_brute.numpy()[hit]
        assert same.mean() > 0.99


def test_rays_from_inside_scene():
    """Slab test must return 0 for boxes containing the origin (wgsl:396)."""
    centers, radii = _random_scene(50, seed=2)
    ps = make_spheres_np(centers, radii, np.arange(50))
    o = centers[:32]
    d = np.tile(np.array([[0.3, 0.5, -0.8]], np.float32), (32, 1))
    t_brute, _ = intersect_spheres(_pvec(o), _pvec(d), ps)
    t_bvh, _ = traverse.intersect_bvh(_pvec(o), _pvec(d), ps,
                                      pbuild.build_scene_bvh(centers, radii))
    np.testing.assert_array_equal(t_bvh.numpy(), t_brute.numpy())


def test_triangle_bvh_traversal_matches_brute_force():
    va, vb, vc = _random_tris(200, seed=11)
    o, d = _rays(256, seed=13, span=10.0)
    tris = make_triangles_np(va, vb, vc, np.zeros(200, np.int32))
    t_brute, i_brute = intersect_triangles(_pvec(o), _pvec(d), tris)
    t_bvh, i_bvh = traverse.intersect_bvh_triangles(
        _pvec(o), _pvec(d), tris, pbuild.build_triangle_bvh(va, vb, vc))
    np.testing.assert_array_equal(t_bvh.numpy(), t_brute.numpy())
    hit = t_brute.numpy() < 1e30
    assert hit.sum() >= 5
    assert (i_bvh.numpy()[hit] == i_brute.numpy()[hit]).mean() > 0.99


@pytest.mark.cuda
def test_cuda_walk_matches_the_cpu_walk_and_the_dense_test():
    """On the card: the walk against the CPU walk on the same inputs (t to
    rtol 1e-6: the CPU's float32 sqrt may be 1 ulp off, the card's is
    IEEE; the same index) at leaf 1 and 4 and with a truncating 4-entry
    stack, and bit-equal to the dense test on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    dev = torch.device("cuda", 0)
    centers, radii = _random_scene(300, seed=307)
    o, d = _rays(4096, seed=5)

    def on(a):
        return Vec3(*(torch.as_tensor(a[:, i], device=dev) for i in range(3)))

    ps = make_spheres_np(centers, radii, np.arange(300), device=dev)
    for leaf, stack in ((1, 32), (4, 32), (1, 4)):
        got = traverse.intersect_bvh(
            on(o), on(d), ps,
            pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf,
                                   device=dev),
            stack_size=stack, max_leaf_size=leaf)
        want = traverse.intersect_bvh(
            _pvec(o), _pvec(d), make_spheres_np(centers, radii,
                                                np.arange(300)),
            pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf),
            stack_size=stack, max_leaf_size=leaf)
        assert got[0].is_cuda
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   rtol=1e-6)
        assert torch.equal(got[1].cpu(), want[1])
        if stack == traverse.STACK_SIZE:
            assert torch.equal(got[0], intersect_spheres(on(o), on(d), ps)[0])
