"""The tables that the wavefront kernels K1 and K3 read, held to the plain
versions on the CPU (``kernels/cuda/csrc/wavefront.cu``).

K3 walks a paired-child record (``core/types.py`` ``SphereWalk``, built by
``make_sphere_walk`` with the scene): each node's children's boxes (or a
leaf's first sphere row) beside its count and index. Here the record
decodes to the
``BvhNodes`` columns with the walk's clamps, and a walk over the record in
plain torch, step for step the kernel's, gives ``intersect_bvh_reference``'s
``(t, index)`` to the bit: at leaf 1 and 4, with a 4-entry stack, and on
axis-aligned rays on box planes. K1 stages an invalid sphere row with ``r *
r = NaN`` in place of a valid flag; a dense test over rows coded so gives
``intersect_spheres_reference``'s values around an invalid row, on exact
ties and on a grazing ray (``disc == 0``). The kernels themselves run on
the card (``chip_smoke.py`` phase 13(b); ``tests/test_torch_wavefront.py
-m cuda``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bevyray_tpu_torch import rtiow
from bevyray_tpu_torch.core.constants import INF, T_MIN
from bevyray_tpu_torch.core.types import (BvhNodes, make_sphere_walk,
                                         make_spheres_np, scene_from_numpy)
from bevyray_tpu_torch.core.vec import Vec3, sqrt
from bevyray_tpu_torch.kernels import intersect, traverse

torch.set_num_threads(2)

N_RAYS = 2048


@pytest.fixture(scope="module")
def big():
    """The 4,971-sphere final scene (``chip_smoke.py`` phase 10(f)) at
    leaf 1 and leaf 4, with host centers and radii."""
    world = rtiow.final_scene(seed=42, grid=35)
    centers, radii = world.extract_host()[:2]
    return {leaf: world.extract(bvh_leaf_size=leaf, device="cpu")
            for leaf in (1, 4)}, centers, radii


def _box(centers, radii):
    """The box of the small spheres, with room for their radii (the
    ground sphere left out)."""
    small = radii < 100.0
    pad = radii[small].max()
    return centers[small].min(0) - pad, centers[small].max(0) + pad


def _rays(centers, radii, n, seed):
    """Rays from the small spheres' box in random (not unit) directions,
    most of them near the horizontal, so that they pass many boxes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(*_box(centers, radii), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 1] *= np.float32(0.1)
    d *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    return _vec(o), _vec(d)


def _axis_rays(centers, radii, bvh, n, seed):
    """Rays along +-x, +-y or +-z with one origin coordinate on a node's
    box face, so a slab meets 0 * inf (NaN) (``chip_smoke.axis_rays``)."""
    rng = np.random.default_rng(seed)
    lo, hi = _box(centers, radii)
    planes = np.stack([np.concatenate([c0.numpy(), c1.numpy()]) for c0, c1 in (
        (bvh.min_x, bvh.max_x), (bvh.min_y, bvh.max_y),
        (bvh.min_z, bvh.max_z))])
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    flat = (axis + rng.integers(1, 3, n)) % 3
    o[np.arange(n), flat] = planes[flat, rng.integers(0, planes.shape[1], n)]
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = rng.choice(np.float32([-1.0, 1.0]), n)
    return _vec(o), _vec(d)


def _vec(a):
    return Vec3(*(torch.as_tensor(a[:, k].copy()) for k in range(3)))


def record_walk(o: Vec3, d: Vec3, record, stack_size: int,
                max_leaf_size: int):
    """The K3 kernel's walk over the record, in lock-step over the lanes:
    pop a node, read its record row, test a leaf's first prim from the
    record and the others from the slot table, or push the children whose
    boxes the record holds."""
    nodes, rows, prims = record
    n_nodes, n_slots = nodes.shape[0], rows.shape[0]
    geo = nodes[:, :12].contiguous().view(torch.float32)
    count, first, first_prim = (nodes[:, 12], nodes[:, 13].long(),
                                nodes[:, 14].long())
    n = o.x.shape[0]
    a = d.dot(d)
    inv_a = 1.0 / a
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    stack = torch.zeros((n, stack_size + 1), dtype=torch.int64)
    sp = torch.ones(n, dtype=torch.int64)
    best_t = torch.full((n,), INF, dtype=torch.float32)
    best_i = torch.full((n,), -1, dtype=torch.int64)
    while True:
        walking = (sp > 0) & (sp < stack_size)
        if not bool(walking.any()):
            return best_t, best_i
        spm1 = torch.clamp(sp - 1, min=0)
        node = torch.where(walking, stack.gather(1, spm1[:, None])[:, 0], 0)
        sp = torch.where(walking, spm1, sp)
        g, cnt, f = geo[node], count[node], first[node]
        leaf = walking & (cnt > 0)
        t = traverse._sphere_t(o, d, a, inv_a, g[:, 0], g[:, 1], g[:, 2],
                               g[:, 3])
        take = leaf & (t < best_t)
        best_i = torch.where(take, first_prim[node], best_i)
        best_t = torch.where(take, t, best_t)
        for k in range(1, max_leaf_size):
            s = torch.clamp(f + k, 0, n_slots - 1)
            row = rows[s]
            t = traverse._sphere_t(o, d, a, inv_a, row[:, 0], row[:, 1],
                                   row[:, 2], row[:, 3])
            take = leaf & (k < cnt) & (t < best_t)
            best_i = torch.where(take, prims[s].long(), best_i)
            best_t = torch.where(take, t, best_t)
        inner = walking & (cnt == 0)
        for lo, child in ((0, torch.clamp(f, 0, n_nodes - 1)),
                          (6, torch.clamp(f + 1, 0, n_nodes - 1))):
            dist = traverse._slab_entry_distance(
                o, inv, Vec3(g[:, lo], g[:, lo + 1], g[:, lo + 2]),
                Vec3(g[:, lo + 3], g[:, lo + 4], g[:, lo + 5]))
            push = inner & (dist < INF) & (dist < best_t)
            pos = torch.where(push & (sp < stack_size), sp, stack_size)
            stack.scatter_(1, pos[:, None], child[:, None])
            sp = sp + push.long()


def _odd_tree() -> BvhNodes:
    """A hand-made 8-node tree whose indices leave the table: leaves past
    the last slot and before the first, a node of negative count, an inner
    node at the last node (both children clamp to it) and one at -3 (both
    children clamp to the root: the walk runs until its stack is full),
    and a NaN box coordinate."""
    box = np.float32([[-9, -9, -9, 9, 9, 9], [-6, -6, -6, 2, 2, 2],
                      [-2, -3, -1, 6, 6, 6], [np.nan, -4, -4, 1, 1, 1],
                      [-5, -5, -5, 5, 5, 5], [1, 1, 1, 4, 4, 4],
                      [0, -2, 0, 3, 3, 3], [-1, -1, -1, 7, 7, 7]])
    col = [torch.as_tensor(box[:, k].copy()) for k in range(6)]
    return BvhNodes(*col,
                    index=torch.tensor([1, 3, 5, 9, -2, 4, 7, -3],
                                       dtype=torch.int32),
                    count=torch.tensor([0, 0, 0, 2, 3, -1, 0, 0],
                                       dtype=torch.int32),
                    n_nodes=torch.tensor(8, dtype=torch.int32),
                    prim_ids=torch.tensor([3, 1, 7, 0, 2, 1, 6, 5],
                                          dtype=torch.int32))


@pytest.mark.parametrize("case", ["leaf 1", "leaf 4", "odd tree",
                                  "odd tree, no prim_ids"])
def test_walk_record_decodes_to_the_bvh_columns(big, case):
    """Every node's record row holds its count and index, an inner node's
    children's boxes at the walk's clamps, a leaf's first slot's sphere
    row and prim id; each slot holds its prim's row and id."""
    scenes = big[0]
    if case.startswith("leaf"):
        scene = scenes[int(case[-1])]
        spheres, bvh = scene.spheres, scene.bvh
    else:
        spheres = scenes[1].spheres
        bvh = _odd_tree()
        if case.endswith("no prim_ids"):
            bvh = bvh._replace(prim_ids=None)
    nodes, rows, prims = make_sphere_walk(spheres, bvh)
    n = bvh.min_x.shape[0]
    cap = spheres.cx.shape[0]
    assert nodes.dtype == torch.int32 and nodes.shape == (n, 16)
    ids = bvh.prim_ids
    want_prims = (torch.arange(cap) if ids is None
                  else torch.clamp(ids.long(), 0, cap - 1))
    assert torch.equal(prims.long(), want_prims)
    sph = torch.stack([spheres.cx, spheres.cy, spheres.cz, spheres.radius], 1)
    assert torch.equal(rows.view(torch.int32), sph[want_prims].view(torch.int32))
    box = torch.stack([bvh.min_x, bvh.min_y, bvh.min_z, bvh.max_x,
                       bvh.max_y, bvh.max_z], 1).view(torch.int32)
    index, count = bvh.index.long(), bvh.count
    assert torch.equal(nodes[:, 12], count) and torch.equal(nodes[:, 13],
                                                            bvh.index)
    inner = count <= 0
    c1, c2 = index.clamp(0, n - 1), (index + 1).clamp(0, n - 1)
    assert torch.equal(nodes[inner, :6], box[c1][inner])
    assert torch.equal(nodes[inner, 6:12], box[c2][inner])
    leaf = count > 0
    slot = index.clamp(0, rows.shape[0] - 1)
    assert torch.equal(nodes[leaf, :4], sph[want_prims][slot][leaf].view(torch.int32))
    assert not bool(nodes[leaf, 4:12].any())
    assert torch.equal(nodes[leaf, 14].long(), want_prims[slot][leaf])
    assert not bool(nodes[:, 15].any())
    if case == "leaf 1":
        assert int(leaf.sum()) == int((spheres.valid).sum())


@pytest.mark.parametrize("case", ["leaf 1", "leaf 4", "4-entry stack",
                                  "axis-aligned leaf 1",
                                  "axis-aligned leaf 4"])
def test_record_walk_equals_the_plain_walk(big, case):
    """The kernel's walk over the record against the plain walk over the
    columns: t to the bit, the same index, on the 4,971-sphere scene."""
    scenes, centers, radii = big
    leaf = 4 if case.endswith("4") and "stack" not in case else 1
    scene = scenes[leaf]
    stack = 4 if "stack" in case else traverse.STACK_SIZE
    if case.startswith("axis"):
        o, d = _axis_rays(centers, radii, scene.bvh, N_RAYS, seed=5)
    else:
        o, d = _rays(centers, radii, N_RAYS, seed=3)
    record = make_sphere_walk(scene.spheres, scene.bvh)
    got = record_walk(o, d, record, stack, leaf)
    want = traverse.intersect_bvh_reference(o, d, scene.spheres, scene.bvh,
                                            stack_size=stack,
                                            max_leaf_size=leaf)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] >= 0).sum()) > N_RAYS // 20   # the rays hit
    if case == "4-entry stack":   # truncation changes some lanes' answer
        full = traverse.intersect_bvh_reference(o, d, scene.spheres,
                                                scene.bvh, max_leaf_size=1)
        assert not torch.equal(full[1], want[1])


def test_odd_tree_walk_equals_the_plain_walk(big):
    """The hand-made tree (indices past both ends, a negative count, a NaN
    box) walked over its record and by the plain walk."""
    _, centers, radii = big
    spheres = make_spheres_np(centers[:8], radii[:8], np.arange(8),
                              device="cpu")
    for tree in (_odd_tree(), _odd_tree()._replace(prim_ids=None)):
        o, d = _rays(centers[:8], radii[:8], 512, seed=9)
        record = make_sphere_walk(spheres, tree)
        for leaf in (1, 4):
            got = record_walk(o, d, record, 32, leaf)
            want = traverse.intersect_bvh_reference(o, d, spheres, tree,
                                                    max_leaf_size=leaf)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_walk_record_is_rebuilt_for_a_new_table():
    """Each extract with a BVH carries the record of its own tables
    (``sphere_walk``): the cached extract keeps it, an edit and a new
    extract build a new one, and ``scene_from_numpy`` builds one too."""
    world = rtiow.final_scene(seed=42, grid=4)
    scene = world.extract(device="cpu")
    first = scene.sphere_walk
    assert all(torch.equal(x, y) for x, y in
               zip(first, make_sphere_walk(scene.spheres, scene.bvh)))
    assert world.extract(device="cpu").sphere_walk is first
    assert world.extract(with_bvh=False, device="cpu").sphere_walk is None
    world.set_translation(1, (0.5, 3.0, -0.5))
    edited = world.extract(device="cpu")
    second = edited.sphere_walk
    assert second is not first
    fresh = make_sphere_walk(edited.spheres, edited.bvh)
    assert all(torch.equal(x, y) for x, y in zip(second, fresh))
    assert not all(torch.equal(x, y) for x, y in zip(first, fresh))
    leaves = edited._replace(sphere_walk=None)
    carried, _ = scene_from_numpy(
        type(leaves)(*(None if t is None else type(t)(
            *(None if c is None else c.numpy() for c in t)) for t in leaves)),
        world.camera_state(aspect=1.0, device="cpu"), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(carried.sphere_walk, fresh))


def coded_dense(o: Vec3, d: Vec3, spheres):
    """K1's scan over rows staged as ``(cx, cy, cz, r * r)`` with ``r * r
    = NaN`` on an invalid row: in ascending row order, a strict ``t <
    best``, the root only where ``disc >= 0``."""
    r2 = torch.where(spheres.valid, spheres.radius * spheres.radius,
                     float("nan"))
    a = d.dot(d)
    inv_a = 1.0 / a
    n = o.x.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32)
    best_i = torch.full((n,), -1, dtype=torch.int64)
    for k in range(spheres.cx.shape[0]):
        ocx = spheres.cx[k] - o.x
        ocy = spheres.cy[k] - o.y
        ocz = spheres.cz[k] - o.z
        h = d.x * ocx + d.y * ocy + d.z * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2[k]
        disc = h * h - a * c
        t = (h - sqrt(torch.where(disc >= 0.0, disc, 0.0))) * inv_a
        take = (disc >= 0.0) & (t > T_MIN) & (t < best_t)
        best_i = torch.where(take, k, best_i)
        best_t = torch.where(take, t, best_t)
    return best_t, best_i


def test_nan_row_coding_equals_the_valid_mask():
    """Rows: an invalid sphere nearest to the rays between two valid ones,
    exact duplicates (the lower index wins), a sphere that the axis ray
    grazes (disc == 0, t = 5) and random spheres, some invalid."""
    rng = np.random.default_rng(4)
    centers = [[0.0, 0.0, 3.0], [0.0, 0.0, 2.0], [0.0, 0.0, 4.0],
               [2.0, 0.0, 8.0], [2.0, 0.0, 8.0], [5.0, 1.0, 0.0]]
    radii = [0.5, 1.0, 0.5, 1.0, 1.0, 1.0]
    far = rng.uniform((-6, -6, 10), (6, 6, 20), (26, 3))   # past the others
    centers = np.concatenate([np.float32(centers), far]).astype(np.float32)
    radii = np.concatenate([np.float32(radii),
                            rng.uniform(0.2, 1.2, 26)]).astype(np.float32)
    spheres = make_spheres_np(centers, radii, np.arange(32), capacity=32,
                              device="cpu")
    valid = spheres.valid.clone()
    valid[1] = False                     # between rows 0 and 2
    valid[rng.choice(np.arange(6, 32), 6, replace=False)] = False
    spheres = spheres._replace(valid=valid)
    o = np.zeros((N_RAYS, 3), np.float32)
    o[:, :2] = rng.uniform(-0.3, 0.3, (N_RAYS, 2))
    o[:, 2] = -5.0
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (N_RAYS, 1))
    d[N_RAYS // 2:] = rng.normal(size=(N_RAYS // 2, 3))
    o[1::7, :] = (0.0, 0.0, 0.0)          # the graze: x axis past row 5
    d[1::7, :] = (1.0, 0.0, 0.0)
    o[2::7, :] = (2.0, 0.0, 0.0)          # the duplicates, rows 3 and 4
    d[2::7, :] = (0.0, 0.0, 1.0)
    po, pd = _vec(o), _vec(d)
    got = coded_dense(po, pd, spheres)
    want = intersect.intersect_spheres_reference(po, pd, spheres)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1][:N_RAYS // 2] == 0).any())   # past row 1
    assert not bool((want[1] == 1).any())
    assert bool((want[1][1::7] == 5).all())
    assert bool((want[0][1::7] == 5.0).all())
    assert bool((want[1][2::7] == 3).all())
    assert not bool((want[1] == 4).any())


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lanes off the block", "sparse mask",
                                  "every sphere twice", "past one tile"])
def test_cuda_dense_spheres_equal_plain(case):
    """K1 against its plain version where its compaction, tiles and ties
    matter: 5,003 lanes, 1 active lane in 97, duplicated rows (the lower
    index wins), and 4,971 spheres (three staged tiles)."""
    dev = _card()
    world = rtiow.final_scene(seed=42, grid=35 if case == "past one tile"
                              else 11)
    centers, radii = world.extract_host()[:2]
    spheres = world.extract(with_bvh=False, device=dev).spheres
    n = 5003 if case == "lanes off the block" else 8192
    o, d = (Vec3(*(c.to(dev) for c in v))
            for v in _rays(centers, radii, n, seed=8))
    active = None
    if case == "sparse mask":
        active = torch.zeros(n, dtype=torch.bool, device=dev)
        active[5::97] = True
    if case == "every sphere twice":
        spheres = type(spheres)(*(torch.repeat_interleave(c, 2)
                                  for c in spheres))
    got = intersect.intersect_spheres(o, d, spheres, active=active)
    want = intersect.on_active(intersect.intersect_spheres_reference, active,
                               o, d, spheres)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "every sphere twice":
        assert bool((got[1][got[1] >= 0] % 2 == 0).all())


@pytest.mark.cuda
def test_cuda_walk_follows_an_edit():
    """K3 walks the record of the tables it is given: after an edit and a
    new extract, its hits are the plain walk's over the new tables."""
    dev = _card()
    world = rtiow.final_scene(seed=42, grid=11)
    centers, radii = world.extract_host()[:2]
    o, d = (Vec3(*(c.to(dev) for c in v))
            for v in _rays(centers, radii, 8192, seed=2))
    for step in range(2):
        scene = world.extract(device=dev)
        got = traverse.intersect_bvh(o, d, scene.spheres, scene.bvh)
        want = traverse.intersect_bvh_reference(o, d, scene.spheres,
                                                scene.bvh)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        world.set_translation(1, (0.5, 3.0 + step, -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("prim_ids", [True, False])
def test_cuda_walk_of_the_odd_tree_equals_plain(prim_ids):
    """K3 on the hand-made tree (indices past both ends, a negative count,
    a NaN box), with and without ``prim_ids``, at leaf 1 and 4, given its
    record and building it itself: the plain walk's values to the bit."""
    dev = _card()
    world = rtiow.final_scene(seed=42, grid=4)
    centers, radii = world.extract_host()[:2]
    spheres = make_spheres_np(centers[:8], radii[:8], np.arange(8),
                              device=dev)
    tree = _odd_tree()
    if not prim_ids:
        tree = tree._replace(prim_ids=None)
    tree = type(tree)(*(None if c is None else c.to(dev) for c in tree))
    o, d = (Vec3(*(c.to(dev) for c in v))
            for v in _rays(centers[:8], radii[:8], 4096, seed=9))
    walk = make_sphere_walk(spheres, tree)
    for leaf in (1, 4):
        want = traverse.intersect_bvh_reference(o, d, spheres, tree,
                                                max_leaf_size=leaf)
        for given in (walk, None):
            got = traverse.intersect_bvh(o, d, spheres, tree,
                                         max_leaf_size=leaf, walk=given)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
