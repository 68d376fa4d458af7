"""The staged rows of the dense triangle test K2
(``kernels/cuda/csrc/wavefront.cu``), held to the plain version on the CPU.

K2 stages each tile of ``TILE`` table rows compacted: its valid rows in
ascending order, each as the corner a, the edges e1 = b - a and e2 = c - a
and its row index, and scans them with a strict ``t < best`` in that order;
a ray whose ``|det|`` or ``u`` fails leaves a row before q, v and t, and one
whose ``v`` or ``u + v`` fails before t. A scan in plain torch over rows
staged so, step for step the kernel's, gives
``intersect_triangles_reference``'s ``(t, index)`` to the bit: around an
invalid row nearer than two valid ones, on every triangle twice, on edge
and vertex hits, on rays parallel to a face, on a triangle whose ``det``
overflows, from NaN origins and past one tile. The kernel itself runs on
the card (the ``cuda``-marked tests here; ``chip_smoke.py`` phase 13(b)).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu_torch.core.constants import INF, T_MIN
from bevyray_tpu_torch.core.types import make_triangles_np
from bevyray_tpu_torch.core.vec import Vec3
from bevyray_tpu_torch.kernels import intersect
from bevyray_tpu_torch.kernels.raygen import generate_rays, pixel_uv

torch.set_num_threads(2)

TILE = 512   # kRowsK2: table rows a staged tile
N_RAYS = 1024


def staged_rows(tris, tile: int = TILE):
    """K2's staged rows over the whole table: tile by tile, the valid rows
    in ascending order as [R, 9] (a, e1, e2) and their row indices [R]."""
    rows, index = [], []
    n = tris.ax.shape[0]
    for base in range(0, n, tile):
        live = base + torch.nonzero(tris.valid[base:base + tile])[:, 0]
        ax, ay, az = tris.ax[live], tris.ay[live], tris.az[live]
        rows.append(torch.stack([ax, ay, az, tris.bx[live] - ax,
                                 tris.by[live] - ay, tris.bz[live] - az,
                                 tris.cx[live] - ax, tris.cy[live] - ay,
                                 tris.cz[live] - az], 1))
        index.append(live)
    return torch.cat(rows), torch.cat(index)


def staged_scan(o: Vec3, d: Vec3, tris, tile: int = TILE):
    """The kernel's scan over its staged rows: Moller-Trumbore term for term,
    the exits in the kernel's order, a strict ``t < best`` row by row."""
    rows, index = staged_rows(tris, tile)
    n = o.x.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32)
    best_i = torch.full((n,), -1, dtype=torch.int64)
    for k in range(rows.shape[0]):
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = rows[k]
        px = d.y * e2z - d.z * e2y
        py = d.z * e2x - d.x * e2z
        pz = d.x * e2y - d.y * e2x
        det = px * e1x + py * e1y + pz * e1z
        inv_det = 1.0 / det
        tx, ty, tz = o.x - ax, o.y - ay, o.z - az
        u = (tx * px + ty * py + tz * pz) * inv_det
        first = (torch.abs(det) > 1e-12) & (u >= 0.0)        # the first exit
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        second = first & (v >= 0.0) & (u + v <= 1.0)          # the second
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        take = second & (t > T_MIN) & (t < best_t)
        best_i = torch.where(take, index[k], best_i)
        best_t = torch.where(take, t, best_t)
    return best_t, best_i


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _table(a, b, c, valid=None):
    tris = make_triangles_np(np.float32(a), np.float32(b), np.float32(c),
                             np.zeros(len(a), np.int32), device="cpu")
    if valid is not None:
        v = tris.valid.clone()
        v[:len(valid)] = torch.as_tensor(valid)
        tris = tris._replace(valid=v)
    return tris


def _random(n, seed, lo=-4.0, hi=4.0, size=1.0):
    """``n`` random triangles of about ``size`` in the box [lo, hi]^3."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (n, 3))
    return a, a + rng.normal(0, size, (n, 3)), a + rng.normal(0, size, (n, 3))


def _rays(n, seed, lo=-4.0, hi=4.0):
    """Rays from the box in random (not unit) directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (rng.normal(size=(n, 3))
         * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    return o, d


def _check(o, d, tris):
    po, pd = _vec(o), _vec(d)
    got = staged_scan(po, pd, tris)
    want = intersect.intersect_triangles_reference(po, pd, tris)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


def test_interleaved_valid_mask():
    """Every other row invalid, an invalid row (1) nearest to the axis rays
    between two valid ones (0 and 2), and random rows past them."""
    quad = np.float32([[-1, -1, 0], [1, -1, 0], [0, 1, 0]])
    a = [quad[0] + (0, 0, z) for z in (2.0, 1.0, 3.0)]
    b = [quad[1] + (0, 0, z) for z in (2.0, 1.0, 3.0)]
    c = [quad[2] + (0, 0, z) for z in (2.0, 1.0, 3.0)]
    ra, rb, rc = _random(125, seed=1, lo=4.0, hi=10.0)
    a, b, c = (np.concatenate([x, y]) for x, y in ((a, ra), (b, rb), (c, rc)))
    valid = np.arange(128) % 2 == 0
    valid[[0, 2]] = True
    o, d = _rays(N_RAYS, seed=2)
    o[: N_RAYS // 4] = np.float32([0.0, -0.2, -5.0])
    o[: N_RAYS // 4, :2] += np.random.default_rng(3).uniform(
        -0.2, 0.2, (N_RAYS // 4, 2)).astype(np.float32)
    d[: N_RAYS // 4] = np.float32([0.0, 0.0, 1.0])
    want = _check(o, d, _table(a, b, c, valid))
    assert bool((want[1][: N_RAYS // 4] == 0).all())
    assert not bool(((want[1] >= 0) & (want[1] % 2 == 1)).any())


def test_every_triangle_twice():
    """Each row twice in a row: exact ties, the lower (even) index wins."""
    a, b, c = (np.repeat(x, 2, axis=0) for x in _random(300, seed=4))
    o, d = _rays(N_RAYS, seed=5)
    want = _check(o, d, _table(a, b, c))
    hits = want[1][want[1] >= 0]
    assert hits.numel() > N_RAYS // 20 and bool((hits % 2 == 0).all())


def test_edge_vertex_and_parallel_rays():
    """One triangle in the z = 0 plane: rays onto its hypotenuse (u + v ==
    1), onto its corners (u == 0, v == 0) and along the plane (det == 0)."""
    tris = _table([[0, 0, 0]], [[1, 0, 0]], [[0, 1, 0]])
    o = np.float32([[0.5, 0.5, -1], [0.25, 0.75, 2], [0, 0, -1], [1, 0, -1],
                    [0, 1, 3], [-0.5, 0.2, 0], [0.2, 0.2, 0], [0.5, 0.5, 1]])
    d = np.float32([[0, 0, 1], [0, 0, -2], [0, 0, 1], [0, 0, 0.5],
                    [0, 0, -1], [1, 0, 0], [0, 1, 0], [1, -1, 0]])
    want = _check(o, d, tris)
    assert want[1][:5].tolist() == [0] * 5     # edges and corners hit
    assert want[1][5:].tolist() == [-1] * 3    # parallel: det == 0
    assert want[0][:5].tolist() == [1.0, 1.0, 1.0, 2.0, 3.0]


def test_overflowing_det_and_nan_origins():
    """Triangles of coordinates near 1e20 in both windings (det = +-inf:
    inv_det = +-0, so t = 0 fails t > T_MIN), beside a small one; rays with
    a NaN origin component miss everything."""
    big = 1e20
    a = [[-big, -big, 5], [-big, -big, 6], [-1, -1, 2]]
    b = [[big, -big, 5], [-big, big, 6], [1, -1, 2]]
    c = [[-big, big, 5], [big, -big, 6], [0, 1, 2]]
    tris = _table(a, b, c)
    d_probe = Vec3(*(torch.tensor([0.0]), torch.tensor([0.0]),
                     torch.tensor([1.0])))
    e1 = Vec3(tris.bx - tris.ax, tris.by - tris.ay, tris.bz - tris.az)
    e2 = Vec3(tris.cx - tris.ax, tris.cy - tris.ay, tris.cz - tris.az)
    p = d_probe.cross(e2)
    det = p.dot(e1)[:3]
    assert torch.isinf(det[:2]).all() and det[0] != det[1]
    o, d = _rays(N_RAYS, seed=6, lo=-1.0, hi=1.0)
    o[:, 2] = -1.0
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    o[1::5, 0] = np.nan
    o[2::5, 2] = np.nan
    want = _check(o, d, tris)
    assert bool((want[1][1::5] == -1).all()) and bool(
        (want[1][2::5] == -1).all())
    assert not bool(((want[1] >= 0) & (want[1] < 2)).any())
    assert bool((want[1] == 2).any())


def test_table_past_one_tile():
    """1,500 random rows (three tiles, the last part-full) with a fifth of
    them invalid, against rays from among them."""
    a, b, c = _random(1500, seed=7, lo=-6.0, hi=6.0, size=0.6)
    valid = np.random.default_rng(8).random(1500) > 0.2
    o, d = _rays(N_RAYS, seed=9, lo=-6.0, hi=6.0)
    want = _check(o, d, _table(a, b, c, valid))
    assert int((want[1] >= TILE).sum()) > 0 and int((want[1] < TILE).sum()) > 0


def test_staged_rows_skip_invalid_rows_in_order():
    """The staged table of the cube field: its 4,092 live rows of 4,096, in
    ascending order, edges as b - a and c - a."""
    import chip_smoke

    tris = chip_smoke.cube_field_world(bt).extract(
        with_bvh=False, device="cpu").triangles
    rows, index = staged_rows(tris)
    assert tris.ax.shape[0] == 4096 and rows.shape == (4092, 9)
    assert torch.equal(index, torch.arange(4092))
    assert torch.equal(rows[:, 3], tris.bx[:4092] - tris.ax[:4092])
    assert torch.equal(rows[:, 8], tris.cz[:4092] - tris.az[:4092])


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lanes off the block", "sparse mask",
                                  "every triangle twice",
                                  "interleaved valid mask",
                                  "4,092 triangles"])
def test_cuda_dense_triangles_equal_plain(case):
    """K2 against its plain version where its compaction, tiles and ties
    matter: 5,003 lanes, 1 active lane in 97, duplicated rows (the lower
    index wins), every third row invalid, and the cube field's 4,092
    triangles (eight staged tiles)."""
    import chip_smoke

    dev = _card()
    tris = chip_smoke.cube_field_world(bt).extract(
        with_bvh=False, device=dev).triangles
    n = 5003 if case == "lanes off the block" else 8192
    o, d = _rays(n, seed=10, lo=-4.0, hi=4.0)
    o[:, 1] = np.abs(o[:, 1]) * 0.1 + 0.05   # among the cubes
    o, d = (Vec3(*(c.to(dev) for c in _vec(x))) for x in (o, d))
    active = None
    if case == "sparse mask":
        active = torch.zeros(n, dtype=torch.bool, device=dev)
        active[5::97] = True
    if case == "every triangle twice":
        tris = type(tris)(*(torch.repeat_interleave(c, 2) for c in tris))
    if case == "interleaved valid mask":
        tris = tris._replace(valid=tris.valid & (torch.arange(
            tris.valid.numel(), device=dev) % 3 != 1))
    got = intersect.intersect_triangles(o, d, tris, active=active)
    want = intersect.on_active(intersect.intersect_triangles_reference,
                               active, o, d, tris)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] >= 0).sum()) > 0
    if case == "every triangle twice":
        assert bool((got[1][got[1] >= 0] % 2 == 0).all())


@pytest.mark.cuda
def test_cuda_raster_call_equals_plain():
    """The raster layer's call: every pixel center of a 1280x720 frame,
    unmasked, against the final scene's raster cube in an exact-sized
    table of 12 rows."""
    dev = _card()
    world = bt.rtiow.final_scene(seed=42)
    va, vb, vc, _ = world.extract_raster_host()
    tris = make_triangles_np(va, vb, vc, np.zeros(va.shape[0], np.int32),
                             capacity=va.shape[0], device=dev)
    cam = world.camera_state(aspect=1280 / 720, device=dev)
    u, v = pixel_uv(1280, 720, device=dev)
    half = torch.full_like(u, 0.5)
    o, d = generate_rays(u, v, half, half, cam, 720)
    got = intersect.intersect_triangles(o, d, tris)
    want = intersect.intersect_triangles_reference(o, d, tris)
    assert tris.ax.shape[0] == 12
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] >= 0).sum()) > 1000
