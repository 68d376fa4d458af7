"""Flattened-BVH traversal — batched twin of ``raycast`` (raytrace.wgsl:313-346).

Counterpart of ``bevyray_tpu/kernels/traverse.py``. :func:`intersect_bvh`
and :func:`intersect_bvh_triangles` are wrappers: on CUDA tensors they
launch the walks of ``cuda/csrc/wavefront.cu`` (K3/K4: one thread per ray;
K3 over the scene's ``SphereWalk``), on CPU tensors they run the plain
versions :func:`intersect_bvh_reference` and
:func:`intersect_bvh_triangles_reference`, torch operators on either
device, described below.

Each ray walks the flattened BVH with a bounded per-lane
stack (the reference uses a fixed 32-entry stack, wgsl:310; overflow
silently truncates traversal — SURVEY.md quirk #9 — reproduced here: a push
past the top lands in one extra sink column that is never read, and a lane
whose stack index reaches the top stops walking). The batch iterates in
lock-step, as JAX's ``while_loop`` does, until no lane walks.

The walk order is the reference's: the first child is pushed before the
second, so the second is popped first, and a leaf prim replaces the best hit
only with a strictly smaller t. The winning index is therefore the first
found along that order, which on an exact tie need not be the lowest (the
dense :func:`.intersect.intersect_spheres` takes the lowest).

Two changes of schedule leave every value as it is, since a lane that has
stopped walking is left unchanged by the loop body: the loop test, which
costs a host sync in torch, runs every :data:`CHECK_EVERY` iterations, and
at each test the lanes that stopped are written out and dropped from the
working set. ``inv_dir = 1 / d`` is inf on a zero component, and a box face
through the origin then gives NaN in the slab test; ``torch.minimum`` /
``torch.maximum`` propagate it as ``jnp.minimum`` / ``jnp.maximum`` do.
"""

from __future__ import annotations

import torch

from ..core.constants import INF, T_MIN
from ..core.types import BvhNodes, Spheres, SphereWalk, make_sphere_walk
from ..core.vec import Vec3, sqrt
from .cuda import wavefront
from .intersect import _check_cuda, on_active

STACK_SIZE = 32  # raytrace.wgsl:310
CHECK_EVERY = 8  # loop iterations between the tests for a lane still walking


def _slab_entry_distance(origin: Vec3, inv_dir: Vec3, bmin: Vec3, bmax: Vec3):
    """Branchless slab test returning entry distance (ray_bounding_dst,
    wgsl:387-398): 0 if origin inside, INF on miss."""
    tx1 = (bmin.x - origin.x) * inv_dir.x
    tx2 = (bmax.x - origin.x) * inv_dir.x
    ty1 = (bmin.y - origin.y) * inv_dir.y
    ty2 = (bmax.y - origin.y) * inv_dir.y
    tz1 = (bmin.z - origin.z) * inv_dir.z
    tz2 = (bmax.z - origin.z) * inv_dir.z
    t_near = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                         torch.minimum(ty1, ty2)),
                           torch.minimum(tz1, tz2))
    t_far = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                        torch.maximum(ty1, ty2)),
                          torch.maximum(tz1, tz2))
    hit = (t_far >= t_near) & (t_far > 0.0)
    return torch.where(hit, torch.where(t_near > 0.0, t_near, 0.0), INF)


def _sphere_t(origin: Vec3, direction: Vec3, a, inv_a, cx, cy, cz, r):
    """Near-root-only sphere distance (hit_sphere, wgsl:371-383); INF if
    invalid. The same operations as the dense test's."""
    ocx = cx - origin.x
    ocy = cy - origin.y
    ocz = cz - origin.z
    h = direction.x * ocx + direction.y * ocy + direction.z * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = h * h - a * c
    t = (h - sqrt(torch.clamp(disc, min=0.0))) * inv_a
    ok = (disc >= 0.0) & (t > T_MIN)
    return torch.where(ok, t, INF)


def _tri_leaf_t(origin: Vec3, direction: Vec3, tris, prim):
    """Möller–Trumbore distance for gathered triangle ``prim`` per lane (same
    acceptance as kernels.intersect.intersect_triangles); INF on miss."""
    ax, ay, az = tris.ax[prim], tris.ay[prim], tris.az[prim]
    e1x = tris.bx[prim] - ax
    e1y = tris.by[prim] - ay
    e1z = tris.bz[prim] - az
    e2x = tris.cx[prim] - ax
    e2y = tris.cy[prim] - ay
    e2z = tris.cz[prim] - az
    dx, dy, dz = direction.x, direction.y, direction.z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv_det = 1.0 / det
    tx = origin.x - ax
    ty = origin.y - ay
    tz = origin.z - az
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN) & tris.valid[prim])
    return torch.where(ok, t, INF)


def intersect_bvh_triangles_reference(origin: Vec3, direction: Vec3, tris,
                                      bvh: BvhNodes,
                                      stack_size: int = STACK_SIZE,
                                      max_leaf_size: int = 1, work=None):
    """Nearest triangle hit via BVH traversal (the reference's planned ModelBVH,
    extract.rs:239-248) — same bounded-stack walk as the sphere version with a
    Möller–Trumbore leaf test. ``work``: see :func:`intersect_bvh_reference`."""
    return _intersect_bvh_generic(
        (origin, direction), bvh, stack_size, max_leaf_size,
        capacity=tris.capacity,
        leaf_t=lambda rays, prim: _tri_leaf_t(rays[0], rays[1], tris, prim),
        work=work)


def intersect_bvh_reference(origin: Vec3, direction: Vec3, spheres: Spheres,
                            bvh: BvhNodes, stack_size: int = STACK_SIZE,
                            max_leaf_size: int = 1, work=None):
    """Nearest hit via BVH traversal. Returns (t, index) like
    :func:`..kernels.intersect.intersect_spheres`: INF / -1 on a miss.
    ``work``: a dict that gets the walk's box tests (``slab_tests``, two per
    inner node visited) and prim tests (``leaf_tests``) added, read on the
    host."""
    a = direction.dot(direction)

    def leaf_t(rays, prim):
        o, d, a, inv_a = rays
        return _sphere_t(o, d, a, inv_a, spheres.cx[prim], spheres.cy[prim],
                         spheres.cz[prim], spheres.radius[prim])

    return _intersect_bvh_generic((origin, direction, a, 1.0 / a), bvh,
                                  stack_size, max_leaf_size,
                                  capacity=spheres.capacity, leaf_t=leaf_t,
                                  work=work)


def intersect_bvh(origin: Vec3, direction: Vec3, spheres: Spheres,
                  bvh: BvhNodes, stack_size: int = STACK_SIZE,
                  max_leaf_size: int = 1, active=None,
                  walk: SphereWalk | None = None):
    """Nearest sphere hit of each ray by the walk, as ``(t, index)``, INF /
    -1 on a miss and where the bool mask ``active`` is False: the values of
    :func:`intersect_bvh_reference`.

    On CPU tensors this runs the plain walk (on the active lanes). On CUDA
    tensors it launches the K3 walk of ``cuda/csrc/wavefront.cu`` (a stack
    of at most 32 entries) or raises; it never falls back. K3 reads only
    ``walk``, the ``SphereWalk`` of ``bvh`` over ``spheres`` (the scene's
    ``sphere_walk``); without one, this call builds it first
    (:func:`..core.types.make_sphere_walk`, a few kernels more).
    ``intersect_bvh.launches`` counts the launches.
    """
    dev = origin.x.device
    if dev.type == "cpu":
        return on_active(intersect_bvh_reference, active, origin, direction,
                         spheres, bvh, stack_size, max_leaf_size)
    _check_cuda(dev, "intersect_bvh")
    if walk is None:
        walk = make_sphere_walk(spheres, bvh)
    out = wavefront.launch("intersect_bvh", origin, direction, active,
                           list(walk), stack_size, max_leaf_size)
    intersect_bvh.launches += 1
    return out


def intersect_bvh_triangles(origin: Vec3, direction: Vec3, tris,
                            bvh: BvhNodes, stack_size: int = STACK_SIZE,
                            max_leaf_size: int = 1, active=None):
    """Nearest triangle hit of each ray by the walk, as ``(t, index)``, INF
    / -1 on a miss and where ``active`` is False: the values of
    :func:`intersect_bvh_triangles_reference`. On CPU tensors the plain
    walk; on CUDA tensors the K4 walk of ``cuda/csrc/wavefront.cu`` or an
    error. ``intersect_bvh_triangles.launches`` counts the launches."""
    dev = origin.x.device
    if dev.type == "cpu":
        return on_active(intersect_bvh_triangles_reference, active, origin,
                         direction, tris, bvh, stack_size, max_leaf_size)
    _check_cuda(dev, "intersect_bvh_triangles")
    out = wavefront.launch("intersect_bvh_triangles", origin, direction,
                           active, wavefront.bvh_columns(bvh), stack_size,
                           max_leaf_size, wavefront.triangle_columns(tris))
    intersect_bvh_triangles.launches += 1
    return out


intersect_bvh.launches = 0
intersect_bvh_triangles.launches = 0


def _take(x, rows):
    return Vec3(*(c[rows] for c in x)) if isinstance(x, Vec3) else x[rows]


def _intersect_bvh_generic(rays: tuple, bvh: BvhNodes, stack_size: int,
                           max_leaf_size: int, capacity: int, leaf_t,
                           work=None):
    """Shared bounded-stack BVH walk. ``rays``: per-lane data, origin and
    direction first (Vec3s or tensors, each compacted with the lanes);
    ``leaf_t(rays, prim)`` returns the per-lane hit distance for one
    primitive (INF on miss); ``work`` counts the tests when given."""
    origin, direction = rays[0], rays[1]
    dev = origin.x.device
    n = origin.x.shape[0]
    n_nodes = bvh.min_x.shape[0]
    out_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    out_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if n == 0:
        return out_t, out_i

    inv_dir = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    lanes = torch.arange(n, device=dev)
    # stack[:, 0] = 0 (root), stack_index = 1 — wgsl:316-318. Column
    # ``stack_size`` is the sink of the pushes past the top.
    stack = torch.zeros((n, stack_size + 1), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best_t, best_i = out_t.clone(), out_i.clone()
    prim_ids = bvh.prim_ids
    step = 0
    while True:
        if step % CHECK_EVERY == 0:
            walking = (sp > 0) & (sp < stack_size)            # wgsl:320
            keep = walking.nonzero()[:, 0]
            if keep.numel() < lanes.numel():
                done = lanes[~walking]
                out_t[done] = best_t[~walking]
                out_i[done] = best_i[~walking]
                if keep.numel() == 0:
                    return out_t, out_i
                lanes, stack, sp, best_t, best_i = (
                    x[keep] for x in (lanes, stack, sp, best_t, best_i))
                rays = tuple(_take(r, keep) for r in rays)
                inv_dir = _take(inv_dir, keep)
        step += 1
        origin = rays[0]

        active = (sp > 0) & (sp < stack_size)
        spm1 = torch.clamp(sp - 1, min=0)
        node = stack.gather(1, spm1[:, None])[:, 0]
        node = torch.where(active, node, 0)
        sp = torch.where(active, spm1, sp)

        count = bvh.count[node]
        first = bvh.index[node].long()
        is_leaf = active & (count > 0)

        # --- leaf: test prims [first, first+count) (wgsl:348-362); with
        # multi-prim leaves the slot resolves through prim_ids.
        new_t, new_i = best_t, best_i
        for k in range(max_leaf_size):
            if prim_ids is None:
                prim = torch.clamp(first + k, 0, capacity - 1)
            else:
                slot = torch.clamp(first + k, 0, prim_ids.shape[0] - 1)
                prim = torch.clamp(prim_ids[slot].long(), 0, capacity - 1)
            t = leaf_t(rays, prim)
            ok = is_leaf & (k < count) & (t < new_t)
            if work is not None:
                work["leaf_tests"] = work.get("leaf_tests", 0) + int(
                    (is_leaf & (k < count)).sum())
            new_i = torch.where(ok, prim, new_i)
            new_t = torch.where(ok, t, new_t)

        # --- inner: push children whose slab distance beats best (wgsl:328-341)
        is_inner = active & (count == 0)
        if work is not None:
            work["slab_tests"] = work.get("slab_tests", 0) + 2 * int(
                is_inner.sum())
        c1 = torch.clamp(first, 0, n_nodes - 1)
        c2 = torch.clamp(first + 1, 0, n_nodes - 1)

        def child_dist(ci):
            bmin = Vec3(bvh.min_x[ci], bvh.min_y[ci], bvh.min_z[ci])
            bmax = Vec3(bvh.max_x[ci], bvh.max_y[ci], bvh.max_z[ci])
            return _slab_entry_distance(origin, inv_dir, bmin, bmax)

        d1 = child_dist(c1)
        d2 = child_dist(c2)
        push1 = is_inner & (d1 < INF) & (d1 < new_t)
        push2 = is_inner & (d2 < INF) & (d2 < new_t)

        # Two sequential pushes at per-lane positions; a push past the top
        # goes to the sink column: the reference's silent truncation.
        pos1 = torch.where(push1 & (sp < stack_size), sp, stack_size)
        stack.scatter_(1, pos1[:, None], c1[:, None])
        sp = sp + push1.long()
        pos2 = torch.where(push2 & (sp < stack_size), sp, stack_size)
        stack.scatter_(1, pos2[:, None], c2[:, None])
        sp = sp + push2.long()
        best_t, best_i = new_t, new_i
