"""PLOC BVH builder + flattener (host side).

Counterpart of ``bevyray_tpu/bvh/build.py``: the same NumPy code, which
replaces the reference's native ``obvhs`` crate (Parallel Locally-Ordered
Clustering, search radius 24, U64 morton precision — extract.rs:316-321)
with a C++ builder loaded via ctypes (``csrc/ploc.cpp``, :mod:`.native`) and
a vectorized NumPy fallback. Only :func:`_pack_nodes` differs: it puts the
flat tables on a torch device.

Output layout matches the reference's flattened node ABI exactly
(extract.rs:229-237, raytrace.wgsl:79-87):

- leaf  ⇔ ``count > 0``; ``index`` = first model index (leaves here hold 1 prim);
- inner ⇔ ``count == 0``; ``index`` = first child, second child at ``index + 1``;
- root at node 0; AABBs inflated by +0.1 like the reference (extract.rs:223-226).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.types import BvhNodes, pad_to

AABB_INFLATION = 0.1   # extract.rs:223-226
SEARCH_RADIUS = 24     # extract.rs:316

# Which builder made the last tree: "native" (the C++ library) or "numpy"
# (the fallback, taken when the library cannot be built or loaded).
last_builder = None


def sphere_aabbs(centers: np.ndarray, radii: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inflated sphere bounds (extract.rs:220-227). |r|: negative radii (the
    hollow-glass trick — hit_sphere only squares r, wgsl:375) bound the same
    ball; a signed radius would invert the box and the slab test would cull it."""
    r = (np.abs(radii) + AABB_INFLATION)[:, None].astype(np.float32)
    c = centers.astype(np.float32)
    return c - r, c + r


def _expand_bits_21(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 so consecutive bits are 3 apart."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes_u64(points: np.ndarray) -> np.ndarray:
    """63-bit morton codes of points normalized to their bounding box — the
    "U64 sort precision" the reference selects (extract.rs:319)."""
    lo = points.min(0)
    hi = points.max(0)
    extent = np.maximum(hi - lo, 1e-12)
    q = ((points - lo) / extent * ((1 << 21) - 1)).astype(np.uint64)
    q = np.clip(q, 0, (1 << 21) - 1)
    return (_expand_bits_21(q[:, 0])
            | (_expand_bits_21(q[:, 1]) << np.uint64(1))
            | (_expand_bits_21(q[:, 2]) << np.uint64(2)))


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def build_ploc_np(bmin: np.ndarray, bmax: np.ndarray,
                  search_radius: int = SEARCH_RADIUS):
    """PLOC agglomerative build over leaf AABBs.

    Returns a binary tree as parallel arrays:
    ``(node_min [M,3], node_max [M,3], left [M], right [M], prim [M], root)``
    where ``prim >= 0`` marks a leaf.
    """
    n = bmin.shape[0]
    if n == 0:
        raise ValueError("empty scene")

    # Pre-size: a binary tree over n leaves has exactly 2n-1 nodes.
    m_total = 2 * n - 1
    node_min = np.zeros((m_total, 3), np.float32)
    node_max = np.zeros((m_total, 3), np.float32)
    left = np.full(m_total, -1, np.int32)
    right = np.full(m_total, -1, np.int32)
    prim = np.full(m_total, -1, np.int32)

    node_min[:n] = bmin
    node_max[:n] = bmax
    prim[:n] = np.arange(n, dtype=np.int32)
    next_node = n

    # Sort leaves by morton code of AABB centroid.
    order = np.argsort(morton_codes_u64((bmin + bmax) * 0.5), kind="stable")
    cl_min = bmin[order].copy()
    cl_max = bmax[order].copy()
    cl_id = order.astype(np.int32).copy()

    while cl_min.shape[0] > 1:
        k = cl_min.shape[0]
        r = min(search_radius, k - 1)
        best_cost = np.full(k, np.inf, np.float64)
        best_j = np.full(k, -1, np.int64)
        for d in range(1, r + 1):
            m_min = np.minimum(cl_min[:-d], cl_min[d:])
            m_max = np.maximum(cl_max[:-d], cl_max[d:])
            sa = _surface_area(m_min, m_max).astype(np.float64)
            # i pairs with i+d
            upd = sa < best_cost[:-d]
            best_cost[:-d] = np.where(upd, sa, best_cost[:-d])
            best_j[:-d] = np.where(upd, np.arange(d, k), best_j[:-d])
            # i+d pairs with i
            upd = sa < best_cost[d:]
            best_cost[d:] = np.where(upd, sa, best_cost[d:])
            best_j[d:] = np.where(upd, np.arange(0, k - d), best_j[d:])

        idx = np.arange(k)
        mutual = (best_j[best_j] == idx) & (idx < best_j)
        lefts = idx[mutual]
        rights = best_j[mutual]

        # Emit one internal node per mutual pair.
        n_merge = lefts.shape[0]
        new_ids = np.arange(next_node, next_node + n_merge, dtype=np.int32)
        node_min[new_ids] = np.minimum(cl_min[lefts], cl_min[rights])
        node_max[new_ids] = np.maximum(cl_max[lefts], cl_max[rights])
        left[new_ids] = cl_id[lefts]
        right[new_ids] = cl_id[rights]
        next_node += n_merge

        # Merged cluster replaces the left slot; right slot is dropped.
        keep = np.ones(k, bool)
        keep[rights] = False
        cl_id[lefts] = new_ids
        cl_min[lefts] = node_min[new_ids]
        cl_max[lefts] = node_max[new_ids]
        cl_min, cl_max, cl_id = cl_min[keep], cl_max[keep], cl_id[keep]

    root = int(cl_id[0])
    return node_min[:next_node], node_max[:next_node], left[:next_node], \
        right[:next_node], prim[:next_node], root


def flatten_tree(node_min, node_max, left, right, prim, root,
                 max_leaf_size: int = 1):
    """Flatten a binary tree to the reference node layout (children adjacent,
    root at 0 — extract.rs:323-332 semantics).

    ``max_leaf_size > 1`` collapses every subtree holding ≤ that many prims
    into ONE leaf (obvhs multi-prim leaves: extract.rs:229-237 model_count,
    raytrace.wgsl:311 MAX_MODELS_PER_NODE / :348-362 leaf loop). Returns
    ``(out_min, out_max, out_index, out_count, prim_ids)``: leaf prims are
    CONTIGUOUS runs of ``prim_ids`` (the obvhs model reordering, kept as an
    indirection so callers' primitive tables stay in extraction order) —
    leaf ``k``'s original prim is ``prim_ids[index + k]``. With the default
    ``max_leaf_size=1``, ``index`` is the original prim id directly and
    ``prim_ids`` is the identity."""
    # Subtree prim counts (children were always emitted before parents by the
    # PLOC merge loop, so ascending id order is a valid bottom-up sweep;
    # original leaves occupy the low ids).
    n_tree = node_min.shape[0]
    sub = np.zeros(n_tree, np.int64)
    for tid in range(n_tree):
        sub[tid] = 1 if prim[tid] >= 0 else sub[left[tid]] + sub[right[tid]]

    def leaf_run(tid):
        """Subtree prim ids, left-to-right (deterministic leaf order)."""
        out, stack = [], [tid]
        while stack:
            t = stack.pop()
            if prim[t] >= 0:
                out.append(int(prim[t]))
            else:
                stack.append(int(right[t]))
                stack.append(int(left[t]))
        return out

    # Flat node count: leaves after collapse = L, nodes = 2L - 1.
    mins, maxs, index, count = [], [], [], []
    prim_ids = []

    def emit():
        mins.append(None)
        maxs.append(None)
        index.append(0)
        count.append(0)

    next_slot = 1
    stack = [(root, 0)]
    emit()
    while stack:
        tid, slot = stack.pop()
        mins[slot] = node_min[tid]
        maxs[slot] = node_max[tid]
        if sub[tid] <= max_leaf_size:
            if max_leaf_size == 1:
                index[slot] = int(prim[tid])   # the prim id directly
            else:
                index[slot] = len(prim_ids)
                prim_ids.extend(leaf_run(tid))
            count[slot] = int(sub[tid])
        else:
            first = next_slot
            next_slot += 2
            emit()
            emit()
            index[slot] = first
            count[slot] = 0
            stack.append((left[tid], first))
            stack.append((right[tid], first + 1))
    out_min = np.stack(mins).astype(np.float32)
    out_max = np.stack(maxs).astype(np.float32)
    out_index = np.asarray(index, np.int32)
    out_count = np.asarray(count, np.int32)
    if max_leaf_size == 1:
        prim_ids = np.arange(int(prim.max()) + 1, dtype=np.int32)  # identity
    return out_min, out_max, out_index, out_count, \
        np.asarray(prim_ids, np.int32)


def triangle_aabbs(va: np.ndarray, vb: np.ndarray,
                   vc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle bounds from [T,3] corner arrays (tiny epsilon inflation for
    axis-aligned triangles whose boxes would be degenerate)."""
    bmin = np.minimum(np.minimum(va, vb), vc).astype(np.float32) - 1e-4
    bmax = np.maximum(np.maximum(va, vb), vc).astype(np.float32) + 1e-4
    return bmin, bmax


def build_bvh_from_aabbs(bmin: np.ndarray, bmax: np.ndarray,
                         capacity: int | None = None,
                         max_leaf_size: int = 1, device=None) -> BvhNodes:
    """Generic entry: PLOC over arbitrary leaf AABBs (native with NumPy
    fallback, recorded in :data:`last_builder`), flattened to the reference
    node ABI and put on ``device``. ``max_leaf_size > 1`` collapses ≤K-prim
    subtrees into multi-prim leaves (obvhs MAX_MODELS_PER_NODE,
    raytrace.wgsl:311); leaf prims resolve through the packed ``prim_ids``
    indirection (see :func:`flatten_tree`)."""
    global last_builder
    from . import native
    built = native.build_ploc_native(bmin, bmax, SEARCH_RADIUS)
    last_builder = "native"
    if built is None:
        built = build_ploc_np(bmin, bmax)
        last_builder = "numpy"
    node_min, node_max, left, right, prim, root = built
    fmin, fmax, index, count, prim_ids = flatten_tree(
        node_min, node_max, left, right, prim, root,
        max_leaf_size=max_leaf_size)
    return _pack_nodes(fmin, fmax, index, count, capacity,
                       prim_ids if max_leaf_size > 1 else None, device)


def build_triangle_bvh(va: np.ndarray, vb: np.ndarray, vc: np.ndarray,
                       capacity: int | None = None,
                       max_leaf_size: int = 1, device=None) -> BvhNodes:
    """[T,3] world-space corner arrays → flat BVH over triangles (the
    reference's planned ModelBVH, extract.rs:239-248; BASELINE config 5)."""
    bmin, bmax = triangle_aabbs(va, vb, vc)
    return build_bvh_from_aabbs(bmin, bmax, capacity,
                                max_leaf_size=max_leaf_size, device=device)


def build_scene_bvh(centers: np.ndarray, radii: np.ndarray,
                    capacity: int | None = None,
                    max_leaf_size: int = 1, device=None) -> BvhNodes:
    """centers [N,3], radii [N] → padded flat BVH on ``device``."""
    bmin, bmax = sphere_aabbs(centers, radii)
    return build_bvh_from_aabbs(bmin, bmax, capacity,
                                max_leaf_size=max_leaf_size, device=device)


def _pack_nodes(fmin, fmax, index, count, capacity: int | None,
                prim_ids=None, device=None) -> BvhNodes:
    """Lane-pad flat node arrays into the BvhNodes table on ``device``."""
    n = fmin.shape[0]
    cap = capacity or pad_to(max(n, 1))

    def pad(a, dt):
        return torch.as_tensor(np.concatenate(
            [a.astype(dt), np.zeros(cap - n, dt)]), device=device)

    if prim_ids is not None:
        npr = prim_ids.shape[0]
        prim_ids = torch.as_tensor(np.concatenate(
            [prim_ids.astype(np.int32),
             np.zeros(pad_to(max(npr, 1)) - npr, np.int32)]), device=device)
    return BvhNodes(
        min_x=pad(fmin[:, 0], np.float32), min_y=pad(fmin[:, 1], np.float32),
        min_z=pad(fmin[:, 2], np.float32), max_x=pad(fmax[:, 0], np.float32),
        max_y=pad(fmax[:, 1], np.float32), max_z=pad(fmax[:, 2], np.float32),
        index=pad(index, np.int32), count=pad(count, np.int32),
        n_nodes=torch.tensor(n, dtype=torch.int32, device=device),
        prim_ids=prim_ids,
    )
