"""Launches of the wavefront renderer's ray tests (``csrc/wavefront.cu``).

The wrappers that callers use are :func:`..intersect.intersect_spheres`,
:func:`..intersect.intersect_triangles`, :func:`..traverse.intersect_bvh`
and :func:`..traverse.intersect_bvh_triangles`: on CPU tensors they run
their plain versions, on CUDA tensors they call :func:`launch` here, which
builds the extension on first use (:mod:`.build`). A launch allocates its
outputs, queues one kernel on the current stream and returns without
waiting for the card.

The sphere walk (K3) reads only the scene's ``SphereWalk``
(:func:`...core.types.make_sphere_walk`), the BVH laid out with its
sphere rows when the scene is extracted.
"""

from __future__ import annotations

import torch

from ...core.vec import Vec3


def _mask(active, device) -> torch.Tensor:
    if active is None:
        return torch.empty(0, dtype=torch.bool, device=device)
    return active.contiguous()


def sphere_columns(spheres) -> list:
    return [c.contiguous() for c in (spheres.cx, spheres.cy, spheres.cz,
                                     spheres.radius, spheres.valid)]


def triangle_columns(tris) -> list:
    return [c.contiguous() for c in (tris.ax, tris.ay, tris.az, tris.bx,
                                     tris.by, tris.bz, tris.cx, tris.cy,
                                     tris.cz, tris.valid)]


def bvh_columns(bvh) -> list:
    ids = (bvh.prim_ids if bvh.prim_ids is not None
           else torch.empty(0, dtype=torch.int32, device=bvh.min_x.device))
    return ([c.contiguous() for c in (bvh.min_x, bvh.min_y, bvh.min_z,
                                      bvh.max_x, bvh.max_y, bvh.max_z)]
            + [c.contiguous() for c in (bvh.index, bvh.count, ids)])


def kernel_info(device, rows: int) -> dict:
    """Registers per thread (``num_regs``), spill bytes per thread
    (``local_bytes``), static and dynamic shared memory per block and
    resident blocks per SM (``blocks_per_sm``) of K1 and K2 (over a table
    of ``rows`` rows, which sets their staged tiles; also their
    ``rays_per_thread``) and K3, by wrapper name, on CUDA ``device``.
    Builds the extension on first use."""
    from .build import extension

    index = torch.device(device).index or 0
    return {name: dict(info) for name, info in
            extension().wavefront_info(index, rows).items()}


def launch(name: str, origin: Vec3, direction: Vec3, active, *tables):
    """``(t, index)`` of extension function ``name`` (``intersect_spheres``,
    ``intersect_triangles``, ``intersect_bvh`` or
    ``intersect_bvh_triangles``) over the rays, ``tables`` being its
    columns (and for a walk, its stack and leaf sizes): float32 t, f32 max
    on a miss and on an inactive lane, and int64 index, -1 there. The
    binding raises on a tensor of another device, type or length."""
    from .build import extension

    dev = origin.x.device
    n = origin.x.shape[0]
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, dtype=torch.int64, device=dev)
    rays = [c.contiguous() for c in (*origin, *direction)]
    getattr(extension(), name)(rays, _mask(active, dev), *tables, out_t,
                               out_i)
    return out_t, out_i
