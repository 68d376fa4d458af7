"""Per-lane hit and material records, and the dense triangle test.

Counterpart of ``bevyray_tpu/kernels/intersect.py``. ``intersect_triangles``
serves the raster layer (:mod:`..engine.raster`) and the fused kernel's plain
version (:mod:`.cuda.megakernel`), whose CUDA kernel has its own per-thread
copy. The wavefront sphere test, ``triangle_hit_info`` and ``merge_hits``
come with the wavefront renderer (ROADMAP §A item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import INF, T_MIN
from ..core.vec import Vec3

# Lanes per step times table columns of a dense [lanes x columns] test (here
# and in the fused kernel's plain version): its temporaries stay near 16 MB
# each whatever the frame size.
DENSE_ELEMS = 1 << 22


class HitInfo(NamedTuple):
    """Batched twin of the WGSL HitInfo struct (raytrace.wgsl:301-307)."""

    t: torch.Tensor           # f32, INF on miss
    miss: torch.Tensor        # bool
    position: Vec3
    normal: Vec3              # outward, unit
    material_id: torch.Tensor  # i32
    front_face: torch.Tensor  # bool


class MaterialLanes(NamedTuple):
    """Per-ray gathered material attributes."""

    base_color: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor
    emissive: Vec3


def _chunk_hits(o: Vec3, d: Vec3, ax, ay, az, bx, by, bz, cx, cy, cz, valid):
    """Möller–Trumbore of rays [m] against triangles [c]: [m, c] t, +inf
    where the test fails (two-sided: back faces hit too)."""
    e1x = bx[None, :] - ax[None, :]
    e1y = by[None, :] - ay[None, :]
    e1z = bz[None, :] - az[None, :]
    e2x = cx[None, :] - ax[None, :]
    e2y = cy[None, :] - ay[None, :]
    e2z = cz[None, :] - az[None, :]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv_det = 1.0 / det
    tx = o.x[:, None] - ax[None, :]
    ty = o.y[:, None] - ay[None, :]
    tz = o.z[:, None] - az[None, :]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN) & valid[None, :])
    return torch.where(ok, t, float("inf"))


def intersect_triangles(origin: Vec3, direction: Vec3, tris,
                        chunk: int = 512):
    """Nearest triangle hit of each ray (Möller–Trumbore) as ``(t, index)``,
    INF / -1 on a miss. Accepts ``t > T_MIN`` like the sphere test and hits
    back faces too.

    ``tris``: a :class:`..core.types.Triangles` (only its corner and
    ``valid`` fields are read). Within a chunk of ``chunk`` triangles the
    first minimum wins and across chunks a strict ``<`` keeps the earlier one,
    so the lowest index wins a tie, as in the JAX package. Rays go in steps
    that bound the dense temporaries.
    """
    n = origin.x.shape[0]
    cap = tris.ax.shape[0]
    if cap % chunk:
        chunk = cap
    cols = (tris.ax, tris.ay, tris.az, tris.bx, tris.by, tris.bz,
            tris.cx, tris.cy, tris.cz, tris.valid)
    best_t = torch.full((n,), INF, dtype=origin.x.dtype,
                        device=origin.x.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=origin.x.device)
    step = max(1, DENSE_ELEMS // chunk)
    for base in range(0, cap, chunk):
        rows = [c[base:base + chunk] for c in cols]
        for lo in range(0, n, step):
            span = slice(lo, lo + step)
            t = _chunk_hits(Vec3(*(c[span] for c in origin)),
                            Vec3(*(c[span] for c in direction)), *rows)
            ct, ci = torch.min(t, dim=1)
            take = ct < best_t[span]
            best_i[span] = torch.where(take, base + ci, best_i[span])
            best_t[span] = torch.where(take, ct, best_t[span])
    return best_t, best_i
