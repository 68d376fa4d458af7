"""Ray-sphere and ray-triangle tests over ray batches, and the per-lane hit
and material records built from their winners.

Counterpart of ``bevyray_tpu/kernels/intersect.py``, with the reference's
acceptance rules (raytrace.wgsl:348-383): the near root only, ``disc >= 0 &&
t > 0.001 && t < closest``, normals always outward, ``front_face =
dot(dir, normal) < 0``. The wavefront renderer (:mod:`..engine.renderer`)
runs these per bounce; ``intersect_triangles`` also serves the raster layer
(:mod:`..engine.raster`). The fused kernel (:mod:`.cuda.megakernel`) has
its own per-thread copies.

:func:`intersect_spheres` and :func:`intersect_triangles` are wrappers: on
CUDA tensors they launch the hand-written kernels of
``cuda/csrc/wavefront.cu`` (up to four of a block's active rays a thread
over the whole table), on CPU
tensors they run the plain versions :func:`intersect_spheres_reference` and
:func:`intersect_triangles_reference`. Those are dense [rays x table chunk]
blocks, as in the JAX package; rays go in steps that bound the temporaries
(:func:`dense_rows`), and each ray's result depends on its own row only, so
the step changes no value. The fused kernel's plain version calls the
plain triangle test, so that it launches no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import INF, T_MIN
from ..core.types import Materials, Spheres
from ..core.vec import Vec3, sqrt
from .cuda import wavefront

# Lanes per step times table columns of a dense [lanes x columns] test (here
# and in the fused kernel's plain version): its temporaries stay near 16 MB
# each whatever the frame size. On a CUDA card the wavefront tests take
# steps 16 times as large (256 MB temporaries, a few GB live at most), so
# that a 1080p bounce launches tens of steps, not hundreds.
DENSE_ELEMS = 1 << 22
DENSE_ELEMS_CUDA = 1 << 26


def dense_rows(n_cols: int, device) -> int:
    """Rays per step of a dense test against ``n_cols`` table columns."""
    elems = (DENSE_ELEMS_CUDA if torch.device(device).type == "cuda"
             else DENSE_ELEMS)
    return max(1, elems // max(n_cols, 1))


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


def intersect_triangles_reference(origin: Vec3, direction: Vec3, tris,
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
    step = dense_rows(chunk, origin.x.device)
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


def intersect_spheres_reference(origin: Vec3, direction: Vec3,
                                spheres: Spheres, chunk: int = 512):
    """Nearest hit of each ray over the whole (padded) sphere table as
    ``(t, index)``, INF / -1 on a miss (``hit_sphere`` +
    ``raycast_against_range``, wgsl:348-383).

    The table goes in chunks of ``chunk`` spheres (one chunk when the
    capacity is not a multiple of it), as in the JAX package: ``t = (h -
    sqrt(max(disc, 0))) * (1 / a)`` with ``a = d.d`` (directions need not be
    unit), accepted where ``disc >= 0``, ``t > T_MIN`` and the lane is valid;
    within a chunk the lowest lane among equal minima wins, and a later
    chunk replaces the best only with a strictly smaller t, so the lowest
    index wins every tie.
    """
    n = origin.x.shape[0]
    dev = origin.x.device
    cap = spheres.capacity
    if cap % chunk:
        chunk = cap
    a = direction.dot(direction)
    inv_a = 1.0 / a
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)
    step = dense_rows(chunk, dev)
    for base in range(0, cap, chunk):
        ccx, ccy, ccz, cr, cvalid = (c[base:base + chunk] for c in (
            spheres.cx, spheres.cy, spheres.cz, spheres.radius, spheres.valid))
        r2 = (cr * cr)[None, :]
        for lo in range(0, n, step):
            span = slice(lo, lo + step)
            ocx = ccx[None, :] - origin.x[span, None]
            ocy = ccy[None, :] - origin.y[span, None]
            ocz = ccz[None, :] - origin.z[span, None]
            h = (direction.x[span, None] * ocx + direction.y[span, None] * ocy
                 + direction.z[span, None] * ocz)                 # wgsl:374
            c = ocx * ocx + ocy * ocy + ocz * ocz - r2             # wgsl:375
            del ocx, ocy, ocz
            disc = h * h - a[span, None] * c                       # wgsl:376
            del c
            t = (h - sqrt(torch.clamp(disc, min=0.0))) * inv_a[span, None]
            del h
            ok = (disc >= 0.0) & (t > T_MIN) & cvalid[None, :]     # wgsl:353
            del disc
            t = torch.where(ok, t, INF)
            del ok
            ct = t.amin(dim=1)
            ci = torch.where(t == ct[:, None], lane, chunk).amin(dim=1)
            del t
            take = ct < best_t[span]                               # wgsl:354
            best_i[span] = torch.where(take, base + ci, best_i[span])
            best_t[span] = torch.where(take, ct, best_t[span])
    return best_t, best_i


def on_active(reference, active, origin: Vec3, direction: Vec3, *args,
              **kwargs):
    """``reference(origin, direction, *args, **kwargs)`` (a plain ray test
    returning ``(t, index)``) on the lanes where ``active`` holds, INF / -1
    on the others; every lane without a mask. Each lane's result depends on
    its own ray only, so the other lanes change no value. Reads the mask on
    the host."""
    if active is None:
        return reference(origin, direction, *args, **kwargs)
    n, dev = origin.x.shape[0], origin.x.device
    lanes = active.nonzero()[:, 0]
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    index = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if lanes.numel():
        t[lanes], index[lanes] = reference(
            Vec3(*(c[lanes] for c in origin)),
            Vec3(*(c[lanes] for c in direction)), *args, **kwargs)
    return t, index


def intersect_spheres(origin: Vec3, direction: Vec3, spheres: Spheres,
                      chunk: int = 512, active=None):
    """Nearest hit of each ray over the whole (padded) sphere table as
    ``(t, index)``, INF / -1 on a miss and where the bool mask ``active``
    is False: the values of :func:`intersect_spheres_reference`.

    On CPU tensors this runs the plain version (on the active lanes). On
    CUDA tensors it launches the K1 kernel of ``cuda/csrc/wavefront.cu``
    (``chunk`` changes no value there and is not read) or raises; it never
    falls back. ``intersect_spheres.launches`` counts the launches.
    """
    dev = origin.x.device
    if dev.type == "cpu":
        return on_active(intersect_spheres_reference, active, origin,
                         direction, spheres, chunk)
    _check_cuda(dev, "intersect_spheres")
    out = wavefront.launch("intersect_spheres", origin, direction, active,
                           wavefront.sphere_columns(spheres))
    intersect_spheres.launches += 1
    return out


def intersect_triangles(origin: Vec3, direction: Vec3, tris,
                        chunk: int = 512, active=None):
    """Nearest triangle hit of each ray (Möller–Trumbore, two-sided) as
    ``(t, index)``, INF / -1 on a miss and where ``active`` is False: the
    values of :func:`intersect_triangles_reference`.

    On CPU tensors this runs the plain version (on the active lanes). On
    CUDA tensors it launches the K2 kernel of ``cuda/csrc/wavefront.cu``
    (``chunk`` is not read there) or raises; it never falls back.
    ``intersect_triangles.launches`` counts the launches.
    """
    dev = origin.x.device
    if dev.type == "cpu":
        return on_active(intersect_triangles_reference, active, origin,
                         direction, tris, chunk)
    _check_cuda(dev, "intersect_triangles")
    out = wavefront.launch("intersect_triangles", origin, direction, active,
                           wavefront.triangle_columns(tris))
    intersect_triangles.launches += 1
    return out


intersect_spheres.launches = 0
intersect_triangles.launches = 0


def _check_cuda(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {dev}")


def make_hit_info(origin: Vec3, direction: Vec3, t: torch.Tensor,
                  index: torch.Tensor, spheres: Spheres) -> HitInfo:
    """Hit attributes of the winning sphere (raycast_against_range body,
    wgsl:355-358). Missed lanes get a well-defined placeholder (position at
    the origin, normal +y), masked by the caller."""
    miss = t >= INF
    safe_t = torch.where(miss, 0.0, t)
    idx = torch.clamp(index, 0, spheres.capacity - 1)
    center = Vec3(spheres.cx[idx], spheres.cy[idx], spheres.cz[idx])
    position = origin + direction.scale(safe_t)            # ray_at, wgsl:130
    normal = (position - center).normalize()               # outward, wgsl:356
    normal = Vec3.where(miss, _up(t), normal)
    return HitInfo(t=t, miss=miss, position=position, normal=normal,
                   material_id=spheres.material_id[idx],
                   front_face=direction.dot(normal) < 0.0)   # wgsl:358


def triangle_hit_info(origin: Vec3, direction: Vec3, t: torch.Tensor,
                      index: torch.Tensor, tris) -> HitInfo:
    """Hit attributes of triangle hits: the geometric normal, normalized
    (b - a) x (c - a), not flipped toward the ray (as the sphere normal is
    always outward); ``front_face`` from the ray-normal sign."""
    miss = t >= INF
    safe_t = torch.where(miss, 0.0, t)
    idx = torch.clamp(index, 0, tris.capacity - 1)
    a = Vec3(tris.ax[idx], tris.ay[idx], tris.az[idx])
    b = Vec3(tris.bx[idx], tris.by[idx], tris.bz[idx])
    c = Vec3(tris.cx[idx], tris.cy[idx], tris.cz[idx])
    normal = (b - a).cross(c - a).normalize()
    normal = Vec3.where(miss, _up(t), normal)
    position = origin + direction.scale(safe_t)
    return HitInfo(t=t, miss=miss, position=position, normal=normal,
                   material_id=tris.material_id[idx],
                   front_face=direction.dot(normal) < 0.0)


def merge_hits(a: HitInfo, b: HitInfo) -> HitInfo:
    """The nearer of two hit sets (sphere and triangle passes): ``b`` wins
    only with a strictly smaller t, so ``a`` wins a tie."""
    b_wins = b.t < a.t
    return HitInfo(
        t=torch.where(b_wins, b.t, a.t), miss=a.miss & b.miss,
        position=Vec3.where(b_wins, b.position, a.position),
        normal=Vec3.where(b_wins, b.normal, a.normal),
        material_id=torch.where(b_wins, b.material_id, a.material_id),
        front_face=torch.where(b_wins, b.front_face, a.front_face))


def gather_materials(materials: Materials,
                     material_id: torch.Tensor) -> MaterialLanes:
    """Each lane's material attributes, by its (clamped) material id."""
    idx = torch.clamp(material_id, 0, materials.capacity - 1)
    return MaterialLanes(
        base_color=Vec3(materials.base_r[idx], materials.base_g[idx],
                        materials.base_b[idx]),
        metallic=materials.metallic[idx], roughness=materials.roughness[idx],
        ior=materials.ior[idx],
        specular_transmission=materials.specular_transmission[idx],
        emissive=Vec3(materials.emissive_r[idx], materials.emissive_g[idx],
                      materials.emissive_b[idx]))


def _up(like: torch.Tensor) -> Vec3:
    return Vec3.full((), 0.0, 1.0, 0.0, device=like.device)
