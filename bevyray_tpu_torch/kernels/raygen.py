"""Camera ray generation, the batched twin of ``random_ray_from_uv``
(raytrace.wgsl:139-156).

Counterpart of ``bevyray_tpu/kernels/raygen.py``: the whole frame as one flat
batch of rays, in the JAX package's order of operations. The fused kernel has
its own per-thread copy (:mod:`.cuda.megakernel`), and so do the wavefront
path's K5 (:mod:`.bounce`) and the raster layer's K8 (:mod:`..engine.raster`),
whose plain versions call these.
"""

from __future__ import annotations

import torch

from ..core.rng import TWO_PI
from ..core.types import CameraState
from ..core.vec import Vec3, sqrt
from .camera import half_fov_tan


def _f32(value, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device``, for a divisor: on a
    CUDA tensor torch divides by a Python float as a multiply by its
    reciprocal, which rounds twice, where the kernel and the JAX package
    divide once. Filled on the device: a copy from the host would wait for
    the work queued on the card."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def pixel_uv(width: int, height: int, device=None):
    """Per-pixel texture coordinates at pixel centers, flattened row-major
    (pixel 0 = top-left; u right, v down, raytrace.wgsl:94)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    u = (xs.reshape(-1) + 0.5) / _f32(width, device)
    v = (ys.reshape(-1) + 0.5) / _f32(height, device)
    return u, v


def pixel_range(first: int, n: int, width: int, height: int, device=None):
    """Pixels ``first .. first + n`` of a ``width`` x ``height`` frame in
    row-major order, as (int64 ids, u, v): the coordinates of
    :func:`pixel_uv` (the same operations, so the same bits as its slice),
    computed from the ids as the wavefront path's K5 computes them."""
    ids = torch.arange(first, first + n, device=device)
    xs = (ids % width).to(torch.float32)
    ys = (ids // width).to(torch.float32)
    return (ids, (xs + 0.5) / _f32(width, device),
            (ys + 0.5) / _f32(height, device))


def generate_rays(u, v, jitter_u, jitter_v, cam: CameraState, height: int,
                  lens_u=None, lens_v=None):
    """Jittered perspective primary rays (raytrace.wgsl:139-156) as
    (origin, unit direction).

    ``jitter_u/v`` are uniforms in [0, 1), shifted by -0.5 and scaled by one
    texel; the width is ``height * aspect`` as in the reference
    (wgsl:142). ``lens_u/v`` turn on the thin lens: the origin moves on a
    disk of diameter ``cam.aperture`` and the ray aims at the pinhole ray's
    point at ``cam.focus_distance``. The camera's 0-d tensors must lie on the
    device of ``u``.
    """
    h = _f32(height, u.device)
    w = h * cam.aspect
    ndc_x = (u * 2.0 - 1.0) + (jitter_u - 0.5) / w
    ndc_y = (1.0 - v * 2.0) + (jitter_v - 0.5) / h

    right = cam.direction.cross(cam.up)             # wgsl:149
    scale = half_fov_tan(cam.fov)                   # wgsl:151
    direction = (cam.direction + right.scale(ndc_x * cam.aspect * scale)
                 + cam.up.scale(ndc_y * scale)).normalize()
    origin = Vec3(*(c.expand_as(direction.x) for c in cam.position))

    if lens_u is not None:
        r = cam.aperture * 0.5 * sqrt(lens_u)
        theta = TWO_PI * lens_v
        focal = origin + direction.scale(cam.focus_distance)
        origin = (origin + right.scale(r * torch.cos(theta))
                  + cam.up.scale(r * torch.sin(theta)))
        direction = (focal - origin).normalize()
    return origin, direction
