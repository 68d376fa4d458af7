"""Sky light and hybrid depth compositing.

Counterpart of ``bevyray_tpu/kernels/composite.py``: ``background_gradient``
twins raytrace.wgsl:364-369 and ``composite`` the mode dispatch in
``fragment`` (raytrace.wgsl:97-122), with the reverse-Z depth comparison
against a rasterized depth buffer.
"""

from __future__ import annotations

import torch

from ..core.vec import Vec3, sqrt


def background_gradient(direction: Vec3) -> Vec3:
    """RTiOW sky: lerp(white -> (0.5, 0.7, 1.0)) on the unit direction's y."""
    unit = direction.normalize()
    a = 0.5 * (unit.y + 1.0)
    return Vec3(1.0 - a + a * 0.5, 1.0 - a + a * 0.7, 1.0 - a + a * 1.0)


def linear_to_gamma(color: Vec3) -> Vec3:
    """sqrt "gamma" (raytrace.wgsl:226-228)."""
    return Vec3(sqrt(torch.clamp(color.x, min=0.0)),
                sqrt(torch.clamp(color.y, min=0.0)),
                sqrt(torch.clamp(color.z, min=0.0)))


def composite(level: int, rt_color: Vec3, rt_depth: torch.Tensor,
              near, far, raster_color: Vec3, raster_depth) -> Vec3:
    """Mode dispatch (raytrace.wgsl:97-122).

    ``raster_depth`` is reverse-Z like Bevy's depth prepass: 0 at far, 1 at
    near. Raytraced distance t maps to reverse-Z as ``near / t``, and anything
    beyond ``far`` to -1, so the raster layer always wins there.
    """
    if level == 0:   # Skip
        return raster_color
    if level == 3:   # Pure
        return rt_color
    rz = torch.where(rt_depth > far, -1.0, near / rt_depth)
    use_raster = torch.as_tensor(raster_depth, device=rz.device) > rz
    return Vec3.where(use_raster, raster_color, rt_color)
