"""Per-lane hit and material records.

Counterpart of the records in ``bevyray_tpu/kernels/intersect.py``. The
wavefront sphere and triangle intersectors of that module are not ported yet
(ROADMAP §A item 7); the fused path intersects inside its kernel
(:mod:`.cuda.megakernel`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Vec3


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
