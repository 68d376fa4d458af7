"""Material scattering — batched twin of ``scatter`` (raytrace.wgsl:231-299).

Counterpart of ``bevyray_tpu/kernels/shade.py``. All three branches are
computed for every lane and the result is selected by mask. The reference's
quirks are kept: the metal direction is not re-normalized (wgsl:238), the
diffuse lobe gets an extra ``roughness * ball()`` term (wgsl:285), ``ball()``
samples lie *in* the unit sphere, a dielectric is never absorbed (wgsl:280),
and metal or diffuse rays below the surface are absorbed (wgsl:245, 296).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import NEAR_ZERO
from ..core.vec import Vec3, reflect, refract, schlick_reflectance, sqrt
from .intersect import HitInfo, MaterialLanes


class ScatterResult(NamedTuple):
    direction: Vec3          # new ray direction (origin is hit.position)
    attenuation: Vec3
    absorbed: torch.Tensor   # bool


def scatter(direction: Vec3, hit: HitInfo, mat: MaterialLanes,
            u_metal, u_trans, u_reflect, ball1: Vec3, ball2: Vec3,
            diffuse_mode: str = "reference") -> ScatterResult:
    """One scatter event for a batch of rays.

    ``u_*`` are uniform draws and ``ball1``/``ball2`` unit-ball samples, from
    the fixed draw slots of :mod:`..engine.slots`. ``diffuse_mode``:
    "reference" is the reference's lobe; "cosine" is textbook cosine sampling
    (normal + on-sphere unit vector).
    """
    n = hit.normal

    # --- metal branch (wgsl:234-245) -----------------------------------------
    metal_dir = reflect(direction, n).normalize() + ball1.scale(mat.roughness)
    metal_absorbed = metal_dir.dot(n) < 0.0

    # --- dielectric branch (wgsl:249-280) -------------------------------------
    unit = direction.normalize()
    ri = torch.where(hit.front_face, 1.0 / mat.ior, mat.ior)
    cos_theta = torch.clamp((-unit).dot(n), max=1.0)
    sin_theta = sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = ri * sin_theta > 1.0
    use_reflect = cannot_refract | (schlick_reflectance(cos_theta, ri)
                                    > u_reflect)
    dielectric_dir = Vec3.where(use_reflect, reflect(unit, n),
                                refract(unit, n, ri))

    # --- diffuse branch (wgsl:282-297) -----------------------------------------
    if diffuse_mode == "cosine":
        diffuse_dir = n + ball1.normalize()
    else:
        diffuse_dir = n + ball1 + ball2.scale(mat.roughness)
    near_zero = ((torch.abs(diffuse_dir.x) < NEAR_ZERO)
                 & (torch.abs(diffuse_dir.y) < NEAR_ZERO)
                 & (torch.abs(diffuse_dir.z) < NEAR_ZERO))
    diffuse_dir = Vec3.where(near_zero, n, diffuse_dir)
    diffuse_absorbed = diffuse_dir.dot(n) < 0.0

    # --- stochastic branch select (wgsl:234, 249) -------------------------------
    is_metal = u_metal < mat.metallic
    is_trans = (~is_metal) & (u_trans < mat.specular_transmission)

    out_dir = Vec3.where(is_metal, metal_dir,
                         Vec3.where(is_trans, dielectric_dir, diffuse_dir))
    one = torch.ones_like(u_metal)
    attenuation = Vec3.where(is_trans, Vec3(one, one, one), mat.base_color)
    absorbed = ((is_metal & metal_absorbed)
                | (~is_metal & ~is_trans & diffuse_absorbed))
    return ScatterResult(direction=out_dir, attenuation=attenuation,
                         absorbed=absorbed)
