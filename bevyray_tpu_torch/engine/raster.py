"""Analytic raster layer: the color and reverse-Z depth buffers that the hybrid
levels blend against, made from the raster-only entities of a ``World``.

Counterpart of ``bevyray_tpu/engine/raster.py``. The reference gets these
buffers from Bevy's rasterizer and depth prepass (main.rs:76-85,
mod.rs:34,108-115, raytrace.wgsl:101-106); here one un-jittered center ray
per pixel is cast against the raster triangles, the nearest wins, and the
depth is Bevy's reverse-Z ``near / view_z`` (0 on a miss, so the raster
layer never wins there).

The reference spawns no lights, so Bevy shades its cube with the default
ambient light alone: ``AmbientLight::default()`` (white, 80 lux) under the
default exposure 1 / (125 * 1.2), with Bevy's ``ambient_light`` term
(the Karis split-sum ``EnvBRDFApprox`` on the diffuse and specular lobes and
Filament's pre-baked specular occlusion; no SSAO). Every operation runs on
the device of the buffers, in torch ops: a set-up per camera, not a kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.constants import INF
from ..core.types import (CameraState, RenderConfig, Triangles,
                          make_triangles_np, resolve_device, upload)
from ..core.vec import Vec3
from ..kernels.intersect import intersect_triangles
from ..kernels.raygen import generate_rays, pixel_uv

# Bevy 0.14's default ambient light (80 lux) under its default exposure
# 1 / (125 * 1.2), the reference app's only light.
_AMBIENT_LUX = 80.0
_EXPOSURE = 1.0 / (125.0 * 1.2)
_AMBIENT = float(np.float32(_AMBIENT_LUX * _EXPOSURE))   # 0.5333...


def _f_ab(perceptual_roughness, no_v):
    """Bevy's ``F_AB`` (bevy_pbr ``pbr_functions``), the Karis mobile
    split-sum environment BRDF: (scale, bias) applied as ``F0 * scale +
    bias``."""
    rx = perceptual_roughness * -1.0 + 1.0
    ry = perceptual_roughness * -0.0275 + 0.0425
    rz = perceptual_roughness * -0.572 + 1.04
    rw = perceptual_roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * no_v)) * rx + ry
    return -1.04 * a004 + rz, 1.04 * a004 + rw


def rasterize_impl(tris: Triangles, tri_colors: torch.Tensor,
                   cam: CameraState, config: RenderConfig,
                   clear_color: Tuple[float, float, float]):
    """(raster color Vec3 [N], raster depth [N]) of the frame, row-major.

    ``tri_colors``: [T, 6] per-triangle linear base color, metallic,
    perceptual roughness and reflectance. The camera's tensors lie on the
    device of ``tris``.
    """
    dev = tris.ax.device
    u, v = pixel_uv(config.width, config.height, device=dev)
    half = torch.full_like(u, 0.5)        # (j - 0.5) / w == 0: the pixel center
    origin, direction = generate_rays(u, v, half, half, cam, config.height)

    t, idx = intersect_triangles(origin, direction, tris)
    hit = t < INF   # the miss sentinel is f32 max, not inf
    safe_idx = torch.clamp(idx, 0, tris.ax.shape[0] - 1)
    safe_t = torch.where(hit, t, 1.0)

    rows = tri_colors[safe_idx]   # hits index live rows; misses row 0
    base = Vec3(rows[:, 0], rows[:, 1], rows[:, 2])
    metallic, rough, refl = rows[:, 3], rows[:, 4], rows[:, 5]

    # The hit triangle's geometric normal; N.V with Bevy's 1e-4 clamp, taken
    # as |N.V| (the face toward the viewer). Center rays are unit length.
    a_c = Vec3(tris.ax[safe_idx], tris.ay[safe_idx], tris.az[safe_idx])
    ab = Vec3(tris.bx[safe_idx], tris.by[safe_idx], tris.bz[safe_idx]) - a_c
    ac = Vec3(tris.cx[safe_idx], tris.cy[safe_idx], tris.cz[safe_idx]) - a_c
    n = ab.cross(ac).normalize()
    no_v = torch.clamp(torch.abs(n.dot(direction)), min=1e-4)

    diffuse = base.scale(1.0 - metallic)
    spec = 0.16 * refl * refl * (1.0 - metallic)
    f0 = base.scale(metallic) + Vec3(spec, spec, spec)
    one = torch.ones((), dtype=torch.float32, device=dev)
    d_scale, d_bias = _f_ab(one, no_v)
    s_scale, s_bias = _f_ab(rough, no_v)
    spec_occ = torch.clamp((f0.x + f0.y + f0.z) * (50.0 * 0.33), 0.0, 1.0)
    shaded = (diffuse.scale(d_scale) + Vec3(d_bias, d_bias, d_bias)
              + (f0.scale(s_scale) + Vec3(s_bias, s_bias, s_bias))
              .scale(spec_occ)).scale(_AMBIENT)
    color = Vec3(*(torch.where(hit, s, c) for s, c in zip(shaded, clear_color)))

    # Reverse-Z depth near / view_z, view_z = t along the camera's forward
    # axis; misses keep the clear depth 0 (infinitely far).
    view_z = safe_t * direction.dot(cam.direction)
    depth = torch.where(hit, cam.near / torch.clamp(view_z, min=1e-20), 0.0)
    return color, depth


def _camera_on(cam: CameraState, device) -> CameraState:
    """``cam`` with every tensor on ``device`` (as ``pack_camera``'s row is
    moved to the scene's device)."""
    return CameraState(*(Vec3(*(c.to(device) for c in f)) if isinstance(f, Vec3)
                         else f.to(device) for f in cam))


def raster_layer(world, cam: CameraState, config: RenderConfig,
                 clear_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 device=None) -> Tuple[Optional[Vec3], Optional[torch.Tensor]]:
    """Raster buffers of ``world`` on ``device`` (None: the CUDA card, see
    :func:`..core.types.resolve_device`), as (color Vec3 [N], depth [N]), or
    ``(None, None)`` when it has no raster entities (the renderers then
    composite over the constant clear color)."""
    data = world.extract_raster_host()
    if data is None:
        return None, None
    device = resolve_device(device)
    va, vb, vc, colors = data
    # The live rows only: padding rows never hit, and the dense test's time
    # goes with the table's rows (the JAX package pads to 128 lanes).
    tris = make_triangles_np(va, vb, vc, np.zeros(va.shape[0], np.int32),
                             capacity=va.shape[0], device=device)
    return rasterize_impl(tris, upload(colors, device),
                          _camera_on(cam, device), config,
                          tuple(float(x) for x in clear_color))
