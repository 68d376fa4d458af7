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
Filament's pre-baked specular occlusion; no SSAO).

:func:`rasterize_impl` is a wrapper: on CPU tensors it runs the plain
version :func:`rasterize_impl_reference` (torch operators: the centre rays
of :func:`raster_rays_reference`, the triangle test, the shade of
:func:`raster_shade_reference`); on CUDA tensors it launches K8
(:func:`raster_rays`), the dense triangle test K2 and K9
(:func:`raster_shade`), of ``kernels/cuda/csrc/raster.cu`` and
``wavefront.cu``, which give the same bits, or raises. It never falls back
and never waits for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.constants import INF
from ..core.types import (CameraState, RenderConfig, Triangles,
                          camera_leaves, make_triangles_np, resolve_device,
                          upload)
from ..core.vec import Vec3
from ..kernels.camera import camera_rows
from ..kernels.cuda.wavefront import triangle_columns
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


def raster_rays_reference(cam: CameraState, config: RenderConfig,
                          device) -> Tuple[Vec3, Vec3]:
    """The plain version of :func:`raster_rays`: the centre ray of every
    pixel, row-major, as (origin, unit direction)."""
    u, v = pixel_uv(config.width, config.height, device=device)
    half = torch.full_like(u, 0.5)        # (j - 0.5) / w == 0: the pixel center
    return generate_rays(u, v, half, half, cam, config.height)


def raster_shade_reference(t: torch.Tensor, idx: torch.Tensor,
                           direction: Vec3, tris: Triangles,
                           tri_colors: torch.Tensor, cam: CameraState,
                           clear_color: Tuple[float, float, float]):
    """The plain version of :func:`raster_shade`: (color Vec3, depth) of
    each ray from the triangle test's ``t``/``idx`` and its direction."""
    dev = tris.ax.device
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


def rasterize_impl_reference(tris: Triangles, tri_colors: torch.Tensor,
                             cam: CameraState, config: RenderConfig,
                             clear_color: Tuple[float, float, float]):
    """The plain version of :func:`rasterize_impl`: the centre rays, the
    triangle test and the shade in torch operators (the triangle test
    through its wrapper)."""
    origin, direction = raster_rays_reference(cam, config, tris.ax.device)
    t, idx = intersect_triangles(origin, direction, tris)
    return raster_shade_reference(t, idx, direction, tris, tri_colors, cam,
                                  clear_color)


def check_kernel_args(tris: Triangles, tri_colors: torch.Tensor,
                      cam: CameraState) -> None:
    """Raise unless the triangle corners are float32 columns of one length,
    ``tri_colors`` a contiguous float32 [T, 6] table and the camera's
    tensors float32, all on the device of ``tris``: what K8, K2 and K9
    take."""
    dev = tris.ax.device
    corners = triangle_columns(tris)[:9]
    n = tris.ax.shape[0]
    if n < 1 or any(c.device != dev or c.dtype != torch.float32
                    or tuple(c.shape) != (n,) for c in corners):
        raise ValueError("rasterize_impl: the triangle corners must be "
                         f"float32 columns of one length > 0 on {dev}")
    if (not isinstance(tri_colors, torch.Tensor) or tri_colors.device != dev
            or tri_colors.dtype != torch.float32
            or tuple(tri_colors.shape) != (n, 6)
            or not tri_colors.is_contiguous()):
        raise ValueError("rasterize_impl: tri_colors must be a contiguous "
                         f"float32 [{n}, 6] tensor on {dev}")
    if any(c.device != dev or c.dtype != torch.float32 or c.numel() != 1
           for c in camera_leaves(cam)):
        raise ValueError("rasterize_impl: the camera's values must be "
                         f"float32 scalars on {dev}")


def raster_rays(camera: torch.Tensor,
                config: RenderConfig) -> Tuple[Vec3, Vec3]:
    """Launch K8 of ``kernels/cuda/csrc/raster.cu``: the values of
    :func:`raster_rays_reference`, from ``camera``, the wavefront camera row of
    :func:`..kernels.camera.camera_rows` on the card. CUDA tensors only;
    ``raster_rays.launches`` counts the launches."""
    dev = camera.device
    _check_cuda(dev, "raster_rays")
    from ..kernels.cuda.build import extension

    rays = torch.empty((6, config.width * config.height), dtype=torch.float32,
                       device=dev)
    extension().raster_rays(camera, list(rays), config.width, config.height)
    raster_rays.launches += 1
    return Vec3(*rays[:3]), Vec3(*rays[3:])


def raster_shade(t: torch.Tensor, idx: torch.Tensor, direction: Vec3,
                 tris: Triangles, tri_colors: torch.Tensor,
                 camera: torch.Tensor, near: torch.Tensor,
                 clear_color: Tuple[float, float, float]):
    """Launch K9 of ``kernels/cuda/csrc/raster.cu``: the values of
    :func:`raster_shade_reference`, the camera's direction read from
    ``camera`` (:func:`..kernels.camera.camera_rows`) and ``near`` a 0-d
    tensor on the card. CUDA tensors only; ``raster_shade.launches``
    counts the launches."""
    dev = t.device
    _check_cuda(dev, "raster_shade")
    from ..kernels.cuda.build import extension

    out = torch.empty((4, t.shape[0]), dtype=torch.float32, device=dev)
    extension().raster_shade(
        t, idx, list(direction), triangle_columns(tris)[:9], tri_colors,
        camera, near, [float(c) for c in clear_color], _AMBIENT, list(out))
    raster_shade.launches += 1
    return Vec3(out[0], out[1], out[2]), out[3]


def rasterize_impl(tris: Triangles, tri_colors: torch.Tensor,
                   cam: CameraState, config: RenderConfig,
                   clear_color: Tuple[float, float, float]):
    """(raster color Vec3 [N], raster depth [N]) of the frame, row-major:
    the values of :func:`rasterize_impl_reference`.

    ``tri_colors``: [T, 6] per-triangle linear base color, metallic,
    perceptual roughness and reflectance. The camera's tensors lie on the
    device of ``tris``. On CPU tensors this runs the plain version; on CUDA
    tensors (:func:`check_kernel_args`) it launches K8, K2 (unmasked, over
    the whole table) and K9 once each, or raises.
    """
    dev = tris.ax.device
    if dev.type == "cpu":
        return rasterize_impl_reference(tris, tri_colors, cam, config,
                                        clear_color)
    _check_cuda(dev, "rasterize_impl")
    check_kernel_args(tris, tri_colors, cam)
    camera = camera_rows(cam, config, fused=False, wavefront=True).wavefront
    origin, direction = raster_rays(camera, config)
    t, idx = intersect_triangles(origin, direction, tris)
    return raster_shade(t, idx, direction, tris, tri_colors, camera,
                        cam.near, clear_color)


raster_rays.launches = 0
raster_shade.launches = 0


def _check_cuda(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {dev}")


def _camera_on(cam: CameraState, device) -> CameraState:
    """``cam`` with every tensor on ``device`` (as the fused camera row is
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
