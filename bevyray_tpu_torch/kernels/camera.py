"""The camera row: a frame's camera scalars, once a frame, for every kernel.

Counterpart of the camera part of the JAX package's jitted frame programs:
``_pack_camera`` (bevyray_tpu/kernels/pallas/megakernel.py:2722-2738), the
fused kernel's uniform row, and the camera terms of ``generate_rays``
(kernels/raygen.py:53-57), which XLA folds into each program. Two layouts:

- the fused row (``N_CAM`` floats, slots ``C_*``): position, direction, up,
  right = direction x up, tan(fov / 2), aspect, near, far, the frame's
  width, height and pixel count, aperture and focus distance;
- the wavefront row (``CAM_FLOATS`` floats, slots ``CAM_*``), read by K5,
  K6 and the raster layer: the same vectors and tangent, aspect, the
  frame's height and height * aspect, aperture, focus distance, and the
  miss depth, ``far + 10`` at level 1 and ``far - 1`` otherwise
  (wgsl:177-182).

:func:`camera_rows` is the wrapper: on CPU tensors it runs the plain version
:func:`camera_rows_reference`; on CUDA tensors it launches K12 of
``cuda/csrc/camera.cu`` once, which gives the same bits, or raises. It never
falls back. ``camera_rows.launches`` counts the launches.

The tangent is :func:`half_fov_tan`, the one helper every path calls. XLA
on the CPU lowers ``tan`` to the C library's ``tanf``, so on CPU tensors
the helper calls that ``tanf`` (ctypes), which gives XLA's bits on any
host. On the card K12 and the helper run :func:`glibc_tanf`, a port of
glibc 2.36's ``tanf`` (sysdeps/ieee754/flt-32/s_tanf.c and k_tanf.c): the
reduction by pi/2 in float64 and the float32 polynomial, operation for
operation. That ``tanf`` is fdlibm's float kernel and not correctly
rounded (about 4% of float32 inputs in (0, 1.5] are 1 ulp off the rounded
float64 tangent); glibc 2.41 and later round correctly, so on such a host
the CPU and the card may differ by that ulp.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import struct
from typing import NamedTuple, Optional

import torch

from ..core.types import CameraState, RenderConfig, camera_leaves

# Slots of the fused kernel's camera row (the JAX kernel's; csrc/camera.h).
(C_POS_X, C_POS_Y, C_POS_Z, C_DIR_X, C_DIR_Y, C_DIR_Z, C_UP_X, C_UP_Y, C_UP_Z,
 C_RIGHT_X, C_RIGHT_Y, C_RIGHT_Z, C_SCALE, C_ASPECT, C_NEAR, C_FAR,
 C_WIDTH, C_HEIGHT, C_NPIX, C_APERTURE, C_FOCUS) = range(21)
N_CAM = 24

# Slots of the wavefront camera row (csrc/bounce.h CAM_*).
(CAM_POS, CAM_DIR, CAM_UP, CAM_RIGHT) = (0, 3, 6, 9)
CAM_SCALE, CAM_ASPECT, CAM_HEIGHT, CAM_WIDTH = 12, 13, 14, 15
CAM_APERTURE, CAM_FOCUS, CAM_FALLBACK = 16, 17, 18
CAM_FLOATS = 19


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# glibc's tanf: the reduction's 2^24 * 2/pi and pi/2 (float64), pi/4 in two
# float32 parts, and the kernel's odd polynomial T0..T12 (k_tanf.c).
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_PIO4, _PIO4LO = _f32(0x3F490FDA), _f32(0x33222168)
_T = [_f32(b) for b in (
    0x3EAAAAAB, 0x3E088889, 0x3D5D0DD1, 0x3CB327A4, 0x3C11371F, 0x3B6B6916,
    0x3ABEDE48, 0x3A1A26C8, 0x398137B9, 0x38A3F445, 0x3895C07A, 0xB79BAE5F,
    0x37D95384)]


def _masked(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the low 12 bits of its float32 word cleared."""
    return (x.view(torch.int32) & -4096).view(torch.float32)


def _kernel_tanf(x: torch.Tensor, y: torch.Tensor,
                 iy: torch.Tensor) -> torch.Tensor:
    """glibc's ``__kernel_tanf(x, y, iy)``: tan(x + y) for ``iy`` 1 and
    -1 / tan(x + y) for ``iy`` -1, |x| <= pi/4, in float32."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    sign = torch.where(hx < 0, -1.0, 1.0)
    fy = iy.to(torch.float32)
    # |x| >= 0.6744: tan(pi/4 - |x|) and the identity below.
    big = ix > 0x3F2CA13F
    xa, ya = x * sign, y * sign
    xr = (_PIO4LO - ya) + (_PIO4 - xa)
    x = torch.where(big, xr, x)
    y = torch.where(big, 0.0, y)
    z = x * x
    w = z * z
    r, v = _T[11] * w, _T[12] * w
    for k in (9, 7, 5, 3):
        r = (r + _T[k]) * w
    for k in (10, 8, 6, 4):
        v = (v + _T[k]) * w
    r = r + _T[1]
    v = (v + _T[2]) * z
    s = z * x
    r = y + z * (s * (r + v) + y)
    r = r + _T[0] * s
    w = x + r
    u = x - (w * w / (w + fy) - r)
    out_big = sign * (fy - (u + u))
    # iy -1: -1 / (x + r), from a 12-bit split of each factor.
    zt = _masked(w)
    vv = r - (zt - x)
    a = -1.0 / w
    t = _masked(a)
    out_inv = t + a * ((1.0 + t * zt) + t * vv)
    out = torch.where(big, out_big, torch.where(iy == 1, w, out_inv))
    # |x| < 2^-13, before or after the reflection.
    tiny = ix < 0x39000000
    out_tiny = torch.where(iy == 1, x,
                           torch.where(ix == 0, 1.0 / torch.abs(x), -1.0 / x))
    tiny_big = big & (torch.abs(xr) < 2.0 ** -13)
    out_tiny_big = (sign * fy) * (1.0 - (fy + fy) * xr)
    return torch.where(tiny, out_tiny, torch.where(tiny_big, out_tiny_big, out))


def glibc_tanf(x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's ``tanf`` of float32 ``x``, step for step, elementwise on
    any device (K12's ``glibc_tanf`` in C). NaN for |x| of 119.5 or more
    (glibc's large-argument reduction is not ported)."""
    x = x.to(torch.float32)
    ix = x.view(torch.int32) & 0x7FFFFFFF
    xd = x.double()
    n = ((xd * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = xd - n.double() * _HPI
    y0 = xr.float()
    y1 = (xr - y0.double()).float()
    small = ix <= 0x3F490FDA
    out = _kernel_tanf(torch.where(small, x, y0),
                       torch.where(small, 0.0, y1),
                       torch.where(small, 1, 1 - ((n & 1) << 1)))
    return torch.where(ix < 0x42F00000, out, float("nan"))


@functools.lru_cache(maxsize=None)
def _c_tanf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.tanf.restype, lib.tanf.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib.tanf


def libm_tanf(x: torch.Tensor) -> torch.Tensor:
    """The C library's ``tanf`` of each element of CPU float32 ``x``."""
    tanf = _c_tanf()
    x = x.to(torch.float32)
    return torch.tensor([tanf(v) for v in x.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(x.shape)


def half_fov_tan(fov: torch.Tensor) -> torch.Tensor:
    """``tan(fov * 0.5)`` in float32, the camera's scale: ``fov * 0.5`` in
    float32, then the C library's ``tanf`` of it on the CPU (XLA's ``tan``
    there) and :func:`glibc_tanf` on any other device (K12's)."""
    x = fov.to(torch.float32) * 0.5
    return libm_tanf(x) if x.device.type == "cpu" else glibc_tanf(x)


class CameraRows(NamedTuple):
    fused: Optional[torch.Tensor]       # [N_CAM] f32, or None
    wavefront: Optional[torch.Tensor]   # [CAM_FLOATS] f32, or None


def camera_rows_reference(cam: CameraState, config: RenderConfig,
                          fused: bool = True,
                          wavefront: bool = False) -> CameraRows:
    """The plain version of :func:`camera_rows`: each entry by torch on the
    camera's device, as the JAX programs compute it."""
    dev = cam.fov.device

    def f32(v):
        return (v.to(dtype=torch.float32, device=dev).reshape(())
                if isinstance(v, torch.Tensor)
                else torch.full((), float(v), dtype=torch.float32,
                                device=dev))

    right = cam.direction.cross(cam.up)   # wgsl:149
    scale = half_fov_tan(cam.fov)          # wgsl:151
    vecs = (*cam.position, *cam.direction, *cam.up, *right)
    row = None
    if fused:
        entries = dict(enumerate(vecs))
        entries.update({
            C_SCALE: scale, C_ASPECT: cam.aspect, C_NEAR: cam.near,
            C_FAR: cam.far, C_WIDTH: config.width, C_HEIGHT: config.height,
            C_NPIX: config.n_pixels, C_APERTURE: cam.aperture,
            C_FOCUS: cam.focus_distance})
        row = torch.stack([f32(entries.get(k, 0.0)) for k in range(N_CAM)])
    wave = None
    if wavefront:
        h = f32(config.height)
        fallback = cam.far + 10.0 if config.level == 1 else cam.far - 1.0
        wave = torch.stack([f32(p) for p in (
            *vecs, scale, cam.aspect, h, h * cam.aspect, cam.aperture,
            cam.focus_distance, fallback)])
    return CameraRows(row, wave)


def check_camera_args(cam: CameraState, config: RenderConfig) -> None:
    """Raise ValueError unless K12 takes this camera: fifteen float32
    tensors of one value each on one CUDA device, and a frame of at least
    one pixel."""
    leaves = camera_leaves(cam)
    dev = cam.fov.device
    for v in leaves:
        if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32
                and v.device == dev and v.numel() == 1):
            raise ValueError(f"camera_rows: every camera value must be one "
                             f"float32 on {dev}")
    if config.n_pixels < 1:
        raise ValueError("camera_rows: the frame must have a pixel")


def camera_rows(cam: CameraState, config: RenderConfig, fused: bool = True,
                wavefront: bool = False) -> CameraRows:
    """The fused row (``fused``) and the wavefront row (``wavefront``) of
    ``cam`` for ``config``'s frame, on the camera's device.

    On CPU tensors this runs :func:`camera_rows_reference`; on CUDA tensors
    it launches K12 of ``cuda/csrc/camera.cu`` once (one thread block,
    reading the camera's values on the card) or raises
    (:func:`check_camera_args`). ``camera_rows.launches`` counts the
    launches.
    """
    dev = cam.fov.device
    if dev.type == "cpu":
        return camera_rows_reference(cam, config, fused, wavefront)
    if dev.type != "cuda":
        raise ValueError(f"camera_rows takes CPU or CUDA tensors, not {dev}")
    check_camera_args(cam, config)
    from .cuda.build import extension

    row = (torch.empty(N_CAM, dtype=torch.float32, device=dev) if fused
           else None)
    wave = (torch.empty(CAM_FLOATS, dtype=torch.float32, device=dev)
            if wavefront else None)
    empty = torch.empty(0, dtype=torch.float32, device=dev)
    extension().camera_rows(
        list(camera_leaves(cam)), empty if row is None else row,
        empty if wave is None else wave, float(config.width),
        float(config.height), float(config.n_pixels), config.level == 1)
    camera_rows.launches += 1
    return CameraRows(row, wave)


camera_rows.launches = 0
