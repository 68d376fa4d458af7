"""Edge-aware à-trous denoising — a post-process extension beyond the
reference (which displays the raw 4-spp estimate every frame).

Counterpart of ``bevyray_tpu/engine/denoise.py``. The classic à-trous
wavelet filter of real-time path tracers (SVGF-family): a 5×5 B3-spline
kernel applied at doubling strides, with bilateral weights that stop the
filter at color and depth edges. The depth guide is the frame's
``rt_depth`` (raytrace.wgsl's depth output). The 25 taps per iteration are
shifted copies (roll, then the wrapped band overwritten with the nearest
valid row or column: replicate borders).

:func:`atrous_denoise` is a wrapper: on CPU tensors and host arrays it runs
the plain version :func:`atrous_denoise_reference` (torch operators); on
CUDA tensors it launches K7 of ``kernels/cuda/csrc/denoise.cu`` once an
iteration, which gives the same bits, or raises. It never falls back.

Not in the render path unless invoked (CLI ``--denoise N`` or a direct
call); ``iterations=0`` returns the input unchanged.
"""

from __future__ import annotations

import functools

import torch

# B3-spline 1D taps (1/16)·[1 4 6 4 1] — the standard à-trous kernel.
_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge-clamp semantics (replicate border): roll, then overwrite
    the wrapped band with the nearest valid row/column."""
    if dy:
        x = torch.roll(x, dy, dims=0)
        if dy > 0:
            x[:dy] = x[dy:dy + 1]
        else:
            x[dy:] = x[dy - 1:dy]
    if dx:
        x = torch.roll(x, dx, dims=1)
        if dx > 0:
            x[:, :dx] = x[:, dx:dx + 1]
        else:
            x[:, dx:] = x[:, dx - 1:dx]
    return x


def atrous_denoise_reference(image, depth, *, iterations: int = 3,
                             sigma_color: float = 0.25,
                             sigma_depth: float = 0.5):
    """The plain version of :func:`atrous_denoise`: denoise ``image``
    [H, W, 3] guided by ``depth`` [H, W] (tensors, or arrays taken as CPU
    tensors) in torch operators, on the device of the image.

    ``sigma_color`` is in gamma-space color units; ``sigma_depth`` in world
    units, scaled by the iteration's stride so coarse passes tolerate the
    depth gradient across smooth surfaces. Misses (depth beyond the far
    fallback) form their own edge region, so the sky never bleeds into
    silhouettes. An iteration whose taps would reach past the image (``2 *
    stride >= min(H, W)``) ends the filter.
    """
    if iterations <= 0:
        return image
    img = torch.as_tensor(image, dtype=torch.float32)
    z = torch.as_tensor(depth, dtype=torch.float32, device=img.device)
    inv_2sc2 = 1.0 / (2.0 * sigma_color * sigma_color)

    for it in range(iterations):
        stride = 1 << it
        if 2 * stride >= min(img.shape[0], img.shape[1]):
            break   # taps would reach past the image — coarser passes are moot
        sz = sigma_depth * stride
        inv_2sz2 = 1.0 / (2.0 * sz * sz)
        acc = torch.zeros_like(img)
        wsum = torch.zeros_like(z)
        for iy, ty in enumerate(_TAPS):
            for ix, tx in enumerate(_TAPS):
                dy, dx = (iy - 2) * stride, (ix - 2) * stride
                cq = _shift2d(img, dy, dx)
                zq = _shift2d(z, dy, dx)
                # JAX's sum over the channels, in the order (d0 + d1) + d2.
                sq = (img - cq) ** 2
                dc2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
                dz2 = (z - zq) ** 2
                w = (ty * tx) * torch.exp(-(dc2 * inv_2sc2 + dz2 * inv_2sz2))
                acc = acc + cq * w[..., None]
                wsum = wsum + w
        img = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return img


def _iteration_scalars(sigma_color: float, sigma_depth: float, stride: int):
    """1 / (2 sigma^2) of colour and of depth at ``stride``, in double as
    the plain version computes them (K7 rounds each to float32, as torch
    rounds a Python float)."""
    sz = sigma_depth * stride
    return (1.0 / (2.0 * sigma_color * sigma_color), 1.0 / (2.0 * sz * sz))


def check_kernel_args(image: torch.Tensor, depth: torch.Tensor) -> None:
    """Raise unless ``image`` [H, W, 3] and ``depth`` [H, W] are contiguous
    float32 tensors on one device: what K7 takes."""
    if not isinstance(depth, torch.Tensor) or depth.device != image.device:
        raise ValueError("atrous_denoise: depth must be a tensor on the "
                         f"image's device {image.device}")
    if image.dtype != torch.float32 or depth.dtype != torch.float32:
        raise ValueError("atrous_denoise: image and depth must be float32, "
                         f"not {image.dtype} and {depth.dtype}")
    if (image.dim() != 3 or image.shape[2] != 3 or depth.dim() != 2
            or tuple(depth.shape) != tuple(image.shape[:2])):
        raise ValueError("atrous_denoise: image must be [H, W, 3] and depth "
                         f"[H, W], not {tuple(image.shape)} and "
                         f"{tuple(depth.shape)}")
    if not (image.is_contiguous() and depth.is_contiguous()):
        raise ValueError("atrous_denoise: image and depth must be "
                         "contiguous")


def atrous_denoise(image, depth, *, iterations: int = 3,
                   sigma_color: float = 0.25, sigma_depth: float = 0.5):
    """Denoise ``image`` [H, W, 3] guided by ``depth`` [H, W]: the values of
    :func:`atrous_denoise_reference`.

    On CPU tensors and host arrays this runs the plain version. On CUDA
    tensors (contiguous float32, on one card: :func:`check_kernel_args`) it
    launches K7 of ``kernels/cuda/csrc/denoise.cu`` once for each
    iteration that the stride rule lets run, ping-ponging two fresh
    buffers, or raises; it never falls back and never waits for the card.
    ``iterations <= 0``, or a frame too small for one iteration, returns
    ``image`` itself. ``atrous_denoise.launches`` counts the launches.
    """
    if not isinstance(image, torch.Tensor) or image.device.type == "cpu":
        return atrous_denoise_reference(image, depth, iterations=iterations,
                                        sigma_color=sigma_color,
                                        sigma_depth=sigma_depth)
    if image.device.type != "cuda":
        raise ValueError("atrous_denoise takes CPU or CUDA tensors, not "
                         f"{image.device}")
    if iterations <= 0:
        return image
    check_kernel_args(image, depth)
    strides = []
    for it in range(iterations):
        if 2 * (1 << it) >= min(image.shape[0], image.shape[1]):
            break   # the stride rule ends the filter
        strides.append(1 << it)
    if not strides:
        return image
    from ..kernels.cuda.build import extension

    ext = extension()
    bufs = [torch.empty_like(image) for _ in range(min(len(strides), 2))]
    img = image
    for k, stride in enumerate(strides):
        ext.atrous_pass(img, depth, bufs[k % 2], stride,
                        *_iteration_scalars(sigma_color, sigma_depth, stride))
        atrous_denoise.launches += 1
        img = bufs[k % 2]
    return img


atrous_denoise.launches = 0


@functools.lru_cache(maxsize=8)
def jitted_denoise(iterations: int, sigma_color: float, sigma_depth: float):
    """:func:`atrous_denoise` with its settings bound: the dispatching
    wrapper, which on the card runs K7 (the JAX package's factory jits the
    filter)."""
    return functools.partial(atrous_denoise, iterations=iterations,
                             sigma_color=sigma_color, sigma_depth=sigma_depth)
