"""Edge-aware à-trous denoising — a post-process extension beyond the
reference (which displays the raw 4-spp estimate every frame).

Counterpart of ``bevyray_tpu/engine/denoise.py`` in torch operators, on the
device of the image. The classic à-trous wavelet filter of real-time path
tracers (SVGF-family): a 5×5 B3-spline kernel applied at doubling strides,
with bilateral weights that stop the filter at color and depth edges. The
depth guide is the frame's ``rt_depth`` (raytrace.wgsl's depth output). The
25 taps per iteration are shifted copies (roll, then the wrapped band
overwritten with the nearest valid row or column: replicate borders).

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


def atrous_denoise(image, depth, *, iterations: int = 3,
                   sigma_color: float = 0.25, sigma_depth: float = 0.5):
    """Denoise ``image`` [H, W, 3] guided by ``depth`` [H, W] (tensors, or
    arrays taken as CPU tensors).

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
                dc2 = torch.sum((img - cq) ** 2, dim=-1)
                dz2 = (z - zq) ** 2
                w = (ty * tx) * torch.exp(-(dc2 * inv_2sc2 + dz2 * inv_2sz2))
                acc = acc + cq * w[..., None]
                wsum = wsum + w
        img = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return img


@functools.lru_cache(maxsize=8)
def jitted_denoise(iterations: int, sigma_color: float, sigma_depth: float):
    """:func:`atrous_denoise` with its settings bound (the JAX package's
    factory jits it; here it is the plain function)."""
    return functools.partial(atrous_denoise, iterations=iterations,
                             sigma_color=sigma_color, sigma_depth=sigma_depth)
