"""The frame's tail and the fused film pass's fold.

Counterpart of the tails of the JAX package's jitted frame programs: the
mean of a frame's sums, ``composite`` over the raster layer at the frame's
level and the [H, W, 3] image, as ``render_impl``
(bevyray_tpu/engine/renderer.py:242-252), ``pallas_render_impl``
(engine/pallas_renderer.py:36-45, after ``unshuffle_blocks``,
kernels/pallas/megakernel.py:2746) and ``resolve_impl``
(engine/film.py:98-112) end; and of ``pallas_accumulate_impl``'s fold of a
fused pass into the film (engine/film.py:127-145).

:func:`resolve_frame` and :func:`fold_pass` are wrappers: on CPU tensors
they run the plain versions :func:`resolve_frame_reference` and
:func:`fold_pass_reference` (the JAX code's operations in its order, with
torch's own operators); on CUDA tensors they launch K10 and K11 of
``cuda/csrc/frame.cu``, which give the same bits, or raise. They never
fall back. Their ``.launches`` count the kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import RenderConfig
from ..core.vec import Vec3
from .composite import composite
from .cuda.megakernel import TILE, block_grid, unshuffle_blocks


def _pixels(color: Vec3, n: int) -> torch.Tensor:
    """[n, 3] from a Vec3 whose components broadcast to [n]."""
    return torch.stack([torch.broadcast_to(c, (n,)) for c in color], dim=-1)


def resolve_frame_reference(config: RenderConfig, near: torch.Tensor,
                            far: torch.Tensor, sums, scale=None,
                            raster_color: Optional[Vec3] = None,
                            raster_depth=None, blocks: bool = False):
    """The plain version of :func:`resolve_frame`: ``unshuffle_blocks``
    where ``blocks``, the sums times ``scale``, :func:`.composite.composite`
    and the image, in the JAX tails' operations."""
    r, g, b, depth = sums
    if blocks:
        r, g, b, depth = (unshuffle_blocks(x, config) for x in sums)
    color = Vec3(r, g, b)
    if isinstance(scale, torch.Tensor):
        scale = 1.0 / torch.clamp(scale, min=1.0)
    if scale is not None:
        color, depth = color.scale(scale), depth * scale
    dev = depth.device
    if raster_color is None:
        raster_color = Vec3.splat(1.0, device=dev)
    if raster_depth is None:
        raster_depth = torch.zeros((), dtype=torch.float32, device=dev)
    out = composite(config.level, color, depth, near.to(dev), far.to(dev),
                    raster_color, raster_depth)
    h, w = config.height, config.width
    return _pixels(out, h * w).reshape(h, w, 3), depth.reshape(h, w)


def _lanes(config: RenderConfig, blocks: bool) -> int:
    """The lanes a frame's sums hold at least: its pixels, or its block
    grid's lanes."""
    if not blocks:
        return config.n_pixels
    nbx, nby = block_grid(config)
    return nbx * nby * TILE


def _f32_columns(name: str, cols, numel, dev) -> None:
    """Raise unless each of ``cols`` is a contiguous float32 tensor on
    ``dev`` holding ``numel`` values (a number) or one of ``numel`` (a
    tuple)."""
    sizes = numel if isinstance(numel, tuple) else (numel,)
    for c in cols:
        if not (isinstance(c, torch.Tensor) and c.dtype == torch.float32
                and c.device == dev and c.is_contiguous()
                and c.numel() in sizes and (c.numel() == 1 or c.dim() == 1)):
            raise ValueError(
                f"{name}: every column must be a contiguous float32 tensor on "
                f"{dev} of {' or '.join(map(str, sizes))} values (one a "
                "pixel: one dimension)")


def check_resolve_args(config: RenderConfig, sums, scale=None,
                       raster_color: Optional[Vec3] = None, raster_depth=None,
                       blocks: bool = False) -> None:
    """Raise ValueError unless K10 takes these arguments: four float32
    sums of the frame's pixels (or, where ``blocks``, of the lanes of a
    shard grid covering its block grid, all of one length), a float or
    one float32 count a frame or one a pixel for ``scale``, and raster
    columns of one value or one a pixel."""
    if len(sums) != 4:
        raise ValueError("resolve_frame: the sums must be r, g, b, depth")
    dev = sums[3].device
    n = config.n_pixels
    need = _lanes(config, blocks)
    size = sums[3].numel() if blocks else n
    if size < need:
        raise ValueError(f"resolve_frame: the sums must be r, g, b, depth "
                         f"of at least {need} lanes")
    _f32_columns("resolve_frame sums", sums, size, dev)
    if isinstance(scale, torch.Tensor):
        _f32_columns("resolve_frame count", [scale], (1, n), dev)
    elif scale is not None and not isinstance(scale, float):
        raise ValueError("resolve_frame: scale must be a float, a count "
                         "tensor or None")
    if raster_color is not None:
        _f32_columns("resolve_frame raster colour", raster_color, (1, n),
                     dev)
    if raster_depth is not None:
        _f32_columns("resolve_frame raster depth", [raster_depth], (1, n),
                     dev)


def resolve_frame(config: RenderConfig, near: torch.Tensor,
                  far: torch.Tensor, sums, scale=None,
                  raster_color: Optional[Vec3] = None, raster_depth=None,
                  blocks: bool = False):
    """A frame's sums as its ``(image [H, W, 3], depth [H, W])``.

    ``sums``: r, g, b and depth, row-major ``[H*W]`` or, where ``blocks``,
    in the fused kernel's block order (``render_tiles``' lanes, or the
    shards' joined; padding lanes are never read). ``scale``: None (the
    sums are means already), a float (``np.float32(1 / spp)``, rounded by
    the caller) that multiplies them, or a count tensor (one a frame, 0-d,
    or one a pixel, ``[H*W]``) whose ``1 / max(n, 1)`` does. Composited at
    ``config.level`` over the raster layer (``raster_color``: a Vec3 of
    0-d or ``[H*W]`` columns, white when None; ``raster_depth``: reverse-Z,
    0-d or ``[H*W]``, 0 when None) with the camera's ``near`` and ``far``
    (0-d tensors): level 0 the raster colour, 3 the traced colour, 1-2 the
    raster layer where its depth lies past ``near / t`` (-1 past ``far``).
    A raster layer given in another dtype is taken as float32, as the JAX
    package holds it.

    On CPU tensors this runs :func:`resolve_frame_reference`; on CUDA
    tensors it launches K10 of ``cuda/csrc/frame.cu`` once, reading
    ``near``, ``far`` and the counts on the card, or raises
    (:func:`check_resolve_args`). ``resolve_frame.launches`` counts the
    launches.
    """
    dev = sums[3].device
    if raster_color is not None:
        raster_color = Vec3(*(torch.as_tensor(c, dtype=torch.float32,
                                              device=dev)
                              for c in raster_color))
    if raster_depth is not None:
        raster_depth = torch.as_tensor(raster_depth, dtype=torch.float32,
                                       device=dev)
    if dev.type == "cpu":
        return resolve_frame_reference(config, near, far, sums, scale,
                                       raster_color, raster_depth, blocks)
    _check_cuda(dev, "resolve_frame")
    check_resolve_args(config, sums, scale, raster_color, raster_depth,
                       blocks)
    from .cuda.build import extension

    h, w = config.height, config.width
    image = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    empty = torch.empty(0, dtype=torch.float32, device=dev)
    count = scale if isinstance(scale, torch.Tensor) else empty
    extension().resolve_frame(
        list(sums), block_grid(config)[0] if blocks else 0,
        isinstance(scale, float), scale if isinstance(scale, float) else 0.0,
        count, config.level, near.to(dev), far.to(dev),
        [] if raster_color is None else list(raster_color),
        empty if raster_depth is None else raster_depth, image, depth, w, h)
    resolve_frame.launches += 1
    return image, depth


def fold_pass_reference(color_sum: Vec3, depth_sum: torch.Tensor,
                        n_samples: torch.Tensor, rays_traced: torch.Tensor,
                        pass_sums, segments: torch.Tensor,
                        config: RenderConfig):
    """The plain version of :func:`fold_pass`: ``unshuffle_blocks`` of the
    pass's sums and the film's four adds, its count and its total."""
    r, g, b, depth = (unshuffle_blocks(x, config) for x in pass_sums)
    return (color_sum + Vec3(r, g, b), depth_sum + depth,
            n_samples + config.samples_per_pixel, rays_traced + segments)


def check_fold_args(color_sum: Vec3, depth_sum: torch.Tensor,
                    n_samples: torch.Tensor, rays_traced: torch.Tensor,
                    pass_sums, segments: torch.Tensor,
                    config: RenderConfig) -> None:
    """Raise ValueError unless K11 takes these arguments: the film's four
    float32 sums of the frame's pixels, one float32 count, the pass's four
    block-ordered float32 sums over the block grid and one int64 total
    each for the film and the pass."""
    if len(pass_sums) != 4:
        raise ValueError("fold_pass: the pass's sums must be r, g, b, depth")
    dev = depth_sum.device
    need = _lanes(config, True)
    if pass_sums[3].numel() < need:
        raise ValueError(f"fold_pass: the pass's sums must be r, g, b, "
                         f"depth of at least {need} lanes")
    _f32_columns("fold_pass film", [*color_sum, depth_sum], config.n_pixels,
                 dev)
    _f32_columns("fold_pass pass", pass_sums, pass_sums[3].numel(), dev)
    _f32_columns("fold_pass count", [n_samples], 1, dev)
    for t in (rays_traced, segments):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.int64
                and t.device == dev and t.numel() == 1):
            raise ValueError(f"fold_pass: the totals must be one int64 on "
                             f"{dev}")


def fold_pass(color_sum: Vec3, depth_sum: torch.Tensor,
              n_samples: torch.Tensor, rays_traced: torch.Tensor, pass_sums,
              segments: torch.Tensor, config: RenderConfig):
    """A fused film pass folded into a film: ``(color_sum + pass, depth_sum
    + pass, n_samples + spp, rays_traced + segments)`` as new tensors (the
    film's are not changed), the pass's sums (``render_tiles``' r, g, b,
    depth with ``normalize=False``) put back in row-major order.

    On CPU tensors this runs :func:`fold_pass_reference`; on CUDA tensors
    it launches K11 of ``cuda/csrc/frame.cu`` once or raises
    (:func:`check_fold_args`). ``fold_pass.launches`` counts the launches.
    """
    dev = depth_sum.device
    if dev.type == "cpu":
        return fold_pass_reference(color_sum, depth_sum, n_samples,
                                   rays_traced, pass_sums, segments, config)
    _check_cuda(dev, "fold_pass")
    check_fold_args(color_sum, depth_sum, n_samples, rays_traced, pass_sums,
                    segments, config)
    from .cuda.build import extension

    out = torch.empty((4, config.n_pixels), dtype=torch.float32, device=dev)
    n_out = torch.empty((), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    extension().fold_pass(
        [*color_sum, depth_sum], list(pass_sums), list(out), n_samples, n_out,
        float(config.samples_per_pixel), rays_traced, segments, total,
        block_grid(config)[0], config.width, config.height)
    fold_pass.launches += 1
    return Vec3(out[0], out[1], out[2]), out[3], n_out, total


resolve_frame.launches = 0
fold_pass.launches = 0


def _check_cuda(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {dev}")
