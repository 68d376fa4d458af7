"""The adaptive pass's map and fold, and the sharded step's sums and tp
hit merge.

Counterpart of pieces of the JAX package's jitted programs that XLA fuses
around the kernels:

- the adaptive pass (``_adaptive_pass``, bevyray_tpu/engine/adaptive.py:51-
  100): the sample map ``shuffle_blocks(where(err >= tolerance | reprobe,
  spp, 0))`` before ``render_tiles``, and after it the un-shuffle of the
  pass's sums, the inter-pass disagreement and the film's adds;
- the sharded step's sums (``jax.lax.psum`` over dp and the sp shards'
  concatenation, bevyray_tpu/parallel/sharding.py:142-144, :231-232);
- the wavefront sharded step's nearest hit over the tp slices of the
  sphere table (``_tp_intersect_fn``, bevyray_tpu/parallel/sharding.py:
  84-92: the slices' index offsets, ``pmin`` over t and over the lowest
  index reaching it).

:func:`adaptive_map`, :func:`fold_adaptive`, :func:`sum_shards` and
:func:`merge_tp_hits` are wrappers: on CPU tensors they run the plain
versions (``*_reference``, the JAX code's operations in its order with
torch's own operators); on CUDA tensors they launch K13, K14, K15 and K16 of
``cuda/csrc/passes.cu``, which give the same bits, or raise. They never
fall back. Their ``.launches`` count the kernel launches: one a call, but
K15 one for every ``PARTS_PER_LAUNCH`` parts and K16 one for the first
``SLICES_PER_LAUNCH`` slices and one for every ``SLICES_PER_LAUNCH - 1``
more (the kernels take their pointers as arguments and carry the running
result from one launch to the next).
"""

from __future__ import annotations

import torch

from ..core.constants import INF
from ..core.types import RenderConfig
from ..core.vec import Vec3
from .cuda.megakernel import TILE, block_grid, shuffle_blocks, unshuffle_blocks
from .frame import _check_cuda, _f32_columns, _lanes

# The parts one K15 launch adds and the slices one K16 launch merges
# (csrc/passes.h kPartsPerLaunch, kSlicesPerLaunch).
PARTS_PER_LAUNCH = 32
SLICES_PER_LAUNCH = 32
_NO_INDEX = torch.iinfo(torch.int64).max


# -- K13: the adaptive pass's sample map ---------------------------------------

def adaptive_map_reference(err: torch.Tensor, tolerance: float, reprobe: bool,
                           config: RenderConfig) -> torch.Tensor:
    """The plain version of :func:`adaptive_map`."""
    want = err >= tolerance
    if reprobe:
        want = torch.ones_like(want)
    spp = config.samples_per_pixel
    return shuffle_blocks(torch.where(want, spp, 0).to(torch.int32), config,
                          fill=0)


def adaptive_map(err: torch.Tensor, tolerance: float, reprobe: bool,
                 config: RenderConfig) -> torch.Tensor:
    """The adaptive pass's per-lane sample targets: ``spp`` where the
    pixel's ``err`` is at or above ``tolerance`` (float32; every pixel when
    ``reprobe``; a NaN ``err`` is below it), 0 elsewhere and on padding
    lanes, int32 ``[n_tiles, TILE // 128, 128]`` in the fused kernel's
    block order (``render_tiles(spp_map=...)``).

    On CPU tensors this runs :func:`adaptive_map_reference`; on CUDA
    tensors it launches K13 of ``cuda/csrc/passes.cu`` once or raises.
    ``adaptive_map.launches`` counts the launches.
    """
    dev = err.device
    if dev.type == "cpu":
        return adaptive_map_reference(err, tolerance, reprobe, config)
    _check_cuda(dev, "adaptive_map")
    _f32_columns("adaptive_map err", [err], config.n_pixels, dev)
    from .cuda.build import extension

    lanes = _lanes(config, True)
    out = torch.empty((lanes // TILE, TILE // 128, 128), dtype=torch.int32,
                      device=dev)
    extension().adaptive_map(err, out, float(tolerance), bool(reprobe),
                             config.samples_per_pixel, block_grid(config)[0],
                             config.width, config.height)
    adaptive_map.launches += 1
    return out


# -- K14: the adaptive pass's fold ----------------------------------------------

def fold_adaptive_reference(film, pass_sums, segments: torch.Tensor,
                            tolerance: float, reprobe: bool,
                            config: RenderConfig) -> tuple:
    """The plain version of :func:`fold_adaptive`: ``unshuffle_blocks`` of
    the pass's sums and the JAX pass's arithmetic (adaptive.py:73-100)."""
    r, g, b, depth = (unshuffle_blocks(x, config) for x in pass_sums)
    color = Vec3(r, g, b)
    spp = config.samples_per_pixel
    want = film.err >= tolerance
    if reprobe:
        want = torch.ones_like(want)
    took = want.to(torch.float32) * spp
    # Inter-pass disagreement: |new pass mean - running mean| relative to the
    # running mean's luminance, plus a floor so that black pixels converge.
    old_n = torch.clamp(film.n_samples, min=1.0)
    old_mean = film.color_sum.scale(1.0 / old_n)
    new_mean = color.scale(1.0 / torch.clamp(took, min=1.0))
    lum = (old_mean.x + old_mean.y + old_mean.z) * (1.0 / 3.0)
    delta = (torch.abs(new_mean.x - old_mean.x)
             + torch.abs(new_mean.y - old_mean.y)
             + torch.abs(new_mean.z - old_mean.z)) * (1.0 / 3.0)
    rel = delta / (lum + 0.05)
    # A pixel's first pass keeps err at +inf, so every pixel gets a second
    # look; afterwards err holds the latest disagreement of a sampled pixel.
    seen = film.n_samples > 0.0
    err = torch.where(want & seen, rel, film.err)
    err = torch.where(want & ~seen, float("inf"), err)
    return (film.color_sum + color, film.depth_sum + depth,
            film.n_samples + took, err, film.rays_traced + segments)


def check_fold_adaptive_args(film, pass_sums, segments: torch.Tensor,
                             config: RenderConfig) -> None:
    """Raise ValueError unless K14 takes these arguments: the film's six
    float32 columns of the frame's pixels and its int64 total, the pass's
    four block-ordered float32 sums over the block grid and its int64
    segment count."""
    if len(pass_sums) != 4:
        raise ValueError("fold_adaptive: the pass's sums must be r, g, b, "
                         "depth")
    dev = film.depth_sum.device
    need = _lanes(config, True)
    if pass_sums[3].numel() < need:
        raise ValueError(f"fold_adaptive: the pass's sums must be r, g, b, "
                         f"depth of at least {need} lanes")
    _f32_columns("fold_adaptive film",
                 [*film.color_sum, film.depth_sum, film.n_samples, film.err],
                 config.n_pixels, dev)
    _f32_columns("fold_adaptive pass", pass_sums, pass_sums[3].numel(), dev)
    for t in (film.rays_traced, segments):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.int64
                and t.device == dev and t.numel() == 1):
            raise ValueError(f"fold_adaptive: the totals must be one int64 "
                             f"on {dev}")


def fold_adaptive(film, pass_sums, segments: torch.Tensor, tolerance: float,
                  reprobe: bool, config: RenderConfig) -> tuple:
    """An adaptive pass folded into its film (an ``AdaptiveFilm``): the
    pass's sums (``render_tiles``' r, g, b, depth with ``normalize=False``,
    block-ordered) put back in row-major order and added, ``spp`` added to
    the count of each pixel that sampled (``err >= tolerance`` or
    ``reprobe``), the pixel's new disagreement (+inf on its first pass, the
    old ``err`` where it traced nothing) and the segment count added to
    ``rays_traced``. Returns ``(color_sum, depth_sum, n_samples, err,
    rays_traced)`` as new tensors; the film's are not changed.

    On CPU tensors this runs :func:`fold_adaptive_reference`; on CUDA
    tensors it launches K14 of ``cuda/csrc/passes.cu`` once or raises
    (:func:`check_fold_adaptive_args`). ``fold_adaptive.launches`` counts
    the launches.
    """
    dev = film.depth_sum.device
    if dev.type == "cpu":
        return fold_adaptive_reference(film, pass_sums, segments, tolerance,
                                       reprobe, config)
    _check_cuda(dev, "fold_adaptive")
    check_fold_adaptive_args(film, pass_sums, segments, config)
    from .cuda.build import extension

    out = torch.empty((6, config.n_pixels), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    extension().fold_adaptive(
        [*film.color_sum, film.depth_sum, film.n_samples, film.err],
        list(pass_sums), list(out), film.rays_traced, segments, total,
        float(tolerance), bool(reprobe), config.samples_per_pixel,
        block_grid(config)[0], config.width, config.height)
    fold_adaptive.launches += 1
    return Vec3(out[0], out[1], out[2]), out[3], out[4], out[5], total


# -- K15: the sharded step's sums -----------------------------------------------

def _move(x, dev):
    return Vec3(*(c.to(dev) for c in x)) if isinstance(x, Vec3) else x.to(dev)


def _psum(parts: list, dev):
    """Sum of ``parts`` (tensors or Vec3s) on ``dev``, in list order."""
    total = _move(parts[0], dev)
    for p in parts[1:]:
        total = total + _move(p, dev)
    return total


def sum_shards_reference(parts: dict, sp: int, dp: int, dev) -> tuple:
    """The plain version of :func:`sum_shards`: each sp shard's sums added
    over dp in ascending order, the shards joined, the segments summed."""
    colors, depths = [], []
    for sp_i in range(sp):
        colors.append(_psum([parts[sp_i, k][0] for k in range(dp)], dev))
        depths.append(_psum([parts[sp_i, k][1] for k in range(dp)], dev))
    segments = _psum([p[2] for p in parts.values()], dev)
    sums = [torch.cat([c[k] for c in colors]) for k in range(3)]
    return (*sums, torch.cat(depths)), segments


def check_shard_args(parts: dict, sp: int, dp: int, dev) -> None:
    """Raise ValueError unless K15 takes these parts: ``sp * dp`` of them
    (at least one), keyed ``(sp_i, dp_i)``, each a Vec3 colour and a depth
    of contiguous float32 columns of one length on ``dev`` and one int64
    segment count there."""
    if sp < 1 or dp < 1:
        raise ValueError("sum_shards takes at least one part")
    if set(parts) != {(i, k) for i in range(sp) for k in range(dp)}:
        raise ValueError("sum_shards: the parts must be keyed (sp_i, dp_i)")
    n = parts[0, 0][1].numel()
    for color, depth, segs in parts.values():
        _f32_columns("sum_shards part", [*color, depth], n, dev)
        if not (isinstance(segs, torch.Tensor) and segs.dtype == torch.int64
                and segs.device == dev and segs.numel() == 1):
            raise ValueError(f"sum_shards: each segment count must be one "
                             f"int64 on {dev}")


def sum_shards(parts: dict, sp: int, dp: int, dev) -> tuple:
    """The sharded step's reduction: for each sp shard its ``dp`` parts'
    r, g, b and depth sums added in ascending ``dp_i``, ``((p0 + p1) +
    p2)``, the shards joined in sp order, and every part's segment count
    summed, on ``dev`` (the mesh's first device). ``parts`` maps ``(sp_i,
    dp_i)`` to ``(Vec3 colour, depth, segments)``, each shard's columns of
    one length. Returns ``((r, g, b, depth), segments)``.

    Parts on another device are copied to ``dev`` first. On CPU tensors
    this runs :func:`sum_shards_reference`; on CUDA tensors it launches K15
    of ``cuda/csrc/passes.cu`` or raises (:func:`check_shard_args`): once
    for up to ``PARTS_PER_LAUNCH`` parts, and once for every
    ``PARTS_PER_LAUNCH`` parts of a larger mesh, each launch carrying the
    running sums on (the same bits: a left fold in chunks is the whole
    fold). ``sum_shards.launches`` counts the launches.
    """
    dev = torch.device(dev)
    if dev.type == "cpu":
        return sum_shards_reference(parts, sp, dp, dev)
    _check_cuda(dev, "sum_shards")
    parts = {k: (_move(c, dev), d.to(dev), s.to(dev))
             for k, (c, d, s) in parts.items()}
    dev = parts[0, 0][1].device
    check_shard_args(parts, sp, dp, dev)
    from .cuda.build import extension

    n = parts[0, 0][1].numel()
    out = torch.empty((4, sp * n), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    order = [(i, k) for i in range(sp) for k in range(dp)]
    sum_shards.launches += extension().sum_shards(
        [c for key in order for c in (*parts[key][0], parts[key][1])],
        [parts[key][2] for key in order], list(out), total, sp, dp, n)
    return tuple(out), total


# -- K16: the tp hit merge --------------------------------------------------------

def merge_tp_hits_reference(ts: list, indices: list, offsets: list) -> tuple:
    """The plain version of :func:`merge_tp_hits`: the JAX step's
    operations (bevyray_tpu/parallel/sharding.py:86-92) with torch's."""
    hits = [(t, torch.where(i >= 0, i + off, -1))
            for t, i, off in zip(ts, indices, offsets)]
    t_min = hits[0][0]
    for t, _ in hits[1:]:
        t_min = torch.minimum(t_min, t)
    i_min = torch.full_like(hits[0][1], _NO_INDEX)
    for t, i in hits:
        i_min = torch.minimum(i_min, torch.where((t == t_min) & (i >= 0), i,
                                                 _NO_INDEX))
    return t_min, torch.where(t_min >= INF, -1, i_min)


def check_tp_hits_args(ts: list, indices: list, offsets: list) -> None:
    """Raise ValueError unless K16 takes these slices: at least one, each a
    contiguous float32 t and int64 index of one length on one device, and
    an offset of at least 0."""
    if not (len(ts) >= 1 and len(indices) == len(ts) == len(offsets)):
        raise ValueError("merge_tp_hits takes t, index and an offset of "
                         "each of at least one slice")
    dev, n = ts[0].device, ts[0].numel()
    _f32_columns("merge_tp_hits t", ts, n, dev)
    for i in indices:
        if not (isinstance(i, torch.Tensor) and i.dtype == torch.int64
                and i.device == dev and i.is_contiguous() and i.dim() == 1
                and i.numel() == n):
            raise ValueError(f"merge_tp_hits: each index must be a "
                             f"contiguous int64 tensor of {n} lanes on {dev}")
    if any(int(off) < 0 for off in offsets):
        raise ValueError("merge_tp_hits: a slice's offset must be at least 0")


def merge_tp_hits(ts: list, indices: list, offsets: list) -> tuple:
    """The nearest hit over the tp slices of a sphere table: slice ``k``
    gives each lane's nearest hit in its part of the table as ``ts[k]``
    (float32, INF on a miss) and ``indices[k]`` (int64, -1 on a miss),
    local to the slice, whose first sphere is ``offsets[k]``. Returns
    ``(t, index)``: the least t, then the lowest global index among the
    slices that reach it; -1 where the least t is INF.

    The least t is ``torch.minimum``'s over the slices in order: NaN where
    any slice's t is NaN (on the card the first NaN's bits; on the CPU
    torch's), and no slice reaches a NaN, so its index is int64's maximum.

    On CPU tensors this runs :func:`merge_tp_hits_reference`; on CUDA
    tensors it launches K16 of ``cuda/csrc/passes.cu`` or raises
    (:func:`check_tp_hits_args`): once for up to ``SLICES_PER_LAUNCH``
    slices, and once more for every ``SLICES_PER_LAUNCH - 1`` further ones,
    each launch merging them into the result so far (the least t and the
    lowest index are exact and associative). ``merge_tp_hits.launches``
    counts the launches.
    """
    dev = ts[0].device
    if dev.type == "cpu":
        return merge_tp_hits_reference(ts, indices, offsets)
    _check_cuda(dev, "merge_tp_hits")
    check_tp_hits_args(ts, indices, offsets)
    from .cuda.build import extension

    t = torch.empty_like(ts[0])
    index = torch.empty_like(indices[0])
    merge_tp_hits.launches += extension().merge_tp_hits(
        list(ts), list(indices), [int(off) for off in offsets], t, index)
    return t, index


adaptive_map.launches = 0
fold_adaptive.launches = 0
sum_shards.launches = 0
merge_tp_hits.launches = 0
