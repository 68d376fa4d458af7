"""Sharded frames: one frame's work split over an (sp, dp, tp) mesh of torch
devices.

Counterpart of ``bevyray_tpu/parallel/sharding.py``, where one controller
drives a ``jax.sharding.Mesh`` through ``shard_map``. Here a :class:`Mesh`
is a grid of torch devices driven by this one process: every shard is
queued on its device before any result is read (so on several cards the
shards overlap), and the collectives are explicit reductions on the mesh's
first device. The axes and what they shard:

- ``sp``: pixels. The fused step gives each shard a range of 64x64 pixel
  blocks (the grid padded to a multiple of sp); the wavefront step a range
  of row-major pixels. No communication.
- ``dp``: samples. Each shard traces ``spp / dp`` samples of its pixels at
  disjoint sample indices; the sums are added in ascending dp order (psum).
- ``tp``: the sphere table, in the wavefront step only. Each shard tests
  its slice of the table and the nearest hit is reduced over the slices:
  the least t, then the lowest index among the slices that reach it (pmin).

The fused step runs the CUDA kernel with the shard offsets
(``render_tiles(block_offset=, n_blocks_local=, sample_offset=)``) and keeps
the whole scene on every device, as the JAX package keeps it in the TPU
kernel's memory; the wavefront step runs :func:`..engine.renderer.trace_sample`.
Tests build meshes over the CPU (``devices=["cpu"] * n``), and one card can
hold a whole mesh (``["cuda:0"] * n``): the shards then run one after
another on it. Several processes, each with its own card, are later work.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..core.constants import INF
from ..core.types import (CameraState, RenderConfig, SceneBuffers, Spheres,
                          camera_key, host_array, host_camera, upload)
from ..core.vec import Vec3
from ..engine.renderer import FrameResult, frame_result, trace_sample
from ..kernels.bounce import new_state
from ..kernels.cuda.megakernel import (KernelScene, block_grid,
                                       kernel_scene_cache_key, morton_order,
                                       prepare_kernel_scene, render_tiles,
                                       unshuffle_blocks)
from ..kernels.cuda.primary import shortlists_for
from ..kernels.intersect import intersect_spheres
from ..kernels.raygen import pixel_uv

AXES = ("sp", "dp", "tp")
_M32 = 0xFFFFFFFF
_NO_INDEX = torch.iinfo(torch.int64).max


class Mesh:
    """An (sp, dp, tp) grid of torch devices (:func:`make_mesh`). ``shape``
    maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    def device(self, sp_i: int, dp_i: int, tp_i: int = 0) -> torch.device:
        return self.devices[sp_i, dp_i, tp_i]


def make_mesh(sp: int = 1, dp: int = 1, tp: int = 1,
              devices: Optional[list] = None) -> Mesh:
    """An (sp, dp, tp) mesh over ``devices`` (anything ``torch.device``
    takes, one per shard; a device may repeat). None takes the first
    sp*dp*tp visible CUDA cards; there is no CPU fallback, so without enough
    cards it raises, as the JAX package does without enough devices."""
    n = sp * dp * tp
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())][:n]
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sp, dp, tp))


def default_mesh_shape(n_devices: int):
    """Factor a device count into (sp, dp, tp): dp and tp each get a factor
    of 2 where there is one (tp from 8 devices on), sp the rest, so that
    every reduction runs."""
    tp = 2 if (n_devices % 2 == 0 and n_devices >= 8) else 1
    rem = n_devices // tp
    dp = 2 if rem % 2 == 0 else 1
    sp = rem // dp
    return sp, dp, tp


def _vec_on(v: Vec3, dev) -> Vec3:
    return Vec3(*(c.to(dev) for c in v))


def _camera_on(cam: CameraState, dev) -> CameraState:
    return CameraState(*(_vec_on(f, dev) if isinstance(f, Vec3) else f.to(dev)
                         for f in cam))


def _scene_on(scene: SceneBuffers, dev) -> SceneBuffers:
    def table(t):
        return None if t is None else type(t)(
            *(None if c is None else c.to(dev) for c in t))

    return SceneBuffers(*(table(t) for t in scene))


def _psum(parts: list, dev):
    """Sum of ``parts`` (tensors or Vec3s) on ``dev``, in list order."""
    total = parts[0]
    move = (lambda x: _vec_on(x, dev)) if isinstance(total, Vec3) else (
        lambda x: x.to(dev))
    total = move(total)
    for p in parts[1:]:
        total = total + move(p)
    return total


def _check_spp(config: RenderConfig, dp: int) -> int:
    if config.samples_per_pixel % dp:
        raise ValueError(f"spp {config.samples_per_pixel} must divide dp={dp}")
    return config.samples_per_pixel // dp


# ---------------------------------------------------------------------------
# The wavefront step: sp over row-major pixels, dp over samples, tp over the
# sphere table.
# ---------------------------------------------------------------------------

def _tp_intersect_fn(scene: SceneBuffers, config: RenderConfig, mesh: Mesh,
                     sp_i: int, dp_i: int):
    """The sphere test of shard (sp_i, dp_i) with the table split over tp:
    each tp device tests its ``capacity / tp`` slice, and the nearest hit is
    the least t, then the lowest global index among the slices that reach
    that t; -1 where nothing hits."""
    tp = mesh.shape["tp"]
    cap = scene.spheres.capacity
    if cap % tp:
        raise ValueError(f"sphere capacity {cap} must divide tp={tp}")
    chunk_len = cap // tp
    home = mesh.device(sp_i, dp_i)
    pieces = [(mesh.device(sp_i, dp_i, k), k * chunk_len,
               Spheres(*(c[k * chunk_len:(k + 1) * chunk_len].to(
                   mesh.device(sp_i, dp_i, k)) for c in scene.spheres)))
              for k in range(tp)]
    chunk = min(config.sphere_chunk, chunk_len)

    def fn(o: Vec3, d: Vec3, active=None):
        hits = []
        for dev, offset, local in pieces:
            t, i = intersect_spheres(
                _vec_on(o, dev), _vec_on(d, dev), local, chunk,
                active=None if active is None else active.to(dev))
            hits.append((t, torch.where(i >= 0, i + offset, -1)))
        hits = [(t.to(home), i.to(home)) for t, i in hits]
        t_min = hits[0][0]
        for t, _ in hits[1:]:
            t_min = torch.minimum(t_min, t)
        i_min = torch.full_like(hits[0][1], _NO_INDEX)
        for t, i in hits:
            i_min = torch.minimum(i_min, torch.where((t == t_min) & (i >= 0),
                                                     i, _NO_INDEX))
        return t_min, torch.where(t_min >= INF, -1, i_min)

    return fn


def render_frame_sharded(mesh: Mesh, scene: SceneBuffers, cam: CameraState,
                         config: RenderConfig, frame_seed,
                         raster_color: Optional[Vec3] = None,
                         raster_depth=None) -> FrameResult:
    """One frame of the wavefront step over ``mesh``: shard (sp_i, dp_i)
    traces samples ``dp_i * spp/dp ..`` of pixel range sp_i (the pixel count
    must divide by sp), its sphere tests split over tp (every bounce runs,
    as in the JAX package). The color and depth sums are added over dp,
    averaged and composited on the mesh's first device."""
    sp, dp, tp = (mesh.shape[a] for a in AXES)
    n = config.n_pixels
    if n % sp:
        raise ValueError(f"pixel count {n} must be divisible by sp={sp}")
    local_spp = _check_spp(config, dp)
    n_local = n // sp
    seed = int(frame_seed) & _M32
    u, v = pixel_uv(config.width, config.height, device=mesh.device(0, 0))
    ids = torch.arange(n, device=mesh.device(0, 0))
    parts = {}
    for sp_i in range(sp):
        rows = slice(sp_i * n_local, (sp_i + 1) * n_local)
        for dp_i in range(dp):
            dev = mesh.device(sp_i, dp_i)
            scene_d, cam_d = _scene_on(scene, dev), _camera_on(cam, dev)
            u_d, v_d, ids_d = (x[rows].to(dev) for x in (u, v, ids))
            intersect_fn = (_tp_intersect_fn(scene, config, mesh, sp_i, dp_i)
                            if tp > 1 else None)
            color_sum = Vec3.full((n_local,), 0.0, 0.0, 0.0, device=dev)
            depth_sum = torch.zeros(n_local, dtype=torch.float32, device=dev)
            segments = torch.zeros((), dtype=torch.int64, device=dev)
            state = new_state(n_local, cam_d, config, dev)
            for k in range(local_spp):
                color, depth, segs = trace_sample(
                    scene_d, cam_d, config, ids_d, u_d, v_d,
                    dp_i * local_spp + k, seed, intersect_fn=intersect_fn,
                    fixed_trip_count=tp > 1, state=state)
                color_sum = color_sum + color
                depth_sum = depth_sum + depth
                segments = segments + segs
            parts[sp_i, dp_i] = color_sum, depth_sum, segments
    return _reduce_and_composite(mesh, parts, config, cam, raster_color,
                                 raster_depth, blocks=False)


def _reduce_and_composite(mesh: Mesh, parts: dict, config: RenderConfig,
                          cam: CameraState, raster_color, raster_depth,
                          blocks: bool) -> FrameResult:
    """Sum each sp shard's (color, depth) over dp in ascending order and
    the segments over every shard, on the mesh's first device; join the sp
    shards, scale by 1/spp, put the fused step's pixel blocks (``blocks``)
    back in scanline order and crop, and composite."""
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    dev0 = mesh.device(0, 0)
    colors, depths = [], []
    for sp_i in range(sp):
        colors.append(_psum([parts[sp_i, k][0] for k in range(dp)], dev0))
        depths.append(_psum([parts[sp_i, k][1] for k in range(dp)], dev0))
    segments = _psum([p[2] for p in parts.values()], dev0)
    inv_spp = float(np.float32(1.0 / config.samples_per_pixel))
    rt = [torch.cat([c[k] for c in colors]) * inv_spp for k in range(3)]
    rt_depth = torch.cat(depths) * inv_spp
    if blocks:
        rt = [unshuffle_blocks(x, config) for x in rt]
        rt_depth = unshuffle_blocks(rt_depth, config)
    return frame_result(config, _camera_on(cam, dev0), Vec3(*rt), rt_depth,
                        segments, raster_color, raster_depth)


# ---------------------------------------------------------------------------
# The fused step: the CUDA kernel per shard, sp over pixel blocks, dp over
# samples.
# ---------------------------------------------------------------------------

# Small keyed LRUs, so that alternating scenes or cameras through the fused
# step (multi-view loops) hit them both ways: the prepared kernel tables per
# scene (which carry ``has_emissive``, the JAX module's cached probe) and
# their copies per device, and the shortlists per (scene, camera values,
# config, sp, dp). Each entry keeps the tensors its id()-based key names
# alive, so the ids stay unique while it is cached.
_KSCENE_CACHE: "OrderedDict" = OrderedDict()
_SHARDED_SL_CACHE: "OrderedDict" = OrderedDict()
_SHARDED_SL_CACHE_MAX = 8


def _cache_put(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    while len(cache) > _SHARDED_SL_CACHE_MAX:
        cache.popitem(last=False)


def _cached_kscene(scene: SceneBuffers, config: RenderConfig, dev
                   ) -> KernelScene:
    """The kernel tables of ``scene`` under ``config``'s grouping, on
    ``dev``; built once per scene and copied once per device."""
    key, leaves = kernel_scene_cache_key(scene)
    key = (key, config.pallas_cand_size, config.pallas_grouping)
    hit = _KSCENE_CACHE.get(key)
    if hit is None:
        order = (morton_order(scene.spheres)
                 if config.pallas_grouping == "morton" else None)
        home = prepare_kernel_scene(scene, config.pallas_cand_size,
                                    order=order)
        hit = (leaves, {home.sph.device: home})
        _cache_put(_KSCENE_CACHE, key, hit)
    _KSCENE_CACHE.move_to_end(key)
    copies = hit[1]
    dev = torch.device(dev)
    if dev not in copies:
        home = next(iter(copies.values()))
        copies[dev] = home._replace(**{
            f: getattr(home, f).to(dev)
            for f in ("sph", "attr", "gaabb", "tri")})
    return copies[dev]


def _cached_shortlists(scene: SceneBuffers, kscene: KernelScene,
                       cam: CameraState, config: RenderConfig, sp: int,
                       dp: int, n_blocks_padded: int):
    """``(sl, slmeta)`` of the padded block grid, gated for ``spp / dp``
    samples a shard, as tensors on the kernel tables' device, or
    ``(None, None)``."""
    sid, leaves = kernel_scene_cache_key(scene)
    key = (sid, camera_key(cam), config, sp, dp)
    hit = _SHARDED_SL_CACHE.get(key)
    if hit is not None:
        _SHARDED_SL_CACHE.move_to_end(key)
        return hit[1]
    out = shortlists_for(host_array(kscene.sph), host_camera(cam), config,
                         config.samples_per_pixel // dp, block_lo=0,
                         n_blocks=n_blocks_padded)
    if out[0] is not None:
        out = tuple(upload(x, kscene.sph.device) for x in out)
    _cache_put(_SHARDED_SL_CACHE, key, (leaves, out))
    return out


def render_frame_sharded_pallas(mesh: Mesh, scene: SceneBuffers,
                                cam: CameraState, config: RenderConfig,
                                frame_seed,
                                raster_color: Optional[Vec3] = None,
                                raster_depth=None) -> FrameResult:
    """One frame of the fused kernel over an (sp, dp, 1) mesh. The block
    grid is padded to a multiple of sp; shard (sp_i, dp_i) renders the
    ``blocks_local`` blocks from ``sp_i * blocks_local`` at samples
    ``dp_i * spp/dp ..`` as sums (``render_tiles(normalize=False)``), with
    its rows of the padded grid's shortlists. The sums are added over dp,
    the shards joined, put back in scanline order and cropped, then
    composited, on the mesh's first device."""
    sp, dp, tp = (mesh.shape[a] for a in AXES)
    if tp != 1:
        raise ValueError("the fused multi-device path supports sp/dp axes "
                         "only; use render_frame_sharded for tp sphere "
                         "sharding")
    local_spp = _check_spp(config, dp)
    local_config = dataclasses.replace(config, samples_per_pixel=local_spp)
    nbx, nby = block_grid(config)
    blocks_local = -(-(nbx * nby) // sp)
    home = _cached_kscene(scene, config, scene.spheres.cx.device)
    sl, slmeta = _cached_shortlists(scene, home, cam, config, sp, dp,
                                    blocks_local * sp)
    seed = int(frame_seed) & _M32
    parts = {}
    for sp_i in range(sp):
        rows = slice(sp_i * blocks_local, (sp_i + 1) * blocks_local)
        for dp_i in range(dp):
            dev = mesh.device(sp_i, dp_i)
            shard_sl = shard_meta = None
            if sl is not None:
                shard_sl, shard_meta = sl[rows].to(dev), slmeta[rows].to(dev)
            r, g, b, depth, segs = render_tiles(
                _cached_kscene(scene, config, dev), _camera_on(cam, dev),
                local_config, seed, block_offset=sp_i * blocks_local,
                sample_offset=dp_i * local_spp, n_blocks_local=blocks_local,
                normalize=False, sl=shard_sl, slmeta=shard_meta)
            parts[sp_i, dp_i] = Vec3(r, g, b), depth, segs
    return _reduce_and_composite(mesh, parts, config, cam, raster_color,
                                 raster_depth, blocks=True)
