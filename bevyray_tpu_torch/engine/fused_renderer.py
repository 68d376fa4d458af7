"""Fused-kernel renderer front-end: the twin of the JAX package's
``PallasRenderer`` (``bevyray_tpu/engine/pallas_renderer.py``), with its hot
path in :mod:`..kernels.cuda.megakernel`."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.composite import composite
from ..kernels.cuda.megakernel import (KernelScene, kernel_scene_cache_key,
                                       morton_order, prepare_kernel_scene,
                                       render_tiles, unshuffle_blocks)
from .renderer import FrameResult


class FusedRenderer:
    """Renders a frame in one launch of the fused CUDA kernel (on CUDA
    tensors) or of its plain PyTorch version (on CPU tensors).

    The port has one path: the persistent sample loop over the full sphere
    table with the exact PCG streams. ``pallas_primary`` "auto"/"off" and
    ``pallas_intersect`` "auto"/"grouped" all resolve to it; on the JAX
    package they pick schedules of its TPU kernel that its own tests pin as
    value-identical to this one. An explicit "split" (ROADMAP B3) or
    "candidates" (ROADMAP B5) raises, as does ``exact_rng=False`` (ROADMAP
    B8). ``exact_rng=None`` resolves to True.
    """

    def __init__(self, config: RenderConfig, exact_rng: Optional[bool] = None):
        if config.pallas_primary == "split":
            raise NotImplementedError(
                "pallas_primary='split' (phase A shortlists) is not ported yet "
                "(ROADMAP B3)")
        if config.pallas_intersect == "candidates":
            raise NotImplementedError(
                "pallas_intersect='candidates' (the candidate walk) is not "
                "ported yet (ROADMAP B5)")
        if exact_rng is None:
            exact_rng = True
        if not exact_rng:
            raise NotImplementedError(
                "the fast RNG (exact_rng=False) is not ported yet (ROADMAP B8)")
        self.config = config
        self.exact_rng = exact_rng
        self._kscene_cache = None

    def prepare(self, scene: SceneBuffers) -> KernelScene:
        """The kernel tables of ``scene``, cached on the identities of the
        tensors they are built from (spheres, materials and triangles)."""
        key, leaves = kernel_scene_cache_key(scene)
        if self._kscene_cache is not None and self._kscene_cache[0] == key:
            return self._kscene_cache[2]
        order = (morton_order(scene.spheres)
                 if self.config.pallas_grouping == "morton" else None)
        kscene = prepare_kernel_scene(scene, self.config.pallas_cand_size,
                                      order=order)
        self._kscene_cache = (key, leaves, kscene)
        return kscene

    def render(self, scene: SceneBuffers, cam: CameraState, seed: int,
               raster_color: Optional[Vec3] = None,
               raster_depth=None) -> FrameResult:
        config = self.config
        dev = scene.spheres.cx.device
        h, w = config.height, config.width
        n = h * w
        if raster_color is None:
            raster_color = Vec3.splat(1.0, device=dev)
        if raster_depth is None:
            raster_depth = torch.zeros((), dtype=torch.float32, device=dev)
        if config.level == 0:   # Skip: raster passthrough, no tracing (wgsl:97-99)
            return FrameResult(
                image=_pixels(raster_color, n).reshape(h, w, 3),
                rt_depth=torch.zeros((h, w), dtype=torch.float32, device=dev),
                rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
        kscene = self.prepare(scene)
        r, g, b, depth, segs = render_tiles(kscene, cam, config,
                                            seed & 0xFFFFFFFF,
                                            exact_rng=self.exact_rng)
        r, g, b, depth = (unshuffle_blocks(x, config) for x in (r, g, b, depth))
        near, far = cam.near.to(dev), cam.far.to(dev)
        out = composite(config.level, Vec3(r, g, b), depth, near, far,
                        raster_color, raster_depth)
        return FrameResult(image=_pixels(out, n).reshape(h, w, 3),
                           rt_depth=depth.reshape(h, w), rays_traced=segs)


def _pixels(color: Vec3, n: int) -> torch.Tensor:
    """[n, 3] from a Vec3 whose components broadcast to [n]."""
    return torch.stack([torch.broadcast_to(c, (n,)) for c in color], dim=-1)
