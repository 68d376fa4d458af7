"""Fused-kernel renderer front-end: the twin of the JAX package's
``PallasRenderer`` (``bevyray_tpu/engine/pallas_renderer.py``), with its hot
path in :mod:`..kernels.cuda.megakernel`."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.composite import composite
from ..kernels.cuda.megakernel import (KernelScene, kernel_mode,
                                       kernel_scene_cache_key, morton_order,
                                       prepare_kernel_scene, render_tiles,
                                       unshuffle_blocks)
from ..kernels.cuda.primary import device_shortlists_for
from .renderer import FrameResult


class FusedRenderer:
    """Renders a frame in one launch of the fused CUDA kernel (on CUDA
    tensors) or of its plain PyTorch version (on CPU tensors).

    ``pallas_primary`` and ``pallas_intersect`` resolve as the JAX package's
    ``PallasRenderer`` resolves them: the per-block primary shortlists are
    built (and the split gated) by :mod:`..kernels.cuda.primary`, and the
    full walk's mode by ``use_candidate_walk``. ``last_mode`` holds the
    (primary, intersect) pair of the last traced frame, e.g.
    ``("split", "candidates")``. ``exact_rng=None`` resolves to True;
    ``exact_rng=False`` (the TPU's fast RNG) raises (ROADMAP B8).
    """

    def __init__(self, config: RenderConfig, exact_rng: Optional[bool] = None):
        if exact_rng is None:
            exact_rng = True
        if not exact_rng:
            raise NotImplementedError(
                "the fast RNG (exact_rng=False) is not ported yet (ROADMAP B8)")
        self.config = config
        self.exact_rng = exact_rng
        self.last_mode = None
        self._kscene_cache = None
        self._sl_cache = None

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

    def shortlists(self, kscene: KernelScene, cam: CameraState):
        """``(sl, slmeta)`` for the phase split, or ``(None, None)`` where the
        gate declines; cached on the prepared scene and the camera's 13
        values. The same camera tensors hit the cache with no transfer; new
        ones come to the host in one copy."""
        leaves = (*cam.position, *cam.direction, *cam.up, cam.fov,
                  cam.aspect, cam.aperture, cam.focus_distance)
        ids = tuple(id(v) for v in leaves)
        scene_key = self._kscene_cache[0]
        hit = self._sl_cache
        if hit is not None and hit[0] == scene_key and hit[1] == ids:
            return hit[4]
        values = tuple(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                    for v in leaves]).cpu().tolist())
        if hit is not None and hit[0] == scene_key and hit[3] == values:
            out = hit[4]
        else:
            out = device_shortlists_for(kscene, cam, self.config,
                                        self.config.samples_per_pixel)
        # ``leaves`` rides along: id() values are unique only among live
        # objects.
        self._sl_cache = (scene_key, ids, leaves, values, out)
        return out

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
        # As PallasRenderer: the tables and the split gate come first, so a
        # forced split at level 0 raises there too.
        kscene = self.prepare(scene)
        sl, slmeta = self.shortlists(kscene, cam)
        if config.level == 0:   # Skip: raster passthrough, no tracing (wgsl:97-99)
            return FrameResult(
                image=_pixels(raster_color, n).reshape(h, w, 3),
                rt_depth=torch.zeros((h, w), dtype=torch.float32, device=dev),
                rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
        r, g, b, depth, segs = render_tiles(kscene, cam, config,
                                            seed & 0xFFFFFFFF,
                                            exact_rng=self.exact_rng, sl=sl,
                                            slmeta=slmeta)
        self.last_mode = kernel_mode(kscene, config, sl)
        r, g, b, depth = (unshuffle_blocks(x, config) for x in (r, g, b, depth))
        near, far = cam.near.to(dev), cam.far.to(dev)
        out = composite(config.level, Vec3(r, g, b), depth, near, far,
                        raster_color, raster_depth)
        return FrameResult(image=_pixels(out, n).reshape(h, w, 3),
                           rt_depth=depth.reshape(h, w), rays_traced=segs)


def _pixels(color: Vec3, n: int) -> torch.Tensor:
    """[n, 3] from a Vec3 whose components broadcast to [n]."""
    return torch.stack([torch.broadcast_to(c, (n,)) for c in color], dim=-1)
