"""Fused-kernel renderer front-end: the twin of the JAX package's
``PallasRenderer`` (``bevyray_tpu/engine/pallas_renderer.py``), with its hot
path in :mod:`..kernels.cuda.megakernel` and its tail (the block order
undone, the composite, the image) in one launch of
:func:`..kernels.frame.resolve_frame`.

A frame is two spans (:func:`..utils.profiling.span`): ``frame_setup``,
the kernel tables and the shortlists looked up or built, then ``queue``,
the kernel's launch and the tail's. A cache miss builds inside
``frame_setup``, in span ``tables_build`` or ``shortlists_build``."""

from __future__ import annotations

from typing import Optional

from ..core.types import (CameraState, RenderConfig, SceneBuffers,
                          camera_key, camera_leaves)
from ..core.vec import Vec3
from ..kernels.cuda.megakernel import (KernelScene, kernel_fuse,
                                       kernel_mode, kernel_scene_cache_key,
                                       morton_order, prepare_kernel_scene,
                                       render_tiles, resolve_exact_rng)
from ..kernels.cuda.primary import device_shortlists_for
from ..utils.profiling import span
from .renderer import FrameResult, frame_result, passthrough_frame


class FusedRenderer:
    """Renders a frame in one launch of the fused CUDA kernel (on CUDA
    tensors) or of its plain PyTorch version (on CPU tensors).

    ``pallas_primary`` and ``pallas_intersect`` resolve as the JAX package's
    ``PallasRenderer`` resolves them: the per-block primary shortlists are
    built (and the split gated) by :mod:`..kernels.cuda.primary`, and the
    full walk's mode by ``use_candidate_walk``. ``last_mode`` holds the
    (primary, intersect) pair of the last traced frame, e.g.
    ``("split", "candidates")``, ``last_fuse`` its block fusion
    (:func:`kernel_fuse`, sized by whether the scene emits, as in the JAX
    package) and ``last_exact_rng`` its draw path.

    ``exact_rng``: True draws from the exact PCG streams, False from the
    fast path (:mod:`..kernels.cuda.fast_rng`); None resolves per frame to
    the fast path for a scene on a CUDA card and to the exact one for a
    scene elsewhere (:func:`resolve_exact_rng`), as ``PallasRenderer``
    resolves it on and off the TPU.
    """

    def __init__(self, config: RenderConfig, exact_rng: Optional[bool] = None):
        self.config = config
        self.exact_rng = exact_rng
        self.last_mode = None
        self.last_fuse = None
        self.last_exact_rng = None
        self._kscene_cache = None
        self._sl_cache = None
        self._cam_memo = None

    def prepare(self, scene: SceneBuffers) -> KernelScene:
        """The kernel tables of ``scene``, cached on the identities of the
        tensors they are built from (spheres, materials and triangles)."""
        key, leaves = kernel_scene_cache_key(scene)
        if self._kscene_cache is not None and self._kscene_cache[0] == key:
            return self._kscene_cache[2]
        with span("tables_build"):
            order = (morton_order(scene.spheres)
                     if self.config.pallas_grouping == "morton" else None)
            kscene = prepare_kernel_scene(scene, self.config.pallas_cand_size,
                                          order=order)
        self._kscene_cache = (key, leaves, kscene)
        return kscene

    def shortlists(self, kscene: KernelScene, cam: CameraState,
                   values=None):
        """``(sl, slmeta)`` for the phase split, or ``(None, None)`` where the
        gate declines; cached on the prepared scene and the camera's
        ``values`` (its :func:`camera_key`; taken by :meth:`camera_values`
        when not given)."""
        if values is None:
            values = self.camera_values(cam)
        key = (self._kscene_cache[0], values)
        if self._sl_cache is not None and self._sl_cache[0] == key:
            return self._sl_cache[1]
        with span("shortlists_build"):
            out = device_shortlists_for(kscene, cam, self.config,
                                        self.config.samples_per_pixel)
        self._sl_cache = (key, out)
        return out

    def camera_values(self, cam: CameraState) -> tuple:
        """:func:`camera_key` of ``cam``, remembered for the same camera
        tensors; new tensors are read from their host copies, or come to the
        host in one copy."""
        leaves = camera_leaves(cam)
        ids = tuple(id(v) for v in leaves)
        if self._cam_memo is None or self._cam_memo[0] != ids:
            # ``leaves`` rides along: id() values are unique only among live
            # objects.
            self._cam_memo = (ids, leaves, camera_key(cam))
        return self._cam_memo[2]

    def render(self, scene: SceneBuffers, cam: CameraState, seed: int,
               raster_color: Optional[Vec3] = None,
               raster_depth=None) -> FrameResult:
        config = self.config
        dev = scene.spheres.cx.device
        # As PallasRenderer: the tables and the split gate come first, so a
        # forced split at level 0 raises there too.
        with span("frame_setup"):
            kscene = self.prepare(scene)
            sl, slmeta = self.shortlists(kscene, cam)
            if config.level == 0:
                return passthrough_frame(config, raster_color, dev)
        with span("queue"):
            r, g, b, depth, segs = render_tiles(kscene, cam, config,
                                                seed & 0xFFFFFFFF,
                                                exact_rng=self.exact_rng,
                                                sl=sl, slmeta=slmeta)
            self.last_mode = kernel_mode(kscene, config, sl)
            self.last_fuse = kernel_fuse(kscene, config, sl)
            self.last_exact_rng = resolve_exact_rng(self.exact_rng, dev)
            return frame_result(config, cam, (r, g, b, depth), segs, None,
                                raster_color, raster_depth, blocks=True)
