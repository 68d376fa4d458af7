"""Adaptive sampling: per-pixel sample allocation guided by the estimate's
inter-pass disagreement.

Counterpart of ``bevyray_tpu/engine/adaptive.py``. A warm-up pass samples
every pixel; each later pass re-samples only the pixels whose relative
inter-pass disagreement is still at or above ``tolerance``, by giving the
fused kernel a per-lane sample target map (``render_tiles(spp_map=...)``), so
a stopped pixel traces nothing and the pass makes no host round trip. Every
``reprobe_every`` passes one pass samples every pixel again and re-measures
its disagreement, so a noisy pixel that stopped on one lucky pass recovers.

Estimates stay unbiased: sums divide by each pixel's actual count, and the
draws of either draw path are keyed by (pixel, absolute sample index), so a
pixel's k-th sample is the same whether it was traced adaptively or
uniformly.
Checkpoints are the JAX package's ``.npz``; ``rays_traced`` is an exact int64
count, as in :mod:`.film`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.types import (CameraState, RenderConfig, SceneBuffers,
                          resolve_device)
from ..core.vec import Vec3
from ..kernels.cuda.megakernel import KernelScene
from ..kernels.passes import adaptive_map, fold_adaptive
from .film import (begin_pass, film_arrays, film_from_arrays, resolve_impl,
                   trace_pass)
from .fused_renderer import FusedRenderer
from .renderer import FrameResult


class AdaptiveFilm(NamedTuple):
    color_sum: Vec3             # [N] gamma-space sums over traced samples
    depth_sum: torch.Tensor     # [N]
    n_samples: torch.Tensor     # [N] f32 per-pixel sample counts
    err: torch.Tensor           # [N] f32 inter-pass relative disagreement
    rays_traced: torch.Tensor   # 0-d int64


def new_adaptive_film(n: int, device) -> AdaptiveFilm:
    def zeros():
        return torch.zeros(n, dtype=torch.float32, device=device)

    return AdaptiveFilm(color_sum=Vec3(zeros(), zeros(), zeros()),
                        depth_sum=zeros(), n_samples=zeros(),
                        err=torch.full((n,), float("inf"), device=device),
                        rays_traced=torch.zeros((), dtype=torch.int64,
                                                device=device))


def adaptive_pass(film: AdaptiveFilm, kscene: KernelScene, cam: CameraState,
                  config: RenderConfig, frame_seed: int, sample_offset: int,
                  reprobe: bool, tolerance: float, sl=None,
                  slmeta=None) -> AdaptiveFilm:
    """One pass: pixels with err >= tolerance (every pixel when ``reprobe``)
    trace ``config.samples_per_pixel`` fresh samples, the rest none. Returns
    the updated film (a new one; the old one is not changed), with no host
    sync: on the card K13 (the sample map), the fused kernel and K14 (the
    fold, :mod:`...kernels.passes`)."""
    spp_map = adaptive_map(film.err, tolerance, reprobe, config)
    color, depth, segs = trace_pass(kscene, cam, config, frame_seed,
                                    sample_offset, sl, slmeta, spp_map,
                                    blocks=True)
    return AdaptiveFilm(*fold_adaptive(film, (*color, depth), segs,
                                       tolerance, reprobe, config))


class AdaptiveRenderer:
    """Progressive renderer that spends samples where the image is still
    noisy. ``config.samples_per_pixel`` is the per-pass budget; call
    ``step`` until ``converged_fraction()`` is high enough, or for a fixed
    number of passes.

    ``tolerance``: a pixel stops sampling once its relative inter-pass
    disagreement drops below it; 0 never stops a pixel (uniform progressive
    rendering). ``reprobe_every``: every this many passes one pass samples
    every pixel and re-measures it (0: never). ``device``: where the film
    lives (None: the CUDA card); the scenes given to ``step`` must lie there
    too. Each pass runs the fused CUDA kernel (its plain PyTorch version on
    CPU tensors) with the split and walk that ``config`` resolves to.
    """

    def __init__(self, config: RenderConfig, tolerance: float = 0.02,
                 reprobe_every: int = 4, *, device=None):
        self.config = config
        self.tolerance = float(tolerance)
        self.reprobe_every = int(reprobe_every)
        self.device = resolve_device(device)
        self.film = new_adaptive_film(config.n_pixels, self.device)
        self._renderer = FusedRenderer(config)
        self._sample_offset = 0
        self._pass_count = 0
        self._last_cam_key = None

    def reset(self) -> None:
        self.film = new_adaptive_film(self.config.n_pixels, self.device)
        self._sample_offset = 0
        self._pass_count = 0

    def step(self, scene: SceneBuffers, cam: CameraState, seed: int) -> None:
        # The film (and the camera-keyed shortlists) hold for one viewpoint:
        # a camera change resets, as in ProgressiveRenderer.
        kscene, sl, slmeta = begin_pass(self, scene, cam)
        reprobe = (self.reprobe_every > 0 and self._pass_count > 0
                   and self._pass_count % self.reprobe_every == 0)
        self.film = adaptive_pass(self.film, kscene, cam, self.config, seed,
                                  self._sample_offset, reprobe,
                                  self.tolerance, sl, slmeta)
        self._sample_offset += self.config.samples_per_pixel
        self._pass_count += 1

    def save(self, path: str) -> None:
        """Checkpoint the adaptive state (.npz), resumable mid-refinement."""
        np.savez(path, **film_arrays(self.film),
                 err=self.film.err.cpu().numpy(),
                 sample_offset=np.int64(self._sample_offset),
                 pass_count=np.int64(self._pass_count),
                 width=np.int64(self.config.width),
                 height=np.int64(self.config.height),
                 cam_key=np.asarray(self._last_cam_key or [], np.float64))

    def load(self, path: str) -> None:
        """Resume from a checkpoint of this package or the JAX package's.
        The next ``step`` under the saved camera continues it; another
        camera resets. Raises ValueError on another frame size."""
        with np.load(path) as z:
            if (int(z["width"]), int(z["height"])) != (self.config.width,
                                                       self.config.height):
                raise ValueError(
                    f"adaptive checkpoint {path!r} is {int(z['width'])}x"
                    f"{int(z['height'])} but the config is "
                    f"{self.config.width}x{self.config.height}")
            f = film_from_arrays(z, self.device)
            self.film = AdaptiveFilm(
                f.color_sum, f.depth_sum, f.n_samples,
                err=torch.as_tensor(np.asarray(z["err"], np.float32),
                                    device=self.device),
                rays_traced=f.rays_traced)
            self._sample_offset = int(z["sample_offset"])
            self._pass_count = (int(z["pass_count"]) if "pass_count" in z
                                else self._sample_offset
                                // max(self.config.samples_per_pixel, 1))
            ck = z["cam_key"] if "cam_key" in z else np.array([])
            self._last_cam_key = (tuple(float(v) for v in ck) if ck.size
                                  else None)

    def converged_fraction(self) -> float:
        return float((self.film.err < self.tolerance).to(torch.float32)
                     .mean())

    def samples_map(self) -> np.ndarray:
        return self.film.n_samples.cpu().numpy().reshape(self.config.height,
                                                         self.config.width)

    def resolve(self, cam: CameraState, raster_color: Optional[Vec3] = None,
                raster_depth=None) -> FrameResult:
        return resolve_impl(self.film, cam, self.config, raster_color,
                            raster_depth)
