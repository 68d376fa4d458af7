"""Progressive sample accumulation: running sums kept on the device across
passes.

Counterpart of ``bevyray_tpu/engine/film.py``. A ``Film`` holds the running
sums of a viewpoint; each pass of :class:`ProgressiveRenderer` traces
``config.samples_per_pixel`` fresh samples, with the sample index offset by
the samples already taken so that no stream repeats, and adds them: through
the wavefront ``trace_sample`` (backend "xla", the default, exact PCG
streams) or through the fused kernel (backend "pallas"), whose pass draws
from the path that the kernel resolves by default: the fast one for a film
on a CUDA card, the exact PCG streams elsewhere. The film resets whenever
the camera changes.

Checkpoints are the JAX package's ``.npz`` (keys ``color_x``, ``color_y``,
``color_z``, ``depth``, ``n_samples``, ``rays_traced``, and ``width`` /
``height`` when a config is given), so a film saved by either package loads
in the other. One deliberate difference: ``rays_traced`` is an exact int64
count here, where the JAX package sums it in float32, which stops being
exact past 2^24 segments (about a fifth of one 1920x1080, 16 spp pass);
a loaded count is cast to int64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.types import (CameraState, RenderConfig, SceneBuffers,
                          camera_key, resolve_device)
from ..core.vec import Vec3
from ..kernels.bounce import FrameSums, new_state, new_sums
from ..kernels.cuda.megakernel import KernelScene, render_tiles, unshuffle_blocks
from ..kernels.frame import fold_pass
from .fused_renderer import FusedRenderer
from .renderer import FrameResult, frame_result, trace_sample

_M32 = 0xFFFFFFFF


class Film(NamedTuple):
    color_sum: Vec3             # [N] running sums of gamma-space sample colors
    depth_sum: torch.Tensor     # [N]
    n_samples: torch.Tensor     # f32 samples per pixel: 0-d, or [N] (adaptive)
    rays_traced: torch.Tensor   # 0-d int64: segments ever traced


def save_film(path: str, film: Film,
              config: Optional[RenderConfig] = None) -> None:
    """Checkpoint the film as ``.npz``. With ``config``, width and height are
    stored, so a resume into another frame size fails loudly."""
    extra = {}
    if config is not None:
        extra = {"width": np.int64(config.width),
                 "height": np.int64(config.height)}
    np.savez(path, **film_arrays(film), **extra)


def load_film(path: str, config: Optional[RenderConfig] = None,
              device=None) -> Film:
    """A film saved by :func:`save_film` or by the JAX package's, on
    ``device`` (None: the CUDA card). With ``config``, a checkpoint of
    another frame size raises ValueError."""
    device = resolve_device(device)
    with np.load(path) as z:
        if config is not None:
            if "width" in z:
                w, h = int(z["width"]), int(z["height"])
                if (w, h) != (config.width, config.height):
                    raise ValueError(
                        f"film checkpoint {path!r} is {w}x{h} but the "
                        f"renderer config is {config.width}x{config.height}")
            elif z["color_x"].shape[0] != config.n_pixels:
                raise ValueError(
                    f"film checkpoint {path!r} has {z['color_x'].shape[0]} "
                    f"pixels but the renderer config expects "
                    f"{config.n_pixels}")
        return film_from_arrays(z, device)


def new_film(config: RenderConfig, device=None) -> Film:
    """An empty film on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    n = config.n_pixels
    return Film(color_sum=Vec3.full((n,), 0.0, 0.0, 0.0, device=device),
                depth_sum=torch.zeros(n, dtype=torch.float32, device=device),
                n_samples=torch.zeros((), dtype=torch.float32, device=device),
                rays_traced=torch.zeros((), dtype=torch.int64, device=device))


def resolve_impl(film: Film, cam: CameraState, config: RenderConfig,
                 raster_color: Optional[Vec3] = None,
                 raster_depth=None) -> FrameResult:
    """The estimate of ``film`` (a Film or an AdaptiveFilm: sums over
    per-pixel counts, at least 1) composited at ``config.level``; the raster
    layer defaults to white at reverse-Z depth 0. One launch of K10 on the
    card (:func:`...kernels.frame.resolve_frame`)."""
    return frame_result(config, cam, (*film.color_sum, film.depth_sum),
                        film.rays_traced, film.n_samples, raster_color,
                        raster_depth)


def accumulate_impl(film: Film, scene: SceneBuffers, cam: CameraState,
                    config: RenderConfig, frame_seed: int,
                    sample_offset: int) -> Film:
    """One pass of ``config.samples_per_pixel`` fresh samples of every pixel
    through the wavefront :func:`.renderer.trace_sample`, sample indices
    ``sample_offset + i`` (mod 2^32), folded into ``film`` one sample at a
    time, as the JAX package's pass folds them (a new film; the old one is
    not changed): the first sample's shading adds it to the old film's sums
    into new ones, and each later sample's adds it to those in place."""
    dev = film.depth_sum.device
    n = config.n_pixels
    state = new_state(n, cam, config, dev)
    sums = new_sums(n, dev)
    old = FrameSums(film.color_sum, film.depth_sum, film.rays_traced)
    for i in range(config.samples_per_pixel):
        trace_sample(scene, cam, config, 0, None, None,
                     (sample_offset + i) & _M32, frame_seed, state=state,
                     sums=sums, base=sums if i else old)
    return Film(color_sum=sums.color, depth_sum=sums.depth,
                n_samples=film.n_samples + config.samples_per_pixel,
                rays_traced=sums.segments)


def trace_pass(kscene: KernelScene, cam: CameraState, config: RenderConfig,
               frame_seed: int, sample_offset: int, sl=None, slmeta=None,
               spp_map=None, blocks: bool = False):
    """One fused-kernel pass of an accumulating film: (r, g, b, depth) sums
    in row-major pixel order (``blocks``: in the kernel's block order, as it
    gives them) and the segment count. ``sample_offset`` wraps
    mod 2^32, as the kernel's add does. The draw path is the kernel's
    default for the scene's device
    (:func:`...kernels.cuda.megakernel.resolve_exact_rng`), as the JAX
    package's film passes none."""
    r, g, b, depth, segs = render_tiles(
        kscene, cam, config, frame_seed & _M32,
        sample_offset=sample_offset & _M32, normalize=False, sl=sl,
        slmeta=slmeta, spp_map=spp_map)
    if not blocks:
        r, g, b, depth = (unshuffle_blocks(x, config)
                          for x in (r, g, b, depth))
    return Vec3(r, g, b), depth, segs


def pallas_accumulate_impl(film: Film, kscene: KernelScene, cam: CameraState,
                           config: RenderConfig, frame_seed: int,
                           sample_offset: int, sl=None, slmeta=None) -> Film:
    """One pass of ``config.samples_per_pixel`` fresh samples for every pixel,
    folded into ``film`` (a new film; the old one is not changed): the
    fused kernel's sums, then one launch of K11 on the card
    (:func:`...kernels.frame.fold_pass`)."""
    color, depth, segs = trace_pass(kscene, cam, config, frame_seed,
                                    sample_offset, sl, slmeta, blocks=True)
    return Film(*fold_pass(film.color_sum, film.depth_sum, film.n_samples,
                           film.rays_traced, (*color, depth), segs, config))


def check_scene_and_camera(owner, scene: SceneBuffers,
                           cam: CameraState) -> tuple:
    """The first check of one step of an accumulating renderer ``owner``
    (one with ``film``, ``reset()`` and ``_last_cam_key``): the scene must
    lie on the film's device; any change of a camera value, compared on the
    host from one copy, resets the film. Returns the camera's key."""
    dev = owner.film.depth_sum.device
    if scene.spheres.cx.device != dev:
        raise ValueError(f"the scene lies on {scene.spheres.cx.device} but "
                         f"the film on {dev}")
    key = camera_key(cam)
    if key != owner._last_cam_key:
        owner.reset()
        owner._last_cam_key = key
    return key


def begin_pass(owner, scene: SceneBuffers, cam: CameraState):
    """The set-up of one fused-kernel step of an accumulating renderer
    ``owner`` (:func:`check_scene_and_camera`, and a ``_renderer``): returns
    the prepared scene and the shortlists ``(kscene, sl, slmeta)``."""
    key = check_scene_and_camera(owner, scene, cam)
    kscene = owner._renderer.prepare(scene)
    return (kscene, *owner._renderer.shortlists(kscene, cam, values=key))


class ProgressiveRenderer:
    """Accumulating front-end: call ``step`` repeatedly and the estimate
    refines. The film resets when any camera value changes (compared on the
    host from one copy per step).

    ``backend="pallas"`` runs each pass through the fused CUDA kernel (its
    plain PyTorch version on CPU tensors); any other backend, the default
    ``"xla"`` among them, as in the JAX package, through the wavefront
    ``trace_sample`` (:func:`accumulate_impl`). ``device``: where the film
    lives (None: the CUDA card); the scenes given to ``step`` must lie there
    too.
    """

    def __init__(self, config: RenderConfig, backend: str = "xla", *,
                 device=None):
        self.config = config
        self.backend = backend
        self.device = resolve_device(device)
        self.film = new_film(config, self.device)
        self._renderer = FusedRenderer(config) if backend == "pallas" else None
        self._last_cam_key = None
        self._sample_offset = 0

    def reset(self) -> None:
        self.film = new_film(self.config, self.device)
        self._sample_offset = 0

    def step(self, scene: SceneBuffers, cam: CameraState, seed: int,
             raster_color: Optional[Vec3] = None,
             raster_depth=None) -> FrameResult:
        if self.backend != "pallas":
            check_scene_and_camera(self, scene, cam)
            self.film = accumulate_impl(self.film, scene, cam, self.config,
                                        seed & _M32, self._sample_offset)
        else:
            kscene, sl, slmeta = begin_pass(self, scene, cam)
            self.film = pallas_accumulate_impl(self.film, kscene, cam,
                                               self.config, seed,
                                               self._sample_offset, sl,
                                               slmeta)
        self._sample_offset += self.config.samples_per_pixel
        return resolve_impl(self.film, cam, self.config, raster_color,
                            raster_depth)

    @property
    def samples_accumulated(self) -> int:
        return self._sample_offset

    # -- checkpoint / resume -------------------------------------------------
    def save(self, path: str) -> None:
        save_film(path, self.film, self.config)

    def load(self, path: str, cam: CameraState) -> None:
        """Resume from a checkpoint taken with the same config and camera;
        later steps continue the sample-index sequence exactly. Raises
        ValueError on a width/height mismatch with this config."""
        self.film = load_film(path, self.config, self.device)
        self._sample_offset = int(self.film.n_samples)
        self._last_cam_key = camera_key(cam)


def film_arrays(film) -> dict:
    """The ``.npz`` arrays of a film's sums and counts (either film type)."""
    def host(t):
        return t.detach().cpu().numpy()

    return dict(color_x=host(film.color_sum.x), color_y=host(film.color_sum.y),
                color_z=host(film.color_sum.z), depth=host(film.depth_sum),
                n_samples=host(film.n_samples),
                rays_traced=host(film.rays_traced))


def film_from_arrays(z, device) -> Film:
    """The sums and counts of an ``.npz`` checkpoint of either package on
    ``device``: float32 sums and counts, an int64 segment count."""
    def f32(key):
        return torch.as_tensor(np.asarray(z[key], np.float32), device=device)

    return Film(color_sum=Vec3(f32("color_x"), f32("color_y"),
                               f32("color_z")),
                depth_sum=f32("depth"), n_samples=f32("n_samples"),
                rays_traced=torch.as_tensor(np.asarray(z["rays_traced"]),
                                            device=device).to(torch.int64))
