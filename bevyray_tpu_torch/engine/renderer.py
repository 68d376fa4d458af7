"""The wavefront frame step and its front-end, ``Renderer``.

Counterpart of ``bevyray_tpu/engine/renderer.py``, the JAX package's public
default. The reference runs one fragment thread per pixel with a sample loop
and a bounce loop of per-thread ``break``s (raytrace.wgsl:93-224); here the
whole frame is one flat batch of rays, one per pixel, and a sample is ray
generation (:func:`..kernels.bounce.raygen_sample`), then per bounce the
sphere test (:func:`..kernels.intersect.intersect_spheres`) or the BVH walk
(:mod:`..kernels.traverse`), the triangle test where the scene has
triangles, and the shading (:func:`..kernels.bounce.shade_bounce`: the hit
records, the sky, the materials, :func:`..kernels.shade.scatter`). On a
CUDA card each of these is one hand-written kernel (``kernels/cuda/csrc/
wavefront.cu`` and ``bounce.cu``); on the CPU their plain PyTorch
versions run. The fused CUDA kernel is
:class:`.fused_renderer.FusedRenderer`.

The bounce loop is JAX's ``while_loop`` body run masked: every lane, every
one of the ``bounces + 1`` iterations, with each update under the lane's
``active`` flag (a dead lane adds nothing and its ray tests return at
once). A sample's lanes live in a :class:`..kernels.bounce.SampleState`,
allocated once a frame and updated in place; the samples fold into the frame's
sums (:class:`..kernels.bounce.FrameSums`) where the last bounce's shading
writes its harvest, and the frame's tail is one more kernel
(:func:`..kernels.frame.resolve_frame`, K10 of ``kernels/cuda/csrc/
frame.cu``): the mean, the composite over the raster layer and the image.
Nothing in a frame reads a value back to the host, so the host queues a
whole frame without waiting for the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.bounce import new_state, new_sums, raygen_sample, shade_bounce
from ..kernels.frame import _pixels, resolve_frame
from ..kernels.intersect import intersect_spheres, intersect_triangles
# pixel_uv is not used here; it stays importable from this module, as from
# the JAX package's engine/renderer.py.
from ..kernels.raygen import pixel_uv  # noqa: F401
from ..kernels.traverse import intersect_bvh, intersect_bvh_triangles

_M32 = 0xFFFFFFFF


class FrameResult(NamedTuple):
    image: torch.Tensor        # [H, W, 3] f32 — final composited, gamma-space
    rt_depth: torch.Tensor     # [H, W] f32 — sample-averaged first-hit distance
    rays_traced: torch.Tensor  # 0-d int64 — path segments traced this frame


def frame_result(config: RenderConfig, cam: CameraState, sums,
                 rays_traced: torch.Tensor, scale=None,
                 raster_color: Optional[Vec3] = None, raster_depth=None,
                 blocks: bool = False) -> FrameResult:
    """The traced layer's sums (r, g, b, depth: row-major ``[N]``, or in the
    fused kernel's block order where ``blocks``) times ``scale`` (None, a
    float or a count tensor), composited over the raster layer at
    ``config.level``; the raster layer defaults to white at reverse-Z depth
    0. One launch of K10 on the card
    (:func:`..kernels.frame.resolve_frame`)."""
    image, depth = resolve_frame(config, cam.near, cam.far, sums, scale,
                                 raster_color, raster_depth, blocks)
    return FrameResult(image=image, rt_depth=depth, rays_traced=rays_traced)


def passthrough_frame(config: RenderConfig, raster_color: Optional[Vec3],
                      device) -> FrameResult:
    """Level 0 (Skip): the raster layer as it is, nothing traced
    (wgsl:97-99)."""
    h, w = config.height, config.width
    if raster_color is None:
        raster_color = Vec3.splat(1.0, device=device)
    return FrameResult(
        image=_pixels(raster_color, h * w).reshape(h, w, 3),
        rt_depth=torch.zeros((h, w), dtype=torch.float32, device=device),
        rays_traced=torch.zeros((), dtype=torch.int64, device=device))


def resolve_intersect_backend(scene: SceneBuffers,
                              config: RenderConfig) -> str:
    """Resolve ``'auto'`` to a concrete backend once per frame, considering
    all primitive types, so the sphere and triangle paths agree. The port
    never runs on a TPU, so "auto" takes the JAX package's off-TPU rule: the
    BVH for a scene that carries one and whose largest table holds over 4096
    rows, else the dense test."""
    backend = config.intersect_backend
    if backend == "auto":
        cap = scene.spheres.capacity
        if scene.triangles is not None:
            cap = max(cap, scene.triangles.capacity)
        has_bvh = scene.bvh is not None or scene.tri_bvh is not None
        backend = "bvh" if (has_bvh and cap > 4096) else "brute"
    return backend


def make_intersect_fn(scene: SceneBuffers, config: RenderConfig):
    """``(origin, direction, active) -> (t, index)`` of the resolved
    backend: the dense test over the whole sphere table ("brute") or the
    bounded-stack walk of the scene's BVH (:mod:`..kernels.traverse`,
    "bvh"); INF / -1 where ``active`` is False."""
    if resolve_intersect_backend(scene, config) == "bvh":
        if scene.bvh is not None:
            return lambda o, d, active: intersect_bvh(
                o, d, scene.spheres, scene.bvh,
                max_leaf_size=config.bvh_leaf_size, active=active,
                walk=scene.sphere_walk)
        if config.intersect_backend == "bvh":
            raise ValueError("bvh backend requested but scene has no BVH")
        # "auto" chose the BVH for the triangles; the spheres have none.
    return lambda o, d, active: intersect_spheres(
        o, d, scene.spheres, config.sphere_chunk, active=active)


def trace_sample(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                 pixel_ids, u, v, sample_index: int, frame_seed: int,
                 intersect_fn=None, fixed_trip_count: bool = False,
                 state=None, sums=None, base=None):
    """Trace one sample of every pixel in ``pixel_ids`` (row-major ids, with
    their ``u``/``v``; or an int: the first of the frame's pixels, which the
    lanes take in row-major order, as many as ``state`` holds or the rest
    of the frame, their ``u``/``v`` computed with the draws and the
    arguments unread). Returns (gamma-space color: Vec3, depth: [N], the
    segments traced: 0-d int64).

    Twin of one iteration of ``trace_multisampled`` + ``raytrace``
    (raytrace.wgsl:159-224): draws keyed by (pixel, ``sample_index``,
    ``frame_seed``, slot) (:mod:`.slots`), miss depth ``far + 10`` at level 1
    and ``far - 1`` otherwise, radiance from the sky and emissive hits
    weighted by the throughput, gamma per sample.

    ``intersect_fn``: ``(origin, direction, active) -> (t, index)`` in
    place of :func:`make_intersect_fn`'s (the sphere-sharded step passes its
    own). ``fixed_trip_count``: kept for the callers of the JAX package's
    signature (the sharded step passes it); every bounce runs either way,
    so it changes nothing. ``state``: a
    :class:`..kernels.bounce.SampleState` of as many lanes made for this
    ``cam`` and ``config`` (:func:`..kernels.bounce.new_state`; another
    raises), reused from an earlier sample (allocated here when None); the
    returned tensors are its harvest and count, which the next sample
    traced into it overwrites. Every caller with a sample loop passes one
    state a pass. ``sums``: a :class:`..kernels.bounce.FrameSums` of as
    many lanes that receives ``base`` + this sample (its harvest and its
    segments; ``base`` None: zeros, and ``base`` may be ``sums``), folded
    in by the ray generation and the last bounce's shading.

    The loop is the JAX body (bevyray_tpu/engine/renderer.py:149-200) over
    every lane with updates under ``active``: ray generation, then per
    bounce the ray tests and the shading; the segment count is summed on
    the device, so nothing here waits for the card.
    """
    del fixed_trip_count
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, config)
    tri_bvh = (scene.tri_bvh
               if resolve_intersect_backend(scene, config) == "bvh" else None)
    if state is None:
        if isinstance(pixel_ids, torch.Tensor):
            n, dev = pixel_ids.shape[0], u.device
        else:
            n, dev = config.n_pixels - int(pixel_ids), scene.spheres.cx.device
        state = new_state(n, cam, config, dev)
    raygen_sample(state, pixel_ids, u, v, cam, config, sample_index,
                  frame_seed, sums, base)
    o, d, active = state.origin, state.direction, state.active
    for bounce in range(config.bounces + 1):          # wgsl:189
        t, idx = intersect_fn(o, d, active)
        tt = ti = None
        if scene.triangles is not None:
            if tri_bvh is not None:
                tt, ti = intersect_bvh_triangles(
                    o, d, scene.triangles, tri_bvh,
                    max_leaf_size=config.bvh_leaf_size, active=active)
            else:
                tt, ti = intersect_triangles(o, d, scene.triangles,
                                             active=active)
        shade_bounce(state, bounce, t, idx, tt, ti, scene, config, sums,
                     base)
    return state.color, state.depth, state.segments


def render_impl(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                frame_seed: int, raster_color: Optional[Vec3] = None,
                raster_depth=None) -> FrameResult:
    """One frame: ``config.samples_per_pixel`` samples of every pixel,
    averaged, composited over the raster layer at ``config.level`` (level 0
    passes the raster layer through and traces nothing)."""
    dev = scene.spheres.cx.device
    if config.level == 0:
        return passthrough_frame(config, raster_color, dev)
    n = config.n_pixels
    intersect_fn = make_intersect_fn(scene, config)
    state = new_state(n, cam, config, dev)
    sums = new_sums(n, dev)
    for i in range(config.samples_per_pixel):
        trace_sample(scene, cam, config, 0, None, None, i, frame_seed,
                     intersect_fn, state=state, sums=sums,
                     base=sums if i else None)
    inv_spp = float(np.float32(1.0 / config.samples_per_pixel))
    return frame_result(config, cam, (*sums.color, sums.depth),   # wgsl:169
                        sums.segments, inv_spp, raster_color, raster_depth)


class Renderer:
    """The wavefront front-end. Usage::

        world = rtiow.final_scene()
        r = Renderer(RenderConfig(width=1280, height=720, samples_per_pixel=16))
        frame = r.render(world.extract(), world.camera_state(aspect=16/9),
                         seed=1)

    Runs where the scene lies: the CUDA kernels of the ray tests and the
    bounce body on the card, their plain PyTorch versions on the CPU; the
    draws are the exact PCG streams, the only ones this path has.
    """

    def __init__(self, config: RenderConfig):
        self.config = config

    def render(self, scene: SceneBuffers, cam: CameraState, seed: int,
               raster_color: Optional[Vec3] = None,
               raster_depth=None) -> FrameResult:
        """Render one frame. ``seed`` plays the role of the reference's
        per-frame ``thread_rng`` seed (extract.rs:72-73), explicit and
        reproducible. ``raster_color``/``raster_depth`` supply the raster
        layer of the hybrid levels; they default to the reference app's
        white clear color (main.rs:60) at reverse-Z depth 0."""
        return render_impl(scene, cam, self.config, seed & _M32,
                           raster_color, raster_depth)
