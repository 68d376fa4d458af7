"""The wavefront frame step and its front-end, ``Renderer``.

Counterpart of ``bevyray_tpu/engine/renderer.py``, the JAX package's public
default. The reference runs one fragment thread per pixel with a sample loop
and a bounce loop of per-thread ``break``s (raytrace.wgsl:93-224); here the
whole frame is one flat batch of rays, one per pixel, and each bounce is a
handful of tensor operations over it: the sphere test
(:func:`..kernels.intersect.intersect_spheres`) or the BVH walk
(:mod:`..kernels.traverse`), which on a CUDA card are the hand-written
kernels of ``kernels/cuda/csrc/wavefront.cu``, then the hit and material
gathers, :func:`..kernels.shade.scatter` and the sky in PyTorch's own
operators. The fused CUDA kernel is :class:`.fused_renderer.FusedRenderer`.

The bounce loop is JAX's ``while_loop`` body run masked: every lane, every
one of the ``bounces + 1`` iterations, with each update under the lane's
``active`` flag (a dead lane adds nothing and its ray tests return at
once). Nothing in a frame reads a value back to the host, so the host
queues a whole frame without waiting for the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import rng
from ..core.constants import INF
from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.composite import (background_gradient, composite,
                                 linear_to_gamma)
from ..kernels.intersect import (gather_materials, intersect_spheres,
                                 intersect_triangles, make_hit_info,
                                 merge_hits, triangle_hit_info)
from ..kernels.raygen import generate_rays, pixel_uv
from ..kernels.shade import scatter
from ..kernels.traverse import intersect_bvh, intersect_bvh_triangles
from . import slots

_M32 = 0xFFFFFFFF


class FrameResult(NamedTuple):
    image: torch.Tensor        # [H, W, 3] f32 — final composited, gamma-space
    rt_depth: torch.Tensor     # [H, W] f32 — sample-averaged first-hit distance
    rays_traced: torch.Tensor  # 0-d int64 — path segments traced this frame


def frame_result(config: RenderConfig, cam: CameraState, rt_color: Vec3,
                 rt_depth: torch.Tensor, rays_traced: torch.Tensor,
                 raster_color: Optional[Vec3] = None,
                 raster_depth=None) -> FrameResult:
    """The traced layer (row-major ``[N]`` color and depth) composited over
    the raster layer at ``config.level``; the raster layer defaults to white
    at reverse-Z depth 0."""
    dev = rt_depth.device
    h, w = config.height, config.width
    if raster_color is None:
        raster_color = Vec3.splat(1.0, device=dev)
    if raster_depth is None:
        raster_depth = torch.zeros((), dtype=torch.float32, device=dev)
    out = composite(config.level, rt_color, rt_depth, cam.near.to(dev),
                    cam.far.to(dev), raster_color, raster_depth)
    return FrameResult(image=_pixels(out, h * w).reshape(h, w, 3),
                       rt_depth=rt_depth.reshape(h, w), rays_traced=rays_traced)


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


def _pixels(color: Vec3, n: int) -> torch.Tensor:
    """[n, 3] from a Vec3 whose components broadcast to [n]."""
    return torch.stack([torch.broadcast_to(c, (n,)) for c in color], dim=-1)


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


def _draw_ball(stream, base: int, first_slot: int) -> Vec3:
    return rng.unit_ball_from_uniforms(
        *(rng.draw(stream, base + first_slot + k)
          for k in range(rng.BALL_DRAWS)))


def trace_sample(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                 pixel_ids: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 sample_index: int, frame_seed: int, intersect_fn=None,
                 fixed_trip_count: bool = False):
    """Trace one sample of every pixel in ``pixel_ids`` (row-major ids, with
    their ``u``/``v``). Returns (gamma-space color: Vec3, depth: [N], the
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
    so it changes nothing.

    The loop is the JAX body (bevyray_tpu/engine/renderer.py:149-200) over
    every lane with updates under ``active``; the segment count is summed on
    the device, so nothing here waits for the card.
    """
    del fixed_trip_count
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, config)
    tri_bvh = (scene.tri_bvh
               if resolve_intersect_backend(scene, config) == "bvh" else None)
    dev = u.device
    n = pixel_ids.shape[0]
    stream = rng.stream_init(pixel_ids, int(sample_index) & _M32,
                             int(frame_seed) & _M32)
    ju = rng.draw(stream, slots.JITTER_U)
    jv = rng.draw(stream, slots.JITTER_V)
    lu = lv = None
    if config.defocus:
        lu = rng.draw(stream, slots.LENS_U)
        lv = rng.draw(stream, slots.LENS_V)
    o, d = generate_rays(u, v, ju, jv, cam, config.height, lens_u=lu,
                         lens_v=lv)
    o = Vec3(*(c.contiguous() for c in o))
    fallback_far = cam.far + 10.0 if config.level == 1 else cam.far - 1.0

    ray_color = Vec3.full((n,), 1.0, 1.0, 1.0, device=dev)
    radiance = Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
    first_depth = torch.full((n,), INF, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for bounce in range(config.bounces + 1):          # wgsl:189
        segments = segments + active.sum()
        t, idx = intersect_fn(o, d, active)
        hit = make_hit_info(o, d, t, idx, scene.spheres)
        if scene.triangles is not None:
            if tri_bvh is not None:
                tt, ti = intersect_bvh_triangles(
                    o, d, scene.triangles, tri_bvh,
                    max_leaf_size=config.bvh_leaf_size, active=active)
            else:
                tt, ti = intersect_triangles(o, d, scene.triangles,
                                             active=active)
            hit = merge_hits(hit, triangle_hit_info(o, d, tt, ti,
                                                    scene.triangles))
        if bounce == 0:                               # wgsl:193-195
            first_depth = hit.t
        # A miss picks up the sky and ends the path (wgsl:198-201); a hit
        # adds its emission (an extension: 0 in the reference's scenes).
        radiance = Vec3.where(active & hit.miss,
                              radiance + ray_color * background_gradient(d),
                              radiance)
        active_hit = active & ~hit.miss
        mat = gather_materials(scene.materials, hit.material_id)
        radiance = Vec3.where(active_hit, radiance + ray_color * mat.emissive,
                              radiance)
        base = slots.bounce_base(bounce)
        sc = scatter(d, hit, mat, rng.draw(stream, base + slots.S_METAL),
                     rng.draw(stream, base + slots.S_TRANS),
                     rng.draw(stream, base + slots.S_REFLECT),
                     _draw_ball(stream, base, slots.S_BALL1),
                     _draw_ball(stream, base, slots.S_BALL2),
                     diffuse_mode=config.diffuse_sampling)   # wgsl:203-211
        cont = active_hit & ~sc.absorbed
        ray_color = Vec3.where(cont, ray_color * sc.attenuation, ray_color)
        o = Vec3.where(active_hit, hit.position, o)
        d = Vec3.where(active_hit, sc.direction, d)
        active = cont
    # Paths that ran out of bounces or were absorbed keep only the light
    # they gathered (wgsl:215-217). Gamma is per sample, before the average
    # (wgsl:165, 223).
    depth = torch.where(first_depth >= INF, fallback_far, first_depth)
    return linear_to_gamma(radiance), depth, segments


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
    u, v = pixel_uv(config.width, config.height, device=dev)
    pixel_ids = torch.arange(n, device=dev)
    color_sum = Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
    depth_sum = torch.zeros(n, dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    intersect_fn = make_intersect_fn(scene, config)
    for i in range(config.samples_per_pixel):
        color, depth, segs = trace_sample(scene, cam, config, pixel_ids, u, v,
                                          i, frame_seed, intersect_fn)
        color_sum = color_sum + color
        depth_sum = depth_sum + depth
        segments = segments + segs
    inv_spp = float(np.float32(1.0 / config.samples_per_pixel))
    return frame_result(config, cam, color_sum.scale(inv_spp),   # wgsl:169
                        depth_sum * inv_spp, segments, raster_color,
                        raster_depth)


class Renderer:
    """The wavefront front-end. Usage::

        world = rtiow.final_scene()
        r = Renderer(RenderConfig(width=1280, height=720, samples_per_pixel=16))
        frame = r.render(world.extract(), world.camera_state(aspect=16/9),
                         seed=1)

    Runs where the scene lies (torch operators on either device); the draws
    are the exact PCG streams, the only ones this path has.
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
