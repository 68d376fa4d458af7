"""The wavefront renderer's bounce body: ray generation and shading.

Counterpart of the jitted ``trace_sample`` of
``bevyray_tpu/engine/renderer.py`` outside its ray tests: the stream, jitter
and lens draws and ``generate_rays`` (:103-112) with the carry's init
(:130-139), the ``while_loop`` body without its ray tests (:149-200) and the
sample's harvest (:207-212). The bounce loop that calls these is
:func:`..engine.renderer.trace_sample`.

A sample's lanes live in a :class:`SampleState`, allocated once a frame
(:func:`new_state`) and updated in place: the ray, its throughput and
radiance, the active flag, the first hit's distance, the stream word, the
sample's segment count and its harvest (gamma colour and depth), beside the
camera row (:func:`camera_row`), the frame's camera scalars computed once
by torch on the lanes' device, and the camera and config it was made for:
ray generation takes its camera from the state and raises when handed
another.

:func:`raygen_sample` and :func:`shade_bounce` are wrappers: on CPU tensors
they run the plain versions :func:`raygen_sample_reference` and
:func:`shade_bounce_reference` (the JAX body's operations in its order,
with torch's own operators); on CUDA tensors they launch K5 and K6 of
``cuda/csrc/bounce.cu``, which give the same bits, or raise. They never
fall back. Their ``.launches`` count the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.constants import INF
from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..engine import slots
from .composite import background_gradient, linear_to_gamma
from .intersect import (gather_materials, make_hit_info, merge_hits,
                        triangle_hit_info)
from .raygen import _f32, generate_rays
from .shade import scatter

_M32 = 0xFFFFFFFF

# Slots of the camera row (csrc/bounce.h CAM_*).
(CAM_POS, CAM_DIR, CAM_UP, CAM_RIGHT) = (0, 3, 6, 9)
CAM_SCALE, CAM_ASPECT, CAM_HEIGHT, CAM_WIDTH = 12, 13, 14, 15
CAM_APERTURE, CAM_FOCUS, CAM_FALLBACK = 16, 17, 18
CAM_FLOATS = 19

# float32 columns of a SampleState a lane: origin, direction, ray_color,
# radiance (3 each), first_depth, the harvest's colour (3) and depth.
_FLOAT_ROWS = 17


class SampleState(NamedTuple):
    """One sample of ``n`` lanes, updated in place by :func:`raygen_sample`
    and :func:`shade_bounce`."""

    origin: Vec3
    direction: Vec3
    ray_color: Vec3            # the path's throughput
    radiance: Vec3
    active: torch.Tensor       # bool
    first_depth: torch.Tensor  # f32: the first hit's distance, INF on a miss
    stream: torch.Tensor       # int32: the bits of the u32 stream word
    segments: torch.Tensor     # 0-d int64: the sample's segments so far
    color: Vec3                # the harvest: gamma colour of the sample
    depth: torch.Tensor        # and its depth, with the level's fallback
    camera: torch.Tensor       # [CAM_FLOATS] f32: the camera row
    cam: CameraState           # the camera and config the row was made
    config: RenderConfig       # from, which every sample must use

    def columns(self) -> list:
        """The tensors in the order of the binding's ``state``."""
        return [*self.origin, *self.direction, *self.ray_color,
                *self.radiance, self.active, self.first_depth, self.stream,
                self.segments, *self.color, self.depth, self.camera]


def camera_row(cam: CameraState, config: RenderConfig,
               device) -> torch.Tensor:
    """The frame's camera scalars as one float32 tensor on ``device``, each
    computed by torch as :func:`.raygen.generate_rays` and the JAX body
    compute it: position, direction, up, right = direction x up,
    tan(fov / 2), aspect, the frame's height and height * aspect,
    aperture, focus distance, and the miss depth ``far + 10`` at level 1,
    ``far - 1`` otherwise (wgsl:177-182)."""
    right = cam.direction.cross(cam.up)
    h = _f32(config.height, device)
    fallback = cam.far + 10.0 if config.level == 1 else cam.far - 1.0
    parts = (*cam.position, *cam.direction, *cam.up, *right,
             torch.tan(cam.fov * 0.5), cam.aspect, h, h * cam.aspect,
             cam.aperture, cam.focus_distance, fallback)
    return torch.stack([p.to(device=device, dtype=torch.float32).reshape(())
                        for p in parts])


def new_state(n: int, cam: CameraState, config: RenderConfig,
              device) -> SampleState:
    """An uninitialised :class:`SampleState` of ``n`` lanes on ``device``
    (:func:`raygen_sample` writes its start) with the camera row."""
    device = torch.device(device)
    f = torch.empty((_FLOAT_ROWS, n), dtype=torch.float32, device=device)
    vec = [Vec3(f[k], f[k + 1], f[k + 2]) for k in (0, 3, 6, 9, 13)]
    return SampleState(
        origin=vec[0], direction=vec[1], ray_color=vec[2], radiance=vec[3],
        active=torch.empty(n, dtype=torch.bool, device=device),
        first_depth=f[12],
        stream=torch.empty(n, dtype=torch.int32, device=device),
        segments=torch.empty((), dtype=torch.int64, device=device),
        color=vec[4], depth=f[16], camera=camera_row(cam, config, device),
        cam=cam, config=config)


def _check_camera(state: SampleState, cam: CameraState,
                  config: RenderConfig) -> None:
    """Raise unless ``state`` was made for ``cam`` (this object) and an
    equal ``config``: its camera row, which K5 and the depth fallback read,
    is theirs."""
    if state.cam is not cam or state.config != config:
        raise ValueError("the SampleState was made for another camera or "
                         "config; make one for this camera with new_state")


def _assign(dst: Vec3, src: Vec3) -> None:
    for a, b in zip(dst, src):
        a.copy_(b)


def _draw_ball(stream, base: int, first_slot: int) -> Vec3:
    return rng.unit_ball_from_uniforms(
        *(rng.draw(stream, base + first_slot + k)
          for k in range(rng.BALL_DRAWS)))


def raygen_sample_reference(state: SampleState, pixel_ids: torch.Tensor,
                            u: torch.Tensor, v: torch.Tensor,
                            cam: CameraState, config: RenderConfig,
                            sample_index: int, frame_seed: int) -> None:
    """The plain version of :func:`raygen_sample`: the stream word of each
    (pixel, ``sample_index``, ``frame_seed``), the jitter draws and under
    ``config.defocus`` the lens draws, :func:`.raygen.generate_rays`, and
    the carry's start (throughput 1, radiance 0, every lane active, first
    depth INF, no segments), written into ``state``. ``state`` must have
    been made for ``cam`` and ``config`` (:func:`new_state`)."""
    _check_camera(state, cam, config)
    stream = rng.stream_init(pixel_ids.to(torch.int64),
                             int(sample_index) & _M32, int(frame_seed) & _M32)
    ju = rng.draw(stream, slots.JITTER_U)
    jv = rng.draw(stream, slots.JITTER_V)
    lu = lv = None
    if config.defocus:
        lu = rng.draw(stream, slots.LENS_U)
        lv = rng.draw(stream, slots.LENS_V)
    o, d = generate_rays(u, v, ju, jv, cam, config.height, lens_u=lu,
                         lens_v=lv)
    _assign(state.origin, o)
    _assign(state.direction, d)
    for c in state.ray_color:
        c.fill_(1.0)
    for c in state.radiance:
        c.fill_(0.0)
    state.active.fill_(True)
    state.first_depth.fill_(INF)
    # The u32 word's bits as int32.
    state.stream.copy_(torch.where(stream > 0x7FFFFFFF, stream - (1 << 32),
                                   stream))
    state.segments.zero_()


def shade_bounce_reference(state: SampleState, bounce: int, t, idx, tt, ti,
                           scene: SceneBuffers, config: RenderConfig) -> None:
    """The plain version of :func:`shade_bounce`: the JAX ``while_loop``
    body (bevyray_tpu/engine/renderer.py:149-200) after its ray tests, in
    its order of operations, on ``state`` in place. ``t``/``idx`` are the
    sphere test's results, ``tt``/``ti`` the triangle test's (None without
    triangles); INF / -1 on the lanes inactive at entry. The segment count
    adds the lanes active at entry; at bounce 0 every lane's first depth
    is the merged hit's t; on the last bounce (``config.bounces``) the
    harvest takes each lane's gamma colour and its depth (the fallback
    where no first hit)."""
    o, d, active = state.origin, state.direction, state.active
    state.segments.add_(active.sum())
    hit = make_hit_info(o, d, t, idx, scene.spheres)
    if tt is not None:
        hit = merge_hits(hit, triangle_hit_info(o, d, tt, ti,
                                                scene.triangles))
    if bounce == 0:                                   # wgsl:193-195
        state.first_depth.copy_(hit.t)
    ray_color = state.ray_color
    # A miss picks up the sky and ends the path (wgsl:198-201); a hit adds
    # its emission (an extension: 0 in the reference's scenes).
    radiance = Vec3.where(active & hit.miss,
                          state.radiance + ray_color * background_gradient(d),
                          state.radiance)
    active_hit = active & ~hit.miss
    mat = gather_materials(scene.materials, hit.material_id)
    radiance = Vec3.where(active_hit, radiance + ray_color * mat.emissive,
                          radiance)
    stream = state.stream.to(torch.int64) & _M32
    base = slots.bounce_base(bounce)
    sc = scatter(d, hit, mat, rng.draw(stream, base + slots.S_METAL),
                 rng.draw(stream, base + slots.S_TRANS),
                 rng.draw(stream, base + slots.S_REFLECT),
                 _draw_ball(stream, base, slots.S_BALL1),
                 _draw_ball(stream, base, slots.S_BALL2),
                 diffuse_mode=config.diffuse_sampling)   # wgsl:203-211
    cont = active_hit & ~sc.absorbed
    new_color = Vec3.where(cont, ray_color * sc.attenuation, ray_color)
    new_o = Vec3.where(active_hit, hit.position, o)
    new_d = Vec3.where(active_hit, sc.direction, d)
    _assign(state.radiance, radiance)
    _assign(state.ray_color, new_color)
    _assign(state.origin, new_o)
    _assign(state.direction, new_d)
    state.active.copy_(cont)
    if bounce == config.bounces:
        # Paths that ran out of bounces or were absorbed keep only the
        # light they gathered (wgsl:215-217). Gamma is per sample, before
        # the average (wgsl:165, 223).
        _assign(state.color, linear_to_gamma(state.radiance))
        state.depth.copy_(torch.where(state.first_depth >= INF,
                                      state.camera[CAM_FALLBACK],
                                      state.first_depth))


def raygen_sample(state: SampleState, pixel_ids: torch.Tensor,
                  u: torch.Tensor, v: torch.Tensor, cam: CameraState,
                  config: RenderConfig, sample_index: int,
                  frame_seed: int) -> None:
    """Write sample ``sample_index`` of the pixels ``pixel_ids`` (row-major
    ids, with their ``u``/``v``) into ``state``: the values of
    :func:`raygen_sample_reference`. On CPU tensors this runs the plain
    version; on CUDA tensors it launches K5 of ``cuda/csrc/bounce.cu``
    (which reads the camera row of ``state``) or raises. Either raises
    unless ``state`` was made for ``cam`` and ``config``.
    ``raygen_sample.launches`` counts the launches."""
    dev = u.device
    if dev.type == "cpu":
        raygen_sample_reference(state, pixel_ids, u, v, cam, config,
                                sample_index, frame_seed)
        return
    _check_cuda(dev, "raygen_sample")
    _check_camera(state, cam, config)
    from .cuda.build import extension

    extension().raygen_sample(
        state.columns(), pixel_ids.to(torch.int64).contiguous(),
        u.contiguous(), v.contiguous(), int(sample_index) & _M32,
        int(frame_seed) & _M32, bool(config.defocus))
    raygen_sample.launches += 1


def shade_bounce(state: SampleState, bounce: int, t, idx, tt, ti,
                 scene: SceneBuffers, config: RenderConfig) -> None:
    """Shade bounce ``bounce`` of every lane of ``state`` in place from its
    ray tests' results: the values of :func:`shade_bounce_reference`. On
    CPU tensors this runs the plain version; on CUDA tensors it launches
    K6 of ``cuda/csrc/bounce.cu`` or raises. ``shade_bounce.launches``
    counts the launches."""
    dev = t.device
    if dev.type == "cpu":
        shade_bounce_reference(state, bounce, t, idx, tt, ti, scene, config)
        return
    _check_cuda(dev, "shade_bounce")
    from .cuda.build import extension

    empty = torch.empty(0, device=dev)
    sph, mats = scene.spheres, scene.materials
    tris = []
    if tt is not None:
        tr = scene.triangles
        tris = [c.contiguous() for c in tr[:9]] + [
            tr.material_id.to(torch.int32).contiguous()]
    extension().shade_bounce(
        state.columns(), t.contiguous(), idx.to(torch.int64).contiguous(),
        empty if tt is None else tt.contiguous(),
        empty if ti is None else ti.to(torch.int64).contiguous(),
        [sph.cx.contiguous(), sph.cy.contiguous(), sph.cz.contiguous(),
         sph.material_id.to(torch.int32).contiguous()],
        tris,
        [c.contiguous() for c in (
            mats.base_r, mats.base_g, mats.base_b, mats.metallic,
            mats.roughness, mats.ior, mats.specular_transmission,
            mats.emissive_r, mats.emissive_g, mats.emissive_b)],
        int(bounce), int(bounce) == config.bounces,
        config.diffuse_sampling == "cosine")
    shade_bounce.launches += 1


raygen_sample.launches = 0
shade_bounce.launches = 0


def _check_cuda(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {dev}")
