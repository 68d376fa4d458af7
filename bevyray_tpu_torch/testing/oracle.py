"""Scalar NumPy oracle: an independent implementation of the exact algorithm.

Counterpart of ``bevyray_tpu/testing/oracle.py``, formula for formula, draw
for draw and in the same float32 order, so that on the same NumPy inputs the
two give the same bits (``tests/test_torch_golden.py``). It is the golden-image
reference the port's renderers are held to: the wavefront ``Renderer``, and
the fused ``render_tiles`` on the CPU (its plain version) and on the card (the
CUDA kernel, ``chip_smoke.py``).

It uses the *reference's* control-flow shape, a serial per-ray bounce loop with
real ``break``s (raytrace.wgsl:189-212), rather than a masked wavefront or a
per-thread kernel loop, so a bug in the masking logic cannot hide in both. Its
formulas and quirks follow raytrace.wgsl: the near root only, hollow glass by
a negative radius, the fallback far of level 1, per-sample gamma. Its draws
follow the slot contract of :mod:`..engine.slots`, from the uint32 NumPy
streams of :mod:`.rng_np`.

It stays NumPy, not torch, by design: it is worth something only because it
shares neither code nor arithmetic with the renderers under test. NumPy rounds
each float32 operation once, contracts no multiply-add and takes an exact
``sqrt``; PyTorch's CPU float32 ``sqrt`` is 1 ulp off on some inputs, and a
torch oracle would inherit the port's own quirks. Agreement with a renderer
is then limited by libm (``log``/``sin``/``cos``/``exp``/``tan``, ~1e-7
relative per op), which can flip a hit or a branch on a measure-zero set of
rays, so image comparisons are tolerance-based.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import INF, NEAR_ZERO, T_MIN
from ..engine import slots
from . import rng_np as rng

F = np.float32


def _normalize(v):
    return (v / np.sqrt((v * v).sum())).astype(F)


def _reflect(v, n):
    return (v - 2.0 * np.dot(v, n) * n).astype(F)


def _refract(v, n, ri):
    cos_theta = min(np.dot(-v, n), F(1.0))
    r_out_perp = (ri * (v + cos_theta * n)).astype(F)
    r_out_parallel = (-np.sqrt(abs(F(1.0) - (r_out_perp * r_out_perp).sum())) * n)
    return (r_out_perp + r_out_parallel).astype(F)


def _schlick(cosine, ri):
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return F(r0 + (1.0 - r0) * (1.0 - cosine) ** 5)


def _draw(stream, slot):
    with np.errstate(over="ignore"):
        return rng.draw(np.uint32(stream), np.uint32(slot))


def _ball(stream, base, first):
    us = [_draw(stream, base + first + k) for k in range(5)]
    return rng.unit_ball_from_uniforms_np(*[np.float32(u) for u in us])


def _raycast(origin, direction, centers, radii):
    """Nearest-hit over all spheres (raycast_against_range + hit_sphere,
    wgsl:348-383). Vectorized over spheres only."""
    oc = (centers - origin).astype(F)                     # wgsl:372
    a = F(np.dot(direction, direction))
    h = (oc @ direction).astype(F)                        # wgsl:374
    c = ((oc * oc).sum(1) - radii * radii).astype(F)      # wgsl:375
    disc = (h * h - a * c).astype(F)
    ok = disc >= 0.0
    t = np.where(ok, (h - np.sqrt(np.where(ok, disc, 0.0))) / a, F(-1.0)).astype(F)
    ok = ok & (t > T_MIN)                                 # wgsl:353
    t = np.where(ok, t, F(INF))
    i = int(np.argmin(t))
    return (F(t[i]), i) if t[i] < INF else (F(INF), -1)


def _raycast_triangles(origin, direction, tri_a, tri_b, tri_c):
    """Nearest triangle hit (Möller–Trumbore), same acceptance as
    kernels.intersect.intersect_triangles. Returns (t, index)."""
    e1 = (tri_b - tri_a).astype(F)
    e2 = (tri_c - tri_a).astype(F)
    p = np.cross(np.broadcast_to(direction, e2.shape), e2).astype(F)
    det = (p * e1).sum(1).astype(F)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = (F(1.0) / det).astype(F)
        tv = (origin - tri_a).astype(F)
        u = ((tv * p).sum(1) * inv_det).astype(F)
        q = np.cross(tv, e1).astype(F)
        v = ((q * np.broadcast_to(direction, q.shape)).sum(1) * inv_det).astype(F)
        t = ((q * e2).sum(1) * inv_det).astype(F)
    ok = ((np.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > T_MIN))
    t = np.where(ok, t, F(INF))
    i = int(np.argmin(t))
    return (F(t[i]), i) if t[i] < INF else (F(INF), -1)


def render_oracle(centers, radii, materials, camera, width, height,
                  samples_per_pixel, bounces, level, frame_seed,
                  raster_color=(1.0, 1.0, 1.0), raster_depth=0.0,
                  defocus=False, diffuse_sampling="reference",
                  triangles=None):
    """Render a full frame.

    ``camera``: dict with position, direction, up (3-vectors), fov, near, far,
    aspect. Returns (image [H,W,3] f32, rt_depth [H,W] f32).
    """
    centers = np.asarray(centers, F)
    radii = np.asarray(radii, F)
    materials = np.asarray(materials, F)
    if triangles is not None:
        # (va [T,3], vb, vc, material_ids [T]) — world-space corners.
        tri_a, tri_b, tri_c, tri_mids = (np.asarray(x) for x in triangles)
    pos = np.asarray(camera["position"], F)
    cam_dir = np.asarray(camera["direction"], F)
    up = np.asarray(camera["up"], F)
    fov, near, far = F(camera["fov"]), F(camera["near"]), F(camera["far"])
    aspect = F(camera["aspect"])
    # Raster inputs may be constants or full buffers ([H,W,3] color, [H,W]
    # reverse-Z depth — e.g. from engine.raster for the hybrid modes).
    raster_color = np.asarray(raster_color, F)
    raster_depth = np.asarray(raster_depth, F)

    right = np.cross(cam_dir, up).astype(F)               # wgsl:149
    scale = F(np.tan(fov * 0.5))

    fallback_far = F(far + 10.0) if level == 1 else F(far - 1.0)  # wgsl:177-182

    image = np.zeros((height, width, 3), F)
    depth_img = np.zeros((height, width), F)

    for py in range(height):
        for px in range(width):
            pixel_id = np.uint32(py * width + px)
            u = F((px + 0.5) / width)
            v = F((py + 0.5) / height)
            color_sum = np.zeros(3, F)
            depth_sum = F(0.0)
            for s in range(samples_per_pixel):
                with np.errstate(over="ignore"):
                    stream = rng.stream_init(pixel_id, np.uint32(s),
                                             np.uint32(frame_seed))
                # --- ray gen (wgsl:139-156) --------------------------------
                ju = _draw(stream, slots.JITTER_U)
                jv = _draw(stream, slots.JITTER_V)
                h_px = F(height)
                w_px = F(h_px * aspect)
                ndc_x = F((u * 2.0 - 1.0) + (ju - 0.5) / w_px)
                ndc_y = F((1.0 - v * 2.0) + (jv - 0.5) / h_px)
                d = _normalize(cam_dir + ndc_x * aspect * scale * right
                               + ndc_y * scale * up)
                o = pos.copy()

                if defocus:
                    lu = _draw(stream, slots.LENS_U)
                    lv = _draw(stream, slots.LENS_V)
                    lens_radius = F(camera.get("aperture", 0.0)) * F(0.5)
                    rr_ = lens_radius * np.sqrt(F(lu))
                    th = F(2.0 * np.pi) * F(lv)
                    focal = (o + F(camera.get("focus_distance", 1.0)) * d).astype(F)
                    o = (o + rr_ * np.cos(th) * right
                         + rr_ * np.sin(th) * up).astype(F)
                    d = _normalize(focal - o)

                # --- bounce loop (wgsl:174-224) ------------------------------
                first_depth = F(INF)
                ray_color = np.ones(3, F)
                light = np.zeros(3, F)
                radiance = np.zeros(3, F)
                b = 0
                while b <= bounces:
                    t, idx = _raycast(o, d, centers, radii)
                    hit_tri = False
                    if triangles is not None:
                        tt, ti = _raycast_triangles(o, d, tri_a, tri_b, tri_c)
                        if tt < t:
                            t, idx, hit_tri = tt, ti, True
                    if b == 0:
                        first_depth = t
                    if t >= INF:
                        unit = _normalize(d)              # wgsl:364-369
                        a01 = F(0.5 * (unit[1] + 1.0))
                        light = ((1.0 - a01) * np.ones(3, F)
                                 + a01 * np.array([0.5, 0.7, 1.0], F)).astype(F)
                        radiance = (radiance + ray_color * light).astype(F)
                        break
                    # hit info (wgsl:355-358)
                    hit_pos = (o + t * d).astype(F)
                    if hit_tri:
                        normal = _normalize(np.cross(tri_b[idx] - tri_a[idx],
                                                     tri_c[idx] - tri_a[idx]))
                        m = materials[int(tri_mids[idx])]
                    else:
                        normal = _normalize(hit_pos - centers[idx])
                        m = materials[idx]
                    front_face = np.dot(d, normal) < 0.0
                    base_color = m[0:3]
                    metallic, roughness, ior, spec_trans = m[3], m[4], m[6], m[7]
                    if m.shape[0] > 8:
                        radiance = (radiance + ray_color * m[8:11]).astype(F)

                    sbase = slots.bounce_base(b)
                    u_metal = _draw(stream, sbase + slots.S_METAL)
                    u_trans = _draw(stream, sbase + slots.S_TRANS)
                    u_reflect = _draw(stream, sbase + slots.S_REFLECT)

                    if u_metal < metallic:
                        # metal (wgsl:234-245)
                        ball1 = _ball(stream, sbase, slots.S_BALL1)
                        new_d = (_normalize(_reflect(d, normal))
                                 + roughness * ball1).astype(F)
                        attenuation = base_color
                        absorbed = np.dot(new_d, normal) < 0.0
                    elif u_trans < spec_trans:
                        # dielectric (wgsl:249-280)
                        ri = F(1.0 / ior) if front_face else F(ior)
                        unit = _normalize(d)
                        cos_theta = min(np.dot(-unit, normal), F(1.0))
                        sin_theta = np.sqrt(max(F(1.0) - cos_theta * cos_theta, F(0.0)))
                        cannot = ri * sin_theta > 1.0
                        if cannot or _schlick(cos_theta, ri) > u_reflect:
                            new_d = _reflect(unit, normal)
                        else:
                            new_d = _refract(unit, normal, ri)
                        attenuation = np.ones(3, F)
                        absorbed = False
                    else:
                        # diffuse (wgsl:282-297)
                        ball1 = _ball(stream, sbase, slots.S_BALL1)
                        if diffuse_sampling == "cosine":
                            new_d = (normal + _normalize(ball1)).astype(F)
                        else:
                            ball2 = _ball(stream, sbase, slots.S_BALL2)
                            new_d = (normal + ball1 + roughness * ball2).astype(F)
                        if (np.abs(new_d) < NEAR_ZERO).all():
                            new_d = normal
                        attenuation = base_color
                        absorbed = np.dot(new_d, normal) < 0.0

                    if absorbed:
                        break
                    ray_color = (ray_color * attenuation).astype(F)
                    o, d = hit_pos, new_d
                    b += 1

                if first_depth >= INF:
                    first_depth = fallback_far

                # Exhausted/absorbed rays never added sky light; their radiance
                # holds only emissive hits — 0 in reference scenes, matching the
                # reference's loop-exhaustion blackness (wgsl:215-217).
                sample = np.sqrt(np.maximum(radiance, 0.0)).astype(F)
                color_sum += sample
                depth_sum += first_depth

            rt_color = color_sum / F(samples_per_pixel)
            rt_depth = depth_sum / F(samples_per_pixel)
            depth_img[py, px] = rt_depth

            # composite (wgsl:97-122)
            rc = raster_color[py, px] if raster_color.ndim == 3 else raster_color
            rd = raster_depth[py, px] if raster_depth.ndim == 2 else raster_depth
            if level == 0:
                out = rc
            elif level == 3:
                out = rt_color
            else:
                rz = F(-1.0) if rt_depth > far else F(near / rt_depth)
                out = rc if rd > rz else rt_color
            image[py, px] = out

    return image, depth_img


def _normalize_rows(v):
    return (v / np.sqrt((v * v).sum(1, dtype=F))[:, None]).astype(F)


def _ball_rows(stream, base, first):
    us = [rng.draw(stream, np.uint32(base + first + k)).astype(F)
          for k in range(5)]
    return rng.unit_ball_from_uniforms_np(*us)   # (rows, 3) f32


def render_oracle_fast(centers, radii, materials, camera, width, height,
                       samples_per_pixel, bounces, level, frame_seed,
                       raster_color=(1.0, 1.0, 1.0), raster_depth=0.0,
                       defocus=False, diffuse_sampling="reference",
                       triangles=None):
    """Pixel-vectorized oracle — same algorithm, draws, and f32 discipline as
    :func:`render_oracle`, with the PIXEL dimension vectorized (NumPy) so golden
    tests can afford 96²+/4spp frames. The per-sample bounce loop keeps REAL
    breaks — dead rays leave via boolean-index compaction, not masking — so it
    remains an independent check on the renderers' masked wavefronts.
    Held to the scalar oracle in tests/test_torch_golden.py.
    """
    centers = np.asarray(centers, F)
    radii = np.asarray(radii, F)
    materials = np.asarray(materials, F)
    if triangles is not None:
        tri_a, tri_b, tri_c, tri_mids = (np.asarray(x) for x in triangles)
    pos = np.asarray(camera["position"], F)
    cam_dir = np.asarray(camera["direction"], F)
    up = np.asarray(camera["up"], F)
    fov, near, far = F(camera["fov"]), F(camera["near"]), F(camera["far"])
    aspect = F(camera["aspect"])
    raster_color = np.asarray(raster_color, F)
    raster_depth = np.asarray(raster_depth, F)

    right = np.cross(cam_dir, up).astype(F)
    scale = F(np.tan(fov * 0.5))
    fallback_far = F(far + 10.0) if level == 1 else F(far - 1.0)

    n = width * height
    pixel_ids = np.arange(n, dtype=np.uint32)
    px = (pixel_ids % np.uint32(width)).astype(F)
    py = (pixel_ids // np.uint32(width)).astype(F)
    u = ((px + F(0.5)) / F(width)).astype(F)
    v = ((py + F(0.5)) / F(height)).astype(F)

    color_sum = np.zeros((n, 3), F)
    depth_sum = np.zeros(n, F)

    for s in range(samples_per_pixel):
        with np.errstate(over="ignore"):
            stream = rng.stream_init(pixel_ids, np.uint32(s),
                                     np.uint32(frame_seed))
        ju = rng.draw(stream, np.uint32(slots.JITTER_U)).astype(F)
        jv = rng.draw(stream, np.uint32(slots.JITTER_V)).astype(F)
        h_px = F(height)
        w_px = F(h_px * aspect)
        ndc_x = ((u * F(2.0) - F(1.0)) + (ju - F(0.5)) / w_px).astype(F)
        ndc_y = ((F(1.0) - v * F(2.0)) + (jv - F(0.5)) / h_px).astype(F)
        d = _normalize_rows(cam_dir[None, :]
                            + (ndc_x * aspect * scale)[:, None] * right[None, :]
                            + (ndc_y * scale)[:, None] * up[None, :])
        o = np.broadcast_to(pos, (n, 3)).astype(F).copy()

        if defocus:
            lu = rng.draw(stream, np.uint32(slots.LENS_U)).astype(F)
            lv = rng.draw(stream, np.uint32(slots.LENS_V)).astype(F)
            lens_radius = F(camera.get("aperture", 0.0)) * F(0.5)
            rr_ = (lens_radius * np.sqrt(lu)).astype(F)
            th = (F(2.0 * np.pi) * lv).astype(F)
            focal = (o + F(camera.get("focus_distance", 1.0)) * d).astype(F)
            o = (o + (rr_ * np.cos(th).astype(F))[:, None] * right[None, :]
                 + (rr_ * np.sin(th).astype(F))[:, None] * up[None, :]).astype(F)
            d = _normalize_rows(focal - o)

        first_depth = np.full(n, INF, F)
        radiance = np.zeros((n, 3), F)
        ray_color = np.ones((n, 3), F)
        live = np.arange(n)          # compaction: indices of still-tracing rays
        live_stream = stream

        for b in range(bounces + 1):
            if live.size == 0:
                break
            # nearest sphere hit, vectorized over (rays × spheres)
            oc = (centers[None, :, :] - o[live][:, None, :]).astype(F)
            dl = d[live]
            a = (dl * dl).sum(1, dtype=F)
            h = (oc * dl[:, None, :]).sum(2, dtype=F)
            c = ((oc * oc).sum(2, dtype=F) - (radii * radii)[None, :]).astype(F)
            disc = (h * h - a[:, None] * c).astype(F)
            ok = disc >= 0.0
            t_all = np.where(
                ok, (h - np.sqrt(np.where(ok, disc, 0.0))) / a[:, None],
                F(-1.0)).astype(F)
            t_all = np.where(ok & (t_all > T_MIN), t_all, F(INF))
            idx = np.argmin(t_all, 1)
            t = t_all[np.arange(live.size), idx].astype(F)
            is_tri = np.zeros(live.size, bool)
            if triangles is not None:
                e1 = (tri_b - tri_a).astype(F)
                e2 = (tri_c - tri_a).astype(F)
                p = np.cross(dl[:, None, :], e2[None, :, :]).astype(F)
                det = (p * e1[None, :, :]).sum(2, dtype=F)
                with np.errstate(divide="ignore", invalid="ignore"):
                    inv_det = (F(1.0) / det).astype(F)
                    tv = (o[live][:, None, :] - tri_a[None, :, :]).astype(F)
                    uu = ((tv * p).sum(2, dtype=F) * inv_det).astype(F)
                    q = np.cross(tv, e1[None, :, :]).astype(F)
                    vv = ((q * dl[:, None, :]).sum(2, dtype=F)
                          * inv_det).astype(F)
                    tt = ((q * e2[None, :, :]).sum(2, dtype=F)
                          * inv_det).astype(F)
                tok = ((np.abs(det) > 1e-12) & (uu >= 0.0) & (vv >= 0.0)
                       & (uu + vv <= 1.0) & (tt > T_MIN))
                tt = np.where(tok, tt, F(INF))
                tidx = np.argmin(tt, 1)
                tbest = tt[np.arange(live.size), tidx].astype(F)
                is_tri = tbest < t
                idx = np.where(is_tri, tidx, idx)
                t = np.where(is_tri, tbest, t)

            if b == 0:
                first_depth[live] = t

            # miss → sky, then break (compaction)
            miss = t >= INF
            if miss.any():
                unit = _normalize_rows(dl[miss])
                a01 = (F(0.5) * (unit[:, 1] + F(1.0))).astype(F)
                sky = ((1.0 - a01)[:, None] * np.ones(3, F)[None, :]
                       + a01[:, None] * np.array([0.5, 0.7, 1.0], F)[None, :]
                       ).astype(F)
                mids = live[miss]
                radiance[mids] = (radiance[mids] + ray_color[mids] * sky
                                  ).astype(F)
            keep = ~miss
            live = live[keep]
            if live.size == 0:
                break
            dl, t, idx, is_tri = dl[keep], t[keep], idx[keep], is_tri[keep]
            live_stream = stream[live]

            hit_pos = (o[live] + t[:, None] * dl).astype(F)
            # idx is a triangle index on is_tri rows, a sphere index otherwise;
            # clamp each view so np.where can evaluate both branches safely.
            sph_idx = np.where(is_tri, 0, idx)
            normal = _normalize_rows(hit_pos - centers[sph_idx])
            mrow = sph_idx
            if triangles is not None:
                tri_idx = np.where(is_tri, idx, 0)
                tn = _normalize_rows(np.cross(tri_b[tri_idx] - tri_a[tri_idx],
                                              tri_c[tri_idx] - tri_a[tri_idx])
                                     .astype(F))
                normal = np.where(is_tri[:, None], tn, normal).astype(F)
                mrow = np.where(is_tri, tri_mids[tri_idx], sph_idx)
            m = materials[mrow]
            front_face = (dl * normal).sum(1, dtype=F) < 0.0
            base_color = m[:, 0:3]
            metallic, roughness = m[:, 3], m[:, 4]
            ior, spec_trans = m[:, 6], m[:, 7]
            if m.shape[1] > 8:
                radiance[live] = (radiance[live] + ray_color[live] * m[:, 8:11]
                                  ).astype(F)

            sbase = slots.bounce_base(b)
            u_metal = rng.draw(live_stream, np.uint32(sbase + slots.S_METAL)
                               ).astype(F)
            u_trans = rng.draw(live_stream, np.uint32(sbase + slots.S_TRANS)
                               ).astype(F)
            u_reflect = rng.draw(live_stream, np.uint32(sbase + slots.S_REFLECT)
                                 ).astype(F)

            is_metal = u_metal < metallic
            is_diel = ~is_metal & (u_trans < spec_trans)
            is_diff = ~is_metal & ~is_diel

            new_d = np.zeros_like(dl)
            attenuation = np.ones_like(dl)
            absorbed = np.zeros(live.size, bool)

            if is_metal.any():
                k = is_metal
                ball1 = _ball_rows(live_stream[k], sbase, slots.S_BALL1)
                refl = (dl[k] - 2.0 * (dl[k] * normal[k]).sum(1, dtype=F)[:, None]
                        * normal[k]).astype(F)
                nd = (_normalize_rows(refl) + roughness[k][:, None] * ball1
                      ).astype(F)
                new_d[k] = nd
                attenuation[k] = base_color[k]
                absorbed[k] = (nd * normal[k]).sum(1, dtype=F) < 0.0
            if is_diel.any():
                k = is_diel
                ri = np.where(front_face[k], F(1.0) / ior[k], ior[k]).astype(F)
                unit = _normalize_rows(dl[k])
                cos_theta = np.minimum((-unit * normal[k]).sum(1, dtype=F),
                                       F(1.0)).astype(F)
                sin_theta = np.sqrt(np.maximum(F(1.0) - cos_theta * cos_theta,
                                               F(0.0))).astype(F)
                r0 = ((1.0 - ri) / (1.0 + ri)).astype(F)
                r0 = (r0 * r0).astype(F)
                schlick = (r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5).astype(F)
                reflect_mask = (ri * sin_theta > 1.0) | (schlick > u_reflect[k])
                refl = (unit - 2.0 * (unit * normal[k]).sum(1, dtype=F)[:, None]
                        * normal[k]).astype(F)
                r_perp = (ri[:, None] * (unit + cos_theta[:, None] * normal[k])
                          ).astype(F)
                r_par = (-np.sqrt(np.abs(F(1.0) - (r_perp * r_perp)
                                         .sum(1, dtype=F)))[:, None]
                         * normal[k])
                refr = (r_perp + r_par).astype(F)
                new_d[k] = np.where(reflect_mask[:, None], refl, refr)
                attenuation[k] = F(1.0)
            if is_diff.any():
                k = is_diff
                ball1 = _ball_rows(live_stream[k], sbase, slots.S_BALL1)
                if diffuse_sampling == "cosine":
                    nd = (normal[k] + _normalize_rows(ball1)).astype(F)
                else:
                    ball2 = _ball_rows(live_stream[k], sbase, slots.S_BALL2)
                    nd = (normal[k] + ball1 + roughness[k][:, None] * ball2
                          ).astype(F)
                near_zero = (np.abs(nd) < NEAR_ZERO).all(1)
                nd = np.where(near_zero[:, None], normal[k], nd)
                new_d[k] = nd
                attenuation[k] = base_color[k]
                absorbed[k] = (nd * normal[k]).sum(1, dtype=F) < 0.0

            keep = ~absorbed
            live = live[keep]
            if live.size == 0:
                break
            ray_color[live] = (ray_color[live] * attenuation[keep]).astype(F)
            o[live] = hit_pos[keep]
            d[live] = new_d[keep]
            live_stream = stream[live]

        first_depth = np.where(first_depth >= INF, fallback_far, first_depth)
        color_sum += np.sqrt(np.maximum(radiance, 0.0)).astype(F)
        depth_sum += first_depth

    rt_color = (color_sum / F(samples_per_pixel)).astype(F)
    rt_depth = (depth_sum / F(samples_per_pixel)).astype(F)

    rc = (raster_color.reshape(n, 3) if raster_color.ndim == 3
          else np.broadcast_to(raster_color, (n, 3)))
    rd = (raster_depth.reshape(n) if raster_depth.ndim == 2
          else np.broadcast_to(raster_depth, (n,)))
    if level == 0:
        out = rc.astype(F)
    elif level == 3:
        out = rt_color
    else:
        rz = np.where(rt_depth > far, F(-1.0), (near / rt_depth).astype(F))
        out = np.where((rd > rz)[:, None], rc, rt_color).astype(F)
    return out.reshape(height, width, 3), rt_depth.reshape(height, width)


def oracle_inputs_from_world(world):
    """Convenience: host-side arrays + camera dict from a World.

    Reads ``World.extract_host`` (spheres only); callers with meshes append
    ``World.extract_meshes_host(first_material_id=len(radii))``'s records to
    the material table and pass its corners as ``triangles``."""
    centers, radii, mat_table, _ = world.extract_host()
    t, p = world.camera_transform, world.projection
    camera = dict(position=t.translation, direction=t.forward, up=t.up,
                  fov=p.fov, near=p.near, far=p.far, aspect=p.aspect_ratio,
                  aperture=world.camera.aperture,
                  focus_distance=world.camera.focus_distance)
    return centers, radii, mat_table, camera
