"""The plain reference: bevyray's path tracer over spheres, with its raster
layer and hybrid composite, in plain PyTorch operators.

It follows the reference shader (raytrace.wgsl) as a serial loop per ray
would: jittered camera rays (wgsl:139-156), the nearest sphere over the whole
table (the near root only, wgsl:348-383), the sky on a miss (wgsl:364-369),
the metal, dielectric and diffuse scatter with its quirks (wgsl:231-299),
per-sample gamma, and the level dispatch of ``fragment`` (wgsl:97-122). Dead
rays leave the batch (real breaks, not masks). The raster layer is the
centre ray of each pixel against the raster meshes' triangles, shaded by
Bevy's default ambient light alone (the app spawns no light), with Bevy's
reverse-Z depth ``near / view_z``.

A scene with an ``aperture`` above 0 has a thin lens, focused at
``focus_distance``: each sample's origin moves on a disk of that diameter
and its ray aims at the pinhole ray's point at the focus distance, as
bevyray_tpu_torch's raygen does (beyond bevyray's shader, which has no
lens). The raster layer's rays stay pinhole rays.

It takes only the scene's arrays, a camera pose and the frame's numbers,
and works out everything else itself: the camera basis, the linear colours,
the draws (:mod:`.draws`), the raster buffers. ``dtype`` sets the precision
of the geometry and shading (the draws are float32 on either):
``torch.float32`` is the reference, ``torch.bfloat16`` the control.
"""

from __future__ import annotations

import numpy as np
import torch

from .draws import DRAWS, M32, over, sqrt, stream_words

T_MIN = 1e-3
NEAR_ZERO = 1e-8
# Bevy's default ambient light (80 lux) under its default exposure.
AMBIENT = float(np.float32(80.0 / (125.0 * 1.2)))
# Elements of one [rays x spheres] block of the dense test, by device.
BLOCK_ELEMS = {"cuda": 1 << 26, "cpu": 1 << 22}
# Pixels traced together.
PIXEL_BLOCK = 1 << 20
# Paths traced together, by device: a pixel block's samples in groups, so
# that the long tails of deep paths share their bounces' launches.
RAY_BLOCK = {"cuda": 1 << 24, "cpu": 1 << 20}


class V3:
    """Three columns of one dtype."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)

    def scale(self, s):
        return V3(self.x * s, self.y * s, self.z * s)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def normalize(self):
        return self.scale(1.0 / sqrt(self.dot(self)))

    def rows(self, i):
        return V3(self.x[i], self.y[i], self.z[i])

    def where(self, m, o):
        return V3(torch.where(m, self.x, o.x), torch.where(m, self.y, o.y),
                  torch.where(m, self.z, o.z))

    def set_rows(self, i, o):
        self.x[i], self.y[i], self.z[i] = o.x, o.y, o.z


def by(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` in one IEEE division (on a card, torch turns a tensor over
    a float into ``x * (1 / c)``)."""
    return x / torch.full_like(x, c)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def camera(pose: dict, scene: dict, width: int, height: int) -> dict:
    """The camera's float32 numbers: Bevy's ``looking_at`` basis in float64
    (forward to the target, up re-orthogonalised), then right = forward x
    up, tan(fov / 2), the aspect and the frame's size, and the lens's
    diameter (0: a pinhole) and focus distance."""
    eye = np.asarray(pose["eye"], np.float64)
    fwd = np.asarray(pose["target"], np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    f32 = np.float32
    pos, d, u = eye.astype(f32), fwd.astype(f32), up.astype(f32)
    r = np.array([d[1] * u[2] - d[2] * u[1], d[2] * u[0] - d[0] * u[2],
                  d[0] * u[1] - d[1] * u[0]], f32)
    half = f32(f32(scene["fov"]) * f32(0.5))
    return {"pos": pos, "dir": d, "up": u, "right": r,
            "scale": f32(np.tan(np.float64(half))),
            "aspect": f32(width / height), "near": f32(scene["near"]),
            "far": f32(scene["far"]), "width": width, "height": height,
            "aperture": f32(scene.get("aperture", 0.0)),
            "focus": f32(scene.get("focus_distance", 1.0))}


def _const(cam, key, dtype, device):
    v = cam[key]
    return V3(*(torch.tensor(float(c), dtype=dtype, device=device) for c in v))


def pixel_rays(cam: dict, pixels: torch.Tensor, ju, jv, dtype, lens=None):
    """(origin, direction) of the rays through ``pixels`` (row-major ids)
    with jitter (ju, jv) in [0, 1) (0.5, 0.5: the pixel's centre). With
    ``lens``, a draws path's ``(u, cos, sin)``, the origin moves to radius
    ``aperture / 2 * sqrt(u)`` on the lens and the ray aims at the pinhole
    ray's point at the focus distance."""
    dev = pixels.device
    w, h = cam["width"], cam["height"]
    px = (pixels % w).to(torch.float32)
    py = (pixels // w).to(torch.float32)
    u = by(px + 0.5, float(w)).to(dtype)
    v = by(py + 0.5, float(h)).to(dtype)
    ju, jv = ju.to(dtype), jv.to(dtype)
    aspect, scale = float(cam["aspect"]), float(cam["scale"])
    h_px = torch.tensor(float(h), dtype=dtype, device=dev)
    w_px = h_px * aspect
    ndc_x = (u * 2.0 - 1.0) + (ju - 0.5) / w_px
    ndc_y = (1.0 - v * 2.0) + (jv - 0.5) / h_px
    d = (_const(cam, "dir", dtype, dev)
         + _const(cam, "right", dtype, dev).scale(ndc_x * aspect * scale)
         + _const(cam, "up", dtype, dev).scale(ndc_y * scale)).normalize()
    pos = _const(cam, "pos", dtype, dev)
    o = V3(*(c.expand_as(d.x).clone() for c in (pos.x, pos.y, pos.z)))
    if lens is not None:
        lu, cos_t, sin_t = (x.to(dtype) for x in lens)
        half = torch.tensor(float(cam["aperture"]), dtype=dtype,
                            device=dev) * 0.5
        r = half * sqrt(lu)
        focal = o + d.scale(torch.tensor(float(cam["focus"]), dtype=dtype,
                                         device=dev))
        o = (o + _const(cam, "right", dtype, dev).scale(r * cos_t)
             + _const(cam, "up", dtype, dev).scale(r * sin_t))
        d = (focal - o).normalize()
    return o, d


def nearest_sphere(o: V3, d: V3, centers: V3, r2: torch.Tensor):
    """(t, index) of each ray's nearest accepted near root over the whole
    table, the lowest index on ties; +inf / -1 on a miss. The roots are
    compared as q = a t (a = d.d), accepted where q > a T_MIN, and the
    nearest one's t is q (1 / a), as bevyray_tpu_torch's walks do: a t
    taken for every sphere first rounds some distinct roots to one."""
    n, s = o.x.shape[0], r2.shape[0]
    a = d.dot(d)
    q_min = a * T_MIN
    best_q = torch.empty_like(a)
    best_i = torch.empty(n, dtype=torch.int64, device=a.device)
    step = max(1, BLOCK_ELEMS[a.device.type] // s)
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        ocx = centers.x[None, :] - o.x[sl, None]
        ocy = centers.y[None, :] - o.y[sl, None]
        ocz = centers.z[None, :] - o.z[sl, None]
        h = d.x[sl, None] * ocx + d.y[sl, None] * ocy + d.z[sl, None] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2[None, :]
        del ocx, ocy, ocz
        disc = h * h - a[sl, None] * c
        del c
        ok = disc >= 0.0
        q = h - sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(ok & (q > q_min[sl, None]), q, float("inf"))
        del h, disc, ok
        i = torch.argmin(q, dim=1)
        best_i[sl] = i
        best_q[sl] = torch.gather(q, 1, i[:, None])[:, 0]
    hit = best_q < float("inf")
    return (torch.where(hit, best_q * (1.0 / a), float("inf")),
            torch.where(hit, best_i, -1))


def nearest_triangle(o: V3, d: V3, tri):
    """(t, index) of each ray's nearest two-sided Moller-Trumbore hit."""
    a, b, c = tri
    e1, e2 = b - a, c - a
    dx, dy, dz = (v[:, None] for v in (d.x, d.y, d.z))
    px = dy * e2.z[None] - dz * e2.y[None]
    py = dz * e2.x[None] - dx * e2.z[None]
    pz = dx * e2.y[None] - dy * e2.x[None]
    det = px * e1.x[None] + py * e1.y[None] + pz * e1.z[None]
    inv = 1.0 / det
    tx = o.x[:, None] - a.x[None]
    ty = o.y[:, None] - a.y[None]
    tz = o.z[:, None] - a.z[None]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1.z[None] - tz * e1.y[None]
    qy = tz * e1.x[None] - tx * e1.z[None]
    qz = tx * e1.y[None] - ty * e1.x[None]
    v = (qx * dx + qy * dy + qz * dz) * inv
    t = (qx * e2.x[None] + qy * e2.y[None] + qz * e2.z[None]) * inv
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN))
    t = torch.where(ok, t, float("inf"))
    i = torch.argmin(t, dim=1)
    bt = torch.gather(t, 1, i[:, None])[:, 0]
    return bt, torch.where(bt < float("inf"), i, -1)


def scene_tables(scene: dict, dtype, device) -> dict:
    """The sphere table in ``dtype``: centres, r^2 and the linear material
    rows (the base colour from sRGB; the rest as given)."""
    mats = np.array(scene["materials"], np.float64)
    mats[:, :3] = srgb_to_linear(mats[:, :3])
    centers = np.asarray(scene["centers"], np.float32)
    radii = np.asarray(scene["radii"], np.float32)

    def col(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)

    r = col(radii)
    return {"centers": V3(*(col(centers[:, k]) for k in range(3))),
            "r2": r * r, "mat": col(mats.astype(np.float32))}


def raster_layer(scene: dict, cam: dict, pixels: torch.Tensor, dtype):
    """(colour V3, reverse-Z depth) of the raster meshes at ``pixels``, or
    None without raster meshes; the clear colour is white at depth 0."""
    meshes = scene.get("raster_meshes") or []
    if not meshes:
        return None
    dev = pixels.device
    corners, rows = [[], [], []], []
    for translation, vertices, indices, material in meshes:
        world = (np.asarray(vertices, np.float32)
                 + np.asarray(translation, np.float32))
        f = np.asarray(indices)
        for k in range(3):
            corners[k].append(world[f[:, k]])
        m = np.array(material, np.float64)
        m[:3] = srgb_to_linear(m[:3])
        rows.append(np.tile(m[:6].astype(np.float32), (f.shape[0], 1)))
    tri = [np.concatenate(c) for c in corners]
    tri = [V3(*(torch.as_tensor(c[:, k].copy(), device=dev).to(dtype)
                for k in range(3))) for c in tri]
    rows = torch.as_tensor(np.concatenate(rows), device=dev).to(dtype)
    half = torch.full(pixels.shape, 0.5, dtype=torch.float32, device=dev)
    o, d = pixel_rays(cam, pixels, half, half, dtype)
    t, idx = nearest_triangle(o, d, tri)
    hit = idx >= 0
    j = idx.clamp(min=0)
    a, b, c = (v.rows(j) for v in tri)
    n = (b - a).cross(c - a).normalize()
    no_v = torch.clamp(torch.abs(n.dot(d)), min=1e-4)
    base = V3(rows[j, 0], rows[j, 1], rows[j, 2])
    metallic, rough, refl = rows[j, 3], rows[j, 4], rows[j, 5]

    def env_brdf(r, nv):
        rx, ry = r * -1.0 + 1.0, r * -0.0275 + 0.0425
        rz, rw = r * -0.572 + 1.04, r * 0.022 - 0.04
        a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * nv)) * rx + ry
        return -1.04 * a004 + rz, 1.04 * a004 + rw

    diffuse = base.scale(1.0 - metallic)
    spec = 0.16 * refl * refl * (1.0 - metallic)
    f0 = base.scale(metallic) + V3(spec, spec, spec)
    d_scale, d_bias = env_brdf(torch.ones_like(no_v), no_v)
    s_scale, s_bias = env_brdf(rough, no_v)
    occ = torch.clamp((f0.x + f0.y + f0.z) * (50.0 * 0.33), 0.0, 1.0)
    shaded = (diffuse.scale(d_scale) + V3(d_bias, d_bias, d_bias)
              + (f0.scale(s_scale) + V3(s_bias, s_bias, s_bias)).scale(occ)
              ).scale(AMBIENT)
    one = torch.ones_like(no_v)
    color = shaded.where(hit, V3(one, one, one))
    view_z = torch.where(hit, t, 1.0) * d.dot(_const(cam, "dir", dtype, dev))
    depth = torch.where(
        hit, over(float(cam["near"]), torch.clamp(view_z, min=1e-20)), 0.0)
    return color, depth


def trace(tables: dict, cam: dict, pixels: torch.Tensor, spp: int,
          bounces: int, level: int, frame_seed: int, draws: str, dtype):
    """(gamma-space colour V3, depth, segments) of ``pixels``, averaged
    over ``spp`` samples; the miss depth is ``far + 10`` at level 1 and
    ``far - 1`` otherwise. The samples are traced in groups (a path's
    numbers do not depend on the others') and summed in their order."""
    dev = pixels.device
    n = pixels.shape[0]
    far = float(cam["far"])
    fallback = float(np.float32(far + 10.0 if level == 1 else far - 1.0))
    centers, r2, mat = tables["centers"], tables["r2"], tables["mat"]
    zeros = lambda m: torch.zeros(m, dtype=dtype, device=dev)   # noqa: E731
    csum = V3(zeros(n), zeros(n), zeros(n))
    dsum = zeros(n)
    segments = 0
    sky_top = (0.5, 0.7, 1.0)
    group = max(1, RAY_BLOCK[dev.type] // n)
    for s0 in range(0, spp, group):
        k = min(group, spp - s0)
        rays = pixels.repeat(k)
        samples = torch.arange(s0, s0 + k, device=dev).repeat_interleave(n)
        m = rays.shape[0]
        rng = DRAWS[draws](stream_words(rays, samples, frame_seed & M32))
        o, d = pixel_rays(cam, rays, *rng.jitter(), dtype,
                          rng.lens() if cam["aperture"] > 0 else None)
        throughput = V3(zeros(m) + 1.0, zeros(m) + 1.0, zeros(m) + 1.0)
        radiance = V3(zeros(m), zeros(m), zeros(m))
        first = torch.full((m,), float("inf"), dtype=dtype, device=dev)
        live = torch.arange(m, device=dev)
        lo, ld, lrng = o, d, rng
        for b in range(bounces + 1):
            if live.numel() == 0:
                break
            segments += live.numel()
            t, idx = nearest_sphere(lo, ld, centers, r2)
            if b == 0:
                first = t
            miss = idx < 0
            if bool(miss.any()):
                m_rows = live[miss]
                unit = ld.rows(miss).normalize()
                a = 0.5 * (unit.y + 1.0)
                sky = V3(*((1.0 - a) + a * c for c in sky_top))
                radiance.set_rows(m_rows, radiance.rows(m_rows)
                                  + throughput.rows(m_rows) * sky)
            keep = ~miss
            live, t, idx = live[keep], t[keep], idx[keep]
            lo, ld, lrng = lo.rows(keep), ld.rows(keep), lrng.select(keep)
            if live.numel() == 0:
                break
            pos = lo + ld.scale(t)
            normal = (pos - centers.rows(idx)).normalize()
            m = mat[idx]
            base = V3(m[:, 0], m[:, 1], m[:, 2])
            metallic, rough = m[:, 3], m[:, 4]
            ior, trans = m[:, 6], m[:, 7]
            emit = V3(m[:, 8], m[:, 9], m[:, 10])
            radiance.set_rows(live, radiance.rows(live)
                              + throughput.rows(live) * emit)
            u_metal, u_trans, u_reflect, ball1, ball2 = lrng.bounce(b)
            u_metal, u_trans, u_reflect = (x.to(dtype) for x in
                                           (u_metal, u_trans, u_reflect))
            ball1 = V3(*(x.to(dtype) for x in ball1))
            ball2 = V3(*(x.to(dtype) for x in ball2))
            front = ld.dot(normal) < 0.0
            # metal (wgsl:234-245): the reflection, normalised, plus fuzz.
            refl = ld - normal.scale(2.0 * ld.dot(normal))
            metal_dir = refl.normalize() + ball1.scale(rough)
            # dielectric (wgsl:249-280)
            unit = ld.normalize()
            ri = torch.where(front, 1.0 / ior, ior)
            cos_t = torch.clamp(-(unit.dot(normal)), max=1.0)
            sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            r0 = (1.0 - ri) / (1.0 + ri)
            r0 = r0 * r0
            x = 1.0 - cos_t
            x2 = x * x
            schlick = r0 + (1.0 - r0) * (x2 * x2 * x)
            use_reflect = (ri * sin_t > 1.0) | (schlick > u_reflect)
            u_refl = unit - normal.scale(2.0 * unit.dot(normal))
            perp = (unit + normal.scale(cos_t)).scale(ri)
            par = normal.scale(-sqrt(torch.abs(1.0 - perp.dot(perp))))
            diel_dir = u_refl.where(use_reflect, perp + par)
            # diffuse (wgsl:282-297), with the extra roughness * ball term.
            diff_dir = normal + ball1 + ball2.scale(rough)
            tiny = ((torch.abs(diff_dir.x) < NEAR_ZERO)
                    & (torch.abs(diff_dir.y) < NEAR_ZERO)
                    & (torch.abs(diff_dir.z) < NEAR_ZERO))
            diff_dir = normal.where(tiny, diff_dir)
            is_metal = u_metal < metallic
            is_diel = ~is_metal & (u_trans < trans)
            new_d = metal_dir.where(is_metal, diel_dir.where(is_diel, diff_dir))
            absorbed = ((is_metal & (metal_dir.dot(normal) < 0.0))
                        | (~is_metal & ~is_diel & (diff_dir.dot(normal) < 0.0)))
            one = torch.ones_like(metallic)
            atten = V3(one, one, one).where(is_diel, base)
            keep = ~absorbed
            live = live[keep]
            throughput.set_rows(live, throughput.rows(live) * atten.rows(keep))
            lo, ld, lrng = pos.rows(keep), new_d.rows(keep), lrng.select(keep)
        first = torch.where(first < float("inf"), first, fallback)
        g = V3(*(sqrt(torch.clamp(c, min=0.0)) for c in
                 (radiance.x, radiance.y, radiance.z)))
        for j in range(k):
            rows = slice(j * n, (j + 1) * n)
            csum = csum + g.rows(rows)
            dsum = dsum + first[rows]
    return csum.scale(1.0 / spp), dsum * (1.0 / spp), segments


def render(scene: dict, pose: dict, width: int, height: int, spp: int,
           bounces: int, level: int, frame_seed: int, draws: str,
           dtype=torch.float32, device="cpu"):
    """The whole frame, row-major, in blocks of pixels: float32 host arrays
    image [P, 3] and depth [P], and the segments traced."""
    device = torch.device(device)
    cam = camera(pose, scene, width, height)
    tables = scene_tables(scene, dtype, device)
    pixels = torch.arange(width * height, device=device)
    images, depths, segments = [], [], 0
    for lo in range(0, pixels.shape[0], PIXEL_BLOCK):
        px = pixels[lo:lo + PIXEL_BLOCK]
        color, depth, segs = trace(tables, cam, px, spp, bounces, level,
                                   frame_seed, draws, dtype)
        segments += segs
        if level in (1, 2):
            raster = raster_layer(scene, cam, px, dtype)
            if raster is not None:
                rc, rd = raster
            else:
                one = torch.ones_like(depth)
                rc, rd = V3(one, one, one), torch.zeros_like(depth)
            near = float(cam["near"])
            rz = torch.where(depth > float(cam["far"]), -1.0,
                             over(near, depth))
            color = rc.where(rd > rz, color)
        elif level == 0:
            raise ValueError("level 0 traces nothing")
        images.append(torch.stack([color.x, color.y, color.z], 1).float().cpu())
        depths.append(depth.float().cpu())
    return (torch.cat(images).numpy(), torch.cat(depths).numpy(), segments)
