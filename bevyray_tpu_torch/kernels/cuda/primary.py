"""Host-side per-block primary-ray sphere shortlists for the fused kernel.

Counterpart of ``bevyray_tpu/kernels/pallas/primary.py`` (NumPy only, copied
so that the port imports nothing of the JAX package). In the phase-split mode
the kernel traces every sample's bounce-0 segment against its 64x64 pixel
block's shortlist instead of the whole sphere table: a block's primary rays
share a few degrees of field of view, so only a handful of spheres can be hit
by any of them. The shortlists need concrete camera values, so they are built
here on the host once per (scene, camera, config).

Conservativeness contract (what keeps the split exact): a sphere is culled
from a block's shortlist only if no primary ray of that block can hit it. The
frustum is widened to the block's pixel bounds plus the raygen jitter, and
with the thin lens every radius is inflated by a distance-aware defocus
margin. Shortlists run front to back by a per-sphere lower bound on the hit
distance, ``t_lo``, in chunks of SL_CHUNK; each chunk's ``t_lo`` lets the
kernel stop as soon as no later sphere can beat the ray's best hit.

The JAX package also builds per-block bf16 attribute tables (``slattr``) for
its TPU's one-hot gather; the CUDA kernel loads the winner's float32
attributes by the global index in shortlist row 4, so they are not ported.
"""

from __future__ import annotations

import numpy as np

from ...core.types import host_array, host_camera, upload
from .megakernel import BLOCK_H, BLOCK_W, MAX_SPLIT_SPP, block_grid

SL_CHUNK = 8      # spheres per early-out chunk
SL_MAX = 512      # capacity cap; blocks needing more take the full walk
N_SL_ROWS = 5     # cx, cy, cz, r², global sphere index (exact in f32 <= 2^24)


def shortlist_capacity(counts: np.ndarray) -> int:
    """Capacity for these per-block counts: the largest count rounded up to
    a power of two, at least SL_CHUNK and at most SL_MAX. Power-of-two
    buckets keep a moving camera on few shortlist shapes."""
    need = int(counts.max()) if counts.size else 0
    cap = SL_CHUNK
    while cap < min(need, SL_MAX):
        cap *= 2
    return min(cap, SL_MAX)


def live_mask(sph: np.ndarray) -> np.ndarray:
    """Real spheres in the kernel table: r² > 0, the trailing sphere-0
    padding duplicates excluded."""
    sph = np.asarray(sph)
    live = sph[3] > 0.0
    j = sph.shape[1]
    while j > 1 and np.all(sph[:, j - 1] == sph[:, 0]):
        j -= 1
    live[j:] = False
    return live


def live_sphere_count(sph: np.ndarray) -> int:
    return int(live_mask(sph).sum())


def shortlists_for(sph: np.ndarray, cam, config, local_spp: int,
                   block_lo: int = 0, n_blocks: int | None = None):
    """The gate and the build of the phase-split shortlists, for the
    ``n_blocks`` blocks from ``block_lo`` (:func:`build_block_shortlists`).

    Returns NumPy ``(sl, meta)`` when the split should run and
    ``(None, None)`` when it should not, and raises when
    ``pallas_primary="split"`` is forced where the split is not supported
    (level 0, or more than MAX_SPLIT_SPP samples per pixel) — the JAX
    package's contract, kept so that both pick the same mode.
    """
    supported = config.level != 0 and 1 <= local_spp <= MAX_SPLIT_SPP
    if config.pallas_primary == "off" or not supported:
        if config.pallas_primary == "split":
            raise ValueError(
                "pallas_primary='split' needs a raytraced level and a "
                f"per-device samples_per_pixel (here {local_spp}) of at most "
                f"{MAX_SPLIT_SPP}")
        return None, None
    sl, meta = build_block_shortlists(sph, cam, config, block_lo=block_lo,
                                      n_blocks=n_blocks)
    if (config.pallas_primary == "auto"
            and not split_worthwhile(sl, meta, sph, local_spp)):
        return None, None
    return sl, meta


def device_shortlists_for(kscene, cam, config, spp: int, block_lo: int = 0,
                          n_blocks: int | None = None):
    """:func:`shortlists_for` on a prepared ``KernelScene``: ``(sl, slmeta)``
    as float32 tensors on the scene's device, or ``(None, None)`` where the
    gate declined. The build reads the host copies of the sphere table and
    the camera (:func:`...core.types.host_array`, ``host_camera``), so on a
    card it waits for nothing queued there."""
    sl, meta = shortlists_for(host_array(kscene.sph), host_camera(cam),
                              config, spp, block_lo=block_lo,
                              n_blocks=n_blocks)
    if sl is None:
        return None, None
    dev = kscene.sph.device
    return upload(sl, dev), upload(meta, dev)


def split_worthwhile(sl: np.ndarray, meta: np.ndarray, sph: np.ndarray,
                     spp: int) -> bool:
    """Should ``pallas_primary="auto"`` take the split for these shortlists?
    The JAX package's gate, kept as it is so that both packages pick the
    same mode: split when the shortlists cull (mean at most half the live
    spheres) or spp <= 4; never when most blocks overflowed."""
    overflow = meta[:, 0] > 0.0
    kept = ~overflow
    if overflow.mean() > 0.5 or not kept.any():
        return False
    if spp <= 4:
        return True
    counts = (sl[:, 3, :] > np.float32(-1e29)).sum(axis=1)
    mean_count = float(counts[kept].mean())
    return mean_count * 2.0 <= live_sphere_count(sph)


def build_block_shortlists(sph: np.ndarray, cam, config, block_lo: int = 0,
                           n_blocks: int | None = None):
    """Per-block primary shortlists for the ``n_blocks`` blocks from
    ``block_lo`` of the row-major block grid (None: to the grid's end).
    Block ids past the grid's last block are allowed: a sharded frame pads
    the grid to a multiple of its shards, and such a block's frustum lies
    below the image (the kernel traces none of its lanes).

    ``sph``: the kernel sphere table, (4, S) float32 rows cx, cy, cz, r²
    (trailing sphere-0 duplicates are dropped: a duplicate ties sphere 0 and
    loses the tie). ``cam``: a CameraState. Returns ``(sl, meta)``:

    - ``sl`` (n_blocks, 5, K) f32: front-to-back sphere rows and the global
      index; padding entries sit at the origin with r² = -1e30 (disc < 0);
    - ``meta`` (n_blocks, 1 + K // SL_CHUNK) f32: [full_flag, chunk t_lo...];
      unused chunks carry +inf. full_flag = 1: the block overflowed SL_MAX
      and the kernel takes the full walk for it.
    """
    sph = np.asarray(sph, np.float32)
    cx, cy, cz, r2 = sph
    live = live_mask(sph)

    pos = np.array([float(cam.position.x), float(cam.position.y),
                    float(cam.position.z)], np.float64)
    fwd = np.array([float(cam.direction.x), float(cam.direction.y),
                    float(cam.direction.z)], np.float64)
    up = np.array([float(cam.up.x), float(cam.up.y), float(cam.up.z)],
                  np.float64)
    right = np.cross(fwd, up)                    # wgsl:149
    # The behind-lens and defocus tests compare projections on the forward
    # axis with world-unit margins, so they need a unit axis.
    fwd_u = fwd / np.linalg.norm(fwd)
    scale = float(np.tan(float(cam.fov) * 0.5))
    aspect = float(cam.aspect)
    w, h = config.width, config.height

    r = np.sqrt(np.maximum(r2, 0.0).astype(np.float64))
    centers = np.stack([cx, cy, cz], axis=1).astype(np.float64)
    oc = centers - pos                           # (S, 3)
    lens_r = 0.0
    r_eff = r.copy()
    if config.defocus and float(cam.aperture) > 0.0:
        lens_r = 0.5 * float(cam.aperture)
        focus = max(float(cam.focus_distance), 1e-6)
        d_fwd = oc @ fwd_u
        t_par = np.maximum((d_fwd + r) / focus, 1.0)
        r_eff = r + lens_r * t_par

    nbx, nby = block_grid(config)
    if n_blocks is None:
        n_blocks = nbx * nby - block_lo

    w_px = h * aspect                            # raygen jitter denominators
    jx, jy = 0.5 / w_px, 0.5 / h

    # The kernel traces in f32, these bounds are f64: a distance-scaled
    # margin keeps borderline f32 hits inside every conservative test.
    dist = np.linalg.norm(oc, axis=1)
    fp_eps = 1e-4 + 1e-5 * dist

    # Distance lower bound (d is unit-normalized in raygen, so t = distance).
    t_lo = np.maximum(dist - r - lens_r - fp_eps, 0.0)
    order_key = np.where(live, t_lo, np.inf)

    b_ids = block_lo + np.arange(n_blocks)
    bx, by = b_ids % nbx, b_ids // nbx
    x0, y0 = bx * BLOCK_W, by * BLOCK_H
    nx_lo = (2.0 * (x0 + 0.5) / w - 1.0) - jx              # (B,)
    nx_hi = (2.0 * (x0 + BLOCK_W - 0.5) / w - 1.0) + jx
    ny_hi = (1.0 - 2.0 * (y0 + 0.5) / h) + jy
    ny_lo = (1.0 - 2.0 * (y0 + BLOCK_H - 0.5) / h) - jy

    def dirn(nx, ny):                                      # (B, 3)
        return (fwd[None, :] + right[None, :] * (nx * aspect * scale)[:, None]
                + up[None, :] * (ny * scale)[:, None])

    c00, c10 = dirn(nx_lo, ny_lo), dirn(nx_hi, ny_lo)
    c01, c11 = dirn(nx_lo, ny_hi), dirn(nx_hi, ny_hi)
    dc = dirn(0.5 * (nx_lo + nx_hi), 0.5 * (ny_lo + ny_hi))
    planes = np.stack([np.cross(pa, pb) for pa, pb in
                       ((c00, c01), (c10, c11), (c00, c10), (c01, c11))],
                      axis=1)                              # (B, 4, 3)
    flip = np.einsum("bpk,bk->bp", planes, dc) < 0.0
    planes = np.where(flip[:, :, None], -planes, planes)
    planes /= np.linalg.norm(planes, axis=2, keepdims=True)
    margin = r_eff + lens_r + fp_eps                       # (S,)
    proj = np.einsum("bpk,sk->bps", planes, oc)            # (B, 4, S)
    inside = ((proj >= -margin[None, None, :]).all(axis=1)
              & ((oc @ fwd_u) >= -margin)[None, :]         # behind the lens
              & live[None, :])                             # (B, S)

    counts = np.zeros(n_blocks, np.int64)
    members = []
    for k in range(n_blocks):
        idx = np.nonzero(inside[k])[0]
        idx = idx[np.argsort(order_key[idx], kind="stable")]
        counts[k] = idx.size
        members.append(idx)

    k_cap = shortlist_capacity(counts)
    n_chunks = k_cap // SL_CHUNK
    sl = np.zeros((n_blocks, N_SL_ROWS, k_cap), np.float32)
    sl[:, 3, :] = np.float32(-1e30)              # inert padding: disc < 0
    meta = np.zeros((n_blocks, 1 + n_chunks), np.float32)
    meta[:, 1:] = np.inf
    for k, idx in enumerate(members):
        if idx.size > k_cap:
            meta[k, 0] = 1.0                     # overflow: full walk
            continue
        m = idx.size
        sl[k, 0, :m] = cx[idx]
        sl[k, 1, :m] = cy[idx]
        sl[k, 2, :m] = cz[idx]
        sl[k, 3, :m] = r2[idx]
        sl[k, 4, :m] = idx.astype(np.float32)
        used = -(-m // SL_CHUNK)
        if used:
            meta[k, 1:1 + used] = t_lo[idx[::SL_CHUNK][:used]].astype(np.float32)
    return sl, meta
