"""The fused path-tracing kernel: scene preparation, the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``bevyray_tpu/kernels/pallas/megakernel.py``. The TPU kernel
(``render_tiles`` -> ``_render_kernel``) traces the whole frame in one
``pallas_call``; here ``render_tiles`` launches ``csrc/megakernel.cu``, one
thread per pixel looping over samples, bounces and spheres, on a persistent
grid: as many CUDA blocks as the card holds at once (:func:`persistent_grid`)
take work from one counter, and a thread that has finished its pixel takes
the next one. The unsplit full walk (off/grouped) takes each pixel from the
launch's counter, over the whole grid (:func:`item_pixels`), and at many
samples a pixel first runs a pilot launch of a few samples whose segment
counts order the main launch's pixels, costliest first
(:func:`pilot_samples`, :func:`walk_order`); the split and candidate walks
take work items (runs of 256-lane slices, :func:`work_items`) closed by a
block barrier, and a thread takes the item's next pixel.
It draws from
the exact PCG streams (``exact_rng=True``) or from the fast path's keyed
words and bit-trick balls (``exact_rng=False``, :mod:`.fast_rng`);
:func:`resolve_exact_rng` picks the fast path for tensors on a CUDA card,
as the JAX package picks its hardware generator for arrays on the TPU. With
the phase split a work item lies within a run of ``fuse`` consecutive pixel
blocks, whose shortlists the CUDA block stages together
(:func:`resolve_fuse`, the JAX kernel's block fusion). A scene with
triangle meshes merges a Möller–Trumbore test of its live triangle rows
after the sphere walk of every segment, in every mode (the TPU kernel's
``_intersect_triangles_scalar``): a triangle wins only with a strictly
smaller t, so a sphere wins an exact tie and the lowest triangle index wins
among triangles. Accumulating passes (:mod:`...engine.film`,
:mod:`...engine.adaptive`) give it a sample offset and per-lane sample
targets, and a sharded frame a range of pixel blocks
(``block_offset`` / ``n_blocks_local``, the JAX kernel's shard offsets). It
runs the JAX kernel's four sphere-walk modes, (primary, intersect):

- primary ``"off"``: every bounce takes the full walk; ``"split"`` (``sl``
  and ``slmeta`` given): bounce 0 walks the pixel block's host-built
  shortlist (:mod:`.primary`) front to back, and blocks whose shortlist
  overflowed take the full walk;
- intersect ``"grouped"``: the full walk tests every sphere of the table;
  ``"candidates"``: it tests only the spheres of the candidate groups whose
  AABB the ray enters ahead of its best hit.

All four give the same values (the lowest index wins every tie);
:func:`use_candidate_walk` resolves ``"auto"`` as the JAX kernel does.

The contract carried over from the TPU kernel:

- outputs are block-ordered flat r/g/b/depth (64x64 pixel blocks, row-major
  over the padded block grid; :func:`unshuffle_blocks` restores scanlines),
  per-spp means or, with ``normalize=False``, sums, plus the segment count;
- sphere tests run in q = a·t space: accept ``q > a·T_MIN`` and keep the
  lexicographic minimum of (q, table index), so the lowest index wins ties
  and the sphere-0 padding duplicates lose every tie; a negative
  discriminant gives a NaN that fails every compare;
- draws are keyed by (row-major pixel id, sample, slot) (:mod:`...engine.slots`),
  and so are the fast path's words (:mod:`.fast_rng`), so neither the mode
  nor the fusion changes a value;
- gamma is applied per sample, and the depth sum uses ``far + 10`` (level 1)
  or ``far - 1`` (other levels) where a sample's first segment missed.

The TPU kernel fetches hit attributes through a one-hot matmul over a bf16
hi/lo table (~16 mantissa bits); the port stores and loads them in float32.
"""

from __future__ import annotations

import collections
import numbers
from typing import NamedTuple

import numpy as np
import torch

from ...core import rng
from ...core.constants import INF, T_MIN
from ...core.types import (CameraState, RenderConfig, SceneBuffers, Triangles,
                          host_array, upload)
from ...core.vec import Vec3, sqrt
from ...engine import slots
from ..camera import (C_APERTURE, C_ASPECT, C_DIR_X, C_DIR_Y, C_DIR_Z, C_FAR,
                      C_FOCUS, C_HEIGHT, C_POS_X, C_POS_Y, C_POS_Z, C_RIGHT_X,
                      C_RIGHT_Y, C_RIGHT_Z, C_SCALE, C_UP_X, C_UP_Y, C_UP_Z,
                      C_WIDTH, camera_rows)
from ..composite import background_gradient, linear_to_gamma
from ..intersect import (DENSE_ELEMS, HitInfo, MaterialLanes,
                         intersect_triangles_reference)
from ..shade import scatter
from . import fast_rng

BLOCK_W = 64           # pixel-block width
BLOCK_H = 64           # pixel-block height
TILE = BLOCK_W * BLOCK_H   # lanes per pixel block
SLICES = TILE // 256   # 256-lane units per pixel block (a CUDA block's width)
GROUP = 32             # spheres per culling group (group AABB columns)
SUPER = 8              # groups per supergroup (appended when >= 4*SUPER groups)
CAND_UNIT = 16         # the auto candidate-group size quantum
MAX_CAND_GROUPS = 62   # candidate groups the auto size aims at (two mask words)
MAX_CAND_WORDS = 6     # 31-group mask words the JAX kernel allows at most
MAX_SPLIT_SPP = 32     # the JAX kernel's phase-split spp limit (its VMEM park)
# Block fusion under the phase split (the JAX kernel's PHASE_FUSE): 1 | 2 | 4
# | 8 | "auto". The JAX kernel sizes it by its parked per-sample state: fuse
# x spp x planes of that state stays within MAX_FUSE_PLANES. The port parks
# nothing, but picks the same fuse for the same frame.
PHASE_FUSE = "auto"
MAX_FUSE_PLANES = 704

# Attribute table rows: sphere center (triangle unit normal), then materials.
N_MAT = 10             # base rgb, metallic, roughness, ior, transmission, emissive rgb
N_ATTR = 3 + N_MAT

_M32 = 0xFFFFFFFF
# f32 max, the miss sentinel (constants.INF) as a float32 value.
_INF32 = float(np.float32(INF))
_NO_INDEX = torch.iinfo(torch.int64).max   # above every sphere index


class KernelScene(NamedTuple):
    """Kernel-ready scene tables, all float32 on the scene's device, and the
    candidate-group geometry.

    The sphere order is a permutation (kd clusters by default) whose group
    AABBs are consecutive runs; padding lanes duplicate sphere 0 (or, in an
    empty scene, sit at the origin with r² = -1e30, so every test misses).
    Candidate group g holds spheres g·gc .. g·gc + gc - 1 (those below S);
    its AABB is ``gaabb`` column ``cand_off + g``.
    """

    sph: torch.Tensor    # (4, S): cx, cy, cz, radius²
    attr: torch.Tensor   # (N_ATTR, S+T): center|normal xyz, 10 material floats
    gaabb: torch.Tensor  # (6, n_groups [+ n_super] [+ n_cand]): min, max xyz
    tri: torch.Tensor    # (10, T): ax..cz, valid — T = 0 without meshes
    gc: int              # spheres per candidate group
    n_cand: int          # candidate groups, ceil(S / gc)
    cand_off: int        # gaabb column of candidate group 0
    # Triangle rows the walks test: the last valid row + 1. Padding rows
    # (valid = 0) never hit, so stopping there changes no value.
    n_tris: int = 0
    # Whether any material emits (:func:`scene_has_emissive`); it sizes the
    # block fusion (:func:`kernel_fuse`) and changes no value.
    has_emissive: bool = True


def auto_cand_size(s: int) -> int:
    """Candidate-group size for ``s`` padded spheres: the smallest CAND_UNIT
    multiple keeping the group count within MAX_CAND_GROUPS. It sets the
    grid that the kd order aligns its clusters to."""
    return CAND_UNIT * (-(-(s // CAND_UNIT) // MAX_CAND_GROUPS))


def morton_order(spheres) -> torch.Tensor:
    """The ``pallas_grouping="morton"`` order: padding last, oversized spheres
    (r > 0.25 x extent) first, the rest in 3x10-bit morton order (stable)."""
    x, y, z, radius, valid = (spheres.cx, spheres.cy, spheres.cz,
                              spheres.radius, spheres.valid)
    inf = torch.tensor(float("inf"), device=x.device)
    mins = [torch.where(valid, v, inf).min() for v in (x, y, z)]
    maxs = [torch.where(valid, v, -inf).max() for v in (x, y, z)]
    extent = torch.clamp(torch.stack([hi - lo for lo, hi in zip(mins, maxs)])
                         .max(), min=1e-6)

    def spread(v, lo):
        q = torch.clamp((v - lo) / extent * 1023.0, 0.0, 1023.0).to(torch.int32)
        q = (q | (q << 16)) & 0x030000FF
        q = (q | (q << 8)) & 0x0300F00F
        q = (q | (q << 4)) & 0x030C30C3
        q = (q | (q << 2)) & 0x09249249
        return q

    morton = (spread(x, mins[0]) | (spread(y, mins[1]) << 1)
              | (spread(z, mins[2]) << 2))
    big = radius > 0.25 * extent
    key = torch.where(big, morton - (1 << 30), morton)
    key = torch.where(valid, key, torch.iinfo(torch.int32).max)
    return torch.argsort(key, stable=True)


def kernel_scene_cache_key(scene: SceneBuffers):
    """(key, leaves) naming every tensor :func:`prepare_kernel_scene` reads,
    plus the kd split rule. Callers keep ``leaves`` alive beside the key:
    id() values are unique only among live objects."""
    from . import grouping
    leaves = tuple(scene.spheres) + tuple(scene.materials) + (
        tuple(scene.triangles) if scene.triangles is not None else ())
    return (tuple(id(x) for x in leaves), grouping.KD_RULE), leaves


def _group_boxes(mins, maxs, size):
    """Per-run AABBs over ``size`` consecutive columns (inf/-inf where a run
    holds no live sphere)."""
    n = mins.shape[1] // size
    gmin = mins.reshape(3, n, size).amin(dim=2)
    gmax = maxs.reshape(3, n, size).amax(dim=2)
    return gmin, gmax


def _invert_empty(gmin, gmax):
    """Give empty runs the inverted unit box, which no slab test passes."""
    empty = ~torch.isfinite(gmin[0])
    return (torch.where(empty[None, :], 1.0, gmin),
            torch.where(empty[None, :], -1.0, gmax))


def _centers_radii(sp):
    """Sphere centers (3, S) and |radius| (S,) of a permuted table, padding
    lanes at sphere 0's center with radius 0."""
    valid = sp.valid
    radius = torch.where(valid, torch.abs(sp.radius), 0.0)
    pad_c = [torch.where(valid[0], c[0], 0.0) for c in (sp.cx, sp.cy, sp.cz)]
    center = torch.stack([torch.where(valid, c, p)
                          for c, p in zip((sp.cx, sp.cy, sp.cz), pad_c)])
    return center, radius


def prepare_kernel_scene(scene: SceneBuffers, cand_size: int = 0,
                         order=None) -> KernelScene:
    """Permute the sphere table, resolve the material indirection to per-sphere
    rows, and build the group (and, from 4*SUPER groups on, supergroup) AABBs
    and, unless the candidate groups are the GROUP-sphere groups themselves,
    the candidate-group AABBs after them.

    ``cand_size``: spheres per candidate group, a multiple of 8 (0 =
    :func:`auto_cand_size`); at most 31 * MAX_CAND_WORDS groups. ``order``:
    sphere permutation (a tensor of table indices); None takes the kd cluster
    order for that group size, the JAX package's shipped default. Hit results
    do not depend on it.
    """
    from .grouping import cached_order

    s = scene.spheres.cx.shape[0]
    gc = cand_size or auto_cand_size(s)
    if gc % 8:
        raise ValueError(f"pallas_cand_size={gc} must be a multiple of 8")
    n_cand = -(-s // gc)
    if n_cand > 31 * MAX_CAND_WORDS:
        raise ValueError(
            f"pallas_cand_size={gc} needs {n_cand} candidate groups for "
            f"{s} padded spheres — the per-lane mask holds at most "
            f"{31 * MAX_CAND_WORDS} ({MAX_CAND_WORDS} words)")
    if order is None:
        order = cached_order(scene, cand_size)
    sp = type(scene.spheres)(*(leaf[order] for leaf in scene.spheres))
    mt = scene.materials
    valid = sp.valid

    mid = torch.clamp(sp.material_id.long(), 0, mt.capacity - 1)
    # Padding lanes duplicate sphere 0 everywhere (geometry, center and
    # material), so even a padding lane that won a tie would shade as sphere 0.
    mid = torch.where(valid, mid, mid[0])
    center, radius = _centers_radii(sp)

    def mat_rows(ids):
        return torch.stack([mt.base_r[ids], mt.base_g[ids], mt.base_b[ids],
                            mt.metallic[ids], mt.roughness[ids], mt.ior[ids],
                            mt.specular_transmission[ids], mt.emissive_r[ids],
                            mt.emissive_g[ids], mt.emissive_b[ids]])

    attr = torch.cat([center, mat_rows(mid)])
    tr = scene.triangles
    if tr is not None:
        a, b, c = (Vec3(tr.ax, tr.ay, tr.az), Vec3(tr.bx, tr.by, tr.bz),
                   Vec3(tr.cx, tr.cy, tr.cz))
        up = Vec3.full((), 0.0, 1.0, 0.0, device=tr.ax.device)
        normal = Vec3.where(tr.valid, (b - a).cross(c - a).normalize(), up)
        tmid = torch.clamp(tr.material_id.long(), 0, mt.capacity - 1)
        attr = torch.cat([attr, torch.cat([torch.stack(normal),
                                           mat_rows(tmid)])], dim=1)
        tri = torch.stack([tr.ax, tr.ay, tr.az, tr.bx, tr.by, tr.bz,
                           tr.cx, tr.cy, tr.cz, tr.valid.float()])
        live = np.flatnonzero(host_array(tr.valid))
        n_tris = int(live[-1]) + 1 if live.size else 0
    else:
        tri = torch.zeros((10, 0), dtype=torch.float32, device=attr.device)
        n_tris = 0

    # The sphere table is built on the host from the host copies (the same
    # float32 operations, exact in IEEE arithmetic) and uploaded with its
    # host copy, which the shortlists read (:mod:`.primary`). Padding lanes
    # take sphere 0's r² (or -1e30 in an empty scene: every test misses).
    host_order = torch.from_numpy(host_array(order))
    host_sp = type(scene.spheres)(
        *(torch.from_numpy(host_array(leaf))[host_order]
          for leaf in scene.spheres))
    host_center, host_radius = _centers_radii(host_sp)
    r2 = host_radius * host_radius
    pad_r2 = torch.where(host_sp.valid[0], r2[0], -1e30)
    sph = upload(torch.stack([*host_center, torch.where(host_sp.valid, r2,
                                                        pad_r2)]).numpy(),
                 sp.cx.device)

    # Conservative group AABBs over the permuted order: center ± |radius|.
    live = radius > 0.0
    mins = torch.stack([torch.where(live, c - radius, float("inf"))
                        for c in (sp.cx, sp.cy, sp.cz)])
    maxs = torch.stack([torch.where(live, c + radius, float("-inf"))
                        for c in (sp.cx, sp.cy, sp.cz)])
    n_groups = s // GROUP
    gmin, gmax = _group_boxes(mins, maxs, GROUP)
    gmin_f, gmax_f = _invert_empty(gmin, gmax)
    if n_groups >= 4 * SUPER:
        # Supergroup columns n_groups + gs: boxes over SUPER-group spans,
        # built from the un-inverted group bounds so empty spans invert too.
        pad_g = (-n_groups) % SUPER
        fill = torch.full((3, pad_g), float("inf"), device=sph.device)
        smin, smax = _group_boxes(torch.cat([gmin, fill], dim=1),
                                  torch.cat([gmax, -fill], dim=1), SUPER)
        smin, smax = _invert_empty(smin, smax)
        gmin_f = torch.cat([gmin_f, smin], dim=1)
        gmax_f = torch.cat([gmax_f, smax], dim=1)
    cand_off = 0
    if gc != GROUP:
        # Candidate-group columns after [groups | supergroups], over the
        # sphere-level bounds (padded to n_cand * gc) so empty groups invert.
        cand_off = gmin_f.shape[1]
        fill = torch.full((3, n_cand * gc - s), float("inf"),
                          device=sph.device)
        cmin, cmax = _invert_empty(*_group_boxes(
            torch.cat([mins, fill], dim=1), torch.cat([maxs, -fill], dim=1),
            gc))
        gmin_f = torch.cat([gmin_f, cmin], dim=1)
        gmax_f = torch.cat([gmax_f, cmax], dim=1)
    gaabb = torch.cat([gmin_f, gmax_f])
    return KernelScene(sph=sph.contiguous(), attr=attr.contiguous(),
                       gaabb=gaabb.contiguous(), tri=tri.contiguous(),
                       gc=gc, n_cand=n_cand, cand_off=cand_off, n_tris=n_tris,
                       has_emissive=scene_has_emissive(scene))


def block_grid(config: RenderConfig):
    """(nbx, nby): the BLOCK_W x BLOCK_H pixel-block grid covering the frame."""
    return -(-config.width // BLOCK_W), -(-config.height // BLOCK_H)


def unshuffle_blocks(flat: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """Block-ordered kernel output -> row-major [H*W] pixels."""
    nbx, nby = block_grid(config)
    img = flat[:nbx * nby * TILE].reshape(nby, nbx, BLOCK_H, BLOCK_W)
    img = img.permute(0, 2, 1, 3).reshape(nby * BLOCK_H, nbx * BLOCK_W)
    return img[:config.height, :config.width].reshape(-1)


def shuffle_blocks(flat: torch.Tensor, config: RenderConfig,
                   fill=0) -> torch.Tensor:
    """Row-major [H*W] per-pixel values -> the kernel's block order
    (n_tiles, BLOCK_H*BLOCK_W // 128, 128); the inverse of
    :func:`unshuffle_blocks` (off-image padding lanes get ``fill``)."""
    nbx, nby = block_grid(config)
    h, w = config.height, config.width
    img = torch.as_tensor(flat).reshape(h, w)
    img = torch.nn.functional.pad(
        img, (0, nbx * BLOCK_W - w, 0, nby * BLOCK_H - h), value=fill)
    img = img.reshape(nby, BLOCK_H, nbx, BLOCK_W).permute(0, 2, 1, 3)
    return img.reshape(nbx * nby, TILE // 128, 128)


def use_candidate_walk(config: RenderConfig, n_spheres_padded: int,
                       phase_split: bool = False) -> bool:
    """The full walk's mode, as the JAX kernel resolves it
    (``_use_candidate_walk``): ``"auto"`` takes the candidate walk from 512
    padded spheres with the phase split and from 1025 without."""
    if config.pallas_intersect == "candidates":
        return True
    if config.pallas_intersect == "auto":
        return n_spheres_padded >= (512 if phase_split else 1025)
    return False


def scene_has_emissive(scene: SceneBuffers) -> bool:
    """Whether any material of the table emits (table-wide, as the JAX
    package's probe); it sets the parked-state planes that size the fuse."""
    mt = scene.materials
    return any(bool(np.any(host_array(c) != 0))
               for c in (mt.emissive_r, mt.emissive_g, mt.emissive_b))


def st_planes(has_emissive: bool) -> int:
    """Planes of the JAX kernel's parked per-sample state (``_st_layout``
    with its shipped depth-in-phase-A): origin, direction, throughput, the
    sample id and, on emissive scenes, the radiance."""
    return 13 if has_emissive else 10


def resolve_fuse(n_tiles: int, spp: int, phase_split: bool,
                 n_spheres_padded: int, n_st: int) -> int:
    """Pixel blocks per kernel instance, by the JAX kernel's rule
    (``_resolve_fuse``): only with the phase split; "auto" takes none under
    128 padded spheres, 8 at spp <= 4 from 2048 and 4 otherwise; the
    largest power of two up to that with fuse x spp x ``n_st`` <= 704, and
    under "auto" no more tail padding than 1/12 of the blocks."""
    if not phase_split:
        return 1
    want = PHASE_FUSE
    auto = want == "auto"
    if auto:
        if n_spheres_padded < 128:
            want = 1
        elif spp <= 4 and n_spheres_padded >= 2048:
            want = 8
        else:
            want = 4
    want = int(want)
    f = 1
    while f < want and f < 8 and (f * 2) * spp * n_st <= MAX_FUSE_PLANES:
        if auto and ((-n_tiles) % (f * 2)) * 12 > n_tiles:
            break
        f *= 2
    return f


def resolve_exact_rng(exact_rng, device) -> bool:
    """The draw path for tensors on ``device``: None takes the fast path on a
    CUDA card and the exact PCG streams elsewhere, as the JAX package takes
    its hardware generator for arrays on the TPU only; True or False is
    taken as given."""
    if exact_rng is None:
        return torch.device(device).type != "cuda"
    return bool(exact_rng)


def local_blocks(config: RenderConfig, n_blocks_local=None) -> int:
    """The pixel blocks one launch renders: ``n_blocks_local``, or the whole
    block grid when it is None."""
    if n_blocks_local is None:
        nbx, nby = block_grid(config)
        return nbx * nby
    return n_blocks_local


def kernel_fuse(pscene: KernelScene, config: RenderConfig, sl,
                n_blocks_local=None) -> int:
    """The block fusion that :func:`render_tiles` runs for these inputs,
    sized by the launch's local block count as the JAX kernel sizes it."""
    return resolve_fuse(local_blocks(config, n_blocks_local),
                        config.samples_per_pixel, sl is not None,
                        pscene.sph.shape[1], st_planes(pscene.has_emissive))


def kernel_mode(pscene: KernelScene, config: RenderConfig, sl) -> tuple:
    """(primary, intersect) that :func:`render_tiles` runs for these inputs:
    ("split" | "off", "candidates" | "grouped")."""
    split = sl is not None
    candidates = use_candidate_walk(config, pscene.sph.shape[1], split)
    return ("split" if split else "off",
            "candidates" if candidates else "grouped")


def _is_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def _check_blocks(block_offset, n_blocks_local):
    """Type and range of a shard's block range."""
    if not _is_int(block_offset) or block_offset < 0:
        raise ValueError(f"block_offset={block_offset!r} must be an int >= 0")
    if n_blocks_local is not None and (not _is_int(n_blocks_local)
                                       or n_blocks_local < 1):
        raise ValueError(f"n_blocks_local={n_blocks_local!r} must be None or "
                         "an int >= 1")
    if block_offset + (n_blocks_local or 0) >= 1 << 31:
        raise ValueError("the blocks' global indices must fit in int32")


def _check_accumulation(pscene: KernelScene, sample_offset, spp_map,
                        n_tiles: int):
    """Type, range, shape and device of an accumulating pass's inputs."""
    if not _is_int(sample_offset) or not 0 <= sample_offset <= _M32:
        raise ValueError(f"sample_offset={sample_offset!r} must be an int in "
                         "[0, 2^32)")
    if spp_map is None:
        return
    shape = (n_tiles, TILE // 128, 128)
    if (not isinstance(spp_map, torch.Tensor) or spp_map.dtype != torch.int32
            or spp_map.device != pscene.sph.device
            or tuple(spp_map.shape) != shape):
        raise ValueError(
            f"spp_map must be an int32 tensor on the scene's device of shape "
            f"{shape} (shuffle_blocks' block order)")


def _check_shortlists(pscene: KernelScene, config: RenderConfig, sl, slmeta,
                      n_tiles: int):
    """Shapes, type and device of the phase-split inputs (:mod:`.primary`):
    one row per block of the launch."""
    from .primary import N_SL_ROWS, SL_CHUNK, SL_MAX

    if (sl is None) != (slmeta is None):
        raise ValueError("sl and slmeta come together")
    if sl is None:
        return
    if config.samples_per_pixel > MAX_SPLIT_SPP:
        raise ValueError(f"the phase split takes at most {MAX_SPLIT_SPP} "
                         "samples per pixel")
    k = sl.shape[-1]
    if (sl.shape != (n_tiles, N_SL_ROWS, k) or k % SL_CHUNK
            or not SL_CHUNK <= k <= SL_MAX
            or slmeta.shape != (n_tiles, 1 + k // SL_CHUNK)):
        raise ValueError(
            f"shortlists {tuple(sl.shape)} / {tuple(slmeta.shape)} must be "
            f"({n_tiles}, {N_SL_ROWS}, K) / ({n_tiles}, 1 + K/{SL_CHUNK}) "
            f"with K a multiple of {SL_CHUNK} up to {SL_MAX}")
    for t in (sl, slmeta):
        if t.dtype != torch.float32 or t.device != pscene.sph.device:
            raise ValueError("sl and slmeta must be float32 tensors on the "
                             "scene's device")


def render_tiles(pscene: KernelScene, cam: CameraState, config: RenderConfig,
                 frame_seed, exact_rng=None, block_offset=0,
                 sample_offset=0, n_blocks_local=None, normalize: bool = True,
                 sl=None, slmeta=None, spp_map=None):
    """Trace the frame, or one shard of it. Returns (r, g, b, depth) as flat
    block-ordered float32 tensors of n_tiles*TILE lanes (pass the whole
    grid's through :func:`unshuffle_blocks`) and the traced-segment count as
    a 0-d int64 tensor; ``normalize=False`` gives sample sums instead of
    per-spp means.

    ``block_offset`` / ``n_blocks_local``: the launch renders the
    ``n_tiles = n_blocks_local`` pixel blocks from global block
    ``block_offset`` of the row-major block grid (None: the whole grid,
    nbx*nby blocks), as one shard of a sharded frame does
    (:mod:`...parallel.sharding`); the grid may be padded past its last row,
    and those blocks trace nothing. The shortlists, the sample map and the
    outputs then hold one row per local block.

    ``sl``/``slmeta``: per-block primary shortlists
    (:func:`.primary.device_shortlists_for`); given, bounce 0 runs the phase
    split. The full walk's mode comes from ``config`` and the table size
    (:func:`kernel_mode`).

    ``sample_offset``: an int in [0, 2^32) added (mod 2^32) to every sample
    index that keys the draws, so a later pass of an accumulating film
    draws fresh samples. ``spp_map``: per-lane sample targets, int32 in the
    kernel's block order, ``(n_tiles, TILE // 128, 128)`` as
    :func:`shuffle_blocks` gives them; each pixel traces min(map, spp)
    samples, so pass ``normalize=False`` and divide by the counts outside.

    ``exact_rng``: the draw path, resolved for the scene's device by
    :func:`resolve_exact_rng`; the fast path takes the layout of
    :func:`.fast_rng.words_per_bounce`. The block fusion is
    :func:`kernel_fuse`'s; no value depends on it.

    On CPU tensors this runs :func:`render_tiles_reference`. On CUDA tensors
    it launches the CUDA kernel (built on first use) or raises; it never
    falls back. ``render_tiles.launches`` counts the calls that launched the
    kernel (the full walk's pilot and main launches count once,
    :func:`pilot_samples`) and ``render_tiles.launches_by`` splits them by
    ("exact" | "fast", fuse).
    """
    dev = pscene.sph.device
    exact_rng = resolve_exact_rng(exact_rng, dev)
    _check_blocks(block_offset, n_blocks_local)
    n_tiles = local_blocks(config, n_blocks_local)
    _check_shortlists(pscene, config, sl, slmeta, n_tiles)
    _check_accumulation(pscene, sample_offset, spp_map, n_tiles)
    if dev.type == "cpu":
        return render_tiles_reference(pscene, cam, config, frame_seed,
                                      normalize=normalize, sl=sl,
                                      slmeta=slmeta,
                                      sample_offset=sample_offset,
                                      spp_map=spp_map, exact_rng=exact_rng,
                                      block_offset=block_offset,
                                      n_blocks_local=n_blocks_local)
    if dev.type != "cuda":
        raise ValueError(f"render_tiles takes CPU or CUDA tensors, not {dev}")
    fuse = kernel_fuse(pscene, config, sl, n_blocks_local)
    outs, segments = _frame(pscene, cam, config, frame_seed, exact_rng,
                            block_offset, sample_offset, n_tiles, normalize,
                            sl, slmeta, spp_map, fuse)
    render_tiles.launches += 1
    render_tiles.launches_by["exact" if exact_rng else "fast", fuse] += 1
    return (*outs, sum(segments))


render_tiles.launches = 0
render_tiles.launches_by = collections.Counter()


GUIDE = 2   # under a sample map an item takes <= 1 / (GUIDE x grid) of the units left


def work_items(n_tiles: int, fuse: int, grid: int, sampled: bool) -> list:
    """The work items of a launch of the split or candidate instances over
    ``n_tiles`` local pixel blocks on a grid of ``grid`` CUDA blocks, as (lo,
    hi) ranges of units, a unit being one 256-lane slice of one block (unit
    u: slice u % SLICES of local block u // SLICES), in the order the
    kernel's counter hands them out. The full walk (off/grouped) takes no
    items: its threads take single pixels from the counter, as one item of
    every unit (:func:`item_pixels` with ``lo`` 0). Without
    a sample map each item is one unit: a thread traces one pixel and the
    warps of a CUDA block trace neighbouring rows together. Under one
    (``sampled``) an item takes at most 1 / (GUIDE x grid) of the units
    left, at least one, and ends no later than the run of ``fuse`` blocks
    that holds its first unit (so it stages at most ``fuse`` shortlists):
    its threads share more pixels than there are threads, and those whose
    target is 0 are skipped as they are taken. The sizes depend on the
    counter's value alone: the kernel's items are these in every run."""
    n_units, run = n_tiles * SLICES, fuse * SLICES
    items, lo = [], 0
    while lo < n_units:
        size = (min(max((n_units - lo) // (GUIDE * grid), 1), run - lo % run)
                if sampled else 1)
        items.append((lo, lo + size))
        lo += size
    return items


def item_pixels(k: torch.Tensor, lo: int, block_offset: int, nbx: int):
    """The kernel's map (``csrc/megakernel.cu`` ``trace_item``) from the
    indices ``k`` of a work item's pixels to (local block, lane within it,
    px, py): pixel k of the item that starts at unit ``lo`` is lane k % 256
    of unit lo + k // 256, and the local block's global index
    ``block_offset`` + local, in a grid ``nbx`` blocks wide, gives the
    coordinates and so the draw keys. The full walk's one item starts at unit
    0, so its counter's value k is local lane k, in the plain version's lane
    order."""
    unit = lo + k // 256
    blk = unit // SLICES
    r = (unit % SLICES) * 256 + k % 256
    block = block_offset + blk
    px = (block % nbx) * BLOCK_W + r % BLOCK_W
    py = (block // nbx) * BLOCK_H + r // BLOCK_W
    return blk, r, px, py


def persistent_grid(n_tiles: int, blocks_per_sm: int, n_sms: int) -> int:
    """CUDA blocks of the persistent grid over ``n_tiles`` local pixel
    blocks: as many as the card holds at once (``blocks_per_sm`` resident on
    each of ``n_sms`` SMs), or one per unit where there are fewer units."""
    if blocks_per_sm < 1:
        raise ValueError("the kernel instance does not fit on an SM")
    return min(n_tiles * SLICES, blocks_per_sm * n_sms)


_INFO = {}


def instance_info(device, split: bool, candidates: bool, fast: bool,
                  fuse: int, sl_cap: int, probe: bool = False) -> dict:
    """Registers per thread (``num_regs``), spill bytes per thread
    (``local_bytes``), static and dynamic shared memory per block, resident
    blocks per SM (``blocks_per_sm``) and the SM count (``n_sms``) of one
    kernel instance at ``fuse`` staged shortlists of ``sl_cap`` entries, on
    CUDA ``device``; asked once per process and key. Builds the kernel on
    first use."""
    from .build import extension

    index = torch.device(device).index or 0
    key = (index, split, candidates, fast, probe,
           fuse if split else 1, sl_cap if split else 0)
    if key not in _INFO:
        _INFO[key] = dict(extension().kernel_info(*key))
    return _INFO[key]


# Samples a pixel of the full walk's pilot launch (:func:`pilot_samples`).
PILOT_SPP = 8


def pilot_samples(mode: tuple, spp: int) -> int:
    """The samples a pixel that the unsplit full walk (off/grouped) traces
    in a pilot launch before its main launch, or 0 for one launch. A frame
    of at least 4 x :data:`PILOT_SPP` samples a pixel traces the first
    PILOT_SPP of them in the block order, and the kernel counts each pixel's
    segments; the main launch traces the rest, each pixel's sums continued
    in sample order (so the bits are one launch's), and takes the costliest
    pixels first (:func:`walk_order`). A pixel at 500 samples may cost as
    much as a thread's whole share of the frame, so one taken late sets the
    frame's end; the pilot's counts say which to take early. On an H100 a
    pilot took 10-22% off the counter alone on the book's frame at 40 and
    100 samples and 8-11% at 16, but added 1-3% to the final scene's 1080p
    frame of 16 samples and 4 bounces, whose pixels cost nearly alike, so a
    frame of fewer samples takes one launch."""
    if mode == ("off", "grouped") and spp >= 4 * PILOT_SPP:
        return PILOT_SPP
    return 0


def walk_order(cost: torch.Tensor, nbx: int, nby: int,
               block_offset: int = 0) -> torch.Tensor:
    """The local lanes in the order the full walk's main launch takes them:
    by the pilot's segment counts ``cost`` (int32, one a lane) averaged over
    each pixel's 3x3 neighbours in the padded frame of ``nbx`` x ``nby``
    pixel blocks (those inside it; lanes of other shards count 0), the
    costliest first, and lanes of equal mean in block order. A few samples
    rank one pixel's cost roughly; its neighbours mostly see the same
    surfaces, so their mean ranks it better, and a costly pixel ranked
    low is taken late and sets the launch's end. Lanes outside the frame
    count 0."""
    lane = torch.arange(cost.numel(), device=cost.device)
    _, _, px, py = item_pixels(lane, 0, block_offset, nbx)
    width = nbx * BLOCK_W
    at = py * width + px
    image = torch.zeros(nby * BLOCK_H * width, device=cost.device)
    image[at] = cost.float()
    mean = torch.nn.functional.avg_pool2d(
        image.view(1, 1, nby * BLOCK_H, width), 3, stride=1, padding=1,
        count_include_pad=False)
    return torch.argsort(mean.view(-1)[at], descending=True,
                         stable=True).to(torch.int32)


def _frame(pscene: KernelScene, cam: CameraState, config: RenderConfig,
           frame_seed, exact_rng: bool, block_offset: int,
           sample_offset: int, n_tiles: int, normalize: bool, sl, slmeta,
           spp_map, fuse: int, probe=None):
    """The launches of one :func:`render_tiles` call on the card: one, or the
    full walk's pilot and main launches (:func:`pilot_samples`), the main
    one continuing the pilot's sums in place. Returns the four outputs and
    the segments each launch counted, the pilot's first. A ``probe`` takes
    the main launch."""
    pilot = pilot_samples(kernel_mode(pscene, config, sl),
                          config.samples_per_pixel)
    run = (pscene, cam, config, frame_seed, exact_rng, block_offset,
           sample_offset, n_tiles, normalize, sl, slmeta, spp_map, fuse)
    if not pilot:
        *outs, segments = _launch(*run, probe=probe)
        return outs, (segments,)
    cost = torch.zeros(n_tiles * TILE, dtype=torch.int32,
                       device=pscene.sph.device)
    *sums, pilot_segments = _launch(*run, spp=pilot, cost=cost)
    order = walk_order(cost, *block_grid(config), block_offset)
    *outs, segments = _launch(*run, probe=probe, first_sample=pilot,
                              order=order, outs=sums)
    return outs, (pilot_segments, segments)


def _launch(pscene: KernelScene, cam: CameraState, config: RenderConfig,
            frame_seed, exact_rng: bool, block_offset: int,
            sample_offset: int, n_tiles: int, normalize: bool, sl, slmeta,
            spp_map, fuse: int, probe=None, spp=None, cost=None,
            first_sample=0, order=None, outs=None):
    """One launch of the CUDA kernel on the persistent grid; ``probe`` (an
    int64 tensor of the extension's ``probe_slots`` zeros) takes the probe
    instance and receives its clock sums. The full walk's pilot gives
    ``spp`` (its samples a pixel, summed unnormalised) and ``cost`` (int32
    zeros, one a lane, that receive each pixel's segments); its main launch
    ``first_sample`` (the samples the pilot traced), ``order`` (the lanes in
    the order its threads take them) and ``outs`` (the pilot's sums, which
    it continues in place)."""
    from .build import extension

    dev = pscene.sph.device
    ext = extension()
    mode = kernel_mode(pscene, config, sl)
    split, candidates = mode[0] == "split", mode[1] == "candidates"
    sl_cap = sl.shape[-1] if split else 0
    info = instance_info(dev, split, candidates, not exact_rng, fuse, sl_cap,
                         probe is not None)
    grid = persistent_grid(n_tiles, info["blocks_per_sm"], info["n_sms"])
    nbx, _ = block_grid(config)
    n_lanes = n_tiles * TILE
    cam_row = camera_rows(cam, config).fused.to(dev)
    if outs is None:
        outs = [torch.empty(n_lanes, dtype=torch.float32, device=dev)
                for _ in range(4)]
    # [0] the segment count, [1] the work counter the CUDA blocks take items
    # (the full walk's threads, pixels) from: fresh for every launch.
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if sl is None:
        sl = slmeta = torch.empty(0, dtype=torch.float32, device=dev)
    if spp_map is None:
        spp_map = torch.empty(0, dtype=torch.int32, device=dev)
    if probe is None:
        probe = torch.empty(0, dtype=torch.int64, device=dev)
    none = torch.empty(0, dtype=torch.int32, device=dev)
    ext.render_tiles(cam_row, pscene.sph, pscene.attr, pscene.gaabb,
                     pscene.tri, pscene.n_tris, sl.contiguous(),
                     slmeta.contiguous(),
                     spp_map.contiguous(), *outs, counters,
                     nbx, block_offset, config.width, config.height,
                     spp or config.samples_per_pixel, config.bounces,
                     int(frame_seed) & _M32, int(sample_offset),
                     1.0 if spp else _inv_spp(config, normalize),
                     config.level, config.defocus,
                     config.diffuse_sampling == "cosine", split, candidates,
                     pscene.gc, pscene.n_cand, pscene.cand_off, not exact_rng,
                     fast_rng.words_per_bounce(), fuse, grid, probe,
                     first_sample, none if order is None else order,
                     none if cost is None else cost)
    return (*outs, counters[0])


# The probe's clock sums, in the kernel's ProbeSlot order (megakernel.h).
PROBE_SLOTS = ("total", "stage", "fetch", "segment", "walk0", "walk",
               "triangles", "warp_idle", "issues", "segments", "slab_tests",
               "block_ns", "block_cycles", "max_ns", "max_cycles")
# A thread's clock sums are 32-bit, so a run of 2^32 cycles wraps them; the
# longest block's run (``max_cycles``) holds its threads' to within the
# cycles between their starts, far below the 2^20 kept spare.
PROBE_WRAP_CYCLES = 2 ** 32 - 2 ** 20
# The (primary, intersect) modes that have a probe instance: the default
# kernel's, and the unsplit full walk that a frame of more than
# MAX_SPLIT_SPP samples a pixel takes below 1025 padded spheres.
PROBE_MODES = (("split", "candidates"), ("off", "grouped"))


def render_tiles_probe(pscene: KernelScene, cam: CameraState,
                       config: RenderConfig, frame_seed, sample_offset=0,
                       normalize: bool = True, sl=None, slmeta=None,
                       spp_map=None):
    """A launch of the probe instance of the kernel in one of
    :data:`PROBE_MODES` (the mode :func:`kernel_mode` gives these inputs,
    the fast draw path, :func:`kernel_fuse`'s fuse): the kernel with
    ``clock64()`` reads around its stages, for measurement only. Returns
    :func:`render_tiles`' outputs, which equal the default instance's, and
    a dict of the clock sums over all threads (:data:`PROBE_SLOTS`: cycles
    per stage; ``issues``, the warp-level segment iterations, and
    ``segments``, the lanes' segments, whose ratio is the mean of active
    lanes per iteration; ``slab_tests``, the candidate-box tests the lanes'
    table walks run, 0 in the off/grouped walk, which tests no box; so is
    ``walk0``, the shortlist walk of the split); then the blocks' runs
    (``block_ns`` and ``block_cycles``, summed over the blocks, whose ratio
    is the SM clock in GHz; ``max_ns`` and ``max_cycles``, the longest
    block's, maxima). Besides the clocks, ``launch_segments``: the segments
    each launch counted on its own counter, in launch order. Where the full
    walk takes a pilot launch first (:func:`pilot_samples`), the pilot runs
    the default instance and the clocks are the main launch's, so the
    probe's ``segments`` equal the last launch's count, and the outputs'
    count is the launches' sum. Raises where a thread may have run long
    enough to wrap its sums (:func:`check_probe_clocks`). Takes CUDA tensors
    only; it is not counted in ``render_tiles.launches``."""
    from .build import extension

    mode = kernel_mode(pscene, config, sl)
    if mode not in PROBE_MODES:
        raise ValueError(f"no probe instance runs {'/'.join(mode)}: only "
                         + ", ".join("/".join(m) for m in PROBE_MODES))
    dev = pscene.sph.device
    if dev.type != "cuda":
        raise ValueError("render_tiles_probe measures the CUDA kernel; it "
                         f"takes CUDA tensors, not {dev}")
    n_tiles = local_blocks(config)
    _check_shortlists(pscene, config, sl, slmeta, n_tiles)
    _check_accumulation(pscene, sample_offset, spp_map, n_tiles)
    probe = torch.zeros(extension().probe_slots, dtype=torch.int64,
                        device=dev)
    outs, segments = _frame(pscene, cam, config, frame_seed, False, 0,
                            sample_offset, n_tiles, normalize, sl, slmeta,
                            spp_map, kernel_fuse(pscene, config, sl), probe)
    clocks = dict(zip(PROBE_SLOTS, probe.tolist()))
    check_probe_clocks(clocks)
    clocks["launch_segments"] = [int(n) for n in segments]
    return (*outs, sum(segments)), clocks


def check_probe_clocks(clocks: dict) -> None:
    """Raises unless the longest block's run (``max_cycles``) stayed under
    :data:`PROBE_WRAP_CYCLES`, so that no thread's 32-bit stage sums
    wrapped."""
    if clocks["max_cycles"] >= PROBE_WRAP_CYCLES:
        raise RuntimeError(
            f"a probe block ran {clocks['max_cycles']} cycles "
            f"({clocks['max_ns'] / 1e6:.0f} ms), too near the 2^32 that a "
            "thread's 32-bit clock sums hold: probe a shorter launch")


def _inv_spp(config: RenderConfig, normalize: bool) -> float:
    return (float(np.float32(1.0 / config.samples_per_pixel)) if normalize
            else 1.0)


def _quadratic_q(o: Vec3, d: Vec3, a, cx, cy, cz, r2):
    """q = a·t of the near root for lanes [m] against spheres [m, k] (or
    [k]), in the kernel's order of operations; NaN where the discriminant is
    negative."""
    ocx = cx - o.x[:, None]
    ocy = cy - o.y[:, None]
    ocz = cz - o.z[:, None]
    h = d.x[:, None] * ocx + d.y[:, None] * ocy + d.z[:, None] * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = h * h - a[:, None] * cc
    return h - sqrt(disc)


def _accepted(q, q_min):
    """+inf where a test fails ``q > a·T_MIN`` or ``q < INF`` (NaN fails
    both), else q."""
    return torch.where((q > q_min[:, None]) & (q < _INF32), q, float("inf"))


def _candidate_groups(o: Vec3, d: Vec3, a, pscene: KernelScene):
    """([m, n_cand] bool, [m, n_cand] a·t_near): the ray enters candidate
    group g's AABB ahead of a miss (``_CandidateWalk.build`` with best_q =
    INF): t_far >= t_near, t_far > 0 and a·t_near < INF.
    ``torch.minimum``/``maximum`` keep NaN (0 · inf on a face plane) as
    ``jnp.minimum``/``maximum`` do, so such a group is not entered."""
    box = pscene.gaabb[:, pscene.cand_off:pscene.cand_off + pscene.n_cand]
    t = [(box[k] - c[:, None]) * (1.0 / dc)[:, None]
         for c, dc, k in ((o.x, d.x, 0), (o.x, d.x, 3), (o.y, d.y, 1),
                          (o.y, d.y, 4), (o.z, d.z, 2), (o.z, d.z, 5))]
    mn, mx = torch.minimum, torch.maximum
    t_near = mx(mx(mn(t[0], t[1]), mn(t[2], t[3])), mn(t[4], t[5]))
    t_far = mn(mn(mx(t[0], t[1]), mx(t[2], t[3])), mx(t[4], t[5]))
    near_q = a[:, None] * t_near
    return (t_far >= t_near) & (t_far > 0.0) & (near_q < _INF32), near_q


def _hit(best_q, best_i, inv_a):
    """(t, index) from the carried (q, index); INF / -1 on a miss."""
    hit = best_q < _INF32
    return (torch.where(hit, best_q * inv_a, _INF32),
            torch.where(hit, best_i, -1))


def _intersect_full(o: Vec3, d: Vec3, pscene: KernelScene, candidates: bool,
                    work: dict):
    """The full walk for every lane as (t, index): a dense [lanes x S] q
    matrix whose first minimum (``argmin``) is the lexicographic minimum of
    (q, index). In candidates mode a sphere counts only where the ray enters
    its candidate group (:func:`_candidate_groups`); the kernel's pruning of
    groups entered behind the best hit drops nothing that could win. Steps
    over lanes to bound the temporaries, and adds to ``work`` the slab tests
    (every lane against every candidate group) and the sphere tests that the
    hits need: every sphere in the full walk; in the candidate walk those of
    the groups entered no farther than the lane's best hit, which the
    kernel, pruning against its best hit so far, tests at least."""
    sph = pscene.sph
    a = d.dot(d)
    q_min = a * T_MIN
    n, s = a.shape[0], sph.shape[1]
    best_q = torch.empty_like(a)
    best_i = torch.empty(n, dtype=torch.int64, device=a.device)
    group = torch.arange(s, device=a.device) // pscene.gc
    sizes = torch.bincount(group, minlength=pscene.n_cand).to(a.dtype)
    step = max(1, DENSE_ELEMS // s)
    for lo in range(0, n, step):
        span = slice(lo, lo + step)
        ol, dl = Vec3(*(c[span] for c in o)), Vec3(*(c[span] for c in d))
        q = _accepted(_quadratic_q(ol, dl, a[span], *sph), q_min[span])
        if candidates:
            entered, near_q = _candidate_groups(ol, dl, a[span], pscene)
            q = torch.where(entered[:, group], q, float("inf"))
        idx = torch.argmin(q, dim=1)
        bq = torch.gather(q, 1, idx[:, None])[:, 0]
        best_i[span], best_q[span] = idx, bq
        if candidates:
            needed = entered & (near_q <= bq[:, None])
            work["sphere_tests"] += int((needed.to(a.dtype) @ sizes).sum())
            work["slab_tests"] += entered.numel()
        else:
            work["sphere_tests"] += q.numel()
    return _hit(best_q, best_i, 1.0 / a)


def _intersect_shortlist(o: Vec3, d: Vec3, sl: torch.Tensor, slmeta, blk,
                         work: dict):
    """Bounce 0 against each lane's block shortlist as (t, global index):
    the lexicographic minimum of (q, global index) over the block's rows
    (``_intersect_shortlist``, whose index tie-break is explicit because the
    rows run front to back). Padding rows (r² = -1e30) never hit. The
    kernel's chunk early-out stops only where no later row can beat the
    best hit, so this dense version tests every row; it adds to ``work``
    the live rows of the leading chunks whose a·t_lo is below the lane's
    best hit, which the kernel, stopping against its best hit so far, tests
    at least."""
    from .primary import SL_CHUNK

    a = d.dot(d)
    q_min = a * T_MIN
    n, k = a.shape[0], sl.shape[2]
    best_q = torch.empty_like(a)
    best_i = torch.empty(n, dtype=torch.int64, device=a.device)
    live = (sl[:, 3, :] > -1e29).sum(dim=1)
    step = max(1, DENSE_ELEMS // k)
    for lo in range(0, n, step):
        span = slice(lo, lo + step)
        rows = sl[blk[span]]                                  # [m, 5, k]
        ol, dl = Vec3(*(c[span] for c in o)), Vec3(*(c[span] for c in d))
        q = _accepted(_quadratic_q(ol, dl, a[span], rows[:, 0], rows[:, 1],
                                   rows[:, 2], rows[:, 3]), q_min[span])
        bq = q.amin(dim=1)
        gi = torch.where(q == bq[:, None], rows[:, 4].long(), _NO_INDEX)
        best_q[span] = bq
        best_i[span] = gi.amin(dim=1)
        ahead = a[span, None] * slmeta[blk[span], 1:] < bq[:, None]
        chunks = ahead.long().cumprod(dim=1).sum(dim=1)
        work["sphere_tests"] += int(torch.minimum(live[blk[span]],
                                                  SL_CHUNK * chunks).sum())
    return _hit(best_q, best_i, 1.0 / a)


def _merge_triangles(o: Vec3, d: Vec3, t, idx, pscene: KernelScene,
                     work: dict):
    """Merge the test of the live triangle rows into the sphere walk's
    (t, index) (``_intersect_triangles_scalar``): a triangle replaces the
    hit only with a strictly smaller t, and its index is its row plus the
    padded sphere count (its ``attr`` column). Adds the tests to ``work``:
    every live row for every lane."""
    n = pscene.n_tris
    rows = pscene.tri[:, :n]
    tt, ti = intersect_triangles_reference(
        o, d, Triangles(*rows[:9], material_id=None, valid=rows[9] > 0.0))
    better = tt < t
    work["triangle_tests"] += t.shape[0] * n
    return (torch.where(better, tt, t),
            torch.where(better, ti + pscene.sph.shape[1], idx))


def _intersect(o: Vec3, d: Vec3, active, pscene: KernelScene,
               candidates: bool, work: dict, sl=None, slmeta=None, blk=None):
    """(t, index) of the active lanes' walks, with the triangles merged
    after the sphere walk; inactive lanes read as a miss (their results are
    never used). With ``sl`` the walk is bounce 0 of the phase split: each
    lane's block shortlist, or the full walk in blocks whose shortlist
    overflowed (``slmeta[:, 0] > 0``)."""
    t = torch.full_like(o.x, _INF32)
    idx = torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
    lanes = active.nonzero()[:, 0]

    def at(v: Vec3, ln) -> Vec3:
        return Vec3(v.x[ln], v.y[ln], v.z[ln])

    full = lanes
    if sl is not None:
        overflow = slmeta[blk[lanes], 0] > 0.0
        short = lanes[~overflow]
        if short.numel():
            t[short], idx[short] = _intersect_shortlist(
                at(o, short), at(d, short), sl, slmeta, blk[short], work)
        full = lanes[overflow]
    if full.numel():
        t[full], idx[full] = _intersect_full(at(o, full), at(d, full),
                                             pscene, candidates, work)
    if pscene.n_tris and lanes.numel():
        t[lanes], idx[lanes] = _merge_triangles(at(o, lanes), at(d, lanes),
                                                t[lanes], idx[lanes], pscene,
                                                work)
    return t, idx


class _ExactDraws:
    """The exact path's draws of one (pixel, sample) stream: two PCG steps
    per slot of :mod:`...engine.slots` (the JAX kernel's
    ``ExactRngProvider``)."""

    def __init__(self, stream):
        self.stream = stream

    def jitter(self):
        return (rng.draw(self.stream, slots.JITTER_U),
                rng.draw(self.stream, slots.JITTER_V))

    def lens(self):
        return (rng.draw(self.stream, slots.LENS_U),
                rng.draw(self.stream, slots.LENS_V))

    def scatter_draws(self, bounce: int):
        base = slots.bounce_base(bounce)
        return (rng.draw(self.stream, base + slots.S_METAL),
                rng.draw(self.stream, base + slots.S_TRANS),
                rng.draw(self.stream, base + slots.S_REFLECT),
                _ball(self.stream, base + slots.S_BALL1),
                _ball(self.stream, base + slots.S_BALL2))


def _raygen(cam: torch.Tensor, config: RenderConfig, draws, exact_rng: bool,
            u, v):
    """Jittered primary ray (random_ray_from_uv, wgsl:139-156), the JAX
    kernel's own raygen, with the thin lens when ``config.defocus``; the
    fast path turns the lens with the fast trig, as the JAX kernel does."""
    pos = Vec3(cam[C_POS_X], cam[C_POS_Y], cam[C_POS_Z])
    cdir = Vec3(cam[C_DIR_X], cam[C_DIR_Y], cam[C_DIR_Z])
    up = Vec3(cam[C_UP_X], cam[C_UP_Y], cam[C_UP_Z])
    right = Vec3(cam[C_RIGHT_X], cam[C_RIGHT_Y], cam[C_RIGHT_Z])
    scale, aspect = cam[C_SCALE], cam[C_ASPECT]
    ju, jv = draws.jitter()
    h_px = cam[C_HEIGHT]
    w_px = h_px * aspect
    ndc_x = (u * 2.0 - 1.0) + (ju - 0.5) / w_px
    ndc_y = (1.0 - v * 2.0) + (jv - 0.5) / h_px
    d = (cdir + right.scale(ndc_x * aspect * scale)
         + up.scale(ndc_y * scale)).normalize()
    o = Vec3(*(c.expand_as(d.x) for c in pos))
    if config.defocus:
        lu, lv = draws.lens()
        rr = cam[C_APERTURE] * 0.5 * sqrt(lu)
        if exact_rng:
            theta = rng.TWO_PI * lv
            lx = rr * torch.cos(theta)
            ly = rr * torch.sin(theta)
        else:
            lx = rr * fast_rng.fast_cos2pi(lv)
            ly = rr * fast_rng.fast_sin2pi(lv)
        focal = o + d.scale(cam[C_FOCUS])
        o = o + right.scale(lx) + up.scale(ly)
        d = (focal - o).normalize()
    return o, d


def _ball(stream, first: int) -> Vec3:
    return rng.unit_ball_from_uniforms(
        *(rng.draw(stream, first + k) for k in range(rng.BALL_DRAWS)))


def render_tiles_reference(pscene: KernelScene, cam: CameraState,
                           config: RenderConfig, frame_seed,
                           normalize: bool = True, sl=None, slmeta=None,
                           work: dict | None = None, sample_offset: int = 0,
                           spp_map=None, exact_rng=None, block_offset=0,
                           n_blocks_local=None):
    """The plain PyTorch version of the kernel, on any device, in the
    dtype of the scene tables (float32 as prepared; a float64 copy replays
    the frame on the same inputs in float64, on the exact path). The draw
    path resolves as in :func:`render_tiles`; the fast path's helpers are
    float32 (:mod:`.fast_rng`). Block fusion changes no value, so it has no
    counterpart here.

    Tensors over all lanes of the padded block grid, like the JAX kernel, and
    a Python loop over samples and bounces; each bounce intersects only the
    lanes still active. Per lane this adds the same values in the same order
    as the kernel's per-pixel sample loop. Takes and returns what
    :func:`render_tiles` does. ``work``, when given, gets the counts of sphere
    tests, of candidate-group slab tests and of triangle tests that the walks
    need on this frame's rays (``"sphere_tests"``, ``"slab_tests"``,
    ``"triangle_tests"``): the sphere and slab tests that the rays' best hits
    leave after the kernel's candidate prune and shortlist early-out
    (:func:`_intersect_full`, :func:`_intersect_shortlist`), and every live
    triangle row per segment (:func:`_merge_triangles`); and
    ``"triangle_hits"`` and ``"triangle_first_hits"``, the segments that hit
    a triangle, at any bounce and at bounce 0.
    Under ``spp_map`` every sample runs over all lanes, masked to the lanes
    whose target it is below, so ``work`` and the segments count only the
    samples traced. With ``block_offset`` / ``n_blocks_local`` the lanes are
    those of the launch's local blocks: the local block indexes the outputs,
    the shortlists and the map, the global block gives the pixel.
    """
    render_tiles_reference.calls += 1
    dev = pscene.sph.device
    exact_rng = resolve_exact_rng(exact_rng, dev)
    work = {} if work is None else work
    for key in ("sphere_tests", "slab_tests", "triangle_tests",
                "triangle_hits", "triangle_first_hits"):
        work.setdefault(key, 0)
    candidates = kernel_mode(pscene, config, sl)[1] == "candidates"
    cam_row = camera_rows(cam, config).fused.to(dev, pscene.sph.dtype)
    nbx, _ = block_grid(config)
    lane = torch.arange(local_blocks(config, n_blocks_local) * TILE,
                        device=dev)
    blk, _, px, py = item_pixels(lane, 0, block_offset, nbx)
    in_image = (px < config.width) & (py < config.height)
    pixel = py * config.width + px        # row-major id keys the streams
    u = (px.to(cam_row.dtype) + 0.5) / cam_row[C_WIDTH]
    v = (py.to(cam_row.dtype) + 0.5) / cam_row[C_HEIGHT]
    far = cam_row[C_FAR]
    fallback_far = far + 10.0 if config.level == 1 else far - 1.0
    seed = int(frame_seed) & _M32
    attr = pscene.attr
    spp = config.samples_per_pixel
    target = (spp if spp_map is None
              else torch.clamp(spp_map.reshape(-1).long(), max=spp))

    zero = torch.zeros_like(u)
    cr, cg, cb, dsum = zero, zero, zero, zero
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        stream = rng.stream_init(pixel, (s + sample_offset) & _M32, seed)
        draws = (_ExactDraws(stream) if exact_rng
                 else fast_rng.FastRngProvider(stream))
        o, d = _raygen(cam_row, config, draws, exact_rng, u, v)
        ray_color = Vec3(zero + 1.0, zero + 1.0, zero + 1.0)
        radiance = Vec3(zero, zero, zero)
        first_depth = torch.full_like(u, _INF32)
        active = in_image & (s < target)
        for b in range(config.bounces + 1):
            segs = segs + active.sum()
            if b == 0 and sl is not None:
                t, idx = _intersect(o, d, active, pscene, candidates, work,
                                    sl=sl, slmeta=slmeta, blk=blk)
            else:
                t, idx = _intersect(o, d, active, pscene, candidates, work)
            miss = t >= _INF32
            if b == 0:
                first_depth = torch.where(active, t, first_depth)
            if pscene.n_tris:
                hits = int((active & (idx >= pscene.sph.shape[1])).sum())
                work["triangle_hits"] += hits
                if b == 0:
                    work["triangle_first_hits"] += hits
            radiance = Vec3.where(active & miss,
                                  radiance + ray_color * background_gradient(d),
                                  radiance)
            active_hit = active & ~miss
            rows = attr[:, idx.clamp(min=0)]
            center = Vec3(rows[0], rows[1], rows[2])
            position = o + d.scale(torch.where(miss, 0.0, t))
            up = Vec3(zero, zero + 1.0, zero)
            # attr rows 0-2 hold a sphere's center or a triangle's unit
            # normal (not flipped toward the ray).
            normal = Vec3.where(idx >= pscene.sph.shape[1], center,
                                (position - center).normalize())
            normal = Vec3.where(miss, up, normal)
            hit = HitInfo(t=t, miss=miss, position=position, normal=normal,
                          material_id=idx, front_face=d.dot(normal) < 0.0)
            mat = MaterialLanes(base_color=Vec3(rows[3], rows[4], rows[5]),
                                metallic=rows[6], roughness=rows[7],
                                ior=rows[8], specular_transmission=rows[9],
                                emissive=Vec3(rows[10], rows[11], rows[12]))
            radiance = Vec3.where(active_hit,
                                  radiance + ray_color * mat.emissive, radiance)
            sc = scatter(d, hit, mat, *draws.scatter_draws(b),
                         diffuse_mode=config.diffuse_sampling)
            cont = active_hit & ~sc.absorbed
            ray_color = Vec3.where(cont, ray_color * sc.attenuation, ray_color)
            o = Vec3.where(active_hit, position, o)
            d = Vec3.where(active_hit, sc.direction, d)
            cont = cont & (b < config.bounces)
            died = active & ~cont
            # Harvest the samples that ended (gamma is per sample, wgsl:226-228).
            g = linear_to_gamma(radiance)
            cr = cr + torch.where(died, g.x, 0.0)
            cg = cg + torch.where(died, g.y, 0.0)
            cb = cb + torch.where(died, g.z, 0.0)
            depth = torch.where(first_depth >= _INF32, fallback_far,
                                first_depth)
            dsum = dsum + torch.where(died, depth, 0.0)
            active = cont
    inv_spp = _inv_spp(config, normalize)
    return cr * inv_spp, cg * inv_spp, cb * inv_spp, dsum * inv_spp, segs


render_tiles_reference.calls = 0
