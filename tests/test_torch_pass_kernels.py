"""The camera row (K12), the adaptive pass's map and fold (K13, K14), the
sharded step's sums (K15) and its tp hit merge (K16): their plain versions
against the JAX package's arithmetic or NumPy on the same inputs, on the
CPU, and the kernels against their plain versions on the card (``-m
cuda``).

- K12 (``kernels/camera.py``): ``half_fov_tan`` bit-equal to jitted
  ``jnp.tan(fov * 0.5)`` (``generate_rays``' scale, the C library's
  ``tanf`` on the CPU) on 2^20 fovs, ``glibc_tanf`` (the card's) to fixed
  bits of glibc 2.36's ``tanf``, the fused row to jitted ``_pack_camera``
  and the wavefront row to JAX's terms, bit-equal.
- K13 (``kernels/passes.py`` ``adaptive_map``): bit-equal to JAX's
  ``shuffle_blocks(where(err >= tolerance | reprobe, spp, 0))``.
- K14 (``fold_adaptive``): bit-equal to JAX's ``_adaptive_pass`` arithmetic
  (bevyray_tpu/engine/adaptive.py:73-100) run op by op on the same
  block-ordered sums (jitted, XLA may contract a multiply-add).
- K15 (``sum_shards``): bit-equal to a NumPy ascending sum over dp and the
  shards' concatenation; on the card also on meshes of more than 32 parts
  (several launches, each carrying the running sums on).
- K16 (``merge_tp_hits``): equal to a NumPy lexicographic min of (t, global
  index) over the slices at tp 2, 4 and 8, with ties across slices, misses,
  inactive lanes and NaN t (torch.minimum's rule); the merge of the plain
  sphere test's slices equal to the whole table's test; on the card bit-equal
  to its plain version, also past 32 slices.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core.constants import INF
from bevyray_tpu_torch.core.types import Spheres, scene_from_numpy
from bevyray_tpu_torch.engine.adaptive import AdaptiveFilm
from bevyray_tpu_torch.kernels import camera, intersect, passes
from bevyray_tpu_torch.kernels.cuda import megakernel as mk

torch.set_num_threads(2)

SIZES = [(64, 64), (70, 45), (131, 67)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _bits_equal(got, want) -> bool:
    return all(np.array_equal(_bits(g.cpu().numpy()), _bits(w))
               for g, w in zip(got, want))


def _cameras(aspect=1.5, lens=False):
    jw = jrtiow.final_scene(seed=1, grid=1)
    if lens:
        jw.camera.aperture, jw.camera.focus_distance = 0.3, 4.5
    jcam = jw.camera_state(aspect=aspect)
    _, pcam = scene_from_numpy(_np(jw.extract(with_bvh=False)), _np(jcam),
                               device="cpu")
    return jcam, pcam


def _with_fov(jcam, pcam, fov):
    fov = np.float32(fov)
    return (jcam._replace(fov=jnp.float32(fov)),
            pcam._replace(fov=torch.tensor(fov)))


# -- K12: the camera row ----------------------------------------------------------

# Every fov the rtiow scenes, the tests and the CLI use (the projection's
# default, pi/4), and the edges of the kernel's branches.
FOVS = [np.pi / 4, np.pi / 2, 2.0, 1.3488, 1.3487, 1e-3, 1e-4, 3.0, 0.2,
        3.1415, 3.14159]


# glibc 2.36's tanf as (half angle, tangent) float32 bits: the halves of
# FOVS, then sixteen of test_half_fov_tan_is_xlas_tangent's seeded halves
# where it is 1 ulp off the rounded float64 tangent.
GLIBC_TANF = [
    (0x3EC90FDB, 0x3ED413CD), (0x3F490FDB, 0x3F800000),
    (0x3F800000, 0x3FC75923), (0x3F2CA57A, 0x3F4CA82A),
    (0x3F2CA234, 0x3F4CA2CC), (0x3A03126F, 0x3A031270),
    (0x3851B717, 0x3851B717), (0x3FC00000, 0x41619F6B),
    (0x3DCCCCCD, 0x3DCD7C44), (0x3FC90E56, 0x46A8A1C8),
    (0x3FC90FD0, 0x49409A21),
    (0x3F7D86EB, 0x3FC32CDB), (0x3F7ADCEA, 0x3FBED0AF),
    (0x3EE12F24, 0x3EF0EC2C), (0x3F299D3E, 0x3F47BBB6),
    (0x3F32D25C, 0x3F56FAE0), (0x3F1EE353, 0x3F3703B2),
    (0x3F9ED76B, 0x403AF0DC), (0x3F71944E, 0x3FB09E78),
    (0x3F591A74, 0x3F912342), (0x3F63C67C, 0x3F9DF278),
    (0x3F380948, 0x3F600722), (0x3F165BBD, 0x3F2A6BB8),
    (0x3F26E882, 0x3F436A5E), (0x3E8BAC7F, 0x3E8F3EB8),
    (0x3F127984, 0x3F24DF20), (0x3EC3B38E, 0x3ECDD2F0)]
# sha256 of glibc 2.36's tanf bits on the halves of _sweep_fovs().
GLIBC_TANF_SWEEP = (
    "f406cef13805b1132f7ffa68bdb7fdc77cad1c888e0e533be3ad6aa08c83d27b")


def _sweep_fovs() -> np.ndarray:
    """2^20 fovs from a seed with their halves in (0, 1.5], then FOVS."""
    rng = np.random.default_rng(17)
    return np.concatenate([rng.uniform(2 ** -20, 3.0, 1 << 20),
                           FOVS]).astype(np.float32)


def test_half_fov_tan_is_xlas_tangent():
    """On the sweep's fovs, jitted ``jnp.tan(fov * 0.5)`` is the C library's
    ``tanf`` of the half, and ``half_fov_tan`` on CPU tensors gives the
    same float32 bits, whatever that C library is."""
    fov = _sweep_fovs()
    want = np.asarray(jax.jit(lambda f: jnp.tan(f * 0.5))(fov))
    libm = camera.libm_tanf(torch.as_tensor(fov * np.float32(0.5))).numpy()
    assert np.array_equal(libm.view(np.int32), want.view(np.int32)), (
        "XLA's tan on this CPU is not the C library's tanf, which "
        "half_fov_tan calls on CPU tensors to give XLA's bits")
    got = camera.half_fov_tan(torch.as_tensor(fov)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_glibc_tanf_is_glibc_236():
    """``glibc_tanf``, which K12 runs in C on the card, gives glibc 2.36's
    ``tanf`` bits on any host: on the named halves, and on the sweep's
    halves by their hash."""
    x = np.uint32([a for a, _ in GLIBC_TANF]).view(np.float32)
    got = camera.glibc_tanf(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, [b for _, b in GLIBC_TANF])
    half = _sweep_fovs() * np.float32(0.5)
    port = camera.glibc_tanf(torch.from_numpy(half)).numpy()
    assert hashlib.sha256(port.view(np.int32).tobytes()).hexdigest() == (
        GLIBC_TANF_SWEEP)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("lens", [False, True])
def test_fused_row_matches_pack_camera(size, lens):
    w, h = size
    jcam0, pcam0 = _cameras(w / h, lens)
    pack = jax.jit(lambda c: jmk._pack_camera(c, JRenderConfig(width=w,
                                                               height=h)))
    for fov in FOVS:
        jcam, pcam = _with_fov(jcam0, pcam0, fov)
        rows = camera.camera_rows_reference(pcam, bt.RenderConfig(w, h))
        assert rows.wavefront is None
        assert _bits_equal([rows.fused], [np.asarray(pack(jcam))[0]])
        assert _bits_equal([camera.camera_rows(pcam,
                                               bt.RenderConfig(w, h)).fused],
                           [np.asarray(pack(jcam))[0]])


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("lens", [False, True])
def test_wavefront_row_matches_jax(level, lens):
    jcam, pcam = _cameras(1.25, lens)
    h = 72
    cfg = bt.RenderConfig(90, h, level=level)
    rows = camera.camera_rows_reference(pcam, cfg, fused=False,
                                        wavefront=True)
    assert rows.fused is None
    right = jcam.direction.cross(jcam.up)
    hh = jnp.float32(h)
    want = [*jcam.position, *jcam.direction, *jcam.up, *right,
            jax.jit(lambda f: jnp.tan(f * 0.5))(jcam.fov), jcam.aspect, hh,
            hh * jcam.aspect, jcam.aperture, jcam.focus_distance,
            jcam.far + 10.0 if level == 1 else jcam.far - 1.0]
    assert _bits_equal([rows.wavefront], [np.float32([np.asarray(x)
                                                      for x in want])])
    got = camera.camera_rows(pcam, cfg, fused=False, wavefront=True)
    assert torch.equal(got.wavefront, rows.wavefront)


def test_camera_rows_wrapper_on_the_cpu_and_its_checks():
    _, pcam = _cameras()
    cfg = bt.RenderConfig(32, 24)
    before = camera.camera_rows.launches
    both = camera.camera_rows(pcam, cfg, fused=True, wavefront=True)
    assert camera.camera_rows.launches == before
    ref = camera.camera_rows_reference(pcam, cfg, True, True)
    assert torch.equal(both.fused, ref.fused)
    assert torch.equal(both.wavefront, ref.wavefront)
    with pytest.raises(ValueError, match="float32"):
        camera.check_camera_args(pcam._replace(near=pcam.near.double()), cfg)
    with pytest.raises(ValueError, match="one float32"):
        camera.check_camera_args(pcam._replace(far=torch.zeros(2)), cfg)
    meta = pcam._replace(fov=torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        camera.camera_rows(meta, cfg)


# -- K13 and K14: the adaptive pass ----------------------------------------------

def _errs(n, rng):
    """Errors around the tolerance: exact ties, +inf, NaN, 0 and -0."""
    err = rng.uniform(0.0, 0.1, n).astype(np.float32)
    k = rng.choice(n, 5 * (n // 50), replace=False).reshape(5, -1)
    err[k[0]] = np.float32(0.05)
    err[k[1]] = np.inf
    err[k[2]] = np.nan
    err[k[3]] = 0.0
    err[k[4]] = -0.0
    return err


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("reprobe", [False, True])
def test_adaptive_map_matches_jax(size, reprobe):
    w, h = size
    err = _errs(w * h, np.random.default_rng(w + h))
    cfg, jcfg = bt.RenderConfig(w, h, 3), JRenderConfig(width=w, height=h,
                                                         samples_per_pixel=3)
    got = passes.adaptive_map(torch.as_tensor(err), 0.05, reprobe, cfg)
    want_mask = (jnp.asarray(err) >= 0.05) | reprobe
    want = jmk.shuffle_blocks(jnp.where(want_mask, 3, 0).astype(jnp.int32),
                              jcfg, fill=0)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int((got.numpy() == 3).sum()) == (w * h if reprobe else int(
        (err >= np.float32(0.05)).sum()))


def _jax_fold(film, sums, tolerance, reprobe, spp, jcfg):
    """``_adaptive_pass``'s arithmetic after ``render_tiles``
    (bevyray_tpu/engine/adaptive.py:66-100), on block-ordered sums."""
    color_sum, depth_sum, n_samples, err = film
    want = (err >= tolerance) | reprobe
    r, g, b, depth = (jmk.unshuffle_blocks(x, jcfg) for x in sums)
    took = want.astype(jnp.float32) * spp
    old_n = jnp.maximum(n_samples, 1.0)
    old_mean = color_sum.scale(1.0 / old_n)
    new_mean = JVec3(r, g, b).scale(1.0 / jnp.maximum(took, 1.0))
    lum = (old_mean.x + old_mean.y + old_mean.z) * (1.0 / 3.0)
    delta = (jnp.abs(new_mean.x - old_mean.x)
             + jnp.abs(new_mean.y - old_mean.y)
             + jnp.abs(new_mean.z - old_mean.z)) * (1.0 / 3.0)
    rel = delta / (lum + 0.05)
    seen = n_samples > 0.0
    new_err = jnp.where(want & seen, rel, err)
    new_err = jnp.where(want & ~seen, jnp.inf, new_err)
    new_err = jnp.where(~want, err, new_err)
    return (*(color_sum + JVec3(r, g, b)), depth_sum + depth,
            n_samples + took, new_err)


def _fold_inputs(w, h, seed, first=False):
    """A film (sums, counts 0 / 2 / 4 / NaN-free, errors around the bar)
    and a pass's block-ordered sums with zero on the padding lanes."""
    rng = np.random.default_rng(seed)
    n = w * h
    nbx, nby = mk.block_grid(bt.RenderConfig(w, h))
    lanes = nbx * nby * mk.TILE
    counts = (np.zeros(n) if first else
              rng.choice([0.0, 2.0, 4.0], n)).astype(np.float32)
    film = [(rng.random(n, dtype=np.float32) * 3 * counts) for _ in range(3)]
    film += [rng.random(n, dtype=np.float32) * 9 * counts, counts,
             np.full(n, np.inf, np.float32) if first else _errs(n, rng)]
    sums = [rng.random(lanes, dtype=np.float32) * 6 for _ in range(4)]
    sums[0][rng.choice(lanes, 20)] = -0.0
    return film, sums, np.int64(123456789012), np.int64(4321)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["first", "later", "reprobe"])
def test_fold_adaptive_matches_jax(size, case):
    w, h = size
    film, sums, rays, segs = _fold_inputs(w, h, w * h, first=case == "first")
    reprobe = case == "reprobe"
    cfg = bt.RenderConfig(w, h, 2)
    jcfg = JRenderConfig(width=w, height=h, samples_per_pixel=2)
    t = [torch.as_tensor(x) for x in film]
    pfilm = AdaptiveFilm(bt.Vec3(*t[:3]), t[3], t[4], t[5],
                         torch.tensor(rays))
    kept = [x.clone() for x in t]
    before = passes.fold_adaptive.launches
    got = passes.fold_adaptive(pfilm, [torch.as_tensor(x) for x in sums],
                               torch.tensor(segs), 0.05, reprobe, cfg)
    assert passes.fold_adaptive.launches == before
    jfilm = (JVec3(*map(jnp.asarray, film[:3])), *map(jnp.asarray, film[3:]))
    with jax.disable_jit():
        want = _jax_fold(jfilm, [jnp.asarray(x) for x in sums], 0.05,
                         reprobe, 2, jcfg)
    assert _bits_equal((*got[0], *got[1:4]), [np.asarray(x) for x in want])
    assert int(got[4]) == rays + segs
    assert _bits_equal(t, kept)   # the old film is not changed


# -- K15: the sharded step's sums -------------------------------------------------

@pytest.mark.parametrize("sp,dp", [(1, 2), (2, 1), (3, 1), (2, 2)])
def test_sum_shards_is_the_ascending_sum(sp, dp):
    rng = np.random.default_rng(10 * sp + dp)
    n = 1000
    cols = rng.random((sp, dp, 4, n), dtype=np.float32) * 50
    segs = rng.integers(0, 1 << 40, (sp, dp))
    parts = {(i, k): (bt.Vec3(*(torch.as_tensor(c) for c in cols[i, k, :3])),
                      torch.as_tensor(cols[i, k, 3]), torch.tensor(segs[i, k]))
             for i in range(sp) for k in range(dp)}
    before = passes.sum_shards.launches
    got, total = passes.sum_shards(parts, sp, dp, "cpu")
    assert passes.sum_shards.launches == before
    want = np.empty((4, sp * n), np.float32)
    for i in range(sp):
        acc = cols[i, 0].copy()
        for k in range(1, dp):
            acc = acc + cols[i, k]
        want[:, i * n:(i + 1) * n] = acc
    assert _bits_equal(got, want)
    assert int(total) == int(segs.sum())


# -- K16: the tp hit merge ---------------------------------------------------------

NO_INDEX = np.iinfo(np.int64).max


def _tp_slices(tp, n, seed, chunk=16):
    """Each slice's (t, local index) of ``n`` lanes, t from a few values so
    that slices tie, and the slices' offsets. Lanes 0-3 of every slice are
    misses (INF / -1, as an inactive lane is); on lanes 4-7 slice 1 misses
    and the others tie; lane 8 has a NaN t in slice 1; lane 9 a NaN t in
    every slice; lane 10 holds one t in every slice (the lowest global
    index wins, slice 0's)."""
    rng = np.random.default_rng(seed)
    t = rng.choice(np.float32([0.5, 1.25, 2.0, 7.75]), (tp, n))
    t[rng.random((tp, n)) < 0.25] = INF
    i = rng.integers(0, chunk, (tp, n))
    t[:, :4] = INF
    t[1, 4:8] = INF
    t[[k for k in range(tp) if k != 1], 4:8] = np.float32(1.25)
    t[1, 8] = np.nan
    t[:, 9] = np.nan
    t[:, 10] = np.float32(2.0)
    i = np.where(t >= INF, -1, i)
    return t.astype(np.float32), i.astype(np.int64), [k * chunk
                                                      for k in range(tp)]


def _lexicographic_min(t, i, offsets):
    """Per lane the least (t, global index) over the slices that hit, INF
    / -1 where none does; a NaN t in any slice gives NaN and no index
    (int64's maximum), as torch.minimum propagates it and no t equals it."""
    tp, n = t.shape
    want_t = np.full(n, INF, np.float32)
    want_i = np.full(n, -1, np.int64)
    for lane in range(n):
        if np.isnan(t[:, lane]).any():
            want_t[lane], want_i[lane] = np.nan, NO_INDEX
            continue
        hits = [(t[k, lane], i[k, lane] + offsets[k]) for k in range(tp)
                if i[k, lane] >= 0 and t[k, lane] < INF]
        if hits:
            want_t[lane], want_i[lane] = min(hits)
    return want_t, want_i


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_merge_tp_hits_is_the_lexicographic_min(tp):
    t, i, offsets = _tp_slices(tp, 600, tp)
    ts = [torch.as_tensor(x) for x in t]
    indices = [torch.as_tensor(x) for x in i]
    before = passes.merge_tp_hits.launches
    got_t, got_i = passes.merge_tp_hits(ts, indices, offsets)
    assert passes.merge_tp_hits.launches == before
    ref_t, ref_i = passes.merge_tp_hits_reference(ts, indices, offsets)
    assert torch.equal(got_i, ref_i)
    assert np.array_equal(got_t.numpy(), ref_t.numpy(), equal_nan=True)
    want_t, want_i = _lexicographic_min(t, i, offsets)
    assert got_t.dtype == torch.float32 and got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # The cases the slices were made with.
    assert (got_i[:4] == -1).all() and (got_t[:4] == INF).all()
    assert (got_t[4:8] == 1.25).all() and (got_i[4:8] >= 0).all()
    assert bool(torch.isnan(got_t[8])) and int(got_i[8]) == NO_INDEX
    assert int(got_i[10]) == i[0, 10]


def _sphere_test(sph, o, d, active):
    """The plain sphere test (K1's) of every ray in ``active``."""
    return intersect.intersect_spheres(o, d, sph, sph.capacity,
                                       active=active)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_merge_of_sphere_slices_is_the_whole_test(tp):
    """The plain sphere test of each slice of a table whose spheres repeat
    across the slices (the lower index must win), merged, equals the whole
    table's test; lanes outside ``active`` miss in every slice."""
    rng = np.random.default_rng(tp)
    cap, n = 64, 3000
    centers = rng.uniform(-3, 3, (cap, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 0.8, cap).astype(np.float32)
    for a, b in ((3, 40), (20, 33), (31, 32), (5, 63)):   # across slices
        centers[b], radii[b] = centers[a], radii[a]
    valid = np.ones(cap, bool)
    valid[[7, 50]] = False
    sph = Spheres(*(torch.as_tensor(c) for c in centers.T),
                  torch.as_tensor(radii), torch.zeros(cap, dtype=torch.int32),
                  torch.as_tensor(valid))
    o = bt.Vec3(*(torch.as_tensor(c) for c in
                  rng.uniform(-6, 6, (3, n)).astype(np.float32)))
    d = bt.Vec3(*(torch.as_tensor(c) for c in
                  rng.normal(size=(3, n)).astype(np.float32)))
    active = torch.as_tensor(rng.random(n) < 0.8)
    whole = _sphere_test(sph, o, d, active)
    w = cap // tp
    ts, indices = [], []
    for k in range(tp):
        part = Spheres(*(c[k * w:(k + 1) * w] for c in sph))
        t, i = _sphere_test(part, o, d, active)
        ts.append(t)
        indices.append(i)
    got = passes.merge_tp_hits(ts, indices, [k * w for k in range(tp)])
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    assert bool((got[1][~active] == -1).all())
    hit = set(got[1][got[1] >= 0].tolist())
    assert {3, 20, 31, 5} <= hit and not hit & {40, 33, 32, 63, 7, 50}


def test_merge_tp_hits_checks():
    t, i = torch.zeros(8), torch.zeros(8, dtype=torch.int64)
    passes.check_tp_hits_args([t, t], [i, i], [0, 4])
    with pytest.raises(ValueError, match="at least one slice"):
        passes.check_tp_hits_args([], [], [])
    with pytest.raises(ValueError, match="at least one slice"):
        passes.check_tp_hits_args([t, t], [i], [0, 4])
    with pytest.raises(ValueError, match="float32"):
        passes.check_tp_hits_args([t, t.double()], [i, i], [0, 4])
    with pytest.raises(ValueError, match="float32"):
        passes.check_tp_hits_args([t, t[:5]], [i, i], [0, 4])
    with pytest.raises(ValueError, match="int64"):
        passes.check_tp_hits_args([t, t], [i, i.int()], [0, 4])
    with pytest.raises(ValueError, match="offset"):
        passes.check_tp_hits_args([t, t], [i, i], [0, -4])
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        passes.merge_tp_hits([meta], [i], [0])


def test_pass_kernel_checks():
    cfg = bt.RenderConfig(40, 30, 2)
    n = cfg.n_pixels
    z = torch.zeros(n)
    lanes = np.prod(mk.block_grid(cfg)) * mk.TILE
    film = AdaptiveFilm(bt.Vec3(z, z, z), z, z, z,
                        torch.zeros((), dtype=torch.int64))
    sums = [torch.zeros(lanes)] * 4
    segs = torch.zeros((), dtype=torch.int64)
    passes.check_fold_adaptive_args(film, sums, segs, cfg)
    with pytest.raises(ValueError, match="r, g, b, depth"):
        passes.check_fold_adaptive_args(film, sums[:3], segs, cfg)
    with pytest.raises(ValueError, match="at least"):
        passes.check_fold_adaptive_args(film, [torch.zeros(100)] * 4, segs,
                                        cfg)
    with pytest.raises(ValueError, match="float32"):
        passes.check_fold_adaptive_args(film._replace(err=z.double()), sums,
                                        segs, cfg)
    with pytest.raises(ValueError, match="int64"):
        passes.check_fold_adaptive_args(film, sums, segs.float(), cfg)
    part = (bt.Vec3(z, z, z), z, segs)
    passes.check_shard_args({(0, 0): part, (0, 1): part}, 1, 2, z.device)
    with pytest.raises(ValueError, match="keyed"):
        passes.check_shard_args({(0, 0): part}, 1, 2, z.device)
    with pytest.raises(ValueError, match="at least one part"):
        passes.check_shard_args({}, 0, 1, z.device)
    # No upper limit: K15 takes a mesh of any size in launches of 32 parts.
    passes.check_shard_args({(i, 0): part for i in range(33)}, 33, 1,
                            z.device)
    with pytest.raises(ValueError, match="float32"):
        passes.check_shard_args({(0, 0): (bt.Vec3(z, z, z[:5]), z, segs)},
                                1, 1, z.device)
    with pytest.raises(ValueError, match="int64"):
        passes.check_shard_args({(0, 0): (bt.Vec3(z, z, z), z, z[0])}, 1, 1,
                                z.device)
    meta = torch.empty(n, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        passes.adaptive_map(meta, 0.1, False, cfg)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        passes.fold_adaptive(film._replace(depth_sum=meta), sums, segs, 0.1,
                             False, cfg)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        passes.sum_shards({(0, 0): part}, 1, 1, "meta")


# -- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda", 0)


def _on(x, dev):
    if isinstance(x, bt.Vec3):
        return bt.Vec3(*(c.to(dev) for c in x))
    return x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("lens", [False, True])
def test_cuda_camera_rows_equal_plain(level, lens):
    dev = _card()
    _, pcam = _cameras(16 / 9, lens)
    for fov in FOVS:
        cam = type(pcam)(*(_on(f, dev) for f in pcam))._replace(
            fov=torch.tensor(np.float32(fov), device=dev))
        cfg = bt.RenderConfig(1920, 1080, level=level)
        got = camera.camera_rows(cam, cfg, True, True)
        want = camera.camera_rows_reference(cam, cfg, True, True)
        torch.cuda.synchronize()
        assert _bits_equal(got, [w.cpu().numpy() for w in want])


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["first", "later", "reprobe"])
def test_cuda_adaptive_kernels_equal_plain(size, case):
    dev = _card()
    w, h = size
    film, sums, rays, segs = _fold_inputs(w, h, w * h, first=case == "first")
    reprobe = case == "reprobe"
    cfg = bt.RenderConfig(w, h, 2)
    t = [torch.as_tensor(x, device=dev) for x in film]
    pfilm = AdaptiveFilm(bt.Vec3(*t[:3]), t[3], t[4], t[5],
                         torch.tensor(rays, device=dev))
    psums = [torch.as_tensor(x, device=dev) for x in sums]
    pseg = torch.tensor(segs, device=dev)
    got_map = passes.adaptive_map(t[5], 0.05, reprobe, cfg)
    want_map = passes.adaptive_map_reference(t[5], 0.05, reprobe, cfg)
    got = passes.fold_adaptive(pfilm, psums, pseg, 0.05, reprobe, cfg)
    want = passes.fold_adaptive_reference(pfilm, psums, pseg, 0.05, reprobe,
                                          cfg)
    torch.cuda.synchronize()
    assert torch.equal(got_map, want_map)
    assert _bits_equal((*got[0], *got[1:]),
                       [x.cpu().numpy() for x in (*want[0], *want[1:])])


@pytest.mark.cuda
@pytest.mark.parametrize("sp,dp", [(1, 2), (3, 1), (2, 2)])
def test_cuda_sum_shards_equal_plain(sp, dp):
    dev = _card()
    rng = np.random.default_rng(sp + dp)
    parts = {(i, k): (bt.Vec3(*(torch.as_tensor(
        rng.random(5000, dtype=np.float32), device=dev) for _ in range(3))),
        torch.as_tensor(rng.random(5000, dtype=np.float32), device=dev),
        torch.tensor(int(rng.integers(1 << 40)), device=dev))
        for i in range(sp) for k in range(dp)}
    got = passes.sum_shards(parts, sp, dp, dev)
    want = passes.sum_shards_reference(parts, sp, dp, dev)
    torch.cuda.synchronize()
    assert _bits_equal([*got[0], got[1]],
                       [x.cpu().numpy() for x in (*want[0], want[1])])


def _card_parts(sp, dp, n, seed, dev):
    rng = np.random.default_rng(seed)
    return {(i, k): (bt.Vec3(*(torch.as_tensor(
        rng.random(n, dtype=np.float32) * 9, device=dev) for _ in range(3))),
        torch.as_tensor(rng.random(n, dtype=np.float32), device=dev),
        torch.tensor(int(rng.integers(1 << 40)), device=dev))
        for i in range(sp) for k in range(dp)}


@pytest.mark.cuda
@pytest.mark.parametrize("sp,dp,launches", [(6, 6, 2), (40, 1, 2), (4, 8, 1),
                                            (1, 70, 3)])
def test_cuda_sum_shards_past_32_parts(sp, dp, launches):
    """More than 32 parts take a launch for every 32, each carrying the
    running sums on (mesh (6, 6) splits shard 5's parts between two
    launches); the bits are the plain version's. A mesh of 32 parts stays
    one launch."""
    dev = _card()
    parts = _card_parts(sp, dp, 3001, sp * dp, dev)
    before = passes.sum_shards.launches
    got = passes.sum_shards(parts, sp, dp, dev)
    assert passes.sum_shards.launches - before == launches
    want = passes.sum_shards_reference(parts, sp, dp, dev)
    torch.cuda.synchronize()
    assert _bits_equal([*got[0], got[1]],
                       [x.cpu().numpy() for x in (*want[0], want[1])])


@pytest.mark.cuda
@pytest.mark.parametrize("tp,launches", [(2, 1), (4, 1), (8, 1), (32, 1),
                                         (40, 2), (64, 3)])
def test_cuda_merge_tp_hits_equal_plain(tp, launches):
    """K16 bit-equal to its plain version (t as bits, NaN lanes included),
    one launch up to 32 slices and one more for every 31 after."""
    dev = _card()
    t, i, offsets = _tp_slices(tp, 100_003, tp, chunk=256)
    ts = [torch.as_tensor(x, device=dev) for x in t]
    indices = [torch.as_tensor(x, device=dev) for x in i]
    before = passes.merge_tp_hits.launches
    got = passes.merge_tp_hits(ts, indices, offsets)
    assert passes.merge_tp_hits.launches - before == launches
    want = passes.merge_tp_hits_reference(ts, indices, offsets)
    torch.cuda.synchronize()
    assert _bits_equal(got, [x.cpu().numpy() for x in want])
    assert int(got[1][8]) == NO_INDEX and bool(torch.isnan(got[0][9]))
