"""The frame's tail and the folded sums: K10 ``resolve_frame`` and K11
``fold_pass`` (``kernels/frame.py``, ``kernels/cuda/csrc/frame.cu``) and the
samples that K5 and K6 fold into a frame's sums (``kernels/bounce.py``
``FrameSums``).

On the CPU the wrappers run their plain versions (their ``.launches`` do not
move), and:

- ``resolve_frame_reference`` equals the JAX package's tails to the bit on
  the same sums: ``resolve_impl`` (a count a frame, 0 among them, or one a
  pixel), ``render_impl``'s (1/spp) and ``pallas_render_impl``'s (means,
  after ``unshuffle_blocks``), at levels 0-3, over raster layers of one
  value and of one a pixel, on depths past ``far``, at 0 and NaN, at 37x53
  (off every block) and at a whole-block size;
- ``fold_pass_reference`` equals ``pallas_accumulate_impl``'s fold;
- the frames of ``Renderer``, the films of ``accumulate_impl`` and
  ``pallas_accumulate_impl`` and the sharded step's tail equal, to the bit,
  what the same plain versions gave when each sample was added by torch and
  the tail ran op by op (the code these replace); ``Renderer`` and the
  wavefront film against JAX's at the repo's bars (image atol 5e-5, depth
  1e-3, segment counts equal);
- a frame's pixels taken by index (``pixel_range``, ``raygen_sample`` with
  an int) equal ``pixel_uv``'s and the id-tensor form's.

The tests marked ``cuda`` hold K10, K11 and the folded K5/K6 to their plain
versions on the card, to the bit; they skip here.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.engine import film as jfilm
from bevyray_tpu.engine.film import ProgressiveRenderer as JProgressive
from bevyray_tpu.engine.raster import raster_layer as jraster_layer
from bevyray_tpu.kernels import composite as jcomposite
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.engine import film as pfilm
from bevyray_tpu_torch.engine import renderer as prenderer
from bevyray_tpu_torch.engine.raster import raster_layer
from bevyray_tpu_torch.kernels import bounce, frame, passes
from bevyray_tpu_torch.kernels.composite import composite
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.raygen import pixel_range, pixel_uv
from bevyray_tpu_torch.parallel import sharding

torch.set_num_threads(2)

NEAR, FAR = 0.1, 20.0
INV_SPP = float(np.float32(1.0 / 3.0))
# (H, W, block order): off every block, its block order, whole blocks.
LAYOUTS = {"37x53": (37, 53, False), "37x53_blocks": (37, 53, True),
           "64x128_blocks": (64, 128, True)}
SCALES = ["none", "inv_spp", "count", "count_zero", "count_pixel"]


def _config(pkg, h, w, level):
    return pkg.RenderConfig(width=w, height=h, samples_per_pixel=1,
                            bounces=1, level=level)


def _tail_inputs(h, w, blocks, scale, raster, seed=0):
    """Seeded sums (r, g, b, depth; in block order with NaN padding lanes
    where ``blocks``), the scale, and the raster layer ("none", "scalar" or
    "pixel"), as numpy arrays. The depths scale to values past FAR, at
    FAR, 0 and NaN; the raster depths straddle every reverse-Z value and
    hold NaNs."""
    rng = np.random.default_rng(seed)
    n = h * w
    r, g, b = (rng.random(n, dtype=np.float32) * 3 for _ in range(3))
    depth = rng.uniform(0.0, 3.0 * 2 * FAR, n).astype(np.float32)
    depth[::17] = 0.0
    depth[5::23] = np.nan
    depth[7::29] = 3.0 * FAR
    r[11::31] = np.nan
    sums = [r, g, b, depth]
    if blocks:
        cfg = _config(bt, h, w, 3)
        sums = [mk.shuffle_blocks(torch.as_tensor(x), cfg,
                                  fill=float("nan")).reshape(-1).numpy()
                for x in sums]
    scales = {"none": None, "inv_spp": INV_SPP,
              "count": np.float32(3.0), "count_zero": np.float32(0.0),
              "count_pixel": rng.choice(np.float32([0, 1, 2, 5]), n)}
    rc = rd = None
    if raster == "scalar":
        rc = [np.float32(v) for v in (0.25, 0.5, 0.75)]
        rd = np.float32(0.02)
    elif raster == "pixel":
        rc = [rng.random(n, dtype=np.float32) for _ in range(3)]
        rd = rng.uniform(-0.1, 1.2, n).astype(np.float32)
        rd[3::19] = np.nan
    return sums, scales[scale], rc, rd


def _jax_tail(level, h, w, blocks, sums, scale, rc, rd):
    """The JAX package's tail of these sums: ``resolve_impl`` for a count,
    ``render_impl``'s lines for 1/spp, ``pallas_render_impl``'s for means;
    the raster layer white at depth 0 where none is given, as its
    renderers default."""
    cfg = _config(jb, h, w, level)
    r, g, b, d = (jnp.asarray(x) for x in sums)
    if blocks:
        r, g, b, d = (jmk.unshuffle_blocks(x, cfg) for x in (r, g, b, d))
    jrc = JVec3(*(jnp.asarray(c) for c in (rc or [np.float32(1.0)] * 3)))
    jrd = jnp.asarray(np.float32(0.0) if rd is None else rd)
    cam = SimpleNamespace(near=jnp.float32(NEAR), far=jnp.float32(FAR))
    if isinstance(scale, np.ndarray) or isinstance(scale, np.float32):
        film = jfilm.Film(JVec3(r, g, b), d, jnp.asarray(scale),
                          jnp.float32(0.0))
        out = jfilm.resolve_impl(film, cam, cfg, jrc, jrd)
        return np.asarray(out.image), np.asarray(out.rt_depth)
    color = JVec3(r, g, b)
    if scale is not None:
        inv = np.float32(scale)
        color, d = color.scale(inv), d * inv
    out = jcomposite.composite(level, color, d, cam.near, cam.far, jrc, jrd)
    n = h * w
    img = jnp.stack([jnp.broadcast_to(c, (n,)) for c in out], axis=-1)
    return np.asarray(img.reshape(h, w, 3)), np.asarray(d.reshape(h, w))


def _port_args(sums, scale, rc, rd, device="cpu"):
    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    count = scale if scale is None or isinstance(scale, float) else t(scale)
    return ([t(x) for x in sums], count,
            None if rc is None else bt.Vec3(*map(t, rc)),
            None if rd is None else t(rd))


def _near_far(device="cpu"):
    return (torch.tensor(NEAR, dtype=torch.float32, device=device),
            torch.tensor(FAR, dtype=torch.float32, device=device))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_resolve_reference_matches_jax(level, scale, layout):
    h, w, blocks = LAYOUTS[layout]
    sums, sc, rc, rd = _tail_inputs(h, w, blocks, scale, "pixel")
    want = _jax_tail(level, h, w, blocks, sums, sc, rc, rd)
    psums, count, prc, prd = _port_args(sums, sc, rc, rd)
    got = frame.resolve_frame_reference(_config(bt, h, w, level), *_near_far(),
                                        psums, count, prc, prd, blocks)
    assert got[0].shape == (h, w, 3) and got[1].shape == (h, w)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wa)


@pytest.mark.parametrize("raster", ["none", "scalar", "pixel"])
@pytest.mark.parametrize("level", [1, 2])
def test_resolve_reference_raster_layers_match_jax(level, raster):
    h, w, blocks = LAYOUTS["37x53_blocks"]
    sums, sc, rc, rd = _tail_inputs(h, w, blocks, "count_pixel", raster,
                                    seed=4)
    want = _jax_tail(level, h, w, blocks, sums, sc, rc, rd)
    psums, count, prc, prd = _port_args(sums, sc, rc, rd)
    got = frame.resolve_frame_reference(_config(bt, h, w, level), *_near_far(),
                                        psums, count, prc, prd, blocks)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wa)
    # Both compares fail on NaN: a NaN depth (or raster depth) keeps the
    # traced colour, which level 3 passes through.
    traced = frame.resolve_frame_reference(_config(bt, h, w, 3), *_near_far(),
                                           psums, count, prc, prd, blocks)
    keep = torch.isnan(got[1].reshape(-1))
    if prd is not None and prd.dim():
        keep |= torch.isnan(prd)
    assert bool(keep.any())
    assert _bits_equal([got[0].reshape(-1, 3)[keep]],
                       [traced[0].reshape(-1, 3)[keep]])


def test_resolve_wrapper_runs_the_plain_version_on_the_cpu():
    h, w, blocks = LAYOUTS["37x53_blocks"]
    sums, sc, rc, rd = _tail_inputs(h, w, blocks, "count_pixel", "pixel")
    psums, count, prc, prd = _port_args(sums, sc, rc, rd)
    cfg = _config(bt, h, w, 2)
    before = frame.resolve_frame.launches
    got = frame.resolve_frame(cfg, *_near_far(), psums, count, prc, prd,
                              blocks)
    want = frame.resolve_frame_reference(cfg, *_near_far(), psums, count,
                                         prc, prd, blocks)
    assert frame.resolve_frame.launches == before
    assert _bits_equal(got, want)
    # A raster layer in float64 is taken as float32, as the JAX package
    # holds it.
    wide = frame.resolve_frame(cfg, *_near_far(), psums, count,
                               bt.Vec3(*(c.double() for c in prc)),
                               prd.double(), blocks)
    assert _bits_equal(wide, want)


def _bad_resolve(case):
    h, w, blocks = LAYOUTS["37x53"]
    sums, sc, rc, rd = _tail_inputs(h, w, blocks, "count_pixel", "pixel")
    psums, count, prc, prd = _port_args(sums, sc, rc, rd)
    kw = dict(scale=count, raster_color=prc, raster_depth=prd,
              blocks=blocks)
    if case == "float64":
        psums[1] = psums[1].double()
    elif case == "short":
        psums = [x[:-1] for x in psums]
    elif case == "strided":
        psums[2] = torch.stack([psums[2], psums[2]], 1)[:, 0]
    elif case == "count_shape":
        kw["scale"] = count[:-1]
    elif case == "raster_shape":
        kw["raster_depth"] = torch.cat([prd, prd[:1]])
    elif case == "scale_type":
        kw["scale"] = 3
    elif case == "blocks_short":
        kw["blocks"] = True
    return _config(bt, h, w, 2), psums, kw


@pytest.mark.parametrize("case", ["float64", "short", "strided",
                                  "count_shape", "raster_shape",
                                  "scale_type", "blocks_short"])
def test_resolve_kernel_checks_raise(case):
    cfg, psums, kw = _bad_resolve(case)
    with pytest.raises(ValueError, match="resolve_frame"):
        frame.check_resolve_args(cfg, psums, **kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scale", SCALES)
def test_resolve_kernel_checks_pass_the_main_path_inputs(scale, layout):
    h, w, blocks = LAYOUTS[layout]
    sums, sc, rc, rd = _tail_inputs(h, w, blocks, scale, "pixel")
    psums, count, prc, prd = _port_args(sums, sc, rc, rd)
    frame.check_resolve_args(_config(bt, h, w, 2), psums, count, prc, prd,
                             blocks)


def test_wrappers_take_cpu_or_cuda_tensors_only():
    cfg = _config(bt, 4, 4, 3)
    meta = [torch.zeros(16, device="meta") for _ in range(4)]
    near = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        frame.resolve_frame(cfg, near, near, meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        frame.fold_pass(bt.Vec3(*meta[:3]), meta[3], near,
                        torch.zeros((), dtype=torch.int64, device="meta"),
                        meta, torch.zeros((), dtype=torch.int64,
                                          device="meta"), cfg)


# -- the fused film pass's fold -------------------------------------------------

def _fold_inputs(h, w, seed=1):
    rng = np.random.default_rng(seed)
    n = h * w
    film = [rng.random(n, dtype=np.float32) * 7 for _ in range(4)]
    cfg = _config(bt, h, w, 3)
    nbx, nby = mk.block_grid(cfg)
    passes = [rng.random(nbx * nby * mk.TILE, dtype=np.float32) * 2
              for _ in range(4)]
    return film, passes, np.float32(12.0), 123456789, 98765


@pytest.mark.parametrize("layout", ["37x53_blocks", "64x128_blocks"])
def test_fold_reference_matches_jax(layout):
    h, w, _ = LAYOUTS[layout]
    film, passes, n_samples, total, segs = _fold_inputs(h, w)
    spp = 4
    jcfg = dataclasses.replace(_config(jb, h, w, 3), samples_per_pixel=spp)
    r, g, b, d = (jmk.unshuffle_blocks(jnp.asarray(x), jcfg) for x in passes)
    jf = jfilm.Film(JVec3(*map(jnp.asarray, film[:3])),
                    jnp.asarray(film[3]), jnp.float32(n_samples),
                    jnp.float32(0.0))
    # pallas_accumulate_impl's fold (bevyray_tpu/engine/film.py:141-145).
    want = (jf.color_sum + JVec3(r, g, b), jf.depth_sum + d,
            jf.n_samples + jcfg.samples_per_pixel)
    cfg = dataclasses.replace(_config(bt, h, w, 3), samples_per_pixel=spp)
    t = torch.as_tensor
    before = frame.fold_pass.launches
    got = frame.fold_pass(bt.Vec3(*map(t, film[:3])), t(film[3]),
                          t(n_samples), t(np.int64(total)),
                          [t(x) for x in passes], t(np.int64(segs)), cfg)
    assert frame.fold_pass.launches == before
    for gc, wc in zip(got[0], want[0]):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[2]) == float(want[2]) == 16.0
    assert got[3].dtype == torch.int64 and int(got[3]) == total + segs


@pytest.mark.parametrize("case", ["pixel_counts", "short_pass", "float_total",
                                  "strided_film"])
def test_fold_kernel_checks_raise(case):
    h, w, _ = LAYOUTS["37x53_blocks"]
    film, passes, n_samples, total, segs = _fold_inputs(h, w)
    t = torch.as_tensor
    args = [bt.Vec3(*map(t, film[:3])), t(film[3]), t(n_samples),
            t(np.int64(total)), [t(x) for x in passes], t(np.int64(segs)),
            _config(bt, h, w, 3)]
    if case == "pixel_counts":     # an adaptive film's counts
        args[2] = torch.full((h * w,), 2.0)
    elif case == "short_pass":
        args[4] = [x[:-1] for x in args[4]]
    elif case == "float_total":
        args[3] = args[3].float()
    else:
        args[1] = torch.stack([args[1], args[1]], 1)[:, 0]
    with pytest.raises(ValueError, match="fold_pass"):
        frame.check_fold_args(*args)


# -- pixels by index ---------------------------------------------------------------

@pytest.mark.parametrize("first,n", [(0, 37 * 53), (0, 1000), (981, 980),
                                     (37 * 53 - 7, 7)])
def test_pixel_range_equals_pixel_uv(first, n):
    u, v = pixel_uv(53, 37)
    ids, pu, pv = pixel_range(first, n, 53, 37)
    assert torch.equal(ids, torch.arange(first, first + n))
    assert torch.equal(pu.view(torch.int32), u[first:first + n].view(
        torch.int32))
    assert torch.equal(pv.view(torch.int32), v[first:first + n].view(
        torch.int32))


# -- frames, films and the sharded tail against the code they replace -------------

def _world(pkg):
    """The final scene on a 4x4 grid, over the reference's raster cube."""
    return pkg.rtiow.final_scene(seed=42, grid=4)


def _both(level, w=24, h=16, spp=2, bounces=3):
    jw, pw = _world(jb), _world(bt)
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=w / h)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    cfg = dict(width=w, height=h, samples_per_pixel=spp, bounces=bounces,
               level=level)
    return js, jcam, ps, pcam, cfg, pw


def _old_tail(config, cam, color, depth, segs, rc=None, rd=None):
    """The tail these kernels replace, op by op (the port's former
    ``frame_result``)."""
    dev = depth.device
    h, w = config.height, config.width
    if rc is None:
        rc = bt.Vec3.splat(1.0, device=dev)
    if rd is None:
        rd = torch.zeros((), dtype=torch.float32, device=dev)
    out = composite(config.level, color, depth, cam.near.to(dev),
                    cam.far.to(dev), rc, rd)
    image = torch.stack([torch.broadcast_to(c, (h * w,)) for c in out], -1)
    return image.reshape(h, w, 3), depth.reshape(h, w), segs


def _old_samples(scene, cam, config, seed, film=None, offset=0):
    """The samples added by torch, as the former ``render_impl`` and
    ``accumulate_impl`` added them: (color sums, depth sums, segments)."""
    n = config.n_pixels
    dev = scene.spheres.cx.device
    u, v = pixel_uv(config.width, config.height, device=dev)
    ids = torch.arange(n, device=dev)
    if film is None:
        cs = bt.Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
        ds = torch.zeros(n, dtype=torch.float32, device=dev)
        segs = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        cs, ds, segs = film.color_sum, film.depth_sum, film.rays_traced
    state = bounce.new_state(n, cam, config, dev)
    for i in range(config.samples_per_pixel):
        c, d, s = prenderer.trace_sample(scene, cam, config, ids, u, v,
                                         offset + i, seed, state=state)
        cs, ds, segs = cs + c, ds + d, segs + s
    return cs, ds, segs


def _bits_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               if g.dtype == torch.float32 else torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_folded_frame_equals_the_torch_adds(level):
    _, _, ps, pcam, cfg, pw = _both(level)
    config = bt.RenderConfig(**cfg)
    rc = rd = None
    if level == 2:
        rc, rd = raster_layer(pw, pcam, config, device="cpu")
        assert rc is not None
    got = bt.Renderer(config).render(ps, pcam, seed=5, raster_color=rc,
                                     raster_depth=rd)
    cs, ds, segs = _old_samples(ps, pcam, config, 5)
    inv = float(np.float32(1.0 / config.samples_per_pixel))
    want = _old_tail(config, pcam, cs.scale(inv), ds * inv, segs, rc, rd)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("level", [1, 2])
def test_folded_renderer_matches_jax(level):
    js, jcam, ps, pcam, cfg, pw = _both(level)
    jw = _world(jb)
    rc = rd = jrc = jrd = None
    kw, jkw = {}, {}
    if level == 2:
        jrc, jrd = jraster_layer(jw, jcam, jb.RenderConfig(**cfg))
        rc = bt.Vec3(*(torch.as_tensor(np.array(c)) for c in jrc))
        rd = torch.as_tensor(np.array(jrd))
        kw, jkw = dict(raster_color=rc, raster_depth=rd), dict(
            raster_color=jrc, raster_depth=jrd)
    want = jb.Renderer(jb.RenderConfig(**cfg)).render(js, jcam, seed=5, **jkw)
    got = bt.Renderer(bt.RenderConfig(**cfg)).render(ps, pcam, seed=5, **kw)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(),
                               np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


def test_folded_film_pass_equals_the_torch_adds_and_leaves_the_film():
    _, _, ps, pcam, cfg, _ = _both(3)
    config = bt.RenderConfig(**cfg)
    film = pfilm.accumulate_impl(pfilm.new_film(config, "cpu"), ps, pcam,
                                 config, 7, 0)
    kept = [x.clone() for x in (*film.color_sum, film.depth_sum,
                                film.n_samples, film.rays_traced)]
    got = pfilm.accumulate_impl(film, ps, pcam, config, 7, 2)
    assert _bits_equal((*film.color_sum, film.depth_sum, film.n_samples,
                        film.rays_traced), kept)
    cs, ds, segs = _old_samples(ps, pcam, config, 7, film, offset=2)
    assert _bits_equal((*got.color_sum, got.depth_sum, got.rays_traced),
                       (*cs, ds, segs))
    assert float(got.n_samples) == 4.0
    want = _old_tail(config, pcam, cs.scale(1.0 / torch.clamp(
        got.n_samples, min=1.0)), ds * (1.0 / torch.clamp(got.n_samples,
                                                           min=1.0)), segs)
    assert _bits_equal(pfilm.resolve_impl(got, pcam, config), want)


def test_folded_film_matches_jax():
    js, jcam, ps, pcam, cfg, _ = _both(1)
    jprog = JProgressive(jb.RenderConfig(**cfg))
    prog = bt.ProgressiveRenderer(bt.RenderConfig(**cfg), device="cpu")
    for _ in range(2):
        want = jprog.step(js, jcam, seed=3)
        got = prog.step(ps, pcam, seed=3)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(),
                               np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


def test_fused_film_pass_equals_the_torch_adds():
    _, _, ps, pcam, cfg, _ = _both(3, w=40, h=20, spp=2, bounces=2)
    config = bt.RenderConfig(**cfg)
    renderer = bt.FusedRenderer(config)
    kscene = renderer.prepare(ps)
    sl, slmeta = renderer.shortlists(kscene, pcam)
    film = pfilm.new_film(config, "cpu")
    film = pfilm.pallas_accumulate_impl(film, kscene, pcam, config, 3, 0,
                                        sl, slmeta)
    got = pfilm.pallas_accumulate_impl(film, kscene, pcam, config, 3, 2, sl,
                                       slmeta)
    color, depth, segs = pfilm.trace_pass(kscene, pcam, config, 3, 2, sl,
                                          slmeta)
    want = (*(film.color_sum + color), film.depth_sum + depth,
            film.n_samples + 2, film.rays_traced + segs)
    assert _bits_equal((*got.color_sum, got.depth_sum, got.n_samples,
                        got.rays_traced), want)


def _old_reduce(mesh, parts, config, cam, rc, rd, blocks):
    """The sharded step's former tail: the dp sums, the shards joined and
    scaled by torch, unshuffled, composited op by op."""
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    dev0 = mesh.device(0, 0)
    colors = [passes._psum([parts[i, k][0] for k in range(dp)], dev0)
              for i in range(sp)]
    depths = [passes._psum([parts[i, k][1] for k in range(dp)], dev0)
              for i in range(sp)]
    segs = passes._psum([p[2] for p in parts.values()], dev0)
    inv = float(np.float32(1.0 / config.samples_per_pixel))
    rt = [torch.cat([c[k] for c in colors]) * inv for k in range(3)]
    rt_depth = torch.cat(depths) * inv
    if blocks:
        rt = [mk.unshuffle_blocks(x, config) for x in rt]
        rt_depth = mk.unshuffle_blocks(rt_depth, config)
    return _old_tail(config, cam, bt.Vec3(*rt), rt_depth, segs, rc, rd)


@pytest.mark.parametrize("blocks", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_sharded_tail_equals_the_old_tail(level, blocks):
    h, w = 37, 54
    config = bt.RenderConfig(w, h, 4, 1, level=level)
    mesh = sharding.make_mesh(2, 2, 1, devices=["cpu"] * 4)
    nbx, nby = mk.block_grid(config)
    per = (-(-(nbx * nby) // 2) * mk.TILE) if blocks else h * w // 2
    rng = np.random.default_rng(3)

    def col(scale):
        return torch.as_tensor(rng.random(per, dtype=np.float32) * scale)

    parts = {(i, k): (bt.Vec3(col(2), col(2), col(2)), col(4 * FAR),
                      torch.tensor(1000 * i + k, dtype=torch.int64))
             for i in range(2) for k in range(2)}
    _, _, _, pcam, _, _ = _both(level)
    rc = bt.Vec3(torch.as_tensor(rng.random(h * w, dtype=np.float32)),
                 torch.full((h * w,), 0.5), torch.full((h * w,), 0.25))
    rd = torch.as_tensor(rng.uniform(-0.1, 1.0, h * w).astype(np.float32))
    got = sharding._reduce_and_composite(mesh, parts, config, pcam, rc, rd,
                                         blocks=blocks)
    want = _old_reduce(mesh, parts, config, pcam, rc, rd, blocks)
    assert _bits_equal(got, want)


def test_raygen_by_index_equals_the_id_form():
    _, _, ps, pcam, cfg, _ = _both(3, w=53, h=37)
    config = bt.RenderConfig(**cfg)
    first, n = 700, 1000
    ids, u, v = pixel_range(first, n, config.width, config.height)
    got = bounce.new_state(n, pcam, config, "cpu")
    want = bounce.new_state(n, pcam, config, "cpu")
    bounce.raygen_sample(got, first, None, None, pcam, config, 3, 11)
    bounce.raygen_sample(want, ids, u, v, pcam, config, 3, 11)
    # What ray generation writes: the ray, throughput, radiance, flag,
    # first depth, stream word and segment count (not the harvest).
    assert _bits_equal(got.columns()[:16], want.columns()[:16])


# -- on the card ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_cuda_resolve_equals_plain(level, scale, layout):
    dev = _card()
    h, w, blocks = LAYOUTS[layout]
    for raster in ("none", "scalar", "pixel"):
        sums, sc, rc, rd = _tail_inputs(h, w, blocks, scale, raster)
        args = _port_args(sums, sc, rc, rd, dev)
        cfg = _config(bt, h, w, level)
        before = frame.resolve_frame.launches
        got = frame.resolve_frame(cfg, *_near_far(dev), *args[:1], *args[1:],
                                  blocks)
        assert frame.resolve_frame.launches - before == 1
        want = frame.resolve_frame_reference(cfg, *_near_far(dev), *args[:1],
                                             *args[1:], blocks)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["37x53_blocks", "64x128_blocks"])
def test_cuda_fold_equals_plain(layout):
    dev = _card()
    h, w, _ = LAYOUTS[layout]
    film, passes, n_samples, total, segs = _fold_inputs(h, w)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    args = (bt.Vec3(*map(t, film[:3])), t(film[3]), t(n_samples),
            t(np.int64(total)), [t(x) for x in passes], t(np.int64(segs)),
            _config(bt, h, w, 3))
    kept = [x.clone() for x in (*args[0], args[1])]
    got = frame.fold_pass(*args)
    want = frame.fold_pass_reference(*args)
    torch.cuda.synchronize()
    assert _bits_equal((*got[0], *got[1:]), (*want[0], *want[1:]))
    assert _bits_equal((*args[0], args[1]), kept)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3])
def test_cuda_folded_frame_equals_the_torch_adds(level):
    """K5 by index and K6 folding the sums, then K10, against the same
    kernels' samples added by torch and the old tail, on the card."""
    dev = _card()
    world = _world(bt)
    config = bt.RenderConfig(96, 64, 3, 3, level=level)
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=96 / 64, device=dev)
    rc = rd = None
    if level == 2:
        rc, rd = raster_layer(world, cam, config, device=dev)
    before = frame.resolve_frame.launches
    got = bt.Renderer(config).render(scene, cam, seed=5, raster_color=rc,
                                     raster_depth=rd)
    assert frame.resolve_frame.launches - before == 1
    cs, ds, segs = _old_samples(scene, cam, config, 5)
    inv = float(np.float32(1.0 / config.samples_per_pixel))
    want = _old_tail(config, cam, cs.scale(inv), ds * inv, segs, rc, rd)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    film = pfilm.new_film(config, dev)
    film = pfilm.accumulate_impl(film, scene, cam, config, 7, 0)
    got = pfilm.accumulate_impl(film, scene, cam, config, 7, 3)
    cs, ds, segs = _old_samples(scene, cam, config, 7, film, offset=3)
    torch.cuda.synchronize()
    assert _bits_equal((*got.color_sum, got.depth_sum, got.rays_traced),
                       (*cs, ds, segs))


@pytest.mark.cuda
def test_cuda_tails_never_wait_for_the_card():
    """After a warm-up, a wavefront frame, a fused frame and a fused film
    pass with its resolve under torch's sync debug mode "error"."""
    dev = _card()
    world = _world(bt)
    config = bt.RenderConfig(96, 64, 2, 2, level=2)
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=96 / 64, device=dev)
    rc, rd = raster_layer(world, cam, config, device=dev)
    fused = bt.FusedRenderer(config)
    kscene = fused.prepare(scene)
    sl, slmeta = fused.shortlists(kscene, cam)
    film = pfilm.new_film(config, dev)
    for debug in ("default", "error"):
        torch.cuda.set_sync_debug_mode(debug)
        try:
            bt.Renderer(config).render(scene, cam, seed=1, raster_color=rc,
                                       raster_depth=rd)
            fused.render(scene, cam, seed=1, raster_color=rc, raster_depth=rd)
            film = pfilm.pallas_accumulate_impl(film, kscene, cam, config, 1,
                                                0, sl, slmeta)
            pfilm.resolve_impl(film, cam, config, rc, rd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
