"""The wavefront bounce body (``bevyray_tpu_torch/kernels/bounce.py``: ray
generation and shading, kernels K5 and K6 of ``kernels/cuda/csrc/
bounce.cu``) against the JAX package on the CPU.

- ``raygen_sample`` (on CPU tensors its plain version) against JAX's
  ``rng.stream_init``, jitter and lens draws and ``generate_rays`` on the
  same pixels: the stream word to the bit, origin and direction within
  atol 1e-5, the carry's start exact; the camera row against JAX's
  scalars at levels 1 and 3;
- ``shade_bounce`` against JAX's ``make_hit_info``, ``triangle_hit_info``,
  ``merge_hits``, ``gather_materials``, ``rng.draw`` and ``scatter`` in the
  order of ``bevyray_tpu/engine/renderer.py:149-200`` on seeded lanes that
  cover inactive lanes, misses, sphere and triangle hits, sphere/triangle
  ties, emissive hits, dielectrics with total internal reflection, both
  diffuse modes, levels 1 and 3 and the last bounce's harvest: ``active``,
  ``segments``, the first depth, the harvest's depth and the branch taken
  exact; positions, directions and colours within atol 1e-5 (as
  ``test_torch_renderer.py`` holds the hit records);
- the wrappers take CPU or CUDA tensors only and launch nothing on the
  CPU, and a reused state gives a fresh state's sample.

The tests marked ``cuda`` run on the card (``JAX_PLATFORMS=cpu python -m
pytest tests/test_torch_bounce.py -m cuda``): K5 and K6 against their
plain versions on the same CUDA tensors, to the bit, and ``Renderer``
frames equal to the frames with the plain versions patched in, whose host
work never waits for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.core import rng as jrng
from bevyray_tpu.core.types import make_materials_np as jmake_materials
from bevyray_tpu.core.types import make_spheres_np as jmake_spheres
from bevyray_tpu.core.types import make_triangles_np as jmake_triangles
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.engine import renderer as jrenderer
from bevyray_tpu.kernels import composite as jcomposite
from bevyray_tpu.kernels import intersect as jint
from bevyray_tpu.kernels import raygen as jraygen
from bevyray_tpu.kernels import shade as jshade
from bevyray_tpu_torch.core import rng as prng
from bevyray_tpu_torch.core.constants import INF
from bevyray_tpu_torch.core.types import (SceneBuffers, make_materials_np,
                                          make_spheres_np, make_triangles_np,
                                          scene_from_numpy)
from bevyray_tpu_torch.core.vec import Vec3
from bevyray_tpu_torch.engine import renderer as prenderer
from bevyray_tpu_torch.engine import slots
from bevyray_tpu_torch.kernels import bounce
from bevyray_tpu_torch.kernels.camera import camera_rows
from bevyray_tpu_torch.kernels.raygen import pixel_uv

torch.set_num_threads(2)

N_LANES = 600
W, H = 24, 20
SEED = 0xDEADBEEF   # the high bit set: the u32 words wrap in int64 and int32
LENS = dict(aperture=0.3, focus_distance=4.0)

# base r, g, b, metallic, roughness, reflectance, ior, transmission,
# emissive r, g, b: diffuse, metal, glass, emissive, and a stochastic mix.
MATERIALS = np.array([
    [0.7, 0.3, 0.2, 0.0, 0.4, 0.5, 1.5, 0.0, 0.0, 0.0, 0.0],
    [0.8, 0.8, 0.9, 1.0, 0.3, 0.5, 1.5, 0.0, 0.0, 0.0, 0.0],
    [1.0, 1.0, 1.0, 0.0, 0.0, 0.5, 1.5, 1.0, 0.0, 0.0, 0.0],
    [0.5, 0.5, 0.5, 0.0, 1.0, 0.5, 1.5, 0.0, 4.0, 2.0, 1.0],
    [0.9, 0.6, 0.1, 0.5, 0.2, 0.5, 1.3, 0.5, 0.0, 0.0, 0.0],
], np.float32)


def _world(pkg, defocus):
    if defocus:
        return pkg.rtiow.material_test_scene(pkg.RaytracedCamera(**LENS))
    return pkg.rtiow.final_scene(seed=42, grid=4)


def _cameras(defocus=False):
    jw = _world(jb, defocus)
    jcam = jw.camera_state(aspect=W / H)
    _, pcam = scene_from_numpy(jax.tree.map(np.asarray, jw.extract()),
                               jax.tree.map(np.asarray, jcam), device="cpu")
    return jcam, pcam


def _config(level=3, bounces=2, **kw):
    return bt.RenderConfig(width=W, height=H, samples_per_pixel=1,
                           bounces=bounces, level=level, **kw)


def _np(x):
    return np.asarray(x)


# -- ray generation -------------------------------------------------------------

@pytest.mark.parametrize("defocus", [False, True])
def test_raygen_matches_jax(defocus):
    jcam, pcam = _cameras(defocus)
    cfg = _config(defocus=defocus)
    n = cfg.n_pixels
    u, v = pixel_uv(W, H)
    ids = torch.arange(n)
    state = bounce.new_state(n, pcam, cfg, "cpu")
    before = bounce.raygen_sample.launches
    bounce.raygen_sample(state, ids, u, v, pcam, cfg, 3, SEED)
    assert bounce.raygen_sample.launches == before

    stream = jrng.stream_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(3),
                              jnp.uint32(SEED))
    draw = [jrng.draw(stream, np.uint32(k)) for k in range(4)]
    ju, jv = jraygen.pixel_uv(W, H)
    o, d = jraygen.generate_rays(
        ju, jv, draw[0], draw[1], jcam, H,
        lens_u=draw[2] if defocus else None,
        lens_v=draw[3] if defocus else None)
    np.testing.assert_array_equal(
        state.stream.numpy().view(np.uint32), _np(stream))
    for got, want in ((state.origin, o), (state.direction, d)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.broadcast_to(_np(w), n),
                                       atol=1e-5)
    if defocus:   # the lens moves the origins
        assert float(state.origin.x.std()) > 0.01
    assert bool((state.ray_color.x == 1).all()) and bool(
        (state.radiance.z == 0).all())
    assert bool(state.active.all()) and bool((state.first_depth == INF).all())
    assert int(state.segments) == 0


@pytest.mark.parametrize("level", [1, 3])
def test_camera_row_matches_jax(level):
    jcam, pcam = _cameras()
    row = camera_rows(pcam, _config(level=level), fused=False,
                      wavefront=True).wavefront.numpy()
    right = jcam.direction.cross(jcam.up)
    fallback = jcam.far + 10.0 if level == 1 else jcam.far - 1.0
    want = [*jcam.position, *jcam.direction, *jcam.up, *right,
            jnp.tan(jcam.fov * 0.5), jcam.aspect, H, H * jcam.aspect,
            jcam.aperture, jcam.focus_distance, fallback]
    assert row.dtype == np.float32 and row.shape == (bounce.CAM_FLOATS,)
    np.testing.assert_allclose(row, np.float32([_np(w) for w in want]),
                               rtol=1e-6)
    assert row[bounce.CAM_FALLBACK] == np.float32(_np(fallback))


# -- shading ----------------------------------------------------------------------

def _tables(rng):
    centers = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 1.0, 6).astype(np.float32)
    s_mat = np.array([0, 1, 2, 3, 4, 2], np.int32)
    va = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    vb = va + rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    vc = va + rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    t_mat = np.array([1, 3, 0, 2], np.int32)
    js = jb.SceneBuffers(
        spheres=jmake_spheres(centers, radii, s_mat),
        materials=jmake_materials(MATERIALS), bvh=None,
        triangles=jmake_triangles(va, vb, vc, t_mat))
    ps = SceneBuffers(
        spheres=make_spheres_np(centers, radii, s_mat, device="cpu"),
        materials=make_materials_np(MATERIALS, device="cpu"),
        triangles=make_triangles_np(va, vb, vc, t_mat, device="cpu"))
    return js, ps


def _lanes(rng, tris, n=N_LANES):
    """``n`` seeded lanes: a fifth inactive (their tests INF / -1, as the
    ray tests give them); of the active ones, misses, sphere hits, triangle
    hits and ties; indices past both ends of the tables (clamped)."""
    f32 = np.float32
    lanes = dict(
        o=rng.normal(scale=2.0, size=(3, n)).astype(f32),
        d=(rng.normal(size=(3, n)) * rng.uniform(0.5, 2.0, n)).astype(f32),
        rc=rng.uniform(0.2, 1.0, (3, n)).astype(f32),
        rad=rng.uniform(0.0, 0.5, (3, n)).astype(f32),
        active=rng.uniform(size=n) < 0.8,
        fd=np.where(rng.uniform(size=n) < 0.3, f32(INF),
                    rng.uniform(0.1, 9.0, n)).astype(f32),
        stream=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        t=np.where(rng.uniform(size=n) < 0.7, rng.uniform(0.01, 5.0, n),
                   INF).astype(f32),
        idx=np.where(np.arange(n) % 50 == 7, 200,
                     rng.integers(-1, 7, n)).astype(np.int64))
    if tris:
        lanes["tt"] = np.where(rng.uniform(size=n) < 0.4,
                               rng.uniform(0.01, 5.0, n), INF).astype(f32)
        lanes["ti"] = np.where(np.arange(n) % 50 == 9, 200,
                               rng.integers(-1, 5, n)).astype(np.int64)
        tie = np.arange(n) % 7 == 3
        lanes["tt"][tie] = lanes["t"][tie]
    off = ~lanes["active"]
    for key, miss in (("t", INF), ("tt", INF), ("idx", -1), ("ti", -1)):
        if key in lanes:
            lanes[key][off] = miss
    return lanes


def _port_state(lanes, pcam, cfg):
    state = bounce.new_state(lanes["t"].shape[0], pcam, cfg, "cpu")
    for dst, key in ((state.origin, "o"), (state.direction, "d"),
                     (state.ray_color, "rc"), (state.radiance, "rad")):
        for k, c in enumerate(dst):
            c.copy_(torch.as_tensor(lanes[key][k]))
    state.active.copy_(torch.as_tensor(lanes["active"]))
    state.first_depth.copy_(torch.as_tensor(lanes["fd"]))
    state.stream.copy_(torch.as_tensor(lanes["stream"].view(np.int32)))
    state.segments.fill_(5)
    return state


def _jax_body(js, jcam, lanes, b, cfg):
    """JAX's loop body (renderer.py:149-200) after its ray tests, and the
    harvest (:207-212) on the last bounce, op by op."""
    o, d, rc, rad = (JVec3(*map(jnp.asarray, lanes[k]))
                     for k in ("o", "d", "rc", "rad"))
    active = jnp.asarray(lanes["active"])
    stream = jnp.asarray(lanes["stream"])
    hit = jint.make_hit_info(o, d, jnp.asarray(lanes["t"]),
                             jnp.asarray(lanes["idx"].astype(np.int32)),
                             js.spheres)
    if "tt" in lanes:
        hit = jint.merge_hits(hit, jint.triangle_hit_info(
            o, d, jnp.asarray(lanes["tt"]),
            jnp.asarray(lanes["ti"].astype(np.int32)), js.triangles))
    first_depth = jnp.where(b == 0, hit.t, jnp.asarray(lanes["fd"]))
    radiance = JVec3.where(active & hit.miss,
                           rad + rc * jcomposite.background_gradient(d), rad)
    active_hit = active & ~hit.miss
    mat = jint.gather_materials(js.materials, hit.material_id)
    radiance = JVec3.where(active_hit, radiance + rc * mat.emissive, radiance)
    base = jnp.uint32(slots.RAYGEN_DRAWS + b * slots.DRAWS_PER_BOUNCE)
    u = [jrng.draw(stream, base + np.uint32(k)) for k in range(3)]
    sc = jshade.scatter(d, hit, mat, *u,
                        jrenderer._draw_ball(stream, base, slots.S_BALL1),
                        jrenderer._draw_ball(stream, base, slots.S_BALL2),
                        diffuse_mode=cfg.diffuse_sampling)
    cont = active_hit & ~sc.absorbed
    out = dict(
        o=JVec3.where(active_hit, hit.position, o),
        d=JVec3.where(active_hit, sc.direction, d),
        rc=JVec3.where(cont, rc * sc.attenuation, rc), rad=radiance,
        active=cont, fd=first_depth, segments=int(jnp.sum(active)),
        draws=u, hit=hit, mat=mat, active_hit=active_hit)
    if b == cfg.bounces:
        fallback = jcam.far + 10.0 if cfg.level == 1 else jcam.far - 1.0
        out["color"] = jcomposite.linear_to_gamma(radiance)
        out["depth"] = jnp.where(first_depth >= INF, fallback, first_depth)
    return out


SHADE_CASES = {
    "bounce 0, triangles, level 3": (0, 3, "reference", True),
    "last bounce, triangles, level 1": (2, 1, "reference", True),
    "last bounce, spheres, cosine, level 3": (2, 3, "cosine", False),
    "bounce 1, triangles, cosine, level 1": (1, 1, "cosine", True),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_matches_jax(case):
    b, level, mode, tris = SHADE_CASES[case]
    rng = np.random.default_rng(sorted(SHADE_CASES).index(case) + 11)
    js, ps = _tables(rng)
    if not tris:
        js, ps = js._replace(triangles=None), ps._replace(triangles=None)
    lanes = _lanes(rng, tris)
    jcam, pcam = _cameras()
    cfg = _config(level=level, diffuse_sampling=mode)
    state = _port_state(lanes, pcam, cfg)
    tt = ti = None
    if tris:
        tt, ti = torch.as_tensor(lanes["tt"]), torch.as_tensor(lanes["ti"])
    before = bounce.shade_bounce.launches
    bounce.shade_bounce(state, b, torch.as_tensor(lanes["t"]),
                        torch.as_tensor(lanes["idx"]), tt, ti, ps, cfg)
    assert bounce.shade_bounce.launches == before
    want = _jax_body(js, jcam, lanes, b, cfg)

    # The branch taken: the same draws to the bit, so the same choice.
    stream = state.stream.to(torch.int64) & 0xFFFFFFFF
    base = slots.bounce_base(b)
    for k, w in enumerate(want["draws"]):
        np.testing.assert_array_equal(prng.draw(stream, base + k).numpy(),
                                      _np(w))
    mat = want["mat"]
    is_metal = _np(want["draws"][0]) < _np(mat.metallic)
    is_trans = ~is_metal & (_np(want["draws"][1])
                            < _np(mat.specular_transmission))
    hit_lanes = _np(want["active_hit"])
    np.testing.assert_array_equal(state.active.numpy(), _np(want["active"]))
    assert int(state.segments) == 5 + want["segments"]
    np.testing.assert_array_equal(state.first_depth.numpy(), _np(want["fd"]))
    for key, got in (("o", state.origin), ("d", state.direction),
                     ("rc", state.ray_color), ("rad", state.radiance)):
        for g, w in zip(got, want[key]):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)
    if b == cfg.bounces:
        for g, w in zip(state.color, want["color"]):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)
        np.testing.assert_array_equal(state.depth.numpy(),
                                      _np(want["depth"]))

    # The lanes the case must cover.
    active = lanes["active"]
    unit = want["hit"].normal
    d = JVec3(*map(jnp.asarray, lanes["d"])).normalize()
    cos = np.minimum(-_np(d.dot(unit)), 1.0)
    ri = np.where(_np(want["hit"].front_face), 1.0 / _np(mat.ior),
                  _np(mat.ior))
    tir = ri * np.sqrt(np.maximum(1.0 - cos * cos, 0.0)) > 1.0
    covered = {
        "inactive": (~active).sum(),
        "miss": (active & _np(want["hit"].miss)).sum(),
        "metal": (hit_lanes & is_metal).sum(),
        "diffuse": (hit_lanes & ~is_metal & ~is_trans).sum(),
        "emissive": (hit_lanes & (_np(mat.emissive.x) > 0)).sum(),
        "total internal reflection": (hit_lanes & is_trans & tir).sum(),
    }
    if tris:
        covered["triangle"] = (hit_lanes & (lanes["tt"] < lanes["t"])).sum()
        covered["tie"] = (hit_lanes & (lanes["tt"] == lanes["t"])).sum()
    assert min(covered.values()) > 0, covered


@pytest.mark.parametrize("b", [0, 1, 4])
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_shade_tiles_cover_every_lane_once(sms, b):
    """K6's launch over n lanes (``shade_tiles``, the lanes each (tile,
    round, thread) takes by the kernel's formula, ``shade_tile_lanes``):
    every lane once, no tile without a lane, each warp's rounds one run
    of 32 consecutive lanes a round; per 1 at bounce 0, later the largest
    per of ``SHADE_PERS`` that leaves ``SHADE_BLOCKS_PER_SM`` tiles an
    SM."""
    sizes = sorted({*range(0, 600, 37), *(k * 256 * p + e for k in (1, 3)
                                         for p in bounce.SHADE_PERS
                                         for e in (-1, 0, 1)),
                    100_003, 230_400, 921_600, 2_073_600})
    for n in sizes:
        per, tiles = bounce.shade_tiles(n, sms, b)
        assert per in bounce.SHADE_PERS
        assert tiles == max(1, -(-n // (bounce.SHADE_THREADS * per)))
        if b == 0:
            assert per == 1
        else:
            fill = bounce.SHADE_BLOCKS_PER_SM * sms
            assert per == 1 or tiles >= fill
            assert all(-(-n // (256 * p)) < fill
                       for p in bounce.SHADE_PERS if p > per)
        lanes = bounce.shade_tile_lanes(n, per, tiles)
        assert lanes.shape == (tiles, per, bounce.SHADE_THREADS)
        taken = lanes[lanes >= 0]
        assert torch.equal(taken.sort().values, torch.arange(n))
        if n:
            assert bool((lanes.view(tiles, -1) >= 0).any(dim=1).all())
            # In each round a warp takes 32 consecutive lanes, and its
            # rounds one run of 32 * per lanes.
            warps = lanes.view(tiles, per, 8, 32).transpose(1, 2)
            first = warps[..., :1, :1]
            steps = torch.arange(32 * per).view(per, 32)
            assert bool(((warps - first == steps) | (warps < 0)).all())


def test_shade_tiles_of_the_main_path():
    """On an H100's 132 SMs: one lane a thread at bounce 0; later the
    headline's and config 5's lanes in runs of 4 (tiles of 1,024 lanes),
    the 4,971-sphere frame's 230,400 and 100,003 lanes one a thread (runs
    of 4 would leave most of the card idle)."""
    assert bounce.shade_tiles(2_073_600, 132, 0) == (1, 8100)
    assert bounce.shade_tiles(2_073_600, 132, 4) == (4, 2025)
    assert bounce.shade_tiles(921_600, 132, 1) == (4, 900)
    assert bounce.shade_tiles(230_400, 132, 2) == (1, 900)
    assert bounce.shade_tiles(100_003, 132, 2) == (1, 391)
    assert bounce.shade_tiles(0, 132, 3) == (1, 1)


def test_wrappers_take_cpu_or_cuda_tensors_only():
    _, pcam = _cameras()
    cfg = _config()
    state = bounce.new_state(4, pcam, cfg, "cpu")
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bounce.raygen_sample(state, torch.arange(4, device="meta"), meta,
                             meta, pcam, cfg, 0, 1)
    rng = np.random.default_rng(3)
    _, ps = _tables(rng)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bounce.shade_bounce(state, 0, meta, torch.zeros(4, dtype=torch.int64,
                                                        device="meta"),
                            None, None, ps, cfg)


def test_state_layout():
    _, pcam = _cameras()
    state = bounce.new_state(33, pcam, _config(), "cpu")
    cols = state.columns()
    assert len(cols) == 21 and all(c.is_contiguous() for c in cols)
    assert [c.dtype for c in cols[12:16]] == [torch.bool, torch.float32,
                                              torch.int32, torch.int64]
    assert cols[20].shape == (bounce.CAM_FLOATS,)


def test_reused_state_gives_a_fresh_states_sample():
    """Two samples traced into one state, as ``render_impl`` does, equal
    each traced into a fresh state."""
    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene = world.extract(device="cpu")
    cam = world.camera_state(aspect=W / H, device="cpu")
    cfg = _config(level=1, bounces=3)
    u, v = pixel_uv(W, H)
    ids = torch.arange(cfg.n_pixels)
    state = bounce.new_state(cfg.n_pixels, cam, cfg, "cpu")
    for sample in (0, 1):
        reused = [x.clone() if isinstance(x, torch.Tensor)
                  else Vec3(*(c.clone() for c in x))
                  for x in prenderer.trace_sample(scene, cam, cfg, ids, u, v,
                                                  sample, 9, state=state)]
        fresh = prenderer.trace_sample(scene, cam, cfg, ids, u, v, sample, 9)
        for g, w in zip(reused[0], fresh[0]):
            assert torch.equal(g, w)
        assert torch.equal(reused[1], fresh[1])
        assert int(reused[2]) == int(fresh[2]) > cfg.n_pixels


def test_state_of_another_camera_raises():
    """A state keeps the camera and config it was made for: reusing it after
    the camera or config changed raises, in ``raygen_sample`` and in
    ``trace_sample``, and a state made for the new camera draws its rays."""
    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene = world.extract(device="cpu")
    cam = world.camera_state(aspect=W / H, device="cpu")
    world.set_camera(bt.Transform.from_xyz(3.0, 2.0, 4.0).looking_at(
        (0.0, 0.0, 0.0)))
    moved = world.camera_state(aspect=W / H, device="cpu")
    cfg = _config(level=1, bounces=2)
    u, v = pixel_uv(W, H)
    ids = torch.arange(cfg.n_pixels)
    state = bounce.new_state(cfg.n_pixels, cam, cfg, "cpu")
    with pytest.raises(ValueError, match="another camera"):
        bounce.raygen_sample(state, ids, u, v, moved, cfg, 0, SEED)
    with pytest.raises(ValueError, match="another camera"):
        prenderer.trace_sample(scene, moved, cfg, ids, u, v, 0, SEED,
                               state=state)
    with pytest.raises(ValueError, match="another camera"):
        prenderer.trace_sample(scene, cam, _config(level=3, bounces=2), ids,
                               u, v, 0, SEED, state=state)
    fresh = bounce.new_state(cfg.n_pixels, moved, cfg, "cpu")
    bounce.raygen_sample(fresh, ids, u, v, moved, cfg, 0, SEED)
    assert torch.equal(fresh.origin.x, moved.position.x.expand(cfg.n_pixels))
    assert not torch.equal(fresh.origin.x,
                           cam.position.x.expand(cfg.n_pixels))


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda", 0)


def _same(a, b) -> bool:
    """Bit-equal tensors (float32 compared as their bits, NaNs too)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _states_equal(a, b) -> bool:
    return all(_same(x, y) for x, y in zip(a.columns(), b.columns()))


def _clone(state):
    return bounce.SampleState(*(
        Vec3(*(c.clone() for c in x)) if isinstance(x, Vec3)
        else x.clone() if isinstance(x, torch.Tensor) else x
        for x in state))


@pytest.mark.cuda
@pytest.mark.parametrize("defocus", [False, True])
def test_cuda_raygen_equals_plain(defocus):
    dev = _card()
    world = _world(bt, defocus)
    cam = world.camera_state(aspect=W / H, device=dev)
    cfg = _config(defocus=defocus)
    u, v = pixel_uv(W, H, device=dev)
    ids = torch.arange(cfg.n_pixels, device=dev)
    got = bounce.new_state(cfg.n_pixels, cam, cfg, dev)
    want = _clone(got)
    before = bounce.raygen_sample.launches
    bounce.raygen_sample(got, ids, u, v, cam, cfg, 3, SEED)
    assert bounce.raygen_sample.launches == before + 1
    bounce.raygen_sample_reference(want, ids, u, v, cam, cfg, 3, SEED)
    assert _states_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_cuda_shade_equals_plain(case):
    dev = _card()
    b, level, mode, tris = SHADE_CASES[case]
    rng = np.random.default_rng(sorted(SHADE_CASES).index(case) + 11)
    _, ps = _tables(rng)
    scene = SceneBuffers(*(None if x is None else type(x)(*(
        c.to(dev) for c in x)) for x in ps))
    if not tris:
        scene = scene._replace(triangles=None)
    lanes = _lanes(rng, tris)
    _, pcam = _cameras()
    cfg = _config(level=level, diffuse_sampling=mode)
    cpu_state = _port_state(lanes, pcam, cfg)
    got = bounce.SampleState(*(
        Vec3(*(c.to(dev) for c in x)) if isinstance(x, Vec3)
        else x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in cpu_state))
    want = _clone(got)
    args = [torch.as_tensor(lanes[k], device=dev) for k in ("t", "idx")]
    args += ([torch.as_tensor(lanes[k], device=dev) for k in ("tt", "ti")]
             if tris else [None, None])
    before = bounce.shade_bounce.launches
    bounce.shade_bounce(got, b, *args, scene, cfg)
    assert bounce.shade_bounce.launches == before + 1
    bounce.shade_bounce_reference(want, b, *args, scene, cfg)
    assert _states_equal(got, want)


# Masks of the lanes live at entry that stress K6's lists: every lane, none,
# one a warp, every 97th, and a first tile whose live lanes all miss with a
# first warp of hits on a diffuse, a metal and a dielectric sphere in turn.
MASKS = ("all", "none", "one a warp", "every 97th", "misses and a mixed warp")
FOLDS = (None, "zero", "film", "self")


def _masked_lanes(rng, n, mask):
    lanes = _lanes(rng, True, n)
    k = np.arange(n)
    active = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
              "one a warp": k % 32 == 5, "every 97th": k % 97 == 0,
              "misses and a mixed warp": lanes["active"] | (k < 32)}[mask]
    lanes["active"] = active
    if mask == "misses and a mixed warp":
        # Spheres 0, 1, 2 are diffuse, metal and dielectric (_tables).
        first = k < 32
        lanes["t"][first] = rng.uniform(0.5, 2.0, 32).astype(np.float32)
        lanes["idx"][first] = k[first] % 3
        lanes["tt"][first] = INF
        tile = (k >= 32) & (k < 1024)
        lanes["t"][tile], lanes["tt"][tile] = INF, INF
    for key, miss in (("t", INF), ("tt", INF), ("idx", -1), ("ti", -1)):
        lanes[key][~active] = miss
    return lanes


def _fold_pair(n, fold, dev, seed):
    """Two equal (sums, base) pairs for ``fold`` (None, "zero", "film",
    "self"), seeded so that every write shows."""
    if fold is None:
        return [(None, None), (None, None)]
    host = np.random.default_rng(seed).random((2, 4, n), dtype=np.float32)

    def sums(k, total):
        cols = torch.as_tensor(host[k] * 8, device=dev)
        return bounce.FrameSums(Vec3(cols[0], cols[1], cols[2]), cols[3],
                                torch.tensor(total, dtype=torch.int64,
                                             device=dev))

    pairs = []
    for _ in range(2):
        out = sums(0, 12345)
        pairs.append((out, {"zero": None, "self": out,
                            "film": sums(1, 777)}[fold]))
    return pairs


def _hold_masked(n, mask, b, fold, per=None):
    """K6 (the wrapper's geometry, or tiles of 256 * ``per`` lanes) against
    its plain version on ``n`` masked lanes at bounce ``b`` of a 2-bounce
    config: every column of the state and the sums as bits, the segment
    counts equal."""
    dev = _card()
    rng = np.random.default_rng(n * 7 + MASKS.index(mask) * 3 + b)
    _, ps = _tables(rng)
    scene = SceneBuffers(*(None if x is None else type(x)(*(
        c.to(dev) for c in x)) for x in ps))
    lanes = _masked_lanes(rng, n, mask)
    _, pcam = _cameras()
    cfg = _config(level=3)
    cpu_state = _port_state(lanes, pcam, cfg)
    got = bounce.SampleState(*(
        Vec3(*(c.to(dev) for c in x)) if isinstance(x, Vec3)
        else x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in cpu_state))
    want = _clone(got)
    args = [b] + [torch.as_tensor(lanes[k], device=dev)
                  for k in ("t", "idx", "tt", "ti")] + [scene, cfg]
    (g_sums, g_base), (w_sums, w_base) = _fold_pair(n, fold, dev, b)
    before = bounce.shade_bounce.launches
    if per is None:
        bounce.shade_bounce(got, *args, g_sums, g_base)
        assert bounce.shade_bounce.launches == before + 1
    else:
        bounce._launch_shade(got, *args, g_sums, g_base, per=per)
    bounce.shade_bounce_reference(want, *args, w_sums, w_base)
    assert _states_equal(got, want)
    assert int(got.segments) == int(want.segments)
    if fold is not None:
        assert all(_same(x, y) for x, y in zip(g_sums.columns(),
                                               w_sums.columns()))


@pytest.mark.cuda
@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("b", [0, 2])
@pytest.mark.parametrize("mask", MASKS)
def test_cuda_shade_lists_under_masks(mask, b, fold):
    """K6's lists of live lanes under masks that stress them, at bounce 0
    and the last bounce, with every fold, bit-equal to the plain
    version."""
    _hold_masked(4096, mask, b, fold)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-1, 1])
@pytest.mark.parametrize("per", [1, 2, 4])
def test_cuda_shade_ragged_tiles(per, offset):
    """A tile of 256 * ``per`` lanes less or more one (one lane at per 1
    less one), at the last bounce folding in place."""
    _hold_masked(max(256 * per + offset, 1), "every 97th", 2, "self",
                 per=per)
    _hold_masked(256 * per + offset, "all", 2, "film", per=per)


@pytest.mark.cuda
@pytest.mark.parametrize("per", [None, 4])
def test_cuda_shade_one_lane_and_odd_lanes(per):
    """One lane, and 100,003 lanes (off every tile's multiple) with the
    wrapper's geometry and with the largest tiles."""
    _hold_masked(1, "all", 0, "zero", per=per)
    _hold_masked(100_003, "misses and a mixed warp", 2, "self", per=per)
    _hold_masked(100_003, "all", 0, None, per=per)


@pytest.mark.cuda
def test_cuda_shade_probe_equals_default():
    """K6's probe instance gives the default instance's bits and counts the
    live lanes' paths: the warps entering the hit path and the miss path
    hold every live lane."""
    dev = _card()
    rng = np.random.default_rng(5)
    _, ps = _tables(rng)
    scene = SceneBuffers(*(None if x is None else type(x)(*(
        c.to(dev) for c in x)) for x in ps))
    lanes = _masked_lanes(rng, 5000, "misses and a mixed warp")
    _, pcam = _cameras()
    cfg = _config(level=3)
    cpu_state = _port_state(lanes, pcam, cfg)
    got = bounce.SampleState(*(
        Vec3(*(c.to(dev) for c in x)) if isinstance(x, Vec3)
        else x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in cpu_state))
    want = _clone(got)
    args = [2] + [torch.as_tensor(lanes[k], device=dev)
                  for k in ("t", "idx", "tt", "ti")] + [scene, cfg]
    before = bounce.shade_bounce.launches
    clocks = bounce.shade_bounce_probe(got, *args)
    assert bounce.shade_bounce.launches == before
    bounce.shade_bounce(want, *args)
    assert _states_equal(got, want)
    assert clocks["miss_lanes"] + clocks["record_lanes"] == int(
        lanes["active"].sum())
    assert clocks["metal_lanes"] + clocks["glass_lanes"] + clocks[
        "diffuse_lanes"] == clocks["record_lanes"]
    assert clocks["total"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["final", "mesh", "defocus_cosine"])
def test_cuda_renderer_frame_equals_plain_body(case, monkeypatch):
    """A ``Renderer`` frame through K5 and K6 under torch's sync debug mode
    "error" (any call that waits for the card raises), equal (image, depth,
    segments) to the frame with the plain versions patched in."""
    dev = _card()
    options = {}
    if case == "mesh":
        world = bt.rtiow.final_scene(seed=42, grid=4)
        world.spawn_mesh(bt.Transform.from_xyz(-1.0, 0.6, 1.0),
                         bt.cube_mesh(1.2),
                         bt.StandardMaterial(base_color=(0.2, 0.5, 0.9),
                                             metallic=1.0))
    else:
        world = _world(bt, case == "defocus_cosine")
        if case == "defocus_cosine":
            options = dict(defocus=True, diffuse_sampling="cosine")
    scene = world.extract(device=dev)
    cam = world.camera_state(aspect=1.0, device=dev)
    renderer = bt.Renderer(bt.RenderConfig(width=64, height=64,
                                           samples_per_pixel=2, bounces=3,
                                           level=1, **options))
    renderer.render(scene, cam, seed=0)
    torch.cuda.synchronize()
    before = (bounce.raygen_sample.launches, bounce.shade_bounce.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = renderer.render(scene, cam, seed=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (bounce.raygen_sample.launches - before[0],
            bounce.shade_bounce.launches - before[1]) == (2, 8)
    monkeypatch.setattr(prenderer, "raygen_sample",
                        bounce.raygen_sample_reference)
    monkeypatch.setattr(prenderer, "shade_bounce",
                        bounce.shade_bounce_reference)
    plain = renderer.render(scene, cam, seed=1)
    assert _same(frame.image, plain.image)
    assert _same(frame.rt_depth, plain.rt_depth)
    assert int(frame.rays_traced) == int(plain.rays_traced) > 0
