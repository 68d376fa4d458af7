"""The port's sharded frames (``parallel/sharding.py``) on in-process CPU
meshes: twins of tests/test_sharding.py, and both steps against the JAX
package's on its 8-device virtual CPU mesh: the wavefront step also on the
tp-only meshes (1, 1, 2), (1, 1, 4) and (1, 1, 8), on a scene whose
duplicate spheres straddle the tp slices (the tp hit merge's tie rule);
and a mesh of more than 32 parts.

Bars: a sharded frame against the port's unsharded one as JAX's own tests
hold theirs (the wavefront step 1e-5, the fused step 1e-6: only the order of
the dp sums differs); against the JAX package, the bars of
tests/test_pallas.py:24-28 (image 5e-5, depth 1e-3, segment counts
equal)."""

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.parallel import sharding as jsharding
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.parallel import sharding
from bevyray_tpu_torch.parallel.sharding import (default_mesh_shape,
                                                 make_mesh,
                                                 render_frame_sharded,
                                                 render_frame_sharded_pallas)

torch.set_num_threads(2)


def cpu_mesh(sp, dp, tp):
    return make_mesh(sp, dp, tp, devices=["cpu"] * (sp * dp * tp))


@pytest.fixture(scope="module")
def both_scenes():
    """The material test scene in both packages (the port's on the CPU)."""
    jw = jb.rtiow.material_test_scene()
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam


def _close_to_jax(got, want):
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.rt_depth.numpy(),
                               np.asarray(want.rt_depth), atol=1e-3)
    assert int(got.rays_traced) == int(want.rays_traced) > 0


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (2, 2, 2), (1, 4, 2),
                                        (1, 1, 8)])
def test_sharded_matches_single_device(both_scenes, mesh_shape):
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=4, bounces=4,
                          level=3)
    want = bt.Renderer(cfg).render(ps, pcam, seed=5)
    got = render_frame_sharded(cpu_mesh(*mesh_shape), ps, pcam, cfg, 5)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-5)
    assert int(got.rays_traced) == int(want.rays_traced)


def test_sharded_hybrid_level(both_scenes):
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=2,
                          level=2)
    want = bt.Renderer(cfg).render(ps, pcam, seed=3)
    got = render_frame_sharded(cpu_mesh(*default_mesh_shape(8)), ps, pcam,
                               cfg, 3)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (4, 2, 1), (1, 4, 1)])
def test_sharded_megakernel_matches_single_device(both_scenes, mesh_shape):
    """The fused kernel per shard (sp pixel blocks, dp samples) against the
    unsharded ``FusedRenderer``: the same image but for the order of the dp
    sums, and the same segments."""
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=4, bounces=3,
                          level=3)
    want = bt.FusedRenderer(cfg).render(ps, pcam, seed=5)
    got = render_frame_sharded_pallas(cpu_mesh(*mesh_shape), ps, pcam, cfg, 5)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got.rt_depth.numpy(), want.rt_depth.numpy(),
                               rtol=1e-6)
    assert int(got.rays_traced) == int(want.rays_traced)
    if mesh_shape[1] == 1:
        assert torch.equal(got.image, want.image)


def test_sharded_indivisible_fuse_segments_exact():
    """128x192 is 6 blocks; sp = 2 gives each shard 3, and fuse 2 pads each
    shard's last instance with a half whose global block is the other
    shard's (the CUDA kernel leaves it out by its local index). The frame
    and its segment count equal the unsharded frame's exactly."""
    world = bt.rtiow.material_test_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=128.0 / 192.0, device="cpu")
    cfg = bt.RenderConfig(width=128, height=192, samples_per_pixel=2,
                          bounces=2, level=3, sphere_chunk=8)
    old = mk.PHASE_FUSE
    mk.PHASE_FUSE = 2
    try:
        want = bt.FusedRenderer(cfg).render(scene, cam, seed=7)
        got = render_frame_sharded_pallas(cpu_mesh(2, 1, 1), scene, cam, cfg,
                                          7)
        kscene = sharding._cached_kscene(scene, cfg, "cpu")
        assert mk.kernel_fuse(kscene, cfg, 1, 3) == 2
    finally:
        mk.PHASE_FUSE = old
    assert torch.equal(got.image, want.image)
    assert int(got.rays_traced) == int(want.rays_traced)


def test_sharded_megakernel_rejects_tp(both_scenes):
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=2,
                          level=3)
    with pytest.raises(ValueError, match="sp/dp"):
        render_frame_sharded_pallas(cpu_mesh(2, 2, 2), ps, pcam, cfg, 1)


def test_default_mesh_shape():
    assert default_mesh_shape(8) == (2, 2, 2)
    assert default_mesh_shape(4) == (2, 2, 1)
    assert default_mesh_shape(1) == (1, 1, 1)
    for n in (1, 2, 4, 8, 16):
        sp, dp, tp = default_mesh_shape(n)
        assert sp * dp * tp == n
        assert (sp, dp, tp) == jsharding.default_mesh_shape(n)


def test_make_mesh_takes_cards_or_raises():
    """``devices=None`` takes the visible CUDA cards and never the CPU:
    asking for more than there are raises."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(2, 2, devices=["cpu"] * 2)
    mesh = cpu_mesh(2, 2, 1)
    assert mesh.shape == {"sp": 2, "dp": 2, "tp": 1}
    assert mesh.device(1, 1) == torch.device("cpu")


def test_sharded_shortlist_cache_lru(monkeypatch):
    """Alternating two cameras through the fused step hits the shortlist
    cache both ways: one build per camera over five frames."""
    world = bt.rtiow.material_test_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam_a = world.camera_state(aspect=1.0, device="cpu")
    world.set_camera(bt.Transform.from_xyz(2.0, 1.5, 6.0).looking_at(
        (0, 0.5, 0)))
    cam_b = world.camera_state(aspect=1.0, device="cpu")
    builds = []
    real = sharding.shortlists_for

    def spy(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(sharding, "shortlists_for", spy)
    sharding._SHARDED_SL_CACHE.clear()
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=2,
                          level=3)
    mesh = cpu_mesh(2, 2, 1)
    for seed, cam in enumerate([cam_a, cam_b, cam_a, cam_b, cam_a]):
        render_frame_sharded_pallas(mesh, scene, cam, cfg, frame_seed=seed)
    assert len(builds) == 2, f"expected one build per camera, got {builds}"


def test_sharded_per_pixel_raster_inputs(both_scenes):
    """Per-pixel raster color and depth (the hybrid G-buffer case) through
    both steps: they composite after the shards are joined."""
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=2,
                          bounces=3, level=2)
    n = cfg.n_pixels
    in_left = torch.arange(n) % cfg.width < cfg.width // 2
    rd = torch.where(in_left, 0.9, 0.0)
    rc = bt.Vec3(torch.where(in_left, 1.0, 0.0), torch.zeros(n),
                 torch.zeros(n))
    want = bt.Renderer(cfg).render(ps, pcam, seed=5, raster_color=rc,
                                   raster_depth=rd)
    got = render_frame_sharded(cpu_mesh(2, 2, 2), ps, pcam, cfg, 5,
                               raster_color=rc, raster_depth=rd)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-4)
    got = render_frame_sharded_pallas(cpu_mesh(4, 2, 1), ps, pcam, cfg, 5,
                                      raster_color=rc, raster_depth=rd)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-4)
    assert bool((got.image[:, :16] == torch.tensor([1.0, 0.0, 0.0])).all())


def test_fused_sharded_matches_jax(both_scenes):
    js, jcam, ps, pcam = both_scenes
    cfg = dict(width=32, height=32, samples_per_pixel=4, bounces=3, level=3)
    want = jsharding.render_frame_sharded_pallas(
        jsharding.make_mesh(4, 2, 1), js, jcam, jb.RenderConfig(**cfg), 5)
    got = render_frame_sharded_pallas(cpu_mesh(4, 2, 1), ps, pcam,
                                      bt.RenderConfig(**cfg), 5)
    _close_to_jax(got, want)


def test_wavefront_sharded_matches_jax(both_scenes):
    js, jcam, ps, pcam = both_scenes
    cfg = dict(width=32, height=32, samples_per_pixel=4, bounces=4, level=3)
    want = jsharding.render_frame_sharded(
        jsharding.make_mesh(2, 2, 2), js, jcam, jb.RenderConfig(**cfg), 5)
    got = render_frame_sharded(cpu_mesh(2, 2, 2), ps, pcam,
                               bt.RenderConfig(**cfg), 5)
    _close_to_jax(got, want)


def _straddle_world(pkg):
    """The material test scene (4 spheres) grown to 96 in its capacity of
    128: small spheres on the ground and, in another material than their
    first copy, duplicates that straddle the tp slices at tp 2, 4 and 8:
    sphere 1 again at index 16, sphere 2 at 64, and two new spheres at 31
    and 40 again at 33 and 95 (the first copy of the last pair lies past
    slice 0 at tp 4 and 8). The lower index must win each tie."""
    w = pkg.rtiow.material_test_scene()
    red = pkg.StandardMaterial(base_color=(1.0, 0.05, 0.05))
    green = pkg.StandardMaterial(base_color=(0.1, 0.9, 0.2), metallic=0.8,
                                 perceptual_roughness=0.3)
    blue = pkg.StandardMaterial(base_color=(0.1, 0.2, 1.0))
    firsts = {1: ((0.0, 0.5, 0.0), 0.5), 2: ((-1.2, 0.5, 0.0), 0.5),
              31: ((0.6, 1.25, -0.6), 0.3), 40: ((-0.6, 1.25, -0.6), 0.3)}
    again = {16: 1, 64: 2, 33: 31, 95: 40}
    rng = np.random.default_rng(5)
    for index in range(4, 96):
        if index in again:
            pos, radius = firsts[again[index]]
            material = red
        elif index in firsts:
            pos, radius = firsts[index]
            material = green
        else:
            pos = (rng.uniform(-2.5, 2.5), 0.1, rng.uniform(-2.0, 1.5))
            radius, material = 0.1, blue
        w.spawn_sphere(pkg.Transform.from_xyz(*pos),
                       pkg.RaytracedSphere(radius=radius), material)
    return w


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("scene", ["material", "straddle"])
def test_wavefront_tp_matches_jax(both_scenes, scene, tp):
    """The tp-only meshes against JAX's sharded step: each slice's nearest
    hit merged by the least t, then the lowest global index."""
    if scene == "material":
        js, jcam, ps, pcam = both_scenes
    else:
        jw = _straddle_world(jb)
        js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
        ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                    jax.tree.map(np.asarray, jcam),
                                    device="cpu")
        cx = np.asarray(js.spheres.cx)
        assert js.spheres.capacity == 128 and int(np.asarray(
            js.spheres.valid).sum()) == 96
        for first, again in ((1, 16), (2, 64), (31, 33), (40, 95)):
            assert cx[first] == cx[again]
            assert (np.asarray(js.spheres.material_id)[first]
                    != np.asarray(js.spheres.material_id)[again])
    cfg = dict(width=32, height=32, samples_per_pixel=2, bounces=3, level=3)
    want = jsharding.render_frame_sharded(
        jsharding.make_mesh(1, 1, tp), js, jcam, jb.RenderConfig(**cfg), 5)
    got = render_frame_sharded(cpu_mesh(1, 1, tp), ps, pcam,
                               bt.RenderConfig(**cfg), 5)
    _close_to_jax(got, want)


def test_wavefront_step_past_32_parts(both_scenes):
    """A mesh of 40 parts on the CPU (K15 takes it on the card in two
    launches) against the unsharded Renderer."""
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=40, height=16, samples_per_pixel=2,
                          bounces=3, level=3)
    want = bt.Renderer(cfg).render(ps, pcam, seed=4)
    got = render_frame_sharded(cpu_mesh(40, 1, 1), ps, pcam, cfg, 4)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-5)
    assert int(got.rays_traced) == int(want.rays_traced)


def test_dryrun_multichip_twin():
    """``__graft_entry__.dryrun_multichip(8)`` in the port: the wavefront
    step on the (2, 2, 2) mesh and the fused step with tp folded into dp,
    each a finite frame equal to its unsharded one."""
    sp, dp, tp = default_mesh_shape(8)
    world = bt.rtiow.final_scene(seed=42, grid=2)
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(width=32, height=32, samples_per_pixel=max(2, dp),
                          bounces=3, level=2)
    frame = render_frame_sharded(cpu_mesh(sp, dp, tp), scene, cam, cfg, 7)
    assert frame.image.shape == (32, 32, 3)
    assert bool(torch.isfinite(frame.image).all())
    want = bt.Renderer(cfg).render(scene, cam, seed=7)
    np.testing.assert_allclose(frame.image.numpy(), want.image.numpy(),
                               atol=1e-5)
    cfg2 = bt.RenderConfig(width=32, height=32,
                           samples_per_pixel=max(2, dp * tp), bounces=3,
                           level=2)
    frame2 = render_frame_sharded_pallas(cpu_mesh(sp, dp * tp, 1), scene, cam,
                                         cfg2, 7)
    assert frame2.image.shape == (32, 32, 3)
    assert bool(torch.isfinite(frame2.image).all())
    want2 = bt.FusedRenderer(cfg2).render(scene, cam, seed=7)
    np.testing.assert_allclose(frame2.image.numpy(), want2.image.numpy(),
                               atol=1e-6)
    assert int(frame.rays_traced) > 0 and int(frame2.rays_traced) > 0


def test_indivisible_shapes_raise(both_scenes):
    _, _, ps, pcam = both_scenes
    cfg = bt.RenderConfig(width=30, height=3, samples_per_pixel=3, bounces=1,
                          level=3)
    with pytest.raises(ValueError, match="divisible by sp=4"):
        render_frame_sharded(cpu_mesh(4, 1, 1), ps, pcam, cfg, 1)
    for step in (render_frame_sharded, render_frame_sharded_pallas):
        with pytest.raises(ValueError, match="dp=2"):
            step(cpu_mesh(1, 2, 1), ps, pcam, cfg, 1)
    with pytest.raises(ValueError, match="tp=3"):
        render_frame_sharded(cpu_mesh(1, 1, 3), ps, pcam,
                             bt.RenderConfig(8, 8, 1, 1, level=3), 1)


@pytest.mark.cuda
def test_sharded_frames_on_card():
    """On the card: both steps over meshes on ``cuda:0`` against the
    unsharded frames (chip_smoke.py phase 8 at the headline)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene, cam = world.extract(with_bvh=False), world.camera_state(aspect=1.0)
    cfg = bt.RenderConfig(width=192, height=128, samples_per_pixel=4,
                          bounces=3, level=3)
    want = bt.FusedRenderer(cfg).render(scene, cam, seed=5)
    for sp, dp in ((2, 1), (4, 1), (2, 2)):
        got = render_frame_sharded_pallas(
            make_mesh(sp, dp, devices=["cuda:0"] * (sp * dp)), scene, cam,
            cfg, 5)
        assert int(got.rays_traced) == int(want.rays_traced)
        assert float((got.image - want.image).abs().max()) <= 1e-6
    want = bt.Renderer(cfg).render(scene, cam, seed=5)
    got = render_frame_sharded(make_mesh(2, 1, 2, devices=["cuda:0"] * 4),
                               scene, cam, cfg, 5)
    assert int(got.rays_traced) == int(want.rays_traced)
    assert float((got.image - want.image).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_tp_step_queues_k1s_and_one_k16(tp):
    """On the card a bounce's sphere test over tp slices queues tp K1
    launches and one K16, and no other kernel (torch's profiler), with the
    whole table's K1 result; a frame takes tp K1 and one K16 a bounce and
    equals the unsharded frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bevyray_tpu_torch.kernels import intersect, passes

    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene, cam = world.extract(with_bvh=False), world.camera_state(aspect=1.5)
    cfg = bt.RenderConfig(width=192, height=128, samples_per_pixel=2,
                          bounces=3, level=3)
    mesh = make_mesh(1, 1, tp, devices=["cuda:0"] * tp)
    fn = sharding._tp_intersect_fn(scene, cfg, mesh, 0, 0)
    rng = np.random.default_rng(tp)
    n = 50_000
    o = bt.Vec3(*(torch.as_tensor(x, device="cuda") for x in
                  rng.uniform(-4, 4, (3, n)).astype(np.float32)))
    d = bt.Vec3(*(torch.as_tensor(x, device="cuda") for x in
                  rng.normal(size=(3, n)).astype(np.float32)))
    active = torch.as_tensor(rng.random(n) < 0.7, device="cuda")
    fn(o, d, active)
    torch.cuda.synchronize()
    k1, k16 = intersect.intersect_spheres.launches, passes.merge_tp_hits.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t, i = fn(o, d, active)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    assert intersect.intersect_spheres.launches - k1 == tp
    assert passes.merge_tp_hits.launches - k16 == 1
    assert kernels == tp + 1
    whole = intersect.intersect_spheres(o, d, scene.spheres, active=active)
    assert torch.equal(t, whole[0]) and torch.equal(i, whole[1])

    want = bt.Renderer(cfg).render(scene, cam, seed=5)
    k1, k16 = intersect.intersect_spheres.launches, passes.merge_tp_hits.launches
    got = render_frame_sharded(mesh, scene, cam, cfg, 5)
    bounces = cfg.samples_per_pixel * (cfg.bounces + 1)
    assert intersect.intersect_spheres.launches - k1 == tp * bounces
    assert passes.merge_tp_hits.launches - k16 == bounces
    assert int(got.rays_traced) == int(want.rays_traced)
    assert float((got.image - want.image).abs().max()) <= 1e-5
