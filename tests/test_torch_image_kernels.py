"""The image kernels' wrappers: the à-trous denoiser (``engine/denoise.py``,
K7 of ``kernels/cuda/csrc/denoise.cu``) and the raster layer
(``engine/raster.py``, K8 and K9 of ``raster.cu`` around the triangle test
K2).

On the CPU the wrappers run their plain versions (their ``.launches`` do not
move), and the plain versions are held to the JAX package's
``atrous_denoise`` and ``rasterize_impl``: the filtered image within atol
1e-5 (tests/test_torch_denoise.py's bar: XLA's exp and its fused passes
round otherwise in the last place), the raster depth within rtol 1e-6 on
identical hit masks and the colour within atol 1e-6
(tests/test_torch_raster.py's bars: XLA on the CPU contracts multiply-adds,
the port rounds each operation). The kernels' argument checks raise on the
wrong dtype, shape, contiguity or device. The tests marked ``cuda`` hold
each kernel to its plain version on the card, to the bit, and run the
wrappers under torch's sync debug mode "error"; they skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.engine import denoise as jdenoise
from bevyray_tpu.engine.raster import raster_layer as jraster_layer
from bevyray_tpu_torch.core.types import make_triangles_np, upload
from bevyray_tpu_torch.engine import denoise, raster
from bevyray_tpu_torch.kernels import intersect
from bevyray_tpu_torch.kernels.camera import camera_rows
from chip_smoke import golden_world

torch.set_num_threads(2)

FAR = 999.0   # a miss's depth in the guide: the far fallback


def _inputs(h, w, seed, misses=False):
    """A seeded image and depth with a depth edge; with ``misses``, a band
    of rows at the far fallback."""
    rng = np.random.default_rng(seed)
    image = rng.random((h, w, 3), dtype=np.float32)
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    depth[:, w // 2:] += 30.0
    if misses:
        depth[h // 3:h // 2] = FAR
    return image, depth


# (name, (H, W), iterations, the iterations the stride rule lets run)
DENOISE_CASES = [
    ("odd_37x53", (37, 53), 3, 3),
    ("side_4", (4, 9), 3, 1),       # 2 * 2 >= 4 ends it after stride 1
    ("side_8", (11, 8), 3, 2),      # 2 * 4 >= 8 ends it after stride 2
    ("iterations_0", (40, 48), 0, 0),
    ("iterations_1", (40, 48), 1, 1),
    ("iterations_3", (40, 48), 3, 3),
    ("iterations_5", (40, 48), 5, 5),
    ("misses", (36, 52), 3, 3),
]


@pytest.mark.parametrize("name,shape,iterations,runs", DENOISE_CASES,
                         ids=[c[0] for c in DENOISE_CASES])
def test_denoise_reference_matches_jax(name, shape, iterations, runs):
    image, depth = _inputs(*shape, seed=len(name), misses=name == "misses")
    want = jdenoise.atrous_denoise(jnp.asarray(image), jnp.asarray(depth),
                                   iterations=iterations)
    image, depth = torch.as_tensor(image), torch.as_tensor(depth)
    got = denoise.atrous_denoise_reference(image, depth,
                                           iterations=iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # The stride rule: exactly ``runs`` iterations change the image.
    if runs:
        assert not torch.equal(got, denoise.atrous_denoise_reference(
            image, depth, iterations=runs - 1))
    assert torch.equal(got, denoise.atrous_denoise_reference(
        image, depth, iterations=runs))


@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_denoise_wrapper_runs_the_plain_version_on_the_cpu(kind):
    image, depth = _inputs(24, 30, seed=5, misses=True)
    if kind == "tensor":
        image, depth = torch.as_tensor(image), torch.as_tensor(depth)
    before = denoise.atrous_denoise.launches
    got = denoise.atrous_denoise(image, depth, iterations=3)
    want = denoise.atrous_denoise_reference(image, depth, iterations=3)
    assert denoise.atrous_denoise.launches == before
    assert got.device.type == "cpu" and torch.equal(got, want)
    cached = denoise.jitted_denoise(3, 0.25, 0.5)(image, depth)
    assert denoise.atrous_denoise.launches == before
    assert torch.equal(cached, want)


def _bad_denoise_args(case):
    image, depth = (torch.as_tensor(a) for a in _inputs(8, 12, seed=1))
    if case == "float64":
        return image.double(), depth
    if case == "channels":
        return torch.zeros(8, 12, 4), depth
    if case == "depth_shape":
        return image, depth[:, :11].contiguous()
    if case == "contiguity":
        return image.transpose(0, 1), depth.t()
    return image, np.asarray(depth)     # depth not a tensor


@pytest.mark.parametrize("case", ["float64", "channels", "depth_shape",
                                  "contiguity", "depth_array"])
def test_denoise_kernel_checks_raise(case):
    with pytest.raises(ValueError, match="atrous_denoise"):
        denoise.check_kernel_args(*_bad_denoise_args(case))


def test_denoise_kernel_checks_pass_the_main_path_inputs():
    image, depth = (torch.as_tensor(a) for a in _inputs(8, 12, seed=1))
    denoise.check_kernel_args(image, depth)


def test_denoise_wrapper_takes_cpu_or_cuda_tensors_only():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        denoise.atrous_denoise(torch.zeros(8, 8, 3, device="meta"),
                               torch.zeros(8, 8, device="meta"))


# -- the raster layer ------------------------------------------------------------

def _config5(pkg):
    """BASELINE config 5's world: the final scene with a metallic cube mesh
    over the reference's raster cube."""
    world = pkg.rtiow.final_scene(seed=42)
    world.spawn_mesh(pkg.Transform.from_xyz(-4.0, 0.6, 1.0),
                     pkg.cube_mesh(1.2),
                     pkg.StandardMaterial(base_color=(0.2, 0.5, 0.9),
                                          metallic=1.0,
                                          perceptual_roughness=0.15))
    return world


def _rotated(pkg):
    world = golden_world(pkg, "cube")
    world.spawn_raster_mesh(
        pkg.Transform.from_xyz(1.3, 0.4, 0.5).with_rotation(
            pkg.Transform.rotation_axis_angle((1.0, 1.0, 0.0), 0.7)),
        pkg.cube_mesh(0.6),
        pkg.StandardMaterial(base_color=(0.9, 0.6, 0.2), metallic=1.0,
                             perceptual_roughness=0.3, reflectance=0.8))
    return world


def _all_miss(pkg):
    """The cube world seen from a camera that looks away from the cube."""
    world = golden_world(pkg, "cube")
    world.set_camera(pkg.Transform.from_xyz(0.0, 1.0, 4.0).looking_at(
        (0.0, 1.5, 9.0)))
    return world


# name: (world builder, (W, H), level)
RASTER_CASES = {
    "config5": (_config5, (64, 36), 2),
    "kitchen_sink": (lambda pkg: golden_world(pkg, "kitchen_sink"),
                     (48, 48), 2),
    "rotated_cube": (_rotated, (48, 32), 1),
    "all_miss": (_all_miss, (40, 24), 1),
}


def _port_inputs(world, w, h, level, device):
    cam = world.camera_state(aspect=w / h, device=device)
    va, vb, vc, colors = world.extract_raster_host()
    tris = make_triangles_np(va, vb, vc, np.zeros(va.shape[0], np.int32),
                             capacity=va.shape[0], device=device)
    return (tris, upload(colors, device), cam,
            bt.RenderConfig(w, h, 1, 1, level=level), (1.0, 1.0, 1.0))


@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_raster_reference_matches_jax(name):
    build, (w, h), level = RASTER_CASES[name]
    jw = build(jb)
    want_c, want_d = jraster_layer(jw, jw.camera_state(aspect=w / h),
                                   jb.RenderConfig(w, h, 1, 1, level=level))
    got_c, got_d = raster.rasterize_impl_reference(
        *_port_inputs(build(bt), w, h, level, "cpu"))
    want_d = np.asarray(want_d)
    hit = want_d > 0
    assert hit.any() != (name == "all_miss")
    np.testing.assert_array_equal(got_d.numpy() > 0, hit)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-6)
    for g, wc in zip(got_c, want_c):
        assert g.shape == (w * h,)
        np.testing.assert_allclose(g.numpy(), np.asarray(wc), atol=1e-6)
    if name == "all_miss":
        assert (got_d.numpy() == 0.0).all()
        assert all((c.numpy() == 1.0).all() for c in got_c)


@pytest.mark.parametrize("name", ["config5", "rotated_cube"])
def test_raster_wrapper_runs_the_plain_version_on_the_cpu(name):
    build, (w, h), level = RASTER_CASES[name]
    world = build(bt)
    args = _port_inputs(world, w, h, level, "cpu")
    before = (raster.raster_rays.launches, raster.raster_shade.launches,
              intersect.intersect_triangles.launches)
    got = raster.rasterize_impl(*args)
    layer = raster.raster_layer(world, args[2], args[3], device="cpu")
    assert (raster.raster_rays.launches, raster.raster_shade.launches,
            intersect.intersect_triangles.launches) == before
    want = raster.rasterize_impl_reference(*args)
    for out in (got, layer):
        assert all(torch.equal(g, wc) for g, wc in zip(out[0], want[0]))
        assert torch.equal(out[1], want[1])


def _bad_raster_args(case):
    tris, colors, cam, _, _ = _port_inputs(_rotated(bt), 8, 8, 1, "cpu")
    if case == "colors_float64":
        colors = colors.double()
    elif case == "colors_shape":
        colors = colors[:, :5]
    elif case == "colors_contiguity":
        colors = colors.t().contiguous().t()
    elif case == "corner_float64":
        tris = tris._replace(bx=tris.bx.double())
    elif case == "corner_length":
        tris = tris._replace(cz=tris.cz[:-1])
    else:
        cam = cam._replace(near=cam.near.double())
    return tris, colors, cam


@pytest.mark.parametrize("case", ["colors_float64", "colors_shape",
                                  "colors_contiguity", "corner_float64",
                                  "corner_length", "camera_float64"])
def test_raster_kernel_checks_raise(case):
    with pytest.raises(ValueError, match="rasterize_impl"):
        raster.check_kernel_args(*_bad_raster_args(case))


def test_raster_kernel_checks_pass_the_main_path_inputs():
    tris, colors, cam, _, _ = _port_inputs(_rotated(bt), 8, 8, 1, "cpu")
    raster.check_kernel_args(tris, colors, cam)


def test_raster_wrappers_take_cpu_or_cuda_tensors_only():
    tris, colors, cam, config, clear = _port_inputs(_rotated(bt), 8, 8, 1,
                                                    "cpu")
    meta = lambda t: t.to("meta")   # noqa: E731
    with pytest.raises(ValueError, match="CPU or CUDA"):
        raster.rasterize_impl(type(tris)(*map(meta, tris)), meta(colors),
                              cam, config, clear)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        raster.raster_rays(torch.zeros(19, device="meta"), config)


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda", 0)


def _same(a, b) -> bool:
    """Bit-equal float32 tensors (NaNs too)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,iterations,runs", DENOISE_CASES,
                         ids=[c[0] for c in DENOISE_CASES])
def test_cuda_atrous_equals_plain(name, shape, iterations, runs):
    dev = _card()
    image, depth = (torch.as_tensor(a, device=dev) for a in _inputs(
        *shape, seed=len(name), misses=name == "misses"))
    before = denoise.atrous_denoise.launches
    got = denoise.atrous_denoise(image, depth, iterations=iterations)
    assert denoise.atrous_denoise.launches - before == runs
    want = denoise.atrous_denoise_reference(image, depth,
                                            iterations=iterations)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_cuda_raster_equals_plain(name):
    dev = _card()
    build, (w, h), level = RASTER_CASES[name]
    tris, colors, cam, config, clear = _port_inputs(build(bt), w, h, level,
                                                    dev)
    row = camera_rows(cam, config, fused=False, wavefront=True).wavefront
    origin, direction = raster.raster_rays(row, config)
    p_origin, p_direction = raster.raster_rays_reference(cam, config, dev)
    for g, wc in zip((*origin, *direction), (*p_origin, *p_direction)):
        assert _same(g, wc.expand_as(g))
    t, idx = intersect.intersect_triangles(origin, direction, tris)
    color, depth = raster.raster_shade(t, idx, direction, tris, colors, row,
                                       cam.near, clear)
    p_color, p_depth = raster.raster_shade_reference(t, idx, direction, tris,
                                                     colors, cam, clear)
    assert all(_same(g, wc) for g, wc in zip(color, p_color))
    assert _same(depth, p_depth)
    before = (raster.raster_rays.launches, raster.raster_shade.launches,
              intersect.intersect_triangles.launches)
    got = raster.rasterize_impl(tris, colors, cam, config, clear)
    assert (raster.raster_rays.launches - before[0],
            raster.raster_shade.launches - before[1],
            intersect.intersect_triangles.launches - before[2]) == (1, 1, 1)
    want = raster.rasterize_impl_reference(tris, colors, cam, config, clear)
    assert all(_same(g, wc) for g, wc in zip(got[0], want[0]))
    assert _same(got[1], want[1])


@pytest.mark.cuda
def test_cuda_wrappers_never_wait_for_the_card():
    """After a warm-up call, the raster layer and the denoiser under
    torch's sync debug mode "error" (any call that waits for the card
    raises)."""
    dev = _card()
    world = _config5(bt)
    cam = world.camera_state(aspect=16 / 9, device=dev)
    config = bt.RenderConfig(128, 72, 1, 1, level=2)
    image, depth = (torch.as_tensor(a, device=dev) for a in _inputs(
        72, 128, seed=2, misses=True))
    for debug in ("default", "error"):
        torch.cuda.set_sync_debug_mode(debug)
        try:
            raster.raster_layer(world, cam, config, device=dev)
            denoise.atrous_denoise(image, depth, iterations=3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
