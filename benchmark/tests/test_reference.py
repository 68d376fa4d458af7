"""The reference against the program's plain CPU path at a tiny frame, on
both draw paths and at the hybrid level 2, with a pinhole and with a thin
lens; the frozen scene against the program's own generator."""

import numpy as np
import pytest
import torch

import harness
from reference import path_tracer
from scenes import rtiow_final

SCENE = rtiow_final.build(42)
# The frozen scene behind a thin lens focused short of the glass sphere.
LENS = dict(SCENE, aperture=0.35, focus_distance=3.5)


def port_frame(entry: str, width, height, spp, level, seed, pose,
               arrays=SCENE):
    from bevyray_tpu_torch import FusedRenderer, Renderer, Transform
    from bevyray_tpu_torch.engine.raster import raster_layer

    world = harness.port_world(arrays)
    world.set_camera(Transform.from_xyz(*pose["eye"]).looking_at(
        pose["target"]))
    config = harness.render_config(
        {"resolution": [width, height], "samples_per_pixel": spp,
         "bounces": 4, "level": level}, arrays)
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=width / height, device="cpu")
    rc, rd = (raster_layer(world, cam, config, device="cpu")
              if level in (1, 2) else (None, None))
    renderer = {"fast": lambda: FusedRenderer(config, exact_rng=False),
                "exact": lambda: FusedRenderer(config, exact_rng=True),
                "wavefront": lambda: Renderer(config)}[entry]()
    f = renderer.render(scene, cam, seed, rc, rd)
    return f.image.numpy(), f.rt_depth.numpy(), int(f.rays_traced)


POSES = [{"eye": SCENE["eye"], "target": SCENE["target"]},
         {"eye": (3.2139, 0.0, 3.8302), "target": (0.0, 0.0, 0.0)}]


@pytest.mark.parametrize("entry,draws", [("fast", "fast"), ("exact", "exact"),
                                         ("wavefront", "exact")])
@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("pose", [0, 1])
def test_reference_matches_plain_path(entry, draws, level, pose):
    w, h, spp, seed = 40, 24, 2, 0xDEADBEEF
    port = port_frame(entry, w, h, spp, level, seed, POSES[pose])
    ref = path_tracer.render(SCENE, POSES[pose], w, h, spp, 4, level, seed,
                             draws)
    c = harness.compare(port, ref)
    assert c["mismatched"] == 0 and c["rays_gap"] == 0.0


@pytest.mark.parametrize("entry,draws", [("fast", "fast"), ("exact", "exact"),
                                         ("wavefront", "exact")])
@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("pose", [0, 1])
def test_lens_reference_matches_plain_path(entry, draws, level, pose):
    w, h, spp, seed = 40, 24, 2, 0xDEADBEEF
    port = port_frame(entry, w, h, spp, level, seed, POSES[pose], LENS)
    ref = path_tracer.render(LENS, POSES[pose], w, h, spp, 4, level, seed,
                             draws)
    c = harness.compare(port, ref)
    assert c["mismatched"] == 0 and c["rays_gap"] == 0.0


@pytest.mark.parametrize("entry,draws", [("fast", "fast"), ("exact", "exact"),
                                         ("wavefront", "exact")])
def test_lens_moves_the_frame(entry, draws):
    # The same seed through the lens and through the pinhole: most pixels
    # change, and the reference follows the program through both.
    w, h, spp, seed = 40, 24, 2, 77
    pin = port_frame(entry, w, h, spp, 3, seed, POSES[0])
    lens = port_frame(entry, w, h, spp, 3, seed, POSES[0], LENS)
    flat = (pin[0].reshape(-1, 3), pin[1].reshape(-1), pin[2])
    assert harness.compare(lens, flat)["mismatched"] > w * h // 2
    ref_pin = path_tracer.render(SCENE, POSES[0], w, h, spp, 4, 3, seed,
                                 draws)
    ref_lens = path_tracer.render(LENS, POSES[0], w, h, spp, 4, 3, seed,
                                  draws)
    assert harness.compare(pin, ref_pin)["mismatched"] == 0
    assert harness.compare(lens, ref_lens)["mismatched"] == 0


def test_pinhole_scene_keeps_the_camera():
    # No lens keys: the RenderConfig and the World's camera the harness
    # built before scenes could carry a lens, field for field.
    from bevyray_tpu_torch import (PerspectiveProjection, RaytracedCamera,
                                   RenderConfig, Transform)

    config = {"resolution": [48, 27], "samples_per_pixel": 2, "bounces": 4,
              "level": 3}
    assert harness.lens(SCENE) is None
    assert harness.render_config(config, SCENE) == RenderConfig(
        width=48, height=27, samples_per_pixel=2, bounces=4, level=3)
    world = harness.port_world(SCENE)
    assert world.camera == RaytracedCamera()
    assert world.projection == PerspectiveProjection(
        fov=SCENE["fov"], near=SCENE["near"], far=SCENE["far"])
    pinhole = Transform.from_xyz(*SCENE["eye"]).looking_at(SCENE["target"])
    assert world.camera_transform == pinhole
    lensed = harness.port_world(LENS)
    assert lensed.camera == RaytracedCamera(aperture=0.35,
                                            focus_distance=3.5)
    assert harness.render_config(config, LENS).defocus is True


@pytest.mark.parametrize("draws", ["exact", "fast"])
def test_sample_groups_leave_the_frame(draws, monkeypatch):
    # One sample a group, three, and all at once: the same bits.
    w, h, spp = 24, 16, 7
    frames = []
    for block in (w * h, 3 * w * h, 1 << 20):
        monkeypatch.setitem(path_tracer.RAY_BLOCK, "cpu", block)
        frames.append(path_tracer.render(LENS, POSES[1], w, h, spp, 6, 2, 21,
                                         draws))
    for image, depth, segments in frames[1:]:
        assert np.array_equal(image, frames[0][0])
        assert np.array_equal(depth, frames[0][1])
        assert segments == frames[0][2]


def test_nearest_root_compared_as_q():
    # Two roots one float apart in q = a t that the multiply by 1 / a rounds
    # to one t (a = 0.09): the nearer sphere wins, listed second, as in the
    # program's walks, and not the lower index on a tie in t.
    def col(*v):
        return torch.tensor(v, dtype=torch.float32)

    o = path_tracer.V3(col(0.0), col(0.0), col(0.0))
    d = path_tracer.V3(col(0.0), col(0.0), col(-0.3))
    centers = path_tracer.V3(
        col(float.fromhex("0x1.2f0bccp-12"), float.fromhex("0x1.6f6742p-11")),
        col(0.0, 0.0),
        col(-float.fromhex("0x1.800010p+2"), -float.fromhex("0x1.800004p+2")))
    t, i = path_tracer.nearest_sphere(o, d, centers, col(0.25, 0.25))
    assert int(i[0]) == 1 and float(t[0]) == 18.333335876464844


def test_level2_shows_the_cube():
    # The cube sits inside the glass sphere at (0, 1, 0): at level 2 it wins
    # only where the traced depth averages behind it.
    w, h = 40, 24
    img3, *_ = path_tracer.render(SCENE, POSES[0], w, h, 1, 4, 3, 5, "fast")
    img2, *_ = path_tracer.render(SCENE, POSES[0], w, h, 1, 4, 2, 5, "fast")
    changed = np.abs(img3 - img2).max(axis=1) > 0
    assert 0 < changed.mean() < 0.5


def test_bfloat16_reference_differs():
    w, h = 40, 24
    a = path_tracer.render(SCENE, POSES[0], w, h, 2, 4, 3, 9, "exact")
    b = path_tracer.render(SCENE, POSES[0], w, h, 2, 4, 3, 9, "exact",
                           dtype=torch.bfloat16)
    assert harness.compare((a[0], a[1], a[2]), b)["mismatched"] > w * h // 4


@pytest.mark.parametrize("draws", ["exact", "fast"])
def test_bfloat16_reference_differs_through_the_lens(draws):
    w, h = 40, 24
    a = path_tracer.render(LENS, POSES[0], w, h, 2, 4, 3, 9, draws)
    b = path_tracer.render(LENS, POSES[0], w, h, 2, 4, 3, 9, draws,
                           dtype=torch.bfloat16)
    assert harness.compare(a, b)["mismatched"] > w * h // 4


def test_frozen_scene_has_508_spheres():
    assert SCENE["centers"].shape == (508, 3)
    assert SCENE["radii"].shape == (508,) and SCENE["materials"].shape == (508, 11)
    assert len(SCENE["raster_meshes"]) == 1


def test_frozen_scene_is_the_programs_final_scene():
    from bevyray_tpu_torch import rtiow

    centers, radii, mats, _ = rtiow.final_scene(seed=42).extract_host()
    assert np.array_equal(centers, SCENE["centers"].astype(np.float32))
    assert np.array_equal(radii, SCENE["radii"].astype(np.float32))
    ours = SCENE["materials"].copy()
    ours[:, :3] = path_tracer.srgb_to_linear(ours[:, :3])
    assert np.array_equal(mats, ours.astype(np.float32))
    world = harness.port_world(SCENE)
    theirs = rtiow.final_scene(seed=42).extract_raster_host()
    for a, b in zip(world.extract_raster_host(), theirs):
        assert np.array_equal(a, b)
