"""The reference against the program's plain CPU path at a tiny frame, on
both draw paths and at the hybrid level 2; the frozen scene against the
program's own generator."""

import numpy as np
import pytest
import torch

import harness
from reference import path_tracer
from scenes import rtiow_final

SCENE = rtiow_final.build(42)


def port_frame(entry: str, width, height, spp, level, seed, pose):
    from bevyray_tpu_torch import (FusedRenderer, PerspectiveProjection,
                                   RenderConfig, Renderer, Transform)
    from bevyray_tpu_torch.engine.raster import raster_layer

    world = harness.port_world(SCENE)
    world.set_camera(Transform.from_xyz(*pose["eye"]).looking_at(
        pose["target"]), PerspectiveProjection(
            fov=SCENE["fov"], near=SCENE["near"], far=SCENE["far"]))
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=4, level=level)
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
