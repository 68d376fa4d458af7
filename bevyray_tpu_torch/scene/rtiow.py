"""Scene generators reproducing the reference's built-in scenes.

``final_scene`` mirrors ``setup()`` in src/main.rs:49-240: ground sphere (r=1000), a
22×22 jittered grid of small spheres with diffuse/metal/glass chosen at
0.8/0.15/0.05, three feature spheres (glass, diffuse brown, polished metal), and the
reference's raster-only cube (main.rs:76-85) as a raster entity — rendered by the
analytic raster layer (``engine.raster``) into the color/depth buffers the hybrid
modes blend against, never raytraced.

Randomness: the reference uses an unseeded ``rand::random`` (main.rs:107-140); we use
a seeded NumPy generator so scenes are reproducible. Draw order per grid cell matches
main.rs:107-119 (choose_mat, center jitter x, center jitter z, then material params).
"""

from __future__ import annotations

import numpy as np

from .components import (PerspectiveProjection, RaytracedCamera, RaytracedSphere,
                         Raytracing, StandardMaterial, Transform, cube_mesh)
from .world import World


def final_scene(seed: int = 42, grid: int = 11,
                camera: RaytracedCamera | None = None) -> World:
    """The RTiOW final scene (main.rs:49-240). ``grid=11`` gives the 22×22 layout."""
    rng = np.random.RandomState(seed)
    world = World()

    # Camera (main.rs:55-73): at (0,0,5) looking at origin, defaults fov π/4.
    world.set_camera(
        Transform.from_xyz(0.0, 0.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        PerspectiveProjection(),
        camera or RaytracedCamera(level=Raytracing.FALLBACK_RAYTRACED,
                                  sample_count=4, bounces=4),
    )

    # The rasterized-only cube (main.rs:76-85): unit cuboid at (0, 0.5, 0),
    # srgb(0.8, 0.7, 0.6) — a visible PbrBundle in the reference, a raster-layer
    # entity here (drawn by engine.raster, invisible to the raytracer).
    world.spawn_raster_mesh(
        Transform.from_xyz(0.0, 0.5, 0.0), cube_mesh(1.0),
        StandardMaterial(base_color=(0.8, 0.7, 0.6)),
    )

    # Ground sphere (main.rs:87-103): srgb(0.5,0.5,0.5), metallic 0, default rest.
    world.spawn_sphere(
        Transform.from_xyz(0.0, -1000.0, 0.0),
        RaytracedSphere(radius=1000.0),
        StandardMaterial(base_color=(0.5, 0.5, 0.5), metallic=0.0),
    )

    # Random small spheres (main.rs:105-182). Note the asymmetric ranges:
    # a in -11..=11 (inclusive), b in -11..11 (exclusive) — 23×22 cells.
    for a in range(-grid, grid + 1):
        for b in range(-grid, grid):
            choose_mat = rng.rand()
            center = np.array([a + 0.9 * rng.rand(), 0.2, b + 0.9 * rng.rand()],
                              np.float64)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            t = Transform.from_xyz(*center)
            if choose_mat < 0.8:
                # diffuse: albedo = random^2 componentwise (main.rs:118-124)
                albedo = rng.rand(3) * rng.rand(3)
                mat = StandardMaterial(base_color=tuple(albedo), metallic=0.0)
            elif choose_mat < 0.95:
                # metal (main.rs:137-146)
                albedo = rng.rand(3)
                roughness = rng.rand()
                mat = StandardMaterial(base_color=tuple(albedo), metallic=1.0,
                                       perceptual_roughness=float(roughness))
            else:
                # glass (main.rs:159-166): defaults + ior 1.5 + transmission 1
                mat = StandardMaterial(metallic=0.0, ior=1.5,
                                       specular_transmission=1.0)
            world.spawn_sphere(t, RaytracedSphere(radius=0.2), mat)

    # Three feature spheres (main.rs:184-239).
    world.spawn_sphere(Transform.from_xyz(0.0, 1.0, 0.0), RaytracedSphere(1.0),
                       StandardMaterial(metallic=0.0, ior=1.5, specular_transmission=1.0))
    world.spawn_sphere(Transform.from_xyz(-4.0, 1.0, 0.0), RaytracedSphere(1.0),
                       StandardMaterial(base_color=(0.4, 0.2, 0.1), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(4.0, 1.0, 0.0), RaytracedSphere(1.0),
                       StandardMaterial(base_color=(0.7, 0.6, 0.5), metallic=1.0,
                                        perceptual_roughness=0.0))
    return world


def simple_scene(camera: RaytracedCamera | None = None) -> World:
    """BASELINE config 1: three Lambertian spheres + ground (CPU-runnable)."""
    world = World()
    world.set_camera(
        Transform.from_xyz(0.0, 0.5, 4.0).looking_at((0.0, 0.5, 0.0)),
        PerspectiveProjection(),
        camera or RaytracedCamera(level=Raytracing.PURE, sample_count=4, bounces=8),
    )
    world.spawn_sphere(Transform.from_xyz(0.0, -1000.0, 0.0), RaytracedSphere(1000.0),
                       StandardMaterial(base_color=(0.5, 0.5, 0.5), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(-1.2, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0.8, 0.2, 0.2), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(0.0, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0.2, 0.8, 0.2), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(1.2, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0.2, 0.2, 0.8), metallic=0.0))
    return world


def night_scene(camera: RaytracedCamera | None = None) -> World:
    """Emissive showcase (extension scene): glowing lamp spheres over a dark
    floor — exercises the radiance-accumulation path (BASELINE config 4)."""
    world = World()
    world.set_camera(
        Transform.from_xyz(0.0, 1.5, 7.0).looking_at((0.0, 1.0, 0.0)),
        PerspectiveProjection(),
        camera or RaytracedCamera(level=Raytracing.PURE, sample_count=32,
                                  bounces=6),
    )
    world.spawn_sphere(Transform.from_xyz(0.0, -1000.0, 0.0), RaytracedSphere(1000.0),
                       StandardMaterial(base_color=(0.45, 0.45, 0.5)))
    world.spawn_sphere(Transform.from_xyz(-1.6, 0.8, 0.0), RaytracedSphere(0.8),
                       StandardMaterial(base_color=(0.8, 0.3, 0.2)))
    world.spawn_sphere(Transform.from_xyz(0.2, 0.7, 1.0), RaytracedSphere(0.7),
                       StandardMaterial(base_color=(0.9, 0.9, 0.9), metallic=1.0,
                                        perceptual_roughness=0.05))
    world.spawn_sphere(Transform.from_xyz(1.9, 0.6, -0.4), RaytracedSphere(0.6),
                       StandardMaterial(metallic=0.0, ior=1.5,
                                        specular_transmission=1.0))
    world.spawn_sphere(Transform.from_xyz(0.5, 2.8, -1.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0, 0, 0),
                                        emissive=(6.0, 5.2, 3.8)))
    world.spawn_sphere(Transform.from_xyz(-2.5, 2.2, 1.5), RaytracedSphere(0.3),
                       StandardMaterial(base_color=(0, 0, 0),
                                        emissive=(1.5, 2.5, 6.0)))
    return world


def material_test_scene(camera: RaytracedCamera | None = None) -> World:
    """BASELINE config 2: metal + dielectric materials (fuzz, Schlick refraction)."""
    world = World()
    world.set_camera(
        Transform.from_xyz(0.0, 0.5, 4.0).looking_at((0.0, 0.5, 0.0)),
        PerspectiveProjection(),
        camera or RaytracedCamera(level=Raytracing.PURE, sample_count=16, bounces=8),
    )
    world.spawn_sphere(Transform.from_xyz(0.0, -1000.0, 0.0), RaytracedSphere(1000.0),
                       StandardMaterial(base_color=(0.8, 0.8, 0.0), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(0.0, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0.1, 0.2, 0.5), metallic=0.0))
    world.spawn_sphere(Transform.from_xyz(-1.2, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(metallic=0.0, ior=1.5, specular_transmission=1.0))
    world.spawn_sphere(Transform.from_xyz(1.2, 0.5, 0.0), RaytracedSphere(0.5),
                       StandardMaterial(base_color=(0.8, 0.6, 0.2), metallic=1.0,
                                        perceptual_roughness=0.3))
    return world
