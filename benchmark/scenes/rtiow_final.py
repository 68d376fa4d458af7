"""The RTiOW final scene as bevyray's app builds it, frozen as NumPy arrays.

bevyray ``src/main.rs:49-240``: a ground sphere of radius 1000, a 22 x 22
jittered grid of 0.2-radius spheres (a in -11..=11, b in -11..11, skipped
within 0.9 of (4, 0.2, 0)) whose material is diffuse, metal or glass at
0.8 / 0.15 / 0.05, three feature spheres, and the rasterized unit cube of
main.rs:76-85. The app draws with an unseeded ``rand::random``; this copy
draws from ``numpy.random.RandomState(scene_seed)`` in the app's order per
cell (choose_mat, the two jitters, then the material's numbers), so that
seed 42 gives 508 spheres.

The arrays are handed to the program through its public scene API and to
the reference as they are, so a later change to the program's own scene
generators moves neither side.
"""

from __future__ import annotations

import numpy as np

# Bevy's StandardMaterial defaults for the columns the renderer reads.
_DEFAULT = dict(base_color=(1.0, 1.0, 1.0), metallic=0.0,
                perceptual_roughness=0.5, reflectance=0.5, ior=1.5,
                specular_transmission=0.0, emissive=(0.0, 0.0, 0.0))
MATERIAL_COLUMNS = ("r", "g", "b", "metallic", "perceptual_roughness",
                    "reflectance", "ior", "specular_transmission",
                    "emissive_r", "emissive_g", "emissive_b")


def _material(**kw) -> list:
    m = dict(_DEFAULT, **kw)
    return [*m["base_color"], m["metallic"], m["perceptual_roughness"],
            m["reflectance"], m["ior"], m["specular_transmission"],
            *m["emissive"]]


def _cube(size: float):
    """The unit cuboid as 8 corners and 12 outward-wound triangles."""
    h = size / 2.0
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                  [0, 1, 5], [0, 5, 4], [3, 7, 6], [3, 6, 2],
                  [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]], np.int32)
    return v, f


def build(scene_seed: int = 42) -> dict:
    """The scene as arrays.

    ``centers`` [N, 3] and ``radii`` [N] float64, ``materials`` [N, 11]
    float64 in :data:`MATERIAL_COLUMNS` order with the base colour in sRGB
    (as Bevy's ``Color::srgb`` takes it); ``raster_meshes``: a list of
    (translation, vertices [V, 3], indices [T, 3], material [11]); the
    camera's eye and target and its projection (main.rs:55-73).
    """
    rng = np.random.RandomState(scene_seed)
    centers = [(0.0, -1000.0, 0.0)]
    radii = [1000.0]
    mats = [_material(base_color=(0.5, 0.5, 0.5))]
    for a in range(-11, 12):
        for b in range(-11, 11):
            choose_mat = rng.rand()
            center = np.array([a + 0.9 * rng.rand(), 0.2, b + 0.9 * rng.rand()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.rand(3) * rng.rand(3)
                mat = _material(base_color=tuple(albedo))
            elif choose_mat < 0.95:
                albedo = rng.rand(3)
                mat = _material(base_color=tuple(albedo), metallic=1.0,
                                perceptual_roughness=float(rng.rand()))
            else:
                mat = _material(specular_transmission=1.0)
            centers.append(tuple(float(c) for c in center))
            radii.append(0.2)
            mats.append(mat)
    for center, mat in (
            ((0.0, 1.0, 0.0), _material(specular_transmission=1.0)),
            ((-4.0, 1.0, 0.0), _material(base_color=(0.4, 0.2, 0.1))),
            ((4.0, 1.0, 0.0), _material(base_color=(0.7, 0.6, 0.5),
                                        metallic=1.0,
                                        perceptual_roughness=0.0))):
        centers.append(center)
        radii.append(1.0)
        mats.append(mat)
    vertices, indices = _cube(1.0)
    return {
        "centers": np.asarray(centers, np.float64),
        "radii": np.asarray(radii, np.float64),
        "materials": np.asarray(mats, np.float64),
        "raster_meshes": [((0.0, 0.5, 0.0), vertices, indices,
                           np.asarray(_material(base_color=(0.8, 0.7, 0.6)),
                                      np.float64))],
        "eye": (0.0, 0.0, 5.0),
        "target": (0.0, 0.0, 0.0),
        "fov": float(np.pi / 4.0),
        "near": 0.1,
        "far": 1000.0,
    }
