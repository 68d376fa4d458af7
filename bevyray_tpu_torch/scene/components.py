"""Public scene components — the framework's user-facing API surface.

Mirrors the reference's entire public surface (SURVEY.md §1 L2):

- ``Raytracing`` mode enum            (src/raytracing/mod.rs:94-101)
- ``RaytracedCamera``                 (src/raytracing/mod.rs:86-91)
- ``RaytracedSphere``                 (src/raytracing/mod.rs:103-106)
- ``StandardMaterial``                (Bevy's, consumed at extract.rs:196-208)
- ``Transform`` / ``look_at``         (Bevy's, consumed at extract.rs:118-157)
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np


class Raytracing(enum.IntEnum):
    """Per-camera raytrace mode (mod.rs:94-101; consumed at raytrace.wgsl:97-122)."""

    SKIP = 0                 # raster passthrough
    FALLBACK_RASTER = 1      # depth blend; raster wins where rays miss
    FALLBACK_RAYTRACED = 2   # depth blend; raytraced sky wins over raster background
    PURE = 3                 # raytraced only


@dataclasses.dataclass
class RaytracedCamera:
    """Per-camera raytrace config (mod.rs:86-91; defaults from main.rs:66-70).

    ``aperture``/``focus_distance`` add thin-lens defocus blur (extension beyond
    the reference — BASELINE config 4); aperture 0 is an exact pinhole.
    """

    level: Raytracing = Raytracing.FALLBACK_RAYTRACED
    sample_count: int = 4
    bounces: int = 4
    aperture: float = 0.0
    focus_distance: float = 1.0


@dataclasses.dataclass
class RaytracedSphere:
    """Analytic sphere marker (mod.rs:103-106)."""

    radius: float = 1.0


@dataclasses.dataclass
class RaytracedMesh:
    """Triangle-mesh primitive (extension — the reference's own roadmap:
    extract.rs:211-212 plans "transform matrix, triangle_start, triangle_count"
    and a commented-out ModelBVHNode at extract.rs:239-248; BASELINE config 5).

    ``vertices``: [V, 3] float, object space; ``indices``: [T, 3] int.
    """

    vertices: "np.ndarray"
    indices: "np.ndarray"

    @property
    def n_triangles(self) -> int:
        return int(np.asarray(self.indices).shape[0])


def cube_mesh(size: float = 1.0) -> RaytracedMesh:
    """The reference app's rasterized unit cube (main.rs:76-85) as 12 triangles,
    centered at the origin, CCW-outward winding."""
    h = size / 2.0
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([
        [0, 2, 1], [0, 3, 2],   # -z
        [4, 5, 6], [4, 6, 7],   # +z
        [0, 1, 5], [0, 5, 4],   # -y
        [3, 7, 6], [3, 6, 2],   # +y
        [0, 4, 7], [0, 7, 3],   # -x
        [1, 2, 6], [1, 6, 5],   # +x
    ], np.int32)
    return RaytracedMesh(vertices=v, indices=f)


def srgb_to_linear(c: float) -> float:
    """sRGB EOTF, matching Bevy's ``Color::srgb(..).to_linear()`` (extract.rs:201)."""
    if c <= 0.04045:
        return c / 12.92
    return ((c + 0.055) / 1.055) ** 2.4


def srgb_to_linear_np(c: "np.ndarray") -> "np.ndarray":
    """Vectorized ``srgb_to_linear`` (float64 in/out — callers cast to f32
    the same way the scalar path's float32 cast does, so records match the
    per-sphere path bit-for-bit)."""
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


@dataclasses.dataclass
class StandardMaterial:
    """The 6 StandardMaterial-derived fields the renderer consumes (extract.rs:196-208).

    ``base_color`` is in sRGB space (like Bevy's ``Color::srgb``); conversion to
    linear happens at extraction, same as the reference. Defaults match Bevy's
    ``StandardMaterial::default()`` — note perceptual_roughness defaults to 0.5,
    which (faithfully to the reference) perturbs even pure-diffuse lobes
    (raytrace.wgsl:285, SURVEY.md quirk #5).
    """

    base_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    metallic: float = 0.0
    perceptual_roughness: float = 0.5
    reflectance: float = 0.5
    ior: float = 1.5
    specular_transmission: float = 0.0
    # Extension beyond the reference shading model (Bevy's StandardMaterial has
    # `emissive` too, the reference just never reads it): linear-space radiance
    # emitted on hit. (0,0,0) reproduces the reference exactly.
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def to_record(self) -> np.ndarray:
        """11-column float32 record with linearized base color (extract.rs:200-207,
        columns 8-10 = emissive, already linear like Bevy's)."""
        r, g, b = (srgb_to_linear(float(c)) for c in self.base_color)
        return np.array(
            [r, g, b, self.metallic, self.perceptual_roughness, self.reflectance,
             self.ior, self.specular_transmission, *self.emissive],
            np.float32,
        )


@dataclasses.dataclass
class Transform:
    """Transform: translation + orthonormal basis (forward/up) + rotation.

    The reference's camera extraction reads exactly translation(), forward(),
    up() from Bevy's GlobalTransform (extract.rs:130-132) — the forward/up
    fields mirror that. ``rotation`` is a unit quaternion (x, y, z, w — Bevy's
    glam ``Quat`` layout, identity default) applied by MESH entities so
    raster/traced meshes can be arbitrarily posed, like the reference's cube
    could be through the gizmo (main.rs:76-85). Spheres stay translation-only,
    faithfully (extract.rs:173-178).
    """

    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    forward: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)

    @staticmethod
    def from_xyz(x: float, y: float, z: float) -> "Transform":
        return Transform(translation=(x, y, z))

    def with_rotation(self, rotation) -> "Transform":
        """This transform with ``rotation`` (unit quaternion x, y, z, w)."""
        q = np.asarray(rotation, np.float64)
        q = q / np.linalg.norm(q)
        return dataclasses.replace(self, rotation=tuple(float(v) for v in q))

    @staticmethod
    def rotation_axis_angle(axis, angle: float):
        """Unit quaternion (x, y, z, w) for ``angle`` radians about ``axis`` —
        Bevy's ``Quat::from_axis_angle``."""
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        s = math.sin(angle / 2.0)
        return (float(a[0] * s), float(a[1] * s), float(a[2] * s),
                float(math.cos(angle / 2.0)))

    def rotation_matrix(self) -> "np.ndarray":
        """3×3 rotation matrix of ``rotation`` (rows act on column vectors)."""
        x, y, z, w = self.rotation
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float64)

    def apply_points(self, pts: "np.ndarray") -> "np.ndarray":
        """Object-space [N, 3] points → world space (rotate, then translate).
        The identity rotation takes the exact add-only path, so existing
        axis-aligned scenes are bit-identical to the pre-rotation extractor."""
        pts = np.asarray(pts, np.float32)
        if self.rotation != (0.0, 0.0, 0.0, 1.0):
            pts = (pts @ self.rotation_matrix().T.astype(np.float32))
        return pts + np.asarray(self.translation, np.float32)

    def looking_at(self, target, up=(0.0, 1.0, 0.0)) -> "Transform":
        """Bevy ``Transform::looking_at`` semantics: forward towards target, up
        re-orthogonalized against forward."""
        eye = np.asarray(self.translation, np.float64)
        # Degenerate targets (target == eye, up ∥ forward) produce NaN basis
        # vectors here and are rejected downstream with an actionable
        # ValueError (world.camera_state); silence the intermediate divide
        # warnings so the intentional-degenerate tests stay warning-clean.
        with np.errstate(invalid="ignore", divide="ignore"):
            fwd = np.asarray(target, np.float64) - eye
            fwd /= np.linalg.norm(fwd)
            upv = np.asarray(up, np.float64)
            right = np.cross(fwd, upv)
            right /= np.linalg.norm(right)
            true_up = np.cross(right, fwd)
        return Transform(
            translation=tuple(float(v) for v in eye),
            forward=tuple(float(v) for v in fwd),
            up=tuple(float(v) for v in true_up),
            rotation=self.rotation,
        )


@dataclasses.dataclass
class PerspectiveProjection:
    """Bevy ``PerspectiveProjection`` defaults (consumed at extract.rs:120-146)."""

    fov: float = math.pi / 4.0   # vertical FOV, radians
    near: float = 0.1
    far: float = 1000.0
    aspect_ratio: float = 1.0
