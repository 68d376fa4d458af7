"""The book's own final render: Shirley, Black and Hollasch, *Ray Tracing in
One Weekend* v4, section 14.1 "A Final Render" (raytracing.github.io).

The spheres, materials and raster cube are :mod:`rtiow_final`'s, unchanged:
bevyray's build of the book's final scene, 508 spheres from seed 42. Only
the camera is the book's: ``lookfrom`` (13, 2, 3), ``lookat`` the origin,
``vfov`` 20 degrees (the vertical fov, as ``PerspectiveProjection`` takes
it), and ``defocus_angle`` 0.6 degrees at ``focus_dist`` 10, which is a
lens of diameter 2 * 10 * tan(0.3 degrees).

Departures from the book:

- the focus is the pinhole ray's point at ``focus_distance`` (the program's
  thin lens), where the book focuses on a plane at that distance;
- bevyray's Bevy materials, scatter and per-sample gamma stand in for the
  book's Lambertian, metal fuzz and dielectric;
- the spheres are bevyray's build from seed 42, not the book's own random
  draws, and the raster cube is in the scene but unseen at level 3.
"""

from __future__ import annotations

import math

from scenes import rtiow_final

EYE = (13.0, 2.0, 3.0)
TARGET = (0.0, 0.0, 0.0)
VFOV_DEG = 20.0
DEFOCUS_ANGLE_DEG = 0.6
FOCUS_DISTANCE = 10.0


def build(scene_seed: int = 42) -> dict:
    """:func:`rtiow_final.build`'s arrays with the book's camera and lens
    (``aperture``, the lens's diameter, and ``focus_distance``)."""
    scene = rtiow_final.build(scene_seed)
    scene.update(
        eye=EYE, target=TARGET, fov=math.radians(VFOV_DEG),
        aperture=2.0 * FOCUS_DISTANCE * math.tan(
            math.radians(DEFOCUS_ANGLE_DEG / 2.0)),
        focus_distance=FOCUS_DISTANCE)
    return scene
