"""Kind ``edit``: a gizmo drag a frame at the scene's own camera. Each frame
moves one sphere, drawn from the seed among all but the ground
(``first_sphere`` on), to a spot drawn uniformly over ``x`` and ``z`` at
height ``y``; the program re-extracts its scene before the frame."""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def frames(params: dict, seed: int, scene: dict):
    """Endless ``(frame_seed, pose, edits)``; an edit is ``(sphere index,
    "center", (x, y, z))``."""
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    base = int(rng.integers(2 ** 32))
    pose = {"eye": tuple(float(x) for x in scene["eye"]),
            "target": tuple(float(x) for x in scene["target"])}
    n = len(scene["radii"])
    (x0, x1), (z0, z1) = params["x"], params["z"]
    k = 0
    while True:
        index = int(rng.integers(params["first_sphere"], n))
        center = (float(rng.uniform(x0, x1)), float(params["y"]),
                  float(rng.uniform(z0, z1)))
        yield (base + k) & M32, pose, ((index, "center", center),)
        k += 1
