"""Kind ``still``: the scene's own camera, never moved, a new frame seed a
frame (consecutive 32-bit seeds from one drawn from the run's seed). The
camera's host work is done once, at set-up."""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def frames(params: dict, seed: int, scene: dict):
    """Endless ``(frame_seed, pose, edits)``; a still makes no edits."""
    base = int(np.random.default_rng(seed & (2 ** 64 - 1)).integers(2 ** 32))
    pose = {"eye": tuple(float(x) for x in scene["eye"]),
            "target": tuple(float(x) for x in scene["target"])}
    k = 0
    while True:
        yield (base + k) & M32, pose, ()
        k += 1
