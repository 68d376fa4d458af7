"""Kind ``orbit``: the flycam pans along a horizontal arc of ``arc_deg``
about the look-at target, centred on the scene's own camera, ``step_deg`` a
frame, back and forth; no edits.

From the seed: the frame seeds' start (consecutive 32-bit seeds from it),
the first sweep's start and each sweep's offset, a fraction of a step, so
that no two frames of a run share a pose (the program keeps the per-camera
work of one camera only). Every seed sweeps the same arc, so every seed
gets the same work in another order.
"""

from __future__ import annotations

import math

import numpy as np

M32 = 0xFFFFFFFF


def frames(params: dict, seed: int, scene: dict):
    """Endless ``(frame_seed, pose, edits)``; a pose is ``{"eye",
    "target"}``."""
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    base = int(rng.integers(2 ** 32))
    target = tuple(float(x) for x in scene["target"])
    arc = math.radians(params["arc_deg"])
    step = math.radians(params["step_deg"])
    n = int(round(params["arc_deg"] / params["step_deg"]))
    rel = np.asarray(scene["eye"], np.float64) - np.asarray(target)
    radius = math.hypot(rel[0], rel[2])
    th0 = math.atan2(rel[2], rel[0])
    start = int(rng.integers(n))
    k, sweep = 0, 0
    while True:
        offset = float(rng.random())
        steps = (range(start, n) if sweep % 2 == 0
                 else range(n - 1 - start, -1, -1))
        for i in steps:
            th = th0 + (i + offset) * step - arc / 2
            eye = (target[0] + radius * math.cos(th), target[1] + rel[1],
                   target[2] + radius * math.sin(th))
            yield (base + k) & M32, {"eye": eye, "target": target}, ()
            k += 1
        start, sweep = 0, sweep + 1
