"""Shared numeric constants.

Mirrors the reference's ``assets/shaders/const.wgsl:1-2`` (PI, INF = f32::MAX) plus the
ray-epsilon used by the reference's hit acceptance test (``raytrace.wgsl:353``).
"""

import numpy as np

PI = float(np.pi)

# f32::MAX — the reference uses this as its "miss" sentinel distance (const.wgsl:2).
INF = float(np.finfo(np.float32).max)  # 3.4028235e38

# Minimum accepted hit distance, rejecting self-intersection (raytrace.wgsl:353).
T_MIN = 1e-3

# Near-zero guard for degenerate diffuse scatter directions (raytrace.wgsl:418-421).
NEAR_ZERO = 1e-8
