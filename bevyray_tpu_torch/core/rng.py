"""Counter-based random numbers over torch tensors.

Counterpart of ``bevyray_tpu/core/rng.py``: the reference's serial PCG hash
(``random.wgsl:8-15``) and the stateless streams built from it, where each draw
is ``hash(stream, slot)`` for a fixed slot layout (:mod:`..engine.slots`). No
global generator is involved: a draw is a pure function of (pixel, sample,
frame seed, slot), so the port, the JAX package and the CUDA kernel consume the
same uniforms.

Torch has no complete uint32 arithmetic and ``>>`` on int32 is arithmetic, so a
u32 word is carried in an int64 tensor and masked with ``& 0xFFFFFFFF`` after
every add and multiply. A product of two u32 words can pass 2^63, but int64
multiplication wraps mod 2^64, so the low 32 bits stay right.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import PI
from .vec import Vec3, sqrt

_M32 = 0xFFFFFFFF

# 2^-32 (exact in f32): ``f32(state) / f32(0xffffffff)`` is exactly this scale,
# because f32(0xffffffff) rounds up to 2^32 (random.wgsl:5).
_INV_2POW32 = float(np.float32(1.0 / 4294967296.0))

# Mixing constants for the counter-based streams (splitmix64 / murmur3 fractions).
_GOLD = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35

# float32 constants of the ball sampler, rounded exactly as the JAX package's.
TWO_PI = float(np.float32(2.0 * PI))
THIRD = float(np.float32(1.0 / 3.0))


def pcg_step(state: torch.Tensor) -> torch.Tensor:
    """One PCG advance+output, bit-exact vs ``random.wgsl:8-15``."""
    old = (state + (747796405 + 2891336453)) & _M32
    word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & _M32
    return (word >> 22) ^ word


def to_float01(state: torch.Tensor) -> torch.Tensor:
    """u32 -> f32 in [0, 1): ``f32(state) * 2^-32`` (random.wgsl:3-6).

    The int64 -> f32 cast rounds once to nearest, exactly like the reference's
    u32 -> f32 conversion; the scale by 2^-32 is exact.
    """
    return state.to(torch.float32) * _INV_2POW32


def stream_init(pixel_id, sample_index, frame_seed) -> torch.Tensor:
    """The stream word of one (pixel, sample, frame); all arguments u32 words."""
    base = (((pixel_id * _GOLD) & _M32) ^ ((sample_index * _MIX1) & _M32)
            ^ frame_seed)
    return pcg_step(pcg_step(base))


def draw(stream: torch.Tensor, slot) -> torch.Tensor:
    """Uniform f32 in [0,1) for draw-slot ``slot`` of ``stream``."""
    return to_float01(pcg_step(pcg_step(stream ^ ((slot * _MIX2) & _M32))))


BALL_DRAWS = 5


def unit_ball_from_uniforms(u1, u2, u3, u4, u5) -> Vec3:
    """Uniform point in the unit ball from 5 uniforms (float32 tensors).

    Box-Muller Gaussian direction times a cube-root radius taken as
    ``exp(log(u)/3)``, the formula every renderer of the JAX package shares.
    """
    u1 = torch.clamp(u1, min=1e-10)
    u3 = torch.clamp(u3, min=1e-10)
    r1 = sqrt(-2.0 * torch.log(u1))
    r3 = sqrt(-2.0 * torch.log(u3))
    g = Vec3(r1 * torch.cos(TWO_PI * u2), r1 * torch.sin(TWO_PI * u2),
             r3 * torch.cos(TWO_PI * u4))
    inv_len = 1.0 / torch.clamp(g.length(), min=1e-20)
    radius = torch.exp(torch.log(torch.clamp(u5, min=1e-30)) * THIRD)
    return g.scale(inv_len * radius)
