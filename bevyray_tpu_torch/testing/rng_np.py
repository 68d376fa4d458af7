"""uint32 NumPy forms of the counter-based PCG draws, for the oracle.

Counterpart of the NumPy half of ``bevyray_tpu/core/rng.py`` (``pcg_step``,
``to_float01``, ``stream_init``, ``draw`` and ``unit_ball_from_uniforms_np``),
copied so that the oracle imports nothing of the JAX package. The port's own
:mod:`..core.rng` carries u32 words in int64 torch tensors; this module keeps
them in NumPy ``uint32``, which wraps on overflow, with no torch at all, so
that the oracle shares no arithmetic with the renderers it checks.

Draw ``slot`` of a (pixel, sample, frame) stream is
``pcg(pcg(stream ^ slot * MIX2))`` mapped to ``[0, 1)`` by a scale of 2^-32
(``random.wgsl:3-15``); the slot layout is :mod:`..engine.slots`.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import PI

# 1 / 2^32 as float32: f32(0xffffffff) rounds up to 2^32, so the WGSL divide
# ``f32(state) / f32(0xffffffffu)`` is exactly a scale by 2^-32 (random.wgsl:5).
_INV_2POW32 = np.float32(1.0 / 4294967296.0)

# Mixing constants for the counter-based streams (splitmix64 / murmur3 fractions).
_GOLD = np.uint32(0x9E3779B9)
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)


def pcg_step(state):
    """One PCG advance+output on uint32 arrays or scalars, bit-exact vs
    ``random.wgsl:8-15``."""
    old = state + np.uint32(747796405) + np.uint32(2891336453)
    word = ((old >> ((old >> np.uint32(28)) + np.uint32(4))) ^ old) * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def to_float01(state):
    """u32 -> f32 in [0, 1): ``f32(state) * 2^-32`` (random.wgsl:3-6)."""
    return state.astype(np.float32) * _INV_2POW32


def stream_init(pixel_id, sample_index, frame_seed):
    """The stream word of one (pixel, sample, frame); all arguments uint32.
    Double PCG application gives full avalanche over the linearly combined
    inputs."""
    base = (pixel_id * _GOLD) ^ (sample_index * _MIX1) ^ frame_seed
    return pcg_step(pcg_step(base))


def draw(stream, slot):
    """Uniform f32 in [0,1) for draw-slot ``slot`` of ``stream`` (no state
    carried)."""
    with np.errstate(over="ignore"):   # uint32 wraparound is the point
        mixed = pcg_step(pcg_step(stream ^ (_as_u32(slot) * _MIX2)))
    return to_float01(mixed)


def _as_u32(v):
    if isinstance(v, (int, np.integer)):
        return np.uint32(v)
    return v


def unit_ball_from_uniforms_np(u1, u2, u3, u4, u5):
    """Uniform point in the unit ball from 5 uniforms, as an ``(..., 3)``
    float32 array: a Box-Muller Gaussian direction times a cube-root radius
    taken as ``exp(log(u) / 3)``, formula for formula the renderers' own."""
    u1 = np.maximum(np.float32(u1), np.float32(1e-10))
    u3 = np.maximum(np.float32(u3), np.float32(1e-10))
    r1 = np.sqrt(np.float32(-2.0) * np.log(u1))
    r3 = np.sqrt(np.float32(-2.0) * np.log(u3))
    two_pi = np.float32(2.0 * PI)
    gx = r1 * np.cos(two_pi * np.float32(u2))
    gy = r1 * np.sin(two_pi * np.float32(u2))
    gz = r3 * np.cos(two_pi * np.float32(u4))
    g = np.stack([gx, gy, gz], axis=-1).astype(np.float32)
    length = np.sqrt((g * g).sum(-1, keepdims=True)).astype(np.float32)
    inv_len = np.float32(1.0) / np.maximum(length, np.float32(1e-20))
    radius = np.exp(np.log(np.maximum(np.float32(u5), np.float32(1e-30)))
                    * np.float32(1.0 / 3.0))[..., None].astype(np.float32)
    return (g * inv_len * radius).astype(np.float32)
