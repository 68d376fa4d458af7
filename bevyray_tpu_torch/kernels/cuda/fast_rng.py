"""The fast draw path of the fused kernel: keyed 32-bit words, their
mantissa uniforms and the bit-trick transcendentals of the unit balls.

Plain PyTorch counterpart of ``bevyray_tpu/kernels/pallas/megakernel.py``
:375-571 (``_fast_log2`` ... ``_fast_ball_zphi`` and ``HwRngProvider``); the
CUDA kernel (``csrc/megakernel.cu``) computes the same terms in the same
order. The helpers take and return float32 tensors; bits are reinterpreted
with ``Tensor.view`` and ``_fast_pow2``'s cast truncates toward zero.

**The word generator is the port's own.** The TPU draws its words from its
hardware generator (``pltpu.prng_seed`` / ``prng_random_bits``), which has no
GPU counterpart and which promises only the distribution, with no bit
contract (megakernel.py:470-471). The port keys every word as the exact path
keys its draws: word ``row`` of a (pixel, sample + sample_offset, frame seed)
stream is one PCG step of ``stream ^ (row * 0xC2B2AE35)``, from the same
``stream_init`` word (:mod:`...core.rng`). Rows 0-1 are the jitter, rows 2-3
the lens, and rows ``4 + w*b + k`` bounce b's w words (w = 6, 9 or 13 by
layout). That makes three promises that are stronger than the TPU path's:

(a) the kernel and this plain version agree to the bit;
(b) every (primary, intersect) mode and every block fusion gives the same
    frame, since a word depends on its key alone;
(c) two passes of 8 spp at sample offsets 0 and 8 sum to one 16 spp frame.

The JAX package cannot run its hardware path off the TPU, so no test holds
the two streams against each other: the tests hold the helpers and the
three layouts to JAX's on the same words, and the port's stream to the
statistics of a uniform one.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.vec import Vec3, sqrt

# Layout knobs, as in the JAX kernel (megakernel.py:473, :483): 9 words per
# bounce with the 9-bit spares repacked (13 without), and 6 with the z/phi
# balls.
HW_DRAWS_COMPACT = True
HW_DRAWS_ZPHI = True

RAYGEN_WORDS = 4        # rows 0-1 jitter, 2-3 lens
_MIX2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _f32(x: float) -> float:
    return float(np.float32(x))


_LOG2_SCALE = _f32(1.1920928955078125e-7)
_LOG2_C = [_f32(c) for c in (124.22551499, 1.498030302, 1.72587999,
                             0.3520887068)]
_POW2_C = [_f32(c) for c in (121.2740575, 27.7280233, 4.84252568,
                             1.49012907)]
_TWO23 = _f32(1 << 23)
_LN2 = _f32(0.6931471805599453)
_THIRD = _f32(1.0 / 3.0)
_SIN_C = _f32(0.225)


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x in one IEEE division: a Python float over a tensor would take
    ``x.reciprocal() * c``, which rounds twice."""
    return torch.full_like(x, c) / x


def words_per_bounce() -> int:
    """The layout the module knobs select: 6 (z/phi), 9 (compact) or 13."""
    if not HW_DRAWS_COMPACT:
        return 13
    return 6 if HW_DRAWS_ZPHI else 9


def fast_word(stream: torch.Tensor, row) -> torch.Tensor:
    """Word ``row`` of ``stream`` (u32 words carried in int64, as in
    :mod:`...core.rng`): one PCG step of ``stream ^ (row * 0xC2B2AE35)``."""
    return rng.pcg_step(stream ^ ((row * _MIX2) & _M32))


def mant_uniform(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the top 23 bits of each word (int32 words, or u32 words
    in int64): the mantissa of a float in [1, 2), minus 1 (:517-521)."""
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def u18(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the 9 low bits of two words, the spares that
    :func:`mant_uniform` drops (:550-553)."""
    v = ((bits_a & 0x1FF) << 9) | (bits_b & 0x1FF)
    return ((v << 5) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def fast_log2(x: torch.Tensor) -> torch.Tensor:
    """log2(x) for x > 0, about 1e-4 absolute error (:375-386)."""
    bits = x.view(torch.int32)
    vx = bits.to(torch.float32)
    mx = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    y = vx * _LOG2_SCALE
    c0, c1, c2, c3 = _LOG2_C
    return y - c0 - c1 * mx - _over(c2, c3 + mx)


def fast_pow2(p: torch.Tensor) -> torch.Tensor:
    """2**p, about 1e-4 relative error (:389-404); the fraction comes from a
    truncation toward zero and so does the final cast."""
    neg = p < 0.0
    offset = torch.where(neg, 1.0, 0.0)
    trunc = torch.where(neg, -torch.floor(-p), torch.floor(p))
    z = p - trunc + offset
    c0, c1, c2, c3 = _POW2_C
    v = _TWO23 * (p + c0 + _over(c1, c2 - z) - c3 * z)
    return v.to(torch.int32).view(torch.float32)


def fast_sinpi(x: torch.Tensor) -> torch.Tensor:
    """sin(pi*x) for x in [-1, 1], about 0.1% error (:407-410)."""
    y = 4.0 * x * (1.0 - torch.abs(x))
    return _SIN_C * (y * torch.abs(y) - y) + y


def fast_sin2pi(t: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*t) for t in [0, 1) (:413-416)."""
    return -fast_sinpi(2.0 * t - 1.0)


def fast_cos2pi(t: torch.Tensor) -> torch.Tensor:
    """cos(2*pi*t) for t in [0, 1) (:419-422)."""
    tq = t + 0.25
    tq = tq - torch.floor(tq)
    return fast_sin2pi(tq)


def fast_ball(u1, u2, u3, u4, u5) -> Vec3:
    """Uniform point in the unit ball from 5 uniforms: Box-Muller direction
    and cube-root radius with the fast transcendentals (:428-443); the
    TPU's ``rsqrt`` is ``1 / sqrt``, as the kernel computes it."""
    l1 = fast_log2(torch.clamp(u1, min=1e-9)) * _LN2
    l3 = fast_log2(torch.clamp(u3, min=1e-9)) * _LN2
    r1 = sqrt(-2.0 * l1)
    r3 = sqrt(-2.0 * l3)
    gx = r1 * fast_cos2pi(u2)
    gy = r1 * fast_sin2pi(u2)
    gz = r3 * fast_cos2pi(u4)
    inv_len = 1.0 / sqrt(torch.clamp(gx * gx + gy * gy + gz * gz,
                                     min=1e-20))
    radius = fast_pow2(fast_log2(torch.clamp(u5, min=1e-30)) * _THIRD)
    s = inv_len * radius
    return Vec3(gx * s, gy * s, gz * s)


def fast_ball_zphi(uz, uphi, ur) -> Vec3:
    """Uniform point in the unit ball from 3 uniforms: z uniform in [-1, 1)
    and a uniform azimuth for the direction, cube-root radius (:446-460)."""
    z = 2.0 * uz - 1.0
    s = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    x = s * fast_cos2pi(uphi)
    y = s * fast_sin2pi(uphi)
    radius = fast_pow2(fast_log2(torch.clamp(ur, min=1e-30)) * _THIRD)
    return Vec3(x * radius, y * radius, z * radius)


def scatter_draws(words, layout: int):
    """(u_metal, u_trans, u_reflect, ball1, ball2) of one bounce from its
    ``layout`` words (6, 9 or 13; :535-571), in the JAX kernel's order."""
    u = [mant_uniform(w) for w in words]
    if layout == 13:
        return (u[0], u[1], u[2], fast_ball(*u[3:8]), fast_ball(*u[8:13]))
    if layout == 6:
        return (u[5], u18(words[4], words[5]), u[4],
                fast_ball_zphi(u[0], u[1], u18(words[0], words[1])),
                fast_ball_zphi(u[2], u[3], u18(words[2], words[3])))
    if layout == 9:
        return (u18(words[4], words[5]), u18(words[6], words[7]), u[8],
                fast_ball(*u[0:4], u18(words[0], words[1])),
                fast_ball(*u[4:8], u18(words[2], words[3])))
    raise ValueError(f"layout {layout} must be 6, 9 or 13 words per bounce")


class FastRngProvider:
    """The draws of one (pixel, sample) stream on the fast path: the
    counterpart of ``HwRngProvider`` with keyed words, so that draws may be
    taken in any order and skipped."""

    def __init__(self, stream: torch.Tensor):
        self.stream = stream
        self.layout = words_per_bounce()

    def _uniforms(self, first: int):
        return (mant_uniform(fast_word(self.stream, first)),
                mant_uniform(fast_word(self.stream, first + 1)))

    def jitter(self):
        return self._uniforms(0)

    def lens(self):
        return self._uniforms(2)

    def scatter_draws(self, bounce: int):
        first = RAYGEN_WORDS + self.layout * bounce
        return scatter_draws([fast_word(self.stream, first + k)
                              for k in range(self.layout)], self.layout)
