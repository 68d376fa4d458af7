"""The two draw paths of a (pixel, sample, frame) stream, worked out anew.

Both key every draw by the stream word of bevyray's counter-based PCG
(``random.wgsl:8-15``): ``stream = pcg(pcg((pixel * GOLD) ^ (sample * MIX1)
^ frame_seed))``. u32 words ride in int64 tensors, masked after each add and
multiply (int64 products wrap mod 2^64, so the low 32 bits stay right).

- **exact**: draw ``slot`` is ``f32(pcg(pcg(stream ^ slot * MIX2))) * 2^-32``
  in the slot layout of four ray-generation slots (0-1 the jitter, 2-3 the
  lens) and 13 a bounce (3 branch tests, two balls of 5), with Box-Muller
  balls, the lens's angle and a cube-root radius from the C library's
  ``log``/``cos``/``sin``/``exp``.
- **fast**: word ``row`` is one ``pcg(stream ^ row * MIX2)``; rows 0-1 are
  the jitter, 2-3 the lens, and bounce b owns rows ``4 + 6 b .. 9 + 6 b``:
  uniforms from the words' top 23 bits, 18-bit uniforms from their spare
  low bits, and balls drawn as a uniform z, an azimuth and a cube-root
  radius through bit-trick ``log2``/``pow2`` and a parabolic ``sin``, which
  turns the lens's angle too.

Each path's ``lens()`` gives the lens's radial uniform and the cosine and
sine of its angle, ``2 pi`` times the second lens draw.

Every value is float32, whatever precision the caller traces in.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_GOLD, _MIX1, _MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_INV_2POW32 = float(np.float32(2.0 ** -32))
_TWO_PI = float(np.float32(2.0 * np.pi))
_THIRD = float(np.float32(1.0 / 3.0))

RAYGEN_SLOTS = 4
EXACT_SLOTS_PER_BOUNCE = 13
FAST_WORDS_PER_BOUNCE = 6


def _f(x: float) -> float:
    return float(np.float32(x))


def pcg(state: torch.Tensor) -> torch.Tensor:
    old = (state + (747796405 + 2891336453)) & M32
    word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & M32
    return (word >> 22) ^ word


def stream_words(pixel: torch.Tensor, sample,
                 frame_seed: int) -> torch.Tensor:
    """The stream word of each (pixel, sample): ``sample`` an int, or a
    tensor of one a pixel."""
    base = (((pixel * _GOLD) & M32) ^ ((sample * _MIX1) & M32)
            ^ (frame_seed & M32))
    return pcg(pcg(base))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (torch's CPU float32
    ``sqrt`` is 1 ulp off on some inputs)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


# -- exact ---------------------------------------------------------------------
def exact_draw(stream: torch.Tensor, slot: int) -> torch.Tensor:
    word = pcg(pcg(stream ^ ((slot * _MIX2) & M32)))
    return word.to(torch.float32) * _INV_2POW32


def exact_ball(stream: torch.Tensor, first: int):
    u1, u2, u3, u4, u5 = (exact_draw(stream, first + k) for k in range(5))
    r1 = sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    r3 = sqrt(-2.0 * torch.log(torch.clamp(u3, min=1e-10)))
    gx = r1 * torch.cos(_TWO_PI * u2)
    gy = r1 * torch.sin(_TWO_PI * u2)
    gz = r3 * torch.cos(_TWO_PI * u4)
    inv_len = 1.0 / torch.clamp(sqrt(gx * gx + gy * gy + gz * gz), min=1e-20)
    radius = torch.exp(torch.log(torch.clamp(u5, min=1e-30)) * _THIRD)
    s = inv_len * radius
    return gx * s, gy * s, gz * s


class ExactDraws:
    def __init__(self, stream: torch.Tensor):
        self.stream = stream

    def select(self, rows: torch.Tensor) -> "ExactDraws":
        return ExactDraws(self.stream[rows])

    def jitter(self):
        return exact_draw(self.stream, 0), exact_draw(self.stream, 1)

    def lens(self):
        theta = _TWO_PI * exact_draw(self.stream, 3)
        return exact_draw(self.stream, 2), torch.cos(theta), torch.sin(theta)

    def bounce(self, b: int):
        """(u_metal, u_trans, u_reflect, ball1, ball2) of bounce ``b``."""
        base = RAYGEN_SLOTS + EXACT_SLOTS_PER_BOUNCE * b
        return (exact_draw(self.stream, base), exact_draw(self.stream, base + 1),
                exact_draw(self.stream, base + 2),
                exact_ball(self.stream, base + 3),
                exact_ball(self.stream, base + 8))


# -- fast ----------------------------------------------------------------------
_LOG2_C = [_f(c) for c in (124.22551499, 1.498030302, 1.72587999,
                           0.3520887068)]
_POW2_C = [_f(c) for c in (121.2740575, 27.7280233, 4.84252568, 1.49012907)]


def over(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` in one IEEE division (a float over a tensor is computed as
    ``x.reciprocal() * c``, which rounds twice)."""
    return torch.full_like(x, c) / x


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def fast_word(stream: torch.Tensor, row: int) -> torch.Tensor:
    return pcg(stream ^ ((row * _MIX2) & M32))


def mantissa_uniform(word: torch.Tensor) -> torch.Tensor:
    return _as_f32(((word >> 9) & 0x7FFFFF) | 0x3F800000) - 1.0


def spare_uniform(word_a: torch.Tensor, word_b: torch.Tensor) -> torch.Tensor:
    v = ((word_a & 0x1FF) << 9) | (word_b & 0x1FF)
    return _as_f32((v << 5) | 0x3F800000) - 1.0


def log2_approx(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    y = bits.to(torch.float32) * _f(1.1920928955078125e-7)
    mx = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    c0, c1, c2, c3 = _LOG2_C
    return y - c0 - c1 * mx - over(c2, c3 + mx)


def pow2_approx(p: torch.Tensor) -> torch.Tensor:
    neg = p < 0.0
    whole = torch.where(neg, -torch.floor(-p), torch.floor(p))
    z = p - whole + torch.where(neg, 1.0, 0.0)
    c0, c1, c2, c3 = _POW2_C
    v = _f(2.0 ** 23) * (p + c0 + over(c1, c2 - z) - c3 * z)
    return v.to(torch.int32).view(torch.float32)


def sin_pi_approx(x: torch.Tensor) -> torch.Tensor:
    y = 4.0 * x * (1.0 - torch.abs(x))
    return _f(0.225) * (y * torch.abs(y) - y) + y


def sin_2pi_approx(t: torch.Tensor) -> torch.Tensor:
    return -sin_pi_approx(2.0 * t - 1.0)


def cos_2pi_approx(t: torch.Tensor) -> torch.Tensor:
    tq = t + 0.25
    return sin_2pi_approx(tq - torch.floor(tq))


def zphi_ball(uz, uphi, ur):
    z = 2.0 * uz - 1.0
    s = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    x = s * cos_2pi_approx(uphi)
    y = s * sin_2pi_approx(uphi)
    radius = pow2_approx(log2_approx(torch.clamp(ur, min=1e-30)) * _THIRD)
    return x * radius, y * radius, z * radius


class FastDraws:
    def __init__(self, stream: torch.Tensor):
        self.stream = stream

    def select(self, rows: torch.Tensor) -> "FastDraws":
        return FastDraws(self.stream[rows])

    def jitter(self):
        return (mantissa_uniform(fast_word(self.stream, 0)),
                mantissa_uniform(fast_word(self.stream, 1)))

    def lens(self):
        angle = mantissa_uniform(fast_word(self.stream, 3))
        return (mantissa_uniform(fast_word(self.stream, 2)),
                cos_2pi_approx(angle), sin_2pi_approx(angle))

    def bounce(self, b: int):
        first = RAYGEN_SLOTS + FAST_WORDS_PER_BOUNCE * b
        w = [fast_word(self.stream, first + k) for k in range(6)]
        u = [mantissa_uniform(x) for x in w]
        return (u[5], spare_uniform(w[4], w[5]), u[4],
                zphi_ball(u[0], u[1], spare_uniform(w[0], w[1])),
                zphi_ball(u[2], u[3], spare_uniform(w[2], w[3])))


DRAWS = {"exact": ExactDraws, "fast": FastDraws}
