"""Structure-of-arrays 3-vector math over torch tensors.

Counterpart of ``bevyray_tpu/core/vec.py``: each component is its own tensor,
so every vector op is a plain elementwise op. Operation order matches the JAX
package term for term (``a.x*b.x + a.y*b.y + a.z*b.z``, left to right), which
keeps the port's float32 results comparable with the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on any device, the CUDA kernels'
    ``sqrtf`` and XLA's: torch's CPU float32 ``sqrt`` is not (1 ulp off on
    0.6% to 17% of inputs, by CPU), a float64 ``sqrt`` rounded to float32
    is, and torch's CUDA one is already."""
    if x.dtype != torch.float32 or x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


class Vec3(NamedTuple):
    """Three same-shaped tensors acting as a batch of 3D vectors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def splat(v: Scalar, device=None) -> "Vec3":
        # A Python number is filled in on the device: a copy from the host
        # would wait for the work queued there.
        if isinstance(v, torch.Tensor):
            v = v.to(dtype=torch.float32, device=device)
        else:
            v = torch.full((), float(v), dtype=torch.float32, device=device)
        return Vec3(v, v, v)

    @staticmethod
    def full(shape, x: float, y: float, z: float, device=None,
             dtype=torch.float32) -> "Vec3":
        return Vec3(torch.full(shape, x, dtype=dtype, device=device),
                    torch.full(shape, y, dtype=dtype, device=device),
                    torch.full(shape, z, dtype=dtype, device=device))

    # -- arithmetic -------------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o: Union["Vec3", Scalar]) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def scale(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    # -- geometry ---------------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def length_squared(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return sqrt(self.length_squared())

    def normalize(self) -> "Vec3":
        # v * (1 / sqrt(|v|^2)), the CUDA kernel's form (zero vectors give
        # inf/nan). torch.rsqrt is not that on either device: on the card it
        # is the approximate rsqrtf, on the CPU its vector path rounds
        # otherwise in a few elements in a thousand.
        return self.scale(1.0 / sqrt(self.length_squared()))

    @staticmethod
    def where(mask: torch.Tensor, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, a.x, b.x),
                    torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection, ``raytrace.wgsl:400-402``: v - 2 (v.n) n."""
    return v - n.scale(2.0 * v.dot(n))


def refract(v: Vec3, n: Vec3, etai_over_etat: Scalar) -> Vec3:
    """Snell refraction, ``raytrace.wgsl:404-409``. ``v`` must be unit-length."""
    cos_theta = torch.clamp((-v).dot(n), max=1.0)
    r_out_perp = (v + n.scale(cos_theta)).scale(etai_over_etat)
    r_out_parallel = n.scale(
        -sqrt(torch.abs(1.0 - r_out_perp.length_squared())))
    return r_out_perp + r_out_parallel


def schlick_reflectance(cosine: torch.Tensor,
                        refraction_index: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation, ``raytrace.wgsl:411-416``."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    p5 = one_minus * one_minus
    p5 = p5 * p5 * one_minus
    return r0 + (1.0 - r0) * p5
