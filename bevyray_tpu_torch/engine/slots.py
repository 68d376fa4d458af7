"""The RNG draw-slot contract shared by every renderer implementation.

The reference threads a serial RNG through each pixel, so the number of draws a ray
consumes depends on its material history (raytrace.wgsl:234-285). That cannot
vectorize. Instead, every (pixel, sample) gets a counter-based stream
(:mod:`bevyray_tpu_torch.core.rng`) and every bounce owns a fixed window of draw slots.
The JAX renderer, the Pallas kernels, and the NumPy oracle all address this exact
layout, which is what makes their images comparable.

Layout per (pixel, sample) stream::

    slot 0        pixel jitter u      (random_ray_from_uv, wgsl:140)
    slot 1        pixel jitter v
    slot 2        lens sample u       (defocus blur — extension, not in reference)
    slot 3        lens sample v
    bounce b window, base = 4 + 13*b:
      +0          metallic branch test        (wgsl:234)
      +1          transmission branch test    (wgsl:249)
      +2          Schlick reflect test        (wgsl:269)
      +3..+7      unit-ball sample 1          (metal fuzz / diffuse lobe)
      +8..+12     unit-ball sample 2          (diffuse roughness term)
"""

JITTER_U = 0
JITTER_V = 1
LENS_U = 2
LENS_V = 3
RAYGEN_DRAWS = 4

S_METAL = 0
S_TRANS = 1
S_REFLECT = 2
S_BALL1 = 3
S_BALL2 = 8
DRAWS_PER_BOUNCE = 13


def bounce_base(bounce):
    """First slot of bounce ``bounce``'s draw window (int or traced int)."""
    return RAYGEN_DRAWS + DRAWS_PER_BOUNCE * bounce
