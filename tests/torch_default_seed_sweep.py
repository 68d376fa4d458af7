"""Frame-seed sweep of the default configuration, the port against the JAX
package on the CPU, for the mismatches that ROADMAP §C logs.

    JAX_PLATFORMS=cpu python tests/torch_default_seed_sweep.py [--seeds 12]

At the settings of ``test_torch_slice.py::test_default_config_matches_pallas_renderer``
(``final_scene(seed=42)``, 64x64, 2 spp, 4 bounces, level 3) it renders each
frame seed with JAX's ``PallasRenderer`` in its default mode and forced to
off/grouped (Pallas interpret mode; compiling the latter takes minutes), and
with the port's ``FusedRenderer`` as it is and with the sphere test's
discriminant ``h*h - a*cc`` rounded once, as a contracted multiply-add rounds
it. Per seed it prints the pixels whose largest channel differs by more than
5e-5, the largest difference and the segment counts.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bevyray_tpu_torch as bt  # noqa: E402
from bevyray_tpu import RenderConfig as JRenderConfig  # noqa: E402
from bevyray_tpu import rtiow as jrtiow  # noqa: E402
from bevyray_tpu.engine.pallas_renderer import PallasRenderer  # noqa: E402
from bevyray_tpu_torch.core.types import scene_from_numpy  # noqa: E402
from bevyray_tpu_torch.core.vec import sqrt  # noqa: E402
from bevyray_tpu_torch.kernels.cuda import megakernel as mk  # noqa: E402

SIZE = dict(width=64, height=64, samples_per_pixel=2, bounces=4, level=3)


def contracted_q(o, d, a, cx, cy, cz, r2):
    """``mk._quadratic_q`` with disc = fma(h, h, -(a*cc)): h*h is exact in
    float64 for float32 h, so one rounding to float32 remains."""
    ocx, ocy, ocz = (c - oc[:, None] for c, oc in ((cx, o.x), (cy, o.y),
                                                   (cz, o.z)))
    h = d.x[:, None] * ocx + d.y[:, None] * ocy + d.z[:, None] * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = (h.double() * h.double() - (a[:, None] * cc).double()).float()
    return h - sqrt(disc)


def off_bar(a, b) -> str:
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return f"{int((diff > 5e-5).sum())} px > 5e-5, max {float(diff.max()):.3g}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args()
    jw = jrtiow.final_scene(seed=42)
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    jax_default = PallasRenderer(JRenderConfig(**SIZE), exact_rng=True)
    jax_off = PallasRenderer(JRenderConfig(
        pallas_primary="off", pallas_intersect="grouped", **SIZE),
        exact_rng=True)
    port = bt.FusedRenderer(bt.RenderConfig(**SIZE))
    plain_q = mk._quadratic_q
    for seed in range(args.seeds):
        want = jax_default.render(js, jcam, seed=seed)
        want_off = jax_off.render(js, jcam, seed=seed)
        got = port.render(ps, pcam, seed=seed)
        mk._quadratic_q = contracted_q
        try:
            got_fma = port.render(ps, pcam, seed=seed)
        finally:
            mk._quadratic_q = plain_q
        print(f"seed {seed}: JAX default vs JAX off/grouped "
              f"{off_bar(want.image, want_off.image)}, segments "
              f"{int(want.rays_traced)} / {int(want_off.rays_traced)} | "
              f"port {port.last_mode} vs JAX default "
              f"{off_bar(got.image, want.image)}, segments "
              f"{int(got.rays_traced)} | port with contracted disc "
              f"{off_bar(got_fma.image, want.image)}, segments "
              f"{int(got_fma.rays_traced)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
