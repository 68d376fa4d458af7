"""Headline benchmark: RTiOW final scene, 1080p, 16 spp, on one CUDA card.

Counterpart of the JAX repository's ``bench.py``, with the same protocol: a
warm-up frame, 3 settle frames, then 12 timed frames at seeds 1-12 through
``FusedRenderer`` at its defaults (the fast draws, the phase split with the
candidate walk, fuse 4), each ended by ``torch.cuda.synchronize()``.

Prints ONE JSON line with ``bench.py``'s keys: ``value`` is Mrays/s (rays =
the path segments the kernel counted in the timed frames), ``vs_baseline``
that over the 1 Grays/s north star of BASELINE.json, then the p50 frame ms,
the best quartile, the drift and the settle frames. ``bench.py``'s
``vs_family_ceiling_500`` is left out: it divides by 500 Mrays/s, the
ceiling of one family of the TPU kernel, which is no number of this card.
``device`` names the card and its power limit; ``launches`` counts the
kernel's launches in the timed frames and ``timed_rays`` each timed frame's
segments, in seed order.

    python -m bevyray_tpu_torch.bench.headline [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..core.types import RenderConfig, resolve_device
from ..engine.fused_renderer import FusedRenderer
from ..scene import rtiow
from .timing import card_fields, device_arg, launch_count, launches_since, sync


def main(width=1920, height=1080, spp=16, bounces=4, n_frames=12,
         device=None) -> dict:
    """Run the headline and print its JSON line; returns it as a dict."""
    dev = resolve_device(device)
    world = rtiow.final_scene(seed=42)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=width / height, device=dev)
    renderer = FusedRenderer(config)

    # A warm-up frame (the kernel's build and first launch), then 3 settle
    # frames, as bench.py.
    renderer.render(scene, cam, seed=0)
    sync(dev)
    warm = []
    for i in range(3):
        t0 = time.perf_counter()
        renderer.render(scene, cam, seed=100 + i)
        sync(dev)
        warm.append(time.perf_counter() - t0)

    times = []
    rays = []   # per seed: path lengths vary with the seed, so the
    before = launch_count()   # numerator comes from the timed frames
    for i in range(n_frames):
        t0 = time.perf_counter()
        frame = renderer.render(scene, cam, seed=i + 1)
        sync(dev)
        times.append(time.perf_counter() - t0)
        rays.append(int(frame.rays_traced))
    launches = launches_since(before, "headline", dev)

    p50 = float(np.percentile(times, 50))
    rays_per_frame = float(np.mean(rays))
    mrays = rays_per_frame / p50 / 1e6
    half = n_frames // 2
    drift = (float(np.percentile(times[half:], 50))
             / float(np.percentile(times[:half], 50)))
    row = {
        "metric": f"Mrays/sec/chip (RTiOW final scene, {height}p, {spp}spp, "
                  f"{bounces} bounces)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / 1000.0, 4),
        "p50_frame_ms": round(p50 * 1e3, 2),
        "mrays_p25": round(rays_per_frame
                           / float(np.percentile(times, 25)) / 1e6, 2),
        "drift_2nd_half_over_1st": round(drift, 4),
        "warmup_settle_ms": [round(t * 1e3, 1) for t in warm],
        "rays_per_frame": int(rays_per_frame),
        "device": card_fields(dev),
        "n_spheres": world.n_spheres,
        "launches": launches,
        "timed_rays": rays,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main(device=device_arg(__doc__.splitlines()[0]))
    sys.exit(0)
