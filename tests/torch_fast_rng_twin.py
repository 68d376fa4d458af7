#!/usr/bin/env python3
"""CPU twin of chip_smoke.py phase 7(d): the fast frame against the exact
frame of the same seed, both through the plain PyTorch version.

    python3 tests/torch_fast_rng_twin.py [--sizes 240x136 480x270]

Renders the RTiOW final scene (16 spp, 4 bounces, level 3, default knobs)
at each size with ``exact_rng=False`` and ``exact_rng=True`` on the CPU and
prints the two image means, the mean |d| per pixel and after an 8x8 box
filter (the statistic whose bar phase 7(d) sets from these figures), and
the segment counts. About 20 s at 240x136 and 80 s at 480x270 on four
threads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", nargs="+", default=["240x136", "480x270"])
    args = parser.parse_args()
    import torch

    import bevyray_tpu_torch as bt

    torch.set_num_threads(4)
    world = bt.rtiow.final_scene(seed=42)
    scene = world.extract(with_bvh=False, device="cpu")
    for size in args.sizes:
        width, height = map(int, size.split("x"))
        cam = world.camera_state(aspect=width / height, device="cpu")
        config = bt.RenderConfig(width, height, 16, 4, level=3)
        t0 = time.perf_counter()
        fast = bt.FusedRenderer(config, exact_rng=False).render(scene, cam,
                                                                seed=1)
        exact = bt.FusedRenderer(config, exact_rng=True).render(scene, cam,
                                                                seed=1)
        h, w = (height // 8) * 8, (width // 8) * 8

        def box(img):
            return img[:h, :w].reshape(h // 8, 8, w // 8, 8, 3).mean(
                dim=(1, 3))

        print(json.dumps({
            "size": size, "mean_fast": float(fast.image.mean()),
            "mean_exact": float(exact.image.mean()),
            "pixel_mean_abs": float((fast.image - exact.image).abs().mean()),
            "box8_mean_abs": float((box(fast.image)
                                    - box(exact.image)).abs().mean()),
            "segments": [int(fast.rays_traced), int(exact.rays_traced)],
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
