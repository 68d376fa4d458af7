#!/usr/bin/env python3
"""K6 ``shade_bounce`` at every bounce of the headline, on one CUDA card.

    python3 tests/torch_shade_probe.py [--config5] [--sweep]

Builds the extension, renders sample 0 of the headline (RTiOW final scene,
1920x1080, 4 bounces, level 3, seed 1) through the wavefront ``Renderer``'s
bounce loop and captures the state and ray test results it hands K6 at
each bounce (``chip_smoke.capture_states``). At each bounce it runs K6's
probe instance against the default instance (bit-equal, or it stops),
times the default instance folding into sums in place (CUDA events, mean
of 20, each call on a fresh copy of its state) beside its bound
(``chip_smoke.shade_bound``) and prints the probe's reading
(``chip_smoke.shade_probe_rows``); ``--config5`` does the same on BASELINE
config 5 (triangles). ``--sweep`` also times K6 at each bounce with each
tile size (``kernels/bounce.py`` ``SHADE_PERS``), each launch held
bit-equal to the plain version. Then it prints the registers and spills that
``nvcc -Xptxas -v`` reports for K6's instances, their occupancy
(``kernels/cuda/wavefront.py`` ``kernel_info``), and the card's kernels
over one 1-spp headline frame (torch's profiler). The last line is a JSON
object of all of it with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def sweep(scene, config, states, card) -> dict:
    """{"bounce b": {"per p": ms}}: K6 folding into sums in place at each
    captured bounce, with tiles of each size, each launch's state and sums
    bit-equal to the plain version's."""
    from bevyray_tpu_torch.kernels import bounce

    out = {}
    for b, (state, t, idx, tt, ti) in sorted(states.items()):
        args = (b, t, idx, tt, ti, scene, config)
        want = chip_smoke.clone_state(state)
        w_sums = chip_smoke.seeded_sums(t.numel(), t.device, b)
        bounce.shade_bounce_reference(want, *args, w_sums, w_sums)
        times = {}
        for per in bounce.SHADE_PERS:
            got = chip_smoke.clone_state(state)
            g_sums = chip_smoke.seeded_sums(t.numel(), t.device, b)

            def launch(st, *a, per=per, sums=g_sums):
                bounce._launch_shade(st, *a, sums, sums, per=per)

            launch(got, *args)
            if not (chip_smoke.state_diff(got, want)[1]
                    and chip_smoke.state_diff(g_sums, w_sums)[1]):
                raise SystemExit(f"K6 per {per} at bounce {b} differs from "
                                 "the plain version")
            times[f"per {per}"] = chip_smoke.shade_ms(launch, state, args,
                                                      chip_smoke.WAVE_REPS)
        out[f"bounce {b}"] = times
        print(f"K6 sweep, bounce {b} (bit-equal to the plain version): "
              f"{json.dumps(times)} | {card}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config5", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_shade_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from bevyray_tpu_torch import RenderConfig, Renderer, rtiow
    from bevyray_tpu_torch.kernels.cuda import build
    from bevyray_tpu_torch.kernels.cuda import wavefront as wavefront_mod

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    build.extension()
    world = rtiow.final_scene(seed=42)
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=1920 / 1080, device=dev)
    headline = RenderConfig(1920, 1080, 16, 4, level=3)
    every = tuple(range(headline.bounces + 1))
    _, states = chip_smoke.capture_states(scene, cam, headline, dev,
                                          bounces=every)
    out = {"card": card, "headline": chip_smoke.shade_probe_rows(
        scene, headline, states, card)}
    if args.sweep:
        out["sweep"] = sweep(scene, headline, states, card)
    del states
    if args.config5:
        world5, config5 = chip_smoke.config5_world()
        cfg5 = dataclasses.replace(config5, intersect_backend="brute")
        scene5 = world5.extract(with_bvh=False, device=dev)
        cam5 = world5.camera_state(aspect=16 / 9, device=dev)
        _, states = chip_smoke.capture_states(scene5, cam5, cfg5, dev,
                                              bounces=every)
        out["config5"] = chip_smoke.shade_probe_rows(scene5, cfg5, states,
                                                     card)
        if args.sweep:
            out["sweep_config5"] = sweep(scene5, cfg5, states, card)
        del states
    out["ptxas"] = chip_smoke.ptxas_usage(chip_smoke.BOUNCE_SOURCE,
                                          ("shade_kernel",))
    info = wavefront_mod.kernel_info(dev, 1)
    out["instances"] = {k: v for k, v in info.items()
                        if k.startswith("shade_bounce")}
    one = Renderer(dataclasses.replace(headline, samples_per_pixel=1))
    kernels, busy, by_name = chip_smoke.profiled(
        lambda: one.render(scene, cam, seed=3))
    out["frame_1spp"] = {"kernels": kernels, "busy_ms": busy,
                         "by_kernel": by_name}
    print(f"ptxas: {json.dumps(out['ptxas'])}", flush=True)
    print(f"instances: {json.dumps(out['instances'])}", flush=True)
    print(f"a 1-spp headline frame: {json.dumps(out['frame_1spp'])}",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
