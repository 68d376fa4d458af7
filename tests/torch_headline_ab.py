#!/usr/bin/env python3
"""Headline frame time of two trees of the port on one CUDA card, in turns.

    python3 tests/torch_headline_ab.py OTHER_TREE [--frames 5] [--exact-rng]
                                      [--phase-fuse N]

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). In separate processes, in the order other, this, this, other, each
arm builds its tree's CUDA kernel (into that tree's ``build/torch_ext/``),
renders the default-config headline frame through ``FusedRenderer`` (RTiOW
final scene, 1920x1080, 16 spp, 4 bounces, level 3) once to warm up, then
``--frames`` frames with seeds 1, 2, ..., and prints its p50 ms and segments
per frame as JSON. ``--exact-rng`` passes ``exact_rng=True`` to both trees'
renderers, which holds the exact PCG path of a tree whose default draws
from the fast path against an older tree's. ``--phase-fuse N`` sets the
block fusion ``PHASE_FUSE`` of both trees' kernels (a tree from before its
port has none and ignores it), which holds the draw path of a tree that
fuses by default against an older tree's unfused kernel. The last lines
give the card (name, power limit) and each tree's runs. Needs one CUDA
card; the two trees must share the public API.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ARM = """
import json, sys, time
sys.path.insert(0, ".")
import torch
from bevyray_tpu_torch import FusedRenderer, RenderConfig, rtiow
from bevyray_tpu_torch.kernels.cuda import build, megakernel
{fuse}
t0 = time.perf_counter()
build.extension()
build_s = time.perf_counter() - t0
world = rtiow.final_scene(seed=42)
scene = world.extract(with_bvh=False)
cam = world.camera_state(aspect=1920 / 1080)
renderer = FusedRenderer(RenderConfig(1920, 1080, 16, 4, level=3){rng})
renderer.render(scene, cam, seed=0)
torch.cuda.synchronize()
times, segments = [], []
for i in range({frames}):
    t0 = time.perf_counter()
    frame = renderer.render(scene, cam, seed=i + 1)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    segments.append(int(frame.rays_traced))
print(json.dumps({{"p50_ms": sorted(times)[len(times) // 2], "ms": times,
                  "segments": segments, "mode": renderer.last_mode,
                  "fuse": getattr(renderer, "last_fuse", 1),
                  "exact_rng": getattr(renderer, "last_exact_rng",
                                       renderer.exact_rng),
                  "build_s": build_s}}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--exact-rng", action="store_true")
    parser.add_argument("--phase-fuse", type=int)
    args = parser.parse_args()
    other = args.other.resolve()
    if not (other / "bevyray_tpu_torch").is_dir():
        print(f"torch_headline_ab: no port in {other}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = {"other": [], "this": []}
    for arm, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        out = subprocess.run([sys.executable, "-c",
                              ARM.format(frames=args.frames, rng=(
                                  ", exact_rng=True" if args.exact_rng
                                  else ""), fuse=(
                                  f"megakernel.PHASE_FUSE = {args.phase_fuse}"
                                  if args.phase_fuse else ""))], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        result = json.loads(out.stdout.strip().splitlines()[-1])
        runs[arm].append(result)
        print(f"{arm} ({tree}): {json.dumps(result)}", flush=True)
    print(f"card: {card}")
    print(json.dumps({arm: [r["p50_ms"] for r in rs]
                      for arm, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
