"""How far each package's CPU renderers sit from the NumPy oracle on the
frames of ``chip_smoke.py`` phase 11, for PERF.md and ROADMAP §C.

    JAX_PLATFORMS=cpu python tests/torch_oracle_distance.py

For each of phase 11's frames (the final scene at 192x108, 4 spp; the mesh,
hollow-glass, kitchen-sink and level-1 cube frames of the JAX golden tests;
4,971 spheres at 64x36, 2 spp) it renders with JAX's ``Renderer`` (XLA on the
CPU, which contracts multiply-adds) and, on the CPU, with the port's
``Renderer`` and its ``FusedRenderer(exact_rng=True)`` (the kernel's plain
version), and prints per renderer the image max and mean |d| from the oracle,
the share of pixels past 5e-3 with the first of them, and the depth max |d|:
the lines phase 11 prints on the card. Levels 1 and 2 give each renderer's
own raster buffers to the oracle. The oracle is the port's
(``bevyray_tpu_torch/testing/oracle.py``), bit-equal to JAX's. About a
minute on a CPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bevyray_tpu as jb  # noqa: E402
import bevyray_tpu_torch as bt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from bevyray_tpu.engine.raster import raster_layer as jraster  # noqa: E402
from bevyray_tpu_torch.engine.raster import raster_layer  # noqa: E402


def frames():
    """(label, scene function, frame, options, JAX backends, port renderers)
    for each of phase 11's checks (a)-(f)."""
    final = lambda pkg: pkg.rtiow.final_scene(seed=42)  # noqa: E731
    big = lambda pkg: pkg.rtiow.final_scene(seed=42, grid=cs.BIG_GRID)  # noqa: E731
    golden = lambda name: lambda pkg: cs.golden_world(pkg, name)  # noqa: E731
    lens = dict(defocus=True, diffuse_sampling="cosine")
    return [("(a) final_scene", final, cs.ORACLE_FINAL, {}, ("brute",),
             ("brute", "fused")),
            ("(b) mesh", golden("mesh"), cs.ORACLE_FRAMES["mesh"], {},
             ("brute",), ("brute", "fused")),
            ("(c) hollow_glass", golden("hollow_glass"),
             cs.ORACLE_FRAMES["hollow_glass"], {}, ("brute", "bvh"),
             ("brute", "bvh", "fused")),
            ("(d) kitchen_sink", golden("kitchen_sink"),
             cs.ORACLE_FRAMES["kitchen_sink"], lens, ("brute",),
             ("brute", "fused")),
            ("(e) cube level 1", golden("cube"), cs.ORACLE_FRAMES["cube"], {},
             ("brute",), ("brute",)),
            ("(f) final_scene grid 35", big, cs.ORACLE_BIG, {}, ("bvh",),
             ("bvh", "fused"))]


def buffers_np(rc, rd, frame):
    shape = (frame[1], frame[0])
    return (np.stack([np.asarray(c).reshape(shape) for c in rc], -1),
            np.asarray(rd).reshape(shape))


def report(label, renderer, image, depth, want):
    stats = cs.oracle_stats(np.asarray(image), np.asarray(depth), *want[:2])
    print(f"{label} {renderer}: {json.dumps(stats)}", flush=True)


def main() -> int:
    torch.set_num_threads(4)
    for label, build, frame, options, jax_backends, port_renderers in frames():
        width, height, spp, bounces, level, seed = frame
        aspect = width / height
        config = dict(width=width, height=height, samples_per_pixel=spp,
                      bounces=bounces, level=level, **options)
        # JAX's Renderer on XLA's CPU.
        jw = build(jb)
        jcam = jw.camera_state(aspect=aspect)
        rc = rd = None
        raster = None
        if level in (1, 2):
            rc, rd = jraster(jw, jcam, jb.RenderConfig(**config))
            raster = buffers_np(rc, rd, frame)
        want = cs.oracle_frame(jw, frame, raster, **options)
        for backend in jax_backends:
            cfg = jb.RenderConfig(**config, intersect_backend=backend)
            out = jb.Renderer(cfg).render(
                jw.extract(with_bvh=backend == "bvh"), jcam, seed=seed,
                raster_color=rc, raster_depth=rd)
            report(label, f"JAX Renderer {backend}", out.image, out.rt_depth,
                   want)
        # The port on the CPU.
        pw = build(bt)
        pcam = pw.camera_state(aspect=aspect, device="cpu")
        rc = rd = None
        raster = None
        if level in (1, 2):
            rc, rd = raster_layer(pw, pcam, bt.RenderConfig(**config),
                                  device="cpu")
            raster = buffers_np([c.numpy() for c in rc], rd.numpy(), frame)
        want = cs.oracle_frame(pw, frame, raster, **options)
        print(f"{label} {width}x{height} {spp} spp: oracle {want[2]:.2f} s",
              flush=True)
        for name in port_renderers:
            if name == "fused":
                renderer = bt.FusedRenderer(bt.RenderConfig(**config),
                                            exact_rng=True)
            else:
                renderer = bt.Renderer(bt.RenderConfig(
                    **config, intersect_backend=name))
            out = renderer.render(
                pw.extract(with_bvh=name == "bvh", device="cpu"), pcam, seed,
                raster_color=rc, raster_depth=rd)
            what = (f"port FusedRenderer {'/'.join(renderer.last_mode)} "
                    "(plain version)" if name == "fused"
                    else f"port Renderer {name}")
            report(label, what, out.image.numpy(), out.rt_depth.numpy(), want)
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())
