"""Command-line front-end — the bevyray-equivalent user program.

Counterpart of ``bevyray_tpu/app/cli.py``, with the same subcommands, flags
and defaults, so a command line that drives one package drives the other:
render stills, run progressive accumulation, benchmark. Usage:

    python -m bevyray_tpu_torch.app.cli render --scene final --width 1280 \
        --height 720 --spp 16 --bounces 4 --level 2 --seed 42 --out frame.png
    python -m bevyray_tpu_torch.app.cli bench --frames 8
    python -m bevyray_tpu_torch.app.cli accumulate --scene material --passes 8 \
        --out out.png

``--backend pallas`` runs the fused CUDA kernel (``FusedRenderer``,
``ProgressiveRenderer(backend="pallas")``; ``AdaptiveRenderer`` under
``--adaptive-tolerance``); ``auto``, ``brute`` and ``bvh`` run the wavefront
``Renderer``. ``--platform auto`` (the default) runs on the CUDA card and
raises without one; ``--platform cpu`` runs the plain PyTorch versions on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.types import resolve_device
from ..utils.profiling import synchronize


def _build_world(args):
    from ..scene import rtiow
    from ..scene.components import RaytracedCamera, Raytracing

    cam = RaytracedCamera(level=Raytracing(args.level), sample_count=args.spp,
                          bounces=args.bounces, aperture=args.aperture,
                          focus_distance=args.focus)
    if args.scene == "final":
        return rtiow.final_scene(seed=args.scene_seed, camera=cam)
    if args.scene == "simple":
        return rtiow.simple_scene(camera=cam)
    if args.scene == "material":
        return rtiow.material_test_scene(camera=cam)
    if args.scene == "night":
        return rtiow.night_scene(camera=cam)
    raise SystemExit(f"unknown scene {args.scene!r}")


def _config(args):
    from ..core.types import RenderConfig

    backend = "auto" if args.backend == "pallas" else args.backend
    return RenderConfig(width=args.width, height=args.height,
                        samples_per_pixel=args.spp, bounces=args.bounces,
                        level=args.level, intersect_backend=backend,
                        defocus=args.aperture > 0.0,
                        diffuse_sampling=args.diffuse_sampling,
                        pallas_intersect=args.pallas_intersect,
                        pallas_primary=args.pallas_primary,
                        pallas_cand_size=args.pallas_cand_size,
                        pallas_grouping=args.pallas_grouping)


def _scene(args, world, device):
    """The scene tables and camera on ``device``; the BVH is built for the
    backends that may walk it."""
    scene = world.extract(with_bvh=(args.backend in ("auto", "bvh")),
                          device=device)
    return scene, world.camera_state(aspect=args.width / args.height,
                                     device=device)


def _denoised(image, frame, args, raster_depth, cam):
    """Apply the a-trous filter; in hybrid modes fold the raster layer's
    reverse-Z depth into the guide (converted to view-z) so rasterized
    silhouettes form depth edges too — rt_depth alone is smooth across them."""
    from ..engine.denoise import jitted_denoise
    guide = frame.rt_depth
    if raster_depth is not None:
        rd = raster_depth.reshape(guide.shape)
        guide = torch.where(rd > 0.0,
                            torch.minimum(guide,
                                          cam.near / torch.clamp(rd, min=1e-8)),
                            guide)
    return jitted_denoise(args.denoise, args.denoise_sigma_color,
                          args.denoise_sigma_depth)(image, guide)


def _raster_buffers(world, cam, config, device):
    """Rasterize the world's raster-only entities (the reference's cube,
    main.rs:76-85) for the hybrid modes; (None, None) = plain clear color."""
    if config.level >= 3 or world.n_raster == 0:
        return None, None
    from ..engine.raster import raster_layer

    return raster_layer(world, cam, config, device=device)


def _make_renderer(args, config):
    if args.backend == "pallas":
        from ..engine.fused_renderer import FusedRenderer

        return FusedRenderer(config)
    from ..engine.renderer import Renderer

    return Renderer(config)


def _write(path, image) -> None:
    from ..utils.png import write_png

    write_png(path, image.cpu().numpy())


def cmd_render(args, device):
    world = _build_world(args)
    config = _config(args)
    scene, cam = _scene(args, world, device)
    renderer = _make_renderer(args, config)
    raster_color, raster_depth = _raster_buffers(world, cam, config, device)

    t0 = time.perf_counter()
    frame = renderer.render(scene, cam, seed=args.seed,
                            raster_color=raster_color, raster_depth=raster_depth)
    synchronize(frame)
    dt = time.perf_counter() - t0
    image = frame.image
    if args.denoise > 0:
        image = _denoised(image, frame, args, raster_depth, cam)
    _write(args.out, image)
    rays = float(frame.rays_traced)
    print(f"rendered {args.width}x{args.height} spp={args.spp} in {dt:.3f}s "
          f"(set-up included), {rays / dt / 1e6:.1f} Mrays/s -> {args.out}")
    return 0


def cmd_accumulate(args, device):
    from ..engine.film import ProgressiveRenderer

    world = _build_world(args)
    config = _config(args)
    scene, cam = _scene(args, world, device)
    raster_color, raster_depth = _raster_buffers(world, cam, config, device)
    if args.adaptive_tolerance > 0.0:
        # Adaptive extension: converged pixels stop sampling (engine/adaptive).
        # The controller drives the fused kernel's spp_map path only.
        if args.backend not in ("auto", "pallas"):
            print(f"--adaptive-tolerance requires the pallas backend "
                  f"(got --backend {args.backend})", file=sys.stderr)
            return 2
        from ..engine.adaptive import AdaptiveRenderer
        adap = AdaptiveRenderer(config, tolerance=args.adaptive_tolerance,
                                device=device)
        for i in range(args.passes):
            adap.step(scene, cam, seed=args.seed + i)
        frame = adap.resolve(cam, raster_color=raster_color,
                             raster_depth=raster_depth)
        synchronize(frame)
        counts = adap.samples_map()
        print(f"adaptive: {adap.converged_fraction() * 100:.0f}% pixels "
              f"converged, samples/pixel {counts.min():.0f}-{counts.max():.0f}"
              f" (mean {counts.mean():.1f})")
    else:
        prog = ProgressiveRenderer(
            config, backend="pallas" if args.backend == "pallas" else "xla",
            device=device)
        frame = None
        for i in range(args.passes):
            frame = prog.step(scene, cam, seed=args.seed + i,
                              raster_color=raster_color,
                              raster_depth=raster_depth)
        synchronize(frame)
    image = frame.image
    if args.denoise > 0:
        image = _denoised(image, frame, args, raster_depth, cam)
    _write(args.out, image)
    spp_done = (f"{counts.mean():.1f} mean (adaptive)"
                if args.adaptive_tolerance > 0.0
                else prog.samples_accumulated)
    print(f"accumulated {spp_done} spp -> {args.out}")
    return 0


def cmd_bench(args, device):
    world = _build_world(args)
    config = _config(args)
    scene, cam = _scene(args, world, device)
    renderer = _make_renderer(args, config)
    raster_color, raster_depth = _raster_buffers(world, cam, config, device)

    frame = renderer.render(scene, cam, seed=0,
                            raster_color=raster_color, raster_depth=raster_depth)
    synchronize(frame)

    times = []
    rays = []   # per-seed ray counts: path lengths vary per seed, so the
    for i in range(args.frames):  # numerator must come from the TIMED frames
        t0 = time.perf_counter()  # (same methodology as the repo-root bench.py)
        frame = renderer.render(scene, cam, seed=i + 1,
                                raster_color=raster_color,
                                raster_depth=raster_depth)
        synchronize(frame)
        times.append(time.perf_counter() - t0)
        rays.append(float(frame.rays_traced))
    p50 = float(np.percentile(times, 50))
    rays_per_frame = float(np.mean(rays))
    print(json.dumps({
        "metric": f"Mrays/sec ({args.scene}, {args.width}x{args.height}, "
                  f"{args.spp}spp)",
        "value": round(rays_per_frame / p50 / 1e6, 2),
        "unit": "Mrays/s",
        "p50_frame_ms": round(p50 * 1e3, 2),
        "rays_per_frame": int(rays_per_frame),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
    }))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="bevyray-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("bench", cmd_bench),
                     ("accumulate", cmd_accumulate)]:
        s = sub.add_parser(name)
        s.set_defaults(fn=fn)
        s.add_argument("--scene", default="final",
                       choices=["final", "simple", "material", "night"])
        s.add_argument("--scene-seed", type=int, default=42)
        s.add_argument("--width", type=int, default=1280)
        s.add_argument("--height", type=int, default=720)
        s.add_argument("--spp", type=int, default=16)
        s.add_argument("--bounces", type=int, default=4)
        s.add_argument("--level", type=int, default=3, choices=[0, 1, 2, 3])
        s.add_argument("--seed", type=int, default=1)
        s.add_argument("--backend", default="auto",
                       choices=["auto", "brute", "bvh", "pallas"],
                       help="pallas: the fused CUDA kernel; the others: the "
                            "wavefront renderer with the dense sphere test "
                            "(brute), the BVH walk (bvh) or the rule that "
                            "picks between them (auto)")
        s.add_argument("--aperture", type=float, default=0.0,
                       help="thin-lens diameter; >0 enables defocus blur")
        s.add_argument("--focus", type=float, default=3.0,
                       help="focus distance for defocus blur")
        s.add_argument("--pallas-intersect", default="auto",
                       choices=["auto", "grouped", "candidates"],
                       help="fused kernel sphere walk (auto: grouped <=1024 "
                            "spheres, candidates above)")
        s.add_argument("--pallas-cand-size", type=int, default=0,
                       help="candidate-walk group size in spheres (multiple "
                            "of 8; 0 = auto — smallest fitting the two-word "
                            "62-group mask)")
        s.add_argument("--pallas-primary", default="auto",
                       choices=["auto", "split", "off"],
                       help="fused kernel bounce-0 strategy (auto: coherent "
                            "shortlist phase when spp <= 32)")
        s.add_argument("--pallas-grouping", default="kd",
                       choices=["kd", "morton"],
                       help="sphere-table order for the culling groups (kd: "
                            "spatially tight equal-size clusters; morton: "
                            "space-filling-curve runs)")
        s.add_argument("--diffuse-sampling", default="reference",
                       choices=["reference", "cosine"])
        s.add_argument("--adaptive-tolerance", type=float, default=0.0,
                       help="adaptive sampling: stop pixels whose inter-pass "
                            "disagreement falls below this (0 = uniform; "
                            "accumulate subcommand, extension)")
        s.add_argument("--denoise", type=int, default=0, metavar="N",
                       help="edge-aware a-trous denoise iterations "
                            "(0 = off, extension)")
        s.add_argument("--denoise-sigma-color", type=float, default=0.25)
        s.add_argument("--denoise-sigma-depth", type=float, default=0.5)
        s.add_argument("--platform", default="auto",
                       choices=["auto", "cpu", "cuda"],
                       help="torch device: auto = the CUDA card (an error "
                            "without one); cpu = the plain PyTorch versions "
                            "on the CPU")
        s.add_argument("--out", default="frame.png")
        s.add_argument("--frames", type=int, default=8)
        s.add_argument("--passes", type=int, default=8)
    args = p.parse_args(argv)
    device = resolve_device(None if args.platform == "auto" else args.platform)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
