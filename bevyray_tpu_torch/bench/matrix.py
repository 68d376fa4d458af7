"""Every BASELINE.json config at full size on the card, one JSON line each:
the per-config evidence behind the single-number headline.

Counterpart of the JAX repository's ``scripts/bench_matrix.py``; the
configs are :func:`matrix_configs`:

 1. RTiOW ch.9: 3 Lambertian spheres + ground, 256x256, 4 spp, depth 8
 2. Metal + dielectric materials, 512x512, 16 spp
 3. RTiOW final scene (~500 spheres), 720p, 16 spp
 4. Defocus + emissive + cosine sampling, 1080p, 64 spp accumulation
    (``ProgressiveRenderer(backend="pallas")``, 16 passes of 4 spp)
 5. Hybrid: the raster layer (cube) depth-blended + a triangle mesh, 720p,
    16 spp

Then the orbit rows (:func:`.orbit.bench`) at 720p, 16 spp, 12 frames, and
a summary line. Frames 1-3 and 5 are ``FusedRenderer`` at its defaults,
timed as :func:`.timing._time` (a warm-up frame, then 3 at seeds 1-3).
Beside JAX's keys each row gives ``rays_per_frame`` (config 4: ``rays``,
the passes' segments), ``launches`` (of the kernel, in the row) and
``device``.

    python -m bevyray_tpu_torch.bench.matrix [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple, Optional

from ..core.types import RenderConfig, resolve_device
from ..engine.film import ProgressiveRenderer
from ..engine.fused_renderer import FusedRenderer
from ..engine.raster import raster_layer
from ..scene import rtiow
from ..scene.components import (RaytracedCamera, Raytracing, StandardMaterial,
                                Transform, cube_mesh)
from ..scene.world import World
from . import orbit
from .timing import (_time, card_fields, device_arg, launch_count,
                     launches_since, sync)


class MatrixConfig(NamedTuple):
    """One BASELINE config as ``scripts/bench_matrix.py`` builds it."""

    name: str
    world: World
    config: RenderConfig
    aspect: float
    # Accumulating passes (config 4: 1 + 15), None for a frame config.
    passes: Optional[int] = None


def matrix_configs():
    """The five configs of ``scripts/bench_matrix.py:55-114``, in order."""
    cube_world = rtiow.final_scene(seed=42)
    cube_world.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                          StandardMaterial(base_color=(0.2, 0.5, 0.9),
                                           metallic=1.0,
                                           perceptual_roughness=0.15))
    night = rtiow.night_scene(camera=RaytracedCamera(
        level=Raytracing.PURE, aperture=0.15, focus_distance=6.0))
    return [
        MatrixConfig("1: ch9 256x256/4spp", rtiow.simple_scene(),
                     RenderConfig(width=256, height=256, samples_per_pixel=4,
                                  bounces=8, level=3), 1.0),
        MatrixConfig("2: materials 512x512/16spp", rtiow.material_test_scene(),
                     RenderConfig(width=512, height=512, samples_per_pixel=16,
                                  bounces=8, level=3), 1.0),
        MatrixConfig("3: final 720p/16spp", rtiow.final_scene(seed=42),
                     RenderConfig(width=1280, height=720, samples_per_pixel=16,
                                  bounces=4, level=3), 16 / 9),
        MatrixConfig("4: defocus+emissive+cosine 1080p/64spp accum", night,
                     RenderConfig(width=1920, height=1080, samples_per_pixel=4,
                                  bounces=4, level=3, defocus=True,
                                  diffuse_sampling="cosine"), 16 / 9,
                     passes=16),
        MatrixConfig("5: hybrid raster+mesh 720p/16spp", cube_world,
                     RenderConfig(width=1280, height=720, samples_per_pixel=16,
                                  bounces=4, level=2), 16 / 9),
    ]


def run_config(entry: MatrixConfig, dev, n=3) -> dict:
    """One config's row: p50 and Mrays/s of ``n`` timed frames, or for an
    accumulating config the total time of its passes after the first."""
    sc = entry.world.extract(with_bvh=False, device=dev)
    cam = entry.world.camera_state(aspect=entry.aspect, device=dev)
    if entry.passes is not None:
        prog = ProgressiveRenderer(entry.config, backend="pallas", device=dev)
        f = prog.step(sc, cam, seed=0)
        sync(dev)
        before = launch_count()
        t0 = time.perf_counter()
        rays0 = int(f.rays_traced)
        for i in range(entry.passes - 1):
            f = prog.step(sc, cam, seed=i + 1)
        sync(dev)
        dt = time.perf_counter() - t0
        rays = int(f.rays_traced) - rays0
        return {"config": entry.name, "total_s": round(dt, 2),
                "mrays": round(rays / dt / 1e6, 1),
                "spp": prog.samples_accumulated, "rays": rays,
                "launches": launches_since(before, entry.name, dev),
                "device": card_fields(dev)}
    rc = rd = None
    if entry.config.level in (1, 2):   # the hybrid levels composite a raster
        rc, rd = raster_layer(entry.world, cam, entry.config, device=dev)
    r = FusedRenderer(entry.config)
    before = launch_count()
    p50, rays = _time(lambda s: r.render(sc, cam, seed=s, raster_color=rc,
                                         raster_depth=rd), n)
    return {"config": entry.name, "p50_ms": round(p50 * 1e3, 1),
            "mrays": round(rays / p50 / 1e6, 1), "rays_per_frame": rays,
            "launches": launches_since(before, entry.name, dev),
            "device": card_fields(dev)}


def bench(configs=None, n=3, orbit_args=None, device=None):
    """The rows of ``configs`` (default :func:`matrix_configs`), then
    :func:`.orbit.bench` with ``orbit_args`` (default 720p, 16 spp, 12
    frames), each printed as it comes; returns them."""
    dev = resolve_device(device)
    out = []
    for entry in (matrix_configs() if configs is None else configs):
        out.append(run_config(entry, dev, n))
        print(json.dumps(out[-1]), flush=True)
    # 6. The interactive paths: an orbiting camera and per-frame sphere
    #    edits (the reference's flycam and gizmo loop); the 1080p rows and
    #    the 720p/4 spp ones are in bench.orbit.
    out += orbit.bench(**(orbit_args or dict(width=1280, height=720, spp=16,
                                             frames=12)), device=dev)
    return out


def main(device=None):
    dev = resolve_device(device)
    out = bench(device=dev)
    print(json.dumps({"device": card_fields(dev), "rows": len(out)}))
    return out


if __name__ == "__main__":
    main(device_arg(__doc__.splitlines()[0]))
    sys.exit(0)
