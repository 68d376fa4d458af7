"""Sharded-frame scaling harness: both sharded steps (the wavefront step
and the fused kernel's, the one to deploy) over 1, 2, 4 and 8 shards, with
each shard's ray count and whether each mesh's image equals the one-shard
image.

Counterpart of the JAX repository's ``scripts/scaling_bench.py``, on a mesh
of torch devices (:mod:`..parallel.sharding`): ``["cuda:0"] * n`` on the
card, where the shards of a frame run one after another, or ``["cpu"] * n``
with ``--device cpu``. Every mesh must give the one-shard image: bit-equal
where dp = 1 (the fused step only moves blocks between shards), within
2e-6 where dp > 1 splits the per-pixel sample sums (JAX's bar), and the
same segment count. ``per_sp_shard_rays`` runs the kernel on each sp
shard's block range, as that shard's device would, and reads its segment
counter. On the card each record adds ``frame_ms`` (p50 of 3 frames after
a warm-up, each ended by ``torch.cuda.synchronize()``) and ``device``.

    python -m bevyray_tpu_torch.bench.scaling [--device cpu] [--out FILE]

One JSON line per mesh and step, and a summary line; ``--out`` also writes
the records as one JSON file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..core.types import RenderConfig, resolve_device
from ..kernels.cuda.megakernel import (block_grid, morton_order,
                                       prepare_kernel_scene, render_tiles)
from ..parallel.sharding import (default_mesh_shape, make_mesh,
                                 render_frame_sharded,
                                 render_frame_sharded_pallas)
from ..scene import rtiow
from .timing import (card_fields, launch_count, launches_since,
                     p50_ms, sync)

SHARD_COUNTS = (1, 2, 4, 8)
FRAME_REPS = 3


def main(n_max: int = 8, out_path=None, device=None):
    """Run both steps over the shard counts up to ``n_max``; returns 0 when
    every mesh matched the one-shard frame, else 1."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def mesh_over(sp, dp, tp):
        return make_mesh(sp, dp, tp, devices=[dev] * (sp * dp * tp))

    def timed(rec, render):
        if on_card:
            ts = []
            for _ in range(FRAME_REPS):
                t0 = time.perf_counter()
                render()
                sync(dev)
                ts.append(time.perf_counter() - t0)
            rec.update(frame_ms=p50_ms(ts), device=card_fields(dev))
        return rec

    world = rtiow.final_scene(seed=42, grid=3)
    scene = world.extract(with_bvh=False, device=dev)
    cam = world.camera_state(aspect=1.0, device=dev)
    config = RenderConfig(width=64, height=64, samples_per_pixel=8, bounces=4,
                          level=3)

    ok = True

    # ---- the wavefront step: sp x dp x tp --------------------------------
    ref_img = None
    for n in SHARD_COUNTS:
        if n > n_max:
            break
        sp, dp, tp = default_mesh_shape(n)
        mesh = mesh_over(sp, dp, tp)
        frame = render_frame_sharded(mesh, scene, cam, config, frame_seed=7)
        img = frame.image.cpu().numpy()
        if ref_img is None:
            ref_img = img
        same = bool(np.abs(img - ref_img).max() < 2e-6)
        ok &= same
        emit(timed({"path": "xla", "devices": n,
                    "mesh": {"sp": sp, "dp": dp, "tp": tp},
                    "rays": int(frame.rays_traced), "matches_1dev": same},
                   lambda: render_frame_sharded(mesh, scene, cam, config,
                                                frame_seed=7)))

    # ---- the fused step: sp x dp ------------------------------------------
    # The kernel renders 64x64 pixel blocks, so sp sharding needs a frame of
    # several blocks (a 64x64 frame is one: every other sp shard would
    # render padding).
    pconfig = RenderConfig(width=256, height=128, samples_per_pixel=4,
                           bounces=4, level=3)   # 4x2 = 8 blocks
    ref_img = None
    ref_rays = None
    for n in SHARD_COUNTS:
        if n > n_max:
            break
        dp = 2 if n >= 4 else 1          # the sample axis too
        sp = n // dp
        mesh = mesh_over(sp, dp, 1)
        before = launch_count()
        frame = render_frame_sharded_pallas(mesh, scene, cam, pconfig,
                                            frame_seed=7)
        launches = launches_since(before, f"pallas {n} shards", dev)
        img = frame.image.cpu().numpy()
        if ref_img is None:
            ref_img = img
            ref_rays = int(frame.rays_traced)
        # dp = 1 meshes only move blocks between shards, so each pixel's sum
        # runs in the same order: bit-equal. dp > 1 splits a pixel's sample
        # sum over shards: equal within float tolerance.
        if dp == 1:
            same = bool(np.array_equal(img, ref_img))
        else:
            same = bool(np.abs(img - ref_img).max() < 2e-6)
        ok &= same
        ok &= int(frame.rays_traced) == ref_rays
        balance = _sp_ray_balance(scene, cam, pconfig, sp, frame_seed=7)
        emit(timed({
            "path": "pallas", "devices": n, "mesh": {"sp": sp, "dp": dp},
            "rays": int(frame.rays_traced),
            ("bitmatches_1dev" if dp == 1 else "matches_1dev"): same,
            "per_sp_shard_rays": balance, "launches": launches,
            "balance_max_over_min": (round(max(balance) / max(min(balance), 1),
                                           3) if balance else 1.0),
        }, lambda: render_frame_sharded_pallas(mesh, scene, cam, pconfig,
                                               frame_seed=7)))

    emit({"scaling_ok": ok,
          "note": "every mesh lies on one device, whose shards run one "
                  "after another: frame_ms is no scaling curve"})
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"probe_script": "bevyray_tpu_torch/bench/scaling.py",
                       "records": records}, f, indent=1)
    return 0 if ok else 1


def _sp_ray_balance(scene, cam, config, sp, frame_seed):
    """Traced segments per sp shard: the kernel on each shard's block range
    as that shard's device runs it, all samples, its segment counter read."""
    nbx, nby = block_grid(config)
    n_blocks = nbx * nby
    n_pad = -(-n_blocks // sp) * sp
    blocks_local = n_pad // sp
    # The tables of the same (cand_size, grouping) as the sharded run.
    order = (morton_order(scene.spheres)
             if config.pallas_grouping == "morton" else None)
    pscene = prepare_kernel_scene(scene, config.pallas_cand_size, order=order)
    out = []
    for i in range(sp):
        *_, segs = render_tiles(pscene, cam, config, frame_seed,
                                block_offset=i * blocks_local,
                                n_blocks_local=blocks_local, normalize=False)
        out.append(int(segs))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--n-max", type=int, default=8)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.exit(main(n_max=args.n_max, out_path=args.out,
                  device=resolve_device(args.device)))
