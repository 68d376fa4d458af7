#!/usr/bin/env python3
"""Variants of the dense triangle test K2 side by side on one CUDA card.

    python3 tests/torch_k2_variants.py [--reps 20] [--other TREE]

Run from the repository root. Each variant is this checkout's
``kernels/cuda/csrc/wavefront.cu`` (and ``wavefront.h``) with a few lines
replaced (``VARIANTS``: the kept design, and what was tried beside it),
built with nvcc into a library of its own under ``build/k2_variants/`` and
called through a small C entry point (ctypes); ``--other`` adds another
checkout's K2 as it stands (for example the parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Each
variant's K2 is held to the plain version
(``intersect_triangles_reference``: t max |d| 0, index equal) and timed
by CUDA events (the mean of ``--reps`` launches queued behind a spin
kernel) on the rays that each bounce of sample 0 hands the triangle test
in BASELINE config 5 and in the cube field (``chip_smoke.cube_field_world``,
4,092 triangles), both at 1280x720, 16 spp, 4 bounces; then on a sparse
mask (one lane in 97). The last lines give the card, each variant's ms
per bounce, their sum over a sample's five bounces, ptxas's registers and
spills of its K2, and the issue slots a (ray, row) pair at the
``--fmad=false`` issue rate (132 SMs x 128 lanes x 1.98 GHz).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "bevyray_tpu_torch" / "kernels" / "cuda" / "csrc"
OUT = ROOT / "build" / "k2_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ISSUE_RATE = 132 * 128 * 1.98e9

# Lines of wavefront.cu or wavefront.h that each variant replaces (old, new).
NO_EXIT = ("const float t = triangle_t<true>(", "const float t = triangle_t<false>(")
NAN_DEAD = (
    "    const int i = s_lane[min(static_cast<int>(threadIdx.x) + j * kThreads, m - 1)];\n"
    "    o[j] = {rays.ox[i], rays.oy[i], rays.oz[i]};\n"
    "    d[j] = {rays.dx[i], rays.dy[i], rays.dz[i]};\n",
    "    const int slot = threadIdx.x + j * kThreads;\n"
    "    const int i = slot < m ? s_lane[slot] : -1;\n"
    "    const float nan = __int_as_float(0x7fc00000);\n"
    "    o[j] = i >= 0 ? V3{rays.ox[i], rays.oy[i], rays.oz[i]} : V3{nan, nan, nan};\n"
    "    d[j] = i >= 0 ? V3{rays.dx[i], rays.dy[i], rays.dz[i]} : V3{0.0f, 0.0f, 0.0f};\n")
VOTE = ("  if (kExit && !(fabsf(det) > 1e-12f && u >= 0.0f)) return kInf;\n",
        "  if (kExit && !__any_sync(0xffffffffu, fabsf(det) > 1e-12f && u >= 0.0f)) {\n"
        "    return kInf;\n"
        "  }\n")
SECOND_EXIT = (
    "  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;\n",
    "  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;\n"
    "  if (kExit && !(v >= 0.0f && u + v <= 1.0f)) return kInf;\n")
TILE_256 = ("constexpr int kRowsK2 = 512; ", "constexpr int kRowsK2 = 256; ")
TWO_RAYS = ("constexpr int kDenseRays = 4;", "constexpr int kDenseRays = 2;")
UNROLL_1 = ("#pragma unroll 2\n", "#pragma unroll 1\n")
# A warp's slots consecutive (warp-major), so that the block's m live
# slots fill whole warps and a warp past them skips the rows.
WARP_MAJOR = [
    ("    const int i = s_lane[min(static_cast<int>(threadIdx.x) + j * kThreads, m - 1)];\n",
     "    const int i = s_lane[min((static_cast<int>(threadIdx.x) / 32 * Q + j) * 32 +\n"
     "                             static_cast<int>(threadIdx.x) % 32, m - 1)];\n"),
    ("  const bool warp_live = (threadIdx.x & ~31) < m;\n  const int warp",
     "  const bool warp_live = static_cast<int>(threadIdx.x) / 32 * Q * 32 < m;\n"
     "  const int warp"),
    ("          best_i[j] = __float_as_int(r2.y);\n        }\n      }\n    }\n  }\n"
     "#pragma unroll\n  for (int j = 0; j < Q; ++j) {\n"
     "    const int slot = threadIdx.x + j * kThreads;\n",
     "          best_i[j] = __float_as_int(r2.y);\n        }\n      }\n    }\n  }\n"
     "#pragma unroll\n  for (int j = 0; j < Q; ++j) {\n"
     "    const int slot = (static_cast<int>(threadIdx.x) / 32 * Q + j) * 32 +\n"
     "                     static_cast<int>(threadIdx.x) % 32;\n"),
]
VARIANTS = {
    "kept: exit after u, dead slots on a live ray": [],
    "no exit": [NO_EXIT],
    "exit after u, NaN dead slots": [NAN_DEAD],
    "no exit, NaN dead slots": [NO_EXIT, NAN_DEAD],
    "warp-vote exit after u": [VOTE],
    "exits after u and after v": [SECOND_EXIT],
    "256-row tiles": [TILE_256],
    "2 rays a thread": [TWO_RAYS],
    "row loop not unrolled": [UNROLL_1],
    "warp-major slots": WARP_MAJOR,
    "warp-major slots, no exit": WARP_MAJOR + [NO_EXIT],
}

SHIM = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "wavefront.h"

extern "C" int k2(const float* ox, const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const bool* active, int n, const float* ax,
                  const float* ay, const float* az, const float* bx, const float* by,
                  const float* bz, const float* cx, const float* cy, const float* cz,
                  const bool* valid, int rows, float* out_t, int64_t* out_i, void* stream) {
  RayBatch r{ox, oy, oz, dx, dy, dz, active, n};
  TriangleTable t{ax, ay, az, bx, by, bz, cx, cy, cz, valid, rows};
  launch_intersect_triangles(r, t, out_t, out_i, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
"""


def build_all(other) -> dict:
    """Start nvcc for every variant at once: {name: (library, process)}.
    An edit applies to the one of wavefront.cu and wavefront.h that holds
    its old text once."""
    names = ("wavefront.cu", "wavefront.h", "common.cuh")
    sources = {(name, edits): {f: (CSRC / f).read_text() for f in names}
               for name, edits in ((n, tuple(e)) for n, e in VARIANTS.items())}
    if other is not None:
        csrc = other / "bevyray_tpu_torch" / "kernels" / "cuda" / "csrc"
        sources[(f"other tree ({other})", ())] = {
            f: (csrc / f).read_text() for f in names}
    procs = {}
    for k, ((name, edits), files) in enumerate(sources.items()):
        for old, new in edits:
            hits = [f for f, text in files.items() if text.count(old) == 1]
            if len(hits) != 1:
                raise SystemExit(f"variant {name!r}: no single {old!r}")
            files[hits[0]] = files[hits[0]].replace(old, new)
        d = OUT / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        (d / "shim.cu").write_text(SHIM)
        lib = d / "libk2.so"
        procs[name] = (lib, subprocess.Popen(
            [NVCC, *FLAGS, f"-I{d}", "-o", str(lib), str(d / "shim.cu"),
             str(d / "wavefront.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--other", type=Path, default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_variants: needs a CUDA card", file=sys.stderr)
        return 2
    procs = build_all(None if args.other is None else args.other.resolve())

    import chip_smoke
    import bevyray_tpu_torch
    from bevyray_tpu_torch.kernels import intersect
    from bevyray_tpu_torch.kernels.cuda import build

    build.extension()   # the captures run the port's own kernels
    dev = torch.device("cuda", 0)
    fns, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            print(out, file=sys.stderr)
            return proc.returncode
        k2_lines, ptxas[name] = False, []
        for line in out.splitlines():   # the lines of the triangle kernel
            if "Compiling entry" in line:
                k2_lines = "Triangle" in line and "walk" not in line
            elif k2_lines and ("registers" in line or "spill" in line):
                ptxas[name].append(line.strip())
        fn = ctypes.CDLL(str(lib)).k2
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, o, d, act, tris):
        n = o.x.shape[0]
        out_t = torch.empty(n, dtype=torch.float32, device=dev)
        out_i = torch.empty(n, dtype=torch.int64, device=dev)
        ptrs = [ctypes.c_void_p(c.data_ptr()) for c in (*o, *d)]
        ptrs.append(ctypes.c_void_p(0 if act is None else act.data_ptr()))
        cols = [ctypes.c_void_p(c.data_ptr()) for c in (
            tris.ax, tris.ay, tris.az, tris.bx, tris.by, tris.bz, tris.cx,
            tris.cy, tris.cz, tris.valid)]
        err = fns[name](*ptrs, ctypes.c_int(n), *cols,
                        ctypes.c_int(tris.ax.numel()),
                        ctypes.c_void_p(out_t.data_ptr()),
                        ctypes.c_void_p(out_i.data_ptr()),
                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise SystemExit(f"{name}: launch error {err}")
        return out_t, out_i

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # ~10 ms: the launches queue meanwhile
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    world5, config5 = chip_smoke.config5_world()
    cases = []
    for cell, world in (("config 5", world5),
                        ("cube field", chip_smoke.cube_field_world(
                            bevyray_tpu_torch))):
        scene = world.extract(with_bvh=False, device=dev)
        cam = world.camera_state(aspect=16 / 9, device=dev)
        rays = chip_smoke.capture_rays(scene, cam, config5, dev)
        for b, (o, d, act) in enumerate(rays):
            cases.append((f"{cell} bounce {b}", o, d, act, scene.triangles))
        if cell == "cube field":
            o, d, act = rays[0]
            few = torch.zeros_like(act)
            few[5::97] = act[5::97]
            cases.append((f"{cell} bounce 0, 1 lane in 97", o, d, few,
                          scene.triangles))
    ms = {name: {} for name in fns}
    for case, o, d, act, tris in cases:
        want = intersect.on_active(intersect.intersect_triangles_reference,
                                   act, o, d, tris)
        for name in fns:
            got = call(name, o, d, act, tris)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise SystemExit(f"{name}, {case}: differs from the plain "
                                 "version")
        for name in list(fns) + list(fns)[::-1]:   # in turns
            ms[name].setdefault(case, []).append(
                device_ms(lambda: call(name, o, d, act, tris)))
        pairs = int(act.sum()) * int(tris.valid.sum())
        print(f"{case}: {int(act.sum())} active x {int(tris.valid.sum())} "
              f"rows, every variant bit-equal; ms " + "; ".join(
                  f"{name} {min(ms[name][case]):.4f} ("
                  f"{min(ms[name][case]) * 1e-3 * ISSUE_RATE / pairs:.1f} "
                  f"slots a pair)" for name in fns), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print(json.dumps({"ptxas": ptxas, "sample_sum_ms": {
        name: {cell: sum(min(t) for case, t in per.items()
                         if case.startswith(cell) and "lane" not in case)
               for cell in ("config 5", "cube field")}
        for name, per in ms.items()}}))
    print(json.dumps({"ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
