"""Witness for the two CPU mismatches between the port and the JAX package
that ROADMAP §C logs as F1 (the camera's tangent) and F2 (torch's sqrt).

    JAX_PLATFORMS=cpu python tests/torch_cpu_rounding_witness.py [--exhaustive] [--seeds 12]

1. torch's CPU float32 ``sqrt`` against the correctly rounded one (a
   float64 sqrt rounded), on 2^22 seeded inputs: the share that differs and
   by how many ulp.
2. XLA's float32 ``tan`` (jitted ``jnp.tan``) against the rounded float64
   tangent and against the C library's ``tanf`` (ctypes), on 2^20 half
   angles in (0, 1.5]; then :func:`kernels.camera.half_fov_tan` (on the
   CPU the C library's ``tanf``) against jitted ``jnp.tan(fov * 0.5)`` on
   the same grid, and :func:`kernels.camera.glibc_tanf` (the card's) there
   or, with ``--exhaustive``, on every float32 fov whose half is a normal
   float in (0, 1.5] (~1 min).
3. The rays of ``test_torch_renderer.py::test_intersect_spheres_matches_jax``:
   the lanes whose ``t`` misses the test's rtol 1e-5 against JAX with
   torch's sqrt and with the port's (``core.vec.sqrt``), the lanes whose
   bits equal JAX's, and each package's largest distance from the float64
   root.
4. The headline scene of ``test_torch_slice.py`` at its default knobs: per
   frame seed the pixels past 5e-5 between the port and JAX, and at those
   pixels each package's distance from the NumPy oracle.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import conftest  # noqa: E402,F401  (the suite's cheap TPU-schedule knobs)
from bevyray_tpu_torch.core import vec  # noqa: E402
from bevyray_tpu_torch.kernels import camera, intersect  # noqa: E402


def ulps(a, b) -> np.ndarray:
    return a.view(np.int32).astype(np.int64) - b.view(np.int32)


def sqrt_share() -> None:
    x = np.random.default_rng(0).random(1 << 22).astype(np.float32) * 100
    got = torch.sqrt(torch.from_numpy(x)).numpy()
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    d = ulps(got, exact)
    print(f"1. torch {torch.__version__} ({torch.backends.cpu.get_cpu_capability()}) "
          f"float32 sqrt: {np.count_nonzero(d)} of {x.size} off the correctly "
          f"rounded value ({np.count_nonzero(d) / x.size:.2%}), ulp "
          f"{dict(zip(*map(list, np.unique(d, return_counts=True))))}; "
          f"core.vec.sqrt: {np.count_nonzero(vec.sqrt(torch.from_numpy(x)).numpy() != exact)}")


def tangent(exhaustive: bool) -> None:
    half = np.linspace(0, 1.5, (1 << 20) + 1)[1:].astype(np.float32)
    xla = np.asarray(jax.jit(jnp.tan)(half))
    exact = np.tan(half.astype(np.float64)).astype(np.float32)
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.tanf.restype, libm.tanf.argtypes = ctypes.c_float, [ctypes.c_float]
    c = np.float32([libm.tanf(float(v)) for v in half[::16]])
    print(f"2. XLA tan: {np.count_nonzero(ulps(xla, exact))} of {half.size} "
          f"half angles in (0, 1.5] off the rounded float64 tangent; "
          f"{np.count_nonzero(ulps(xla[::16], c))} of {c.size} off libm tanf")
    tan_half = jax.jit(lambda f: jnp.tan(f * 0.5))
    fov = half * np.float32(2)
    got = camera.half_fov_tan(torch.from_numpy(fov)).numpy()
    print(f"   half_fov_tan (CPU: the C library's tanf) vs jitted "
          f"jnp.tan(fov * 0.5): "
          f"{np.count_nonzero(ulps(got, np.asarray(tan_half(fov))))} of "
          f"{fov.size} differ")
    if not exhaustive:
        got = camera.glibc_tanf(torch.from_numpy(half)).numpy()
        print(f"   glibc_tanf (the card's) vs jitted jnp.tan(fov * 0.5): "
              f"{np.count_nonzero(ulps(got, np.asarray(tan_half(fov))))} of "
              f"{fov.size} differ")
        return
    bad = total = 0
    hi = int(np.float32(1.5).view(np.int32)) + 1
    for lo in range(0x800000, hi, 1 << 23):
        half = np.arange(lo, min(lo + (1 << 23), hi), dtype=np.int32).view(
            np.float32)
        got = camera.glibc_tanf(torch.from_numpy(half)).numpy()
        want = np.asarray(tan_half(half * np.float32(2)))
        bad += np.count_nonzero(ulps(got, want))
        total += half.size
    print(f"   glibc_tanf (the card's) vs jitted jnp.tan(fov * 0.5), every fov "
          f"with a normal half in (0, 1.5]: {bad} of {total} differ")


def sphere_lanes() -> None:
    import test_torch_renderer as tr

    js, ps, dup = tr.duplicate_scene.__wrapped__()
    o, d = tr._rays((0.0, 1.0, 5.0))
    cam = np.array([0.0, 1.0, 5.0], np.float32)
    for k, (i, _) in enumerate(dup):
        c = np.array([js.spheres.cx[i], js.spheres.cy[i], js.spheres.cz[i]],
                     np.float32)
        o[:, k::8], d[:, k::8] = cam[:, None], (c - cam)[:, None]
    jo, jd, po, pd = tr._vecs(o, d)
    want, wi = map(np.asarray, tr.jint.intersect_spheres(jo, jd, js.spheres))
    got = {}
    for name, fn in (("torch.sqrt", torch.sqrt), ("core.vec.sqrt", vec.sqrt)):
        intersect.sqrt = fn
        got[name] = intersect.intersect_spheres(po, pd, ps.spheres)[0].numpy()
    intersect.sqrt = vec.sqrt
    s = ps.spheres
    hit = np.nonzero(wi >= 0)[0]
    oc = np.stack([c.numpy()[wi[hit]] for c in (s.cx, s.cy, s.cz)]) - o[:, hit]
    oc, dd = oc.astype(np.float64), d[:, hit].astype(np.float64)
    a, h = (dd * dd).sum(0), (dd * oc).sum(0)
    cc = (oc * oc).sum(0) - s.radius.numpy()[wi[hit]].astype(np.float64) ** 2
    root = (h - np.sqrt(h * h - a * cc)) / a
    for name, t in got.items():
        past = ~np.isclose(t, want, rtol=1e-5, atol=0)
        print(f"3. {name}: {past.sum()} lanes past rtol 1e-5 of JAX, "
              f"{np.count_nonzero(ulps(t[hit], want[hit]) == 0)} of "
              f"{hit.size} hit lanes bit-equal, max |t - root| / root "
              f"{np.max(np.abs(t[hit] - root) / root):.3g}")
    print(f"   JAX: max |t - root| / root "
          f"{np.max(np.abs(want[hit] - root) / root):.3g}")


def slice_seeds(seeds: int) -> None:
    import test_torch_slice as ts

    frames = ts.default_config_frames.__wrapped__()
    oracle = ts.default_config_oracle.__wrapped__()
    for seed in range(seeds):
        got, want, _, _ = frames(seed)
        g, w = got.image.numpy(), np.asarray(want.image)
        past = np.abs(g - w).max(axis=-1) > 5e-5
        o = oracle(seed)
        print(f"4. seed {seed}: {past.sum()} px past 5e-5; at them |port - "
              f"oracle| {np.abs(g - o).max(axis=-1)[past].round(6).tolist()}, "
              f"|JAX - oracle| {np.abs(w - o).max(axis=-1)[past].round(6).tolist()}",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exhaustive", action="store_true")
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args()
    sqrt_share()
    tangent(args.exhaustive)
    sphere_lanes()
    slice_seeds(args.seeds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
