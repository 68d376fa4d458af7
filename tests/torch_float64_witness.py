"""Float64 witness for the CPU mismatches between the port and the JAX
package that ROADMAP §C logs.

    JAX_PLATFORMS=cpu python tests/torch_float64_witness.py [--seeds 13] [--map]

At the settings of ``test_torch_megakernel.py`` (``final_scene(seed=42,
grid=4)``, 96x64, 2 spp, 4 bounces, off/grouped) it renders each frame seed
three ways: the JAX kernel (Pallas interpret mode), the port's plain version
in float32, and the port's plain version replayed in float64 on the same
float32 inputs (sphere table, camera row, PCG draws). The float64 frame
stands for the exact path of each pixel. Per seed it prints how many pixels
each float32 frame puts past 5e-5 from the other and from the float64 one,
and the segment counts; per pixel where the two packages differ, the first
segment where the port's float32 path leaves the float64 path: both rays,
the sphere, and in float64 whether that sphere's near root hits each ray.
``--map`` gives both kernels the seeded sample map and sample offset 5 of
``test_torch_film.py::test_render_tiles_spp_map_and_offset_match_jax``
(sums, not means).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import conftest  # noqa: E402,F401  (the suite's cheap TPU-schedule knobs)
import bevyray_tpu_torch as bt  # noqa: E402
from bevyray_tpu import RenderConfig as JRenderConfig  # noqa: E402
from bevyray_tpu import rtiow as jrtiow  # noqa: E402
from bevyray_tpu.kernels.pallas import megakernel as jmk  # noqa: E402
from bevyray_tpu_torch.kernels.cuda import megakernel as mk  # noqa: E402
from test_torch_megakernel import SLICE, _inputs  # noqa: E402

W, H = 96, 64
T_MIN = 1e-3


def traced(kscene, pcam, cfg, seed, f64=False, **kw):
    """The plain version's frame and, per ``_intersect`` call (sample-major,
    bounce-minor), the rays, hits and active lanes; ``f64`` replays it in
    float64 on the same float32 inputs (float64 copies of the tables)."""
    calls = []
    real = mk._intersect

    def spy(o, d, active, *a, **k):
        t, idx = real(o, d, active, *a, **k)
        calls.append((torch.stack(list(o)), torch.stack(list(d)), t, idx,
                      active))
        return t, idx

    if f64:
        kscene = kscene._replace(sph=kscene.sph.double(),
                                 attr=kscene.attr.double(),
                                 gaabb=kscene.gaabb.double())
    mk._intersect = spy
    try:
        out = mk.render_tiles_reference(kscene, pcam, cfg, seed, **kw)
    finally:
        mk._intersect = real
    return out, calls


def past(a, b) -> np.ndarray:
    return np.max([np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
                   for x, y in zip(a[:3], b[:3])], axis=0) > 5e-5


def sphere_witness(sph, i, o, d) -> str:
    oc = sph[:3, i] - o
    h, a = d @ oc, d @ d
    cc = oc @ oc - sph[3, i]
    disc = h * h - a * cc
    root = (h - np.sqrt(disc)) / a if disc >= 0 else float("nan")
    return (f"disc {disc:.6g} ({disc / (h * h):.3g} of h^2), near root t "
            f"{root:.9g}, hits {bool(disc >= 0 and root > T_MIN)}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[13])
    parser.add_argument("--map", action="store_true")
    args = parser.parse_args()
    js, jcam, kscene, pcam = _inputs(jrtiow.final_scene(seed=42, grid=4), W, H)
    cfg = bt.RenderConfig(width=W, height=H, **SLICE)
    kw = {}
    if args.map:
        spp_map = np.random.default_rng(3).integers(
            0, SLICE["samples_per_pixel"] + 1,
            (2, mk.TILE // 128, 128)).astype(np.int32)
        kw = dict(normalize=False, sample_offset=5,
                  spp_map=torch.as_tensor(spp_map))
    jscene = jmk.jitted_prepare(0, "kd")(js)
    jcfg = JRenderConfig(width=W, height=H, **SLICE)
    render = jax.jit(lambda seed: jmk.render_tiles(
        jscene, jcam, jcfg, seed, exact_rng=True,
        **({**kw, "spp_map": spp_map} if args.map else {})))
    sph = kscene.sph.numpy().astype(np.float64)
    nb = SLICE["bounces"] + 1
    for seed in args.seeds:
        want = render(np.uint32(seed))
        got, calls = traced(kscene, pcam, cfg, seed, **kw)
        exact, calls64 = traced(kscene, pcam, cfg, seed, f64=True, **kw)
        lanes = np.nonzero(past(got, want))[0]
        print(f"seed {seed}: port vs JAX {lanes.size} px past 5e-5, port vs "
              f"float64 {int(past(got, exact).sum())}, JAX vs float64 "
              f"{int(past(want, exact).sum())}; segments port "
              f"{int(got[4])}, JAX {int(want[4])}, float64 {int(exact[4])}",
              flush=True)
        for lane in lanes:
            print(f"  lane {lane}: r/g/b/depth port "
                  f"{[round(float(x[lane]), 6) for x in got[:4]]}, JAX "
                  f"{[round(float(x[lane]), 6) for x in want[:4]]}, float64 "
                  f"{[round(float(x[lane]), 6) for x in exact[:4]]}")
            for k, (c32, c64) in enumerate(zip(calls, calls64)):
                act32, act64 = bool(c32[4][lane]), bool(c64[4][lane])
                i32, i64 = int(c32[3][lane]), int(c64[3][lane])
                if (act32, i32) == (act64, i64) or not (act32 or act64):
                    continue
                s, b = divmod(k, nb)
                print(f"    sample {s} bounce {b}: float32 path hits sphere "
                      f"{i32}, float64 path {i64} (-1: miss)")
                for name, c in (("float32", c32), ("float64", c64)):
                    o = c[0][:, lane].double().numpy()
                    d = c[1][:, lane].double().numpy()
                    print(f"      {name} ray o {o.tolist()} d {d.tolist()}")
                    for i in sorted({i32, i64} - {-1}):
                        print(f"        sphere {i} (center "
                              f"{sph[:3, i].tolist()}, r^2 {sph[3, i]:.9g}) "
                              f"in float64: {sphere_witness(sph, i, o, d)}")
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
