"""The harness end to end on the CPU at a small size (the look for a card
skipped), its traffic kinds, the result line's keys, the control and the
faults the comparison catches."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import control
import harness
from scenes import rtiow_final

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SMALL = {"resolution": [48, 27], "samples_per_pixel": 2}
# The cells BENCHMARK.json lists, and those kept ready beside them.
CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# The frozen scene behind a thin lens.
LENS = {"aperture": 0.35, "focus_distance": 3.5}


def run(cell, seed=123456789012, trace=False, **kw):
    return harness.run_cell(cell, seed, 0.5, trace, time.perf_counter(),
                            device="cpu", overrides=SMALL, **kw)


def take(gen, n):
    return [next(gen) for _ in range(n)]


def mix_frames(name, seed, n):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    kind = harness.load_module("traffic", mix["kind"])
    return take(kind.frames(mix, seed, rtiow_final.build(42)), n)


def test_orbit_poses_from_the_seed_and_never_repeated():
    seed = 2 ** 31 + 12345
    a = mix_frames("orbit-fused", seed, 3000)
    b = mix_frames("orbit-fused", seed, 3000)
    c = mix_frames("orbit-fused", seed + 1, 3000)
    assert a == b and a != c
    poses = [p["eye"] for _, p, _ in a]
    assert len(set(poses)) == len(poses)
    assert len({s for s, _, _ in a}) == len(a)
    assert all(e == () for _, _, e in a)
    # Within the 40-degree arc about the target, 5 from it.
    for eye in poses:
        assert abs((eye[0] ** 2 + eye[2] ** 2) ** 0.5 - 5.0) < 1e-9
        assert abs(eye[0]) <= 5.0 * 0.3421


@pytest.mark.parametrize("mix", ["still-fused", "still-wavefront"])
def test_still_traffic_keeps_its_pose(mix):
    frames = mix_frames(mix, 7, 50)
    assert len({json.dumps(p) for _, p, _ in frames}) == 1
    assert len({s for s, _, _ in frames}) == 50
    assert all(e == () for _, _, e in frames)


def test_edit_traffic_from_the_seed():
    seed = 2 ** 33 + 5
    a = mix_frames("edit-fused", seed, 500)
    assert a == mix_frames("edit-fused", seed, 500)
    assert a != mix_frames("edit-fused", seed + 1, 500)
    n = len(rtiow_final.build(42)["radii"])
    for _, pose, edits in a:
        assert pose["eye"] == (0.0, 0.0, 5.0)
        (index, key, (x, y, z)), = edits
        assert key == "center" and 1 <= index < n
        assert -8 <= x <= 8 and -8 <= z <= 8 and y == 0.2
    assert len({e[0][0] for _, _, e in a}) > 100


def test_edits_copy_on_write():
    scene = rtiow_final.build(42)
    before = scene["centers"].copy()
    one = harness.edited(scene, [(3, "center", (1.0, 2.0, 3.0))])
    two = harness.edited(one, [(4, "center", (0.5, 0.2, 0.5)),
                               (3, "center", (4.0, 5.0, 6.0))])
    assert (scene["centers"] == before).all()
    assert tuple(one["centers"][3]) == (1.0, 2.0, 3.0)
    assert tuple(two["centers"][3]) == (4.0, 5.0, 6.0)
    assert tuple(two["centers"][4]) == (0.5, 0.2, 0.5)
    assert tuple(one["centers"][4]) == tuple(before[4])
    assert two["radii"] is scene["radii"]


def test_no_card_no_result():
    # With every card hidden the measured run fails and prints nothing.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = ['benchmark', '.']; "
            "import harness; harness.run_cell("
            f"{CELLS[0]!r}, 1, 0.1, False, time.perf_counter(), "
            "device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "bevyray_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    result = run(cell, trace=trace)
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True and result["attempted"] >= 1
    assert result["failed"] == 0
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    if not trace:
        assert {"frame_ms", "latency_p95_ms", "setup_s"} == set(
            result["metrics"])
    else:
        # No device here: only the host spans read.
        assert "dispatch_ms" in result["metrics"]
        assert set(result["device"]) >= {"busy_s", "window_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    result = run(cell, wrap_entry=control.ControlEntry)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_fault_fails(cell, fault):
    result = run(cell, wrap_entry=control.FAULTS[fault])
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_lens_cell_is_correct(cell):
    result = run(cell, scene_overrides=LENS)
    assert result["correct"] is True
    assert result["checks"]["mismatch_share"]["value"] == 0
    assert result["checks"]["rays_gap"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_lens_control_fails(cell):
    result = run(cell, wrap_entry=control.ControlEntry, scene_overrides=LENS)
    assert result["correct"] is False
