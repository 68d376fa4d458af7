"""The metric readers on made-up records: what each reads, and that a
reader with nothing to read returns nothing."""

import pytest

import harness
import timeline

KERNELS = [("void render_kernel<true, 4>(Params)", 0.10, 0.30),
           ("void render_kernel<true, 4>(Params)", 0.50, 0.70),
           ("dense_kernel(float const*, int)", 0.30, 0.35),
           ("shade_kernel(State)", 0.35, 0.40),
           ("Memcpy HtoD (Pinned -> Device)", 0.72, 0.74),
           ("void render_kernel<true, 4>(Params)", 0.95, 1.20)]
SPANS = [("dispatch", 0.00, 0.08), ("camera_host", 0.40, 0.48),
         ("wait", 0.48, 0.50), ("dispatch", 0.80, 0.90)]
RECORDS = {"window_s": 1.0, "frames": 4, "setup_s": 7.5,
           "latency_ms": [10.0, 12.0, 11.0, 30.0], "device": KERNELS,
           "spans": SPANS}


def read(name, records=RECORDS):
    return harness.load_module("metrics", name).read(records)


def test_frame_and_setup():
    assert read("frame_ms") == pytest.approx(250.0)
    assert read("setup_s") == 7.5
    assert 12.0 < read("latency_p95_ms") <= 30.0
    assert read("latency_p95_ms", dict(RECORDS, latency_ms=[4.0])) == 4.0


def test_kernel_readers():
    # The last render_kernel runs past the window: clipped at 1.0.
    assert read("fused_kernel_ms") == pytest.approx((0.2 + 0.2 + 0.05) * 250)
    assert read("ray_tests_ms") == pytest.approx(0.05 * 250)
    assert read("shade_ms") == pytest.approx(0.05 * 250)


def test_span_readers():
    assert read("dispatch_ms") == pytest.approx(0.18 * 250)
    assert read("camera_host_ms") == pytest.approx(0.08 * 250)


def test_idle_share():
    busy = 0.2 + 0.2 + 0.05 + 0.05 + 0.02 + 0.05
    assert timeline.busy_s(RECORDS) == pytest.approx(busy)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - busy))


def test_nothing_to_read():
    empty = dict(RECORDS, device=[], spans=[])
    for name in ("fused_kernel_ms", "ray_tests_ms", "shade_ms",
                 "dispatch_ms", "camera_host_ms", "device_idle_pct"):
        assert read(name, empty) is None
    other = dict(RECORDS, device=[("dense_kernel()", 0.1, 0.2)])
    assert read("fused_kernel_ms", other) is None


def test_breakdown():
    b = timeline.breakdown(RECORDS)
    ops = [k for k, _ in b["device_ops"]]
    assert ops[0] == "render_kernel" and ops[-1] == "Memcpy HtoD"
    assert sorted(ops[1:3]) == ["dense_kernel", "shade_kernel"]
    # Idle: 0-0.1, 0.4-0.5, 0.7-0.72, 0.74-0.95, each named by the span its
    # middle falls in, longest first.
    names = [n for n, _ in b["idle_gaps"]]
    lengths = [round(x, 6) for _, x in b["idle_gaps"]]
    assert lengths == [0.21, 0.1, 0.1, 0.02]
    assert names[0] == "dispatch" and names[-1] == "host_other"
    assert sorted(names[1:3]) == ["camera_host", "dispatch"]
