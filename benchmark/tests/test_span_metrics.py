"""The readers of the program's own spans on made-up records: the front-end's
host time, the device idle time inside it, the fused renderer's cache
builds, and nothing read where the program opens no span."""

import pytest

import harness

# Two frames in a 1.0 s window. Device: 0.10-0.40, 0.55-0.90.
DEVICE = [("void render_kernel<true, 4>(Params)", 0.10, 0.40),
          ("resolve_kernel(Frame)", 0.55, 0.60),
          ("void render_kernel<true, 4>(Params)", 0.60, 0.90)]
# The harness's spans, and the port's inside ``dispatch``: the first
# frame's set-up holds both cache builds; the second frame's queue ends
# after its first launch has started (a gap only partly inside a span).
SPANS = [("dispatch", 0.00, 0.12), ("frame_setup", 0.01, 0.06),
         ("tables_build", 0.02, 0.04), ("shortlists_build", 0.04, 0.05),
         ("queue", 0.06, 0.12), ("wait", 0.12, 0.40),
         ("dispatch", 0.45, 0.62), ("frame_setup", 0.45, 0.50),
         ("queue", 0.50, 0.62), ("wait", 0.62, 0.90)]
RECORDS = {"window_s": 1.0, "frames": 2, "device": DEVICE, "spans": SPANS}


def read(name, records=RECORDS):
    return harness.load_module("metrics", name).read(records)


def test_front_end_host_time():
    assert read("frame_setup_ms") == pytest.approx((0.05 + 0.05) * 500)
    assert read("queue_ms") == pytest.approx((0.06 + 0.12) * 500)


def test_front_end_idle_time():
    # Idle inside the front end's spans: 0.01-0.10 in the first frame;
    # 0.45-0.55 in the second, whose queue runs on to 0.62 while the card
    # is busy from 0.55.
    assert read("front_end_idle_ms") == pytest.approx((0.09 + 0.10) * 500)


def test_front_end_idle_time_clipped_to_the_window():
    spans = SPANS + [("frame_setup", 0.95, 1.20)]
    records = dict(RECORDS, spans=spans)
    assert read("front_end_idle_ms", records) == pytest.approx(
        (0.09 + 0.10 + 0.05) * 500)


def test_cache_builds():
    assert read("cache_builds") == pytest.approx(2 / 2)
    none = [s for s in SPANS if not s[0].endswith("_build")]
    assert read("cache_builds", dict(RECORDS, spans=none)) == 0.0


def test_nothing_to_read_without_the_programs_spans():
    harness_only = [s for s in SPANS if s[0] in ("dispatch", "wait")]
    parent = dict(RECORDS, spans=harness_only)
    for name in ("frame_setup_ms", "queue_ms", "front_end_idle_ms",
                 "cache_builds"):
        assert read(name, parent) is None
    assert read("front_end_idle_ms", dict(RECORDS, device=[])) is None
