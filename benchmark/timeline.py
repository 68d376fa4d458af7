"""What a traced run keeps, and the arithmetic the per-layer readers share.

A traced run records, on the profiler's one clock and relative to the start
of the measured window: the benchmark's host spans (``dispatch``,
``camera_host``, ``wait``) and every device activity (kernels, copies,
fills) as ``(name, start_s, end_s)``.
"""

from __future__ import annotations

import re

SPAN_PREFIX = "bench."
_IDENT = re.compile(r"([A-Za-z_][A-Za-z_0-9]*)\s*(?:<|\()")


def kernel_name(signature: str) -> str:
    """The function's name in a demangled kernel signature (``void
    render_kernel<true, 4>(Params)`` -> ``render_kernel``); the signature
    itself when it names no function (``Memcpy HtoD ...``)."""
    if signature.startswith(("Memcpy", "Memset")):
        return " ".join(signature.split()[:2])
    for m in _IDENT.finditer(signature):
        if m.group(1) not in ("void", "__launch_bounds__"):
            return m.group(1)
    return signature


def clipped(intervals, lo: float, hi: float):
    for name, s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            yield name, s, e


def union(intervals) -> list:
    """Sorted, merged (start, end) pairs of ``(name, start, end)``."""
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(records: dict) -> float:
    w = records["window_s"]
    return sum(e - s for s, e in union(clipped(records["device"], 0.0, w)))


def kernel_ms_per_frame(records: dict, names) -> float | None:
    """Device milliseconds a frame of the kernels named ``names``, or None
    where none of them ran in the window."""
    if not records.get("device"):
        return None
    w = records["window_s"]
    total, seen = 0.0, False
    for name, s, e in clipped(records["device"], 0.0, w):
        if kernel_name(name) in names:
            total += e - s
            seen = True
    return total * 1e3 / records["frames"] if seen else None


def span_ms_per_frame(records: dict, span: str) -> float | None:
    """Host milliseconds a frame in the benchmark's span ``span``, or None
    where the window holds no such span."""
    durations = [e - s for name, s, e in records.get("spans", ())
                 if name == span]
    if not durations:
        return None
    return sum(durations) * 1e3 / records["frames"]


def breakdown(records: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each gap named by the host span it fell in."""
    w = records["window_s"]
    by_op = {}
    for name, s, e in clipped(records["device"], 0.0, w):
        key = kernel_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    busy = union(clipped(records["device"], 0.0, w))
    gaps, prev = [], 0.0
    for s, e in busy + [[w, w]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = sorted(records.get("spans", ()), key=lambda x: x[1])

    def label(lo, hi):
        mid = (lo + hi) / 2
        inner = [n for n, s, e in spans if s <= mid <= e]
        return inner[-1] if inner else "host_other"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[label(lo, hi), hi - lo] for lo, hi in gaps[:10]]}
