"""front_end_idle_ms: device idle time a frame that falls inside the
renderer's own host path (ms): the gaps of the union of the device's
activities over the window, intersected with the port's spans
``frame_setup`` and ``queue``. The rest of ``device_idle_pct`` lies in the
harness's loop between frames. Absent without device records or where the
program opens no such span."""

from timeline import clipped, union

SPANS = ("frame_setup", "queue")


def _shared(a, b) -> float:
    """The length two sorted lists of disjoint ``[start, end]`` pairs
    have in common."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(records: dict):
    if not records.get("device"):
        return None
    w = records["window_s"]
    front = union(clipped((s for s in records.get("spans", ())
                           if s[0] in SPANS), 0.0, w))
    if not front:
        return None
    busy = union(clipped(records["device"], 0.0, w))
    idle = sum(e - s for s, e in front) - _shared(front, busy)
    return idle * 1e3 / records["frames"]
