"""dispatch_ms: host time a frame in the renderer's ``render`` call, the
frame's queueing (ms; the benchmark's ``dispatch`` span)."""

from timeline import span_ms_per_frame


def read(records: dict):
    return span_ms_per_frame(records, "dispatch")
