"""camera_host_ms: host time a frame in the per-camera work of the next
frame: ``World.camera_state``, ``raster_layer`` and ``FusedRenderer.
shortlists`` (ms; the benchmark's ``camera_host`` span). Absent where the
camera never moves in the window."""

from timeline import span_ms_per_frame


def read(records: dict):
    return span_ms_per_frame(records, "camera_host")
