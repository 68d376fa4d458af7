"""queue_ms: host time a frame in the renderer's queueing of the frame's
launches (ms; the port's span ``queue``: ``render_tiles`` and the tail in
``FusedRenderer.render``; the sample loop and the tail in ``render_impl``).
Absent where the program opens no such span."""

from timeline import span_ms_per_frame


def read(records: dict):
    return span_ms_per_frame(records, "queue")
