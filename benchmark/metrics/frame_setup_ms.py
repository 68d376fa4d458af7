"""frame_setup_ms: host time a frame in the renderer's set-up of the frame
(ms; the port's span ``frame_setup``: ``FusedRenderer.render``'s kernel
tables and shortlists looked up, or built; ``render_impl``'s backend,
sample state and sums). Absent where the program opens no such span."""

from timeline import span_ms_per_frame


def read(records: dict):
    return span_ms_per_frame(records, "frame_setup")
