"""frame_ms: the measured window over the frames completed in it (ms)."""


def read(records: dict):
    return records["window_s"] * 1e3 / records["frames"]
