"""device_idle_pct: the share of the traced window in which no operation
ran on the card (%): 100 x (1 - union of device intervals / window)."""

from timeline import busy_s


def read(records: dict):
    if not records.get("device"):
        return None
    return 100.0 * (1.0 - busy_s(records) / records["window_s"])
