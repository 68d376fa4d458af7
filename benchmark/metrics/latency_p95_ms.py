"""latency_p95_ms: the 95th percentile of every frame's latency in the
window, each from the moment the host took up its inputs to the moment its
image was complete on the card (ms)."""

import statistics


def read(records: dict):
    lat = records["latency_ms"]
    if len(lat) < 2:
        return lat[0]
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
