"""count_p95_ms: the 95th percentile of the host-clock latencies of every
count in the window (rank 0's on several cards), from the call to the
returned int, in ms (statistics.quantiles, n=20)."""

import statistics


def read(run):
    lat = run["latency_ms"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20)[-1]
