"""Median query latency over the window, from each query's due time to
its result (the same timing as ``query_p95_ms``)."""

from portbench import stats


def read(layer):
    lat = layer.get("latency_ms")
    return stats.percentile(lat, 50) if lat else None
