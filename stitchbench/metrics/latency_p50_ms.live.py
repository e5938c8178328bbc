"""latency_p50_ms.live: the median of latency_p95_ms's samples."""

from stitchbench.stats import nearest_rank


def read(ctx):
    return nearest_rank(ctx["latencies_ms"], 0.50)
