"""latency_p95_ms: 95th percentile, by nearest rank, over every frame set
due in the window, from its due time on the schedule to its output frame
in host memory; a frame that never came sits above every latency."""

from stitchbench.stats import nearest_rank


def read(ctx):
    return nearest_rank(ctx["latencies_ms"], 0.95)
