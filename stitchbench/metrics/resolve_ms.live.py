"""resolve_ms.live: mean wall milliseconds of the recalibrate_mesh calls
that ran inside the window (the benchmark's wrapper on the stitcher)."""


def read(ctx):
    spans = ctx["resolve_ms"]
    return sum(spans) / len(spans) if spans else None
