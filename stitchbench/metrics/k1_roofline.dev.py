"""k1_roofline.dev: K1's least time (stitchbench/roofline/k1.py, at the
card's published memory bandwidth) over its mean device time a call in
the traced window, in percent."""

from stitchbench.harness import load_module


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["peak_bytes_per_s"]:
        return None
    calls = [n for n in tr["by_name"] if "RemapGain" in n]
    count = sum(tr["counts"][n] for n in calls)
    if not count:
        return None
    per_call = sum(tr["by_name"][n] for n in calls) / count
    least = load_module("roofline", "k1").bytes_needed(ctx) / ctx[
        "peak_bytes_per_s"]
    return 100.0 * least / per_call
