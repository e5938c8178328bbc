"""The trace's reduction and each per-layer reader on a recorded trace,
and the byte counts from a cell's shapes."""

import json
import math
from pathlib import Path

import pytest
import torch

from stitchbench import harness, trace
from stitchbench.stats import nearest_rank

DATA = Path(__file__).resolve().parent / "data"
BENCH = harness.load_benchmark()


def recorded():
    with open(DATA / "trace_dev_flat.json") as f:
        rec = json.load(f)
    return [tuple(e) for e in rec["events"]], rec


def test_reduce_recorded_trace():
    events, rec = recorded()
    w0, w1 = trace.bounds(events)
    red = trace.reduce(events, w0, w1)
    assert 0 < red["busy_s"] <= red["window_s"] == pytest.approx(w1 - w0)
    assert red["device_s"] >= red["busy_s"]
    assert len(red["device_ops"]) <= 10 and len(red["idle_gaps"]) <= 10
    gaps = [g for _, g in red["idle_gaps"]]
    assert gaps == sorted(gaps, reverse=True)
    assert red["busy_s"] + sum(gaps) <= red["window_s"] + 1e-9


def test_reduce_by_hand():
    ev = [("window", "mark", 0.0, 0.0), ("window", "mark", 1.0, 1.0),
          ("k1", "kernel", 0.1, 0.3), ("k2", "kernel", 0.2, 0.4),
          ("Memcpy HtoD", "copy", 0.6, 0.7), ("stitch_out", "host", 0.4, 0.5)]
    red = trace.reduce(ev, *trace.bounds(ev))
    assert red["busy_s"] == pytest.approx(0.4)
    assert red["device_s"] == pytest.approx(0.5)
    assert red["idle_gaps"][0] == ["idle_in_none", pytest.approx(0.3)]
    assert ["idle_in_stitch_out", pytest.approx(0.2)] in red["idle_gaps"]


def ctx_for(cell, red):
    n, bh, bw, h, w = 2, 32, 128, 40, 60
    maps = torch.full((n, 2, bh, bw), -5.0)
    maps[:, 0, :16, :64] = 10.5
    maps[:, 1, :16, :64] = 20.5
    return {
        "seconds": 4.0, "setup_s": 3.0, "completed_in_window": 400,
        "latencies_ms": [10.0] * 95 + [30.0] * 4 + [math.inf],
        "calibrate_s": 2.0, "resolve_ms": [180.0, 200.0],
        "frame_format": "nv12",
        "maps": maps, "src_hw": (h, w), "peak_bytes_per_s": 3.35e12,
        "trace": red}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_reader_reads_the_recorded_trace(cell):
    events, rec = recorded()
    red = trace.reduce(events, *trace.bounds(events))
    red["frames"] = rec["frames"]
    ctx = ctx_for(cell, red)
    for name in (harness.cell_metrics(BENCH, cell, False)
                 + harness.cell_metrics(BENCH, cell, True)):
        v = harness.load_module("metrics", name).read(ctx)
        assert v is not None and math.isfinite(v) and v > 0, name
        if name.endswith("roofline.dev") or name.startswith("device_idle"):
            assert v <= 100.0


def test_readers_without_a_trace_read_nothing():
    ctx = ctx_for("r1080-nv12-dev-flat", None)
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.load_module("metrics", m["name"]).read(ctx) is None


def test_nearest_rank():
    assert nearest_rank([3.0, 1.0, 2.0, 4.0], 0.5) == 2.0
    assert nearest_rank([1.0] * 19 + [math.inf], 0.95) == 1.0
    assert nearest_rank([1.0] * 18 + [math.inf] * 2, 0.95) == math.inf


def test_byte_counts_from_shapes():
    k1 = harness.load_module("roofline", "k1")
    ctx = ctx_for("r1080-nv12-dev-flat", None)
    # one 64 x 16 tile a camera reads, at one source point: its 2 x 2 taps
    out = 2 * 3 * 32 * 128 * 4
    maps = 2 * 16 * 64 * 2 * 4
    src = 2 * 4 * 3 * 4
    plan = 2 * (2 * 2) * 4
    assert k1.bytes_needed(ctx) == out + maps + src + plan
    ctx["frame_format"] = "rgb"
    assert k1.bytes_needed(ctx) == out + maps + src // 4 + plan


def test_k1_counts_taps_at_the_edges():
    k1 = harness.load_module("roofline", "k1")
    maps = torch.tensor([[[[-0.5, 59.5, 100.0]], [[0.0, 39.0, 0.0]]]])
    (reads, idx), = list(k1.taps(maps, 40, 60))
    assert reads.tolist() == [[True, True, False]]
    # (-0.5, 0): taps x -1, 0 at rows 0, 1 -> 2 inside; (59.5, 39): x 59
    # at row 39 -> 1 inside
    assert sorted(idx.tolist()) == [0, 60, 39 * 60 + 59]
