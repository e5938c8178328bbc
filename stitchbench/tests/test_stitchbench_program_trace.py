"""The program's trace read beside the card's (stitchbench/program_trace.py):
on a hand-made trace, and on a stretch of a traced run recorded on the
card with the port's tracer on (data/trace_dev_marks.json): the stage
split, the re-solve's programs, the clock, the idle gaps named by the
program's spans, and the markers left out of every sum of the card's
work."""

import json
from pathlib import Path

import pytest

from stitchbench import program_trace as pt
from stitchbench import trace
from video_stitcher_tpu_torch.utils.trace import Anchor, Span

DATA = Path(__file__).resolve().parent / "data"
MS = 1e6


def mark(name, t, stream=7):
    return pt.Dev(name, "mark", t, t + 0.002 * MS, stream)


def kern(name, t0, t1, stream=7, kind="kernel"):
    return pt.Dev(name, kind, t0 * MS, t1 * MS, stream)


def hand_made():
    """Two step replays on stream 7 (the second cut by the trace's end),
    one re-solve program bracket on stream 9, an anchor each side."""
    ev = [kern("Memcpy DtoD", 0.0, 0.1, kind="copy"),
          mark("step.begin", 0.1 * MS), kern("nv12", 0.11, 1.0),
          mark("step.warp", 1.0 * MS),
          kern("void RemapGain<float>", 1.01, 1.13),
          mark("step.blend", 1.2 * MS), kern("gather", 1.21, 8.0),
          kern("add", 8.0, 9.0),
          mark("step.output", 9.0 * MS), kern("resize", 9.01, 9.5),
          mark("step.end", 9.5 * MS), kern("clone", 9.6, 9.7),
          mark("step.begin", 12.0 * MS), kern("nv12", 12.01, 13.0),
          mark("resolve.detect", 2.0 * MS, 9), kern("orb", 2.1, 5.0, 9),
          mark("resolve.end", 5.1 * MS, 9), kern("draw", 5.2, 5.3, 9),
          mark("anchor.0", -1.0 * MS, 11),
          mark("anchor.1", 14.0 * MS, 11)]
    return sorted(ev, key=lambda d: d.t0)


def test_stage_split_by_hand():
    split = pt.stage_split(hand_made())
    assert split["replays"] == 1 and split["stream"] == 7
    assert split["prep_ns"] == pytest.approx(0.89 * MS)
    assert split["warp_ns"] == pytest.approx(0.12 * MS)
    assert split["k1_ns"] == pytest.approx(0.12 * MS)
    assert split["blend_ns"] == pytest.approx(7.79 * MS)
    assert split["output_ns"] == pytest.approx(0.49 * MS)


def test_resolve_split_and_coverage_by_hand():
    ev = hand_made()
    assert pt.resolve_split(ev, [(1.5 * MS, 6.0 * MS)]) == [
        pytest.approx(2.9 * MS)]
    # a re-solve that runs past the trace is not whole
    assert pt.resolve_split(ev, [(1.5 * MS, 20.0 * MS)]) == []
    cov = pt.coverage(ev)
    work, marks = pt.strip_marks(ev)
    assert cov["marks"] == len(marks) == 10
    assert cov["device_ns"] == pytest.approx(
        sum(d.t1 - d.t0 for d in work))
    assert cov["stages_ns"] == pytest.approx(9.29 * MS)
    assert cov["resolve_ns"] == pytest.approx(2.9 * MS)
    # the copy in, the clone, the cut replay's prep
    assert cov["step_outside_ns"] == pytest.approx((0.1 + 0.1 + 0.99) * MS)
    assert cov["rest"] == [["draw", pytest.approx(0.1 * MS)]]


def test_markers_stay_out_of_the_cards_work():
    ev = hand_made()
    work, marks = pt.strip_marks(ev)
    plain = [(d.name, d.kind, d.t0 / 1e9, d.t1 / 1e9) for d in work]
    red = trace.reduce(plain, 0.0, 0.014)
    assert red["busy_s"] * 1e9 == pytest.approx(pt._busy(
        [d for d in work if d.t0 < 14 * MS]))
    assert not any("step." in n for n in red["by_name"])
    gaps = pt.idle_gaps(ev, 0.0, 14.0 * MS)
    assert sum(e - s for s, e in gaps) == pytest.approx(
        14.0 * MS - red["busy_s"] * 1e9)


def test_clock_from_anchors():
    ev = hand_made()
    _, marks = pt.strip_marks(ev)
    host_off = 5e12
    anchors = [("anchor.0", -1.0 * MS - host_off - 20e3,
                -1.0 * MS - host_off + 20e3, 0),
               ("anchor.1", 14.0 * MS - host_off - 50e3,
                14.0 * MS - host_off + 30e3, 1)]
    clk = pt.clock(anchors, marks)
    (h0, off0, w0), (h1, off1, w1) = clk["points"]
    assert off0 == pytest.approx(host_off)
    assert clk["start_width_us"] == pytest.approx(40.0)
    assert clk["stop_width_us"] == pytest.approx(80.0)
    assert clk["drift_us"] == pytest.approx(10.0)
    # between the points the offset is interpolated
    h = (h0 + h1) / 2
    assert pt.to_card(clk["points"], h) == pytest.approx(
        h + host_off + 5e3)
    assert pt.to_host(clk["points"], pt.to_card(clk["points"], h)) == \
        pytest.approx(h)
    assert pt.clock([], marks) == {}


def test_stretch_ends_at_the_last_replay():
    """The anchors bound the stretch; after the last replay's end the
    source has closed and the card only idles."""
    _, marks = pt.strip_marks(hand_made())
    assert pt.stretch(marks) == (-1.0 * MS, 9.5 * MS + 0.002 * MS)
    assert pt.stretch([m for m in marks if m.name.startswith("anchor")]) \
        == (-1.0 * MS, 14.0 * MS + 0.002 * MS)
    assert pt.stretch([m for m in marks if m.name.startswith("step")]) \
        is None


def spans_by_hand():
    """The step loop waiting on the swap lock while the re-solve thread
    solves; a queue's wait, which names no thread's work."""
    return [Span(1, None, "step.launch", "MainThread", 100, 900, 4),
            Span(2, 1, "lock.wait", "MainThread", 120, 880, 4),
            Span(3, None, "resolve", "resolve", 0, 1000, None),
            Span(4, 3, "resolve.solve", "resolve", 50, 950, None),
            Span(5, None, "queue.staged", "queue", 0, 1000, 5),
            Span(6, None, "consume", "consumer", 0, 10, 3)]


def test_gaps_named_by_the_spans_open():
    sp = spans_by_hand()
    assert pt.gap_name(sp, 500) == \
        "idle_in_step.launch/lock.wait+resolve.solve"
    assert pt.gap_name(sp, 5) == "idle_in_consume+resolve"
    assert pt.gap_name(sp, 2000) == "idle_in_none"
    ev = [kern("a", 0.0, 0.0001), kern("b", 0.0009, 0.001)]
    named = pt.name_gaps(ev, sp, [(0.0, 0.0, 0.0)], 0.0, 1000.0)
    assert named == [["idle_in_step.launch/lock.wait+resolve.solve",
                      pytest.approx(800e-9)]]


def test_program_metrics_from_spans():
    s = 1_000_000_000
    sp = [Span(1, None, "capture", "MainThread", 1, 3 * s // 10, None, "k"),
          Span(2, None, "step.launch", "MainThread", 2 * s, 2 * s + 100, 0),
          Span(3, None, "step.launch", "MainThread", 3 * s, 3 * s + 300, 1),
          Span(4, None, "queue.staged", "queue", 2 * s, 2 * s + 1000, 0),
          Span(5, None, "queue.results", "queue", 2 * s, 2 * s + 3000, 0),
          Span(6, None, "resolve", "resolve", 4 * s, 4 * s + 10_000, None),
          Span(7, 6, "resolve.fetch", "resolve", 4 * s, 4 * s + 3000, None),
          Span(8, 6, "resolve.install", "resolve", 4 * s + 5000,
               4 * s + 9000, None),
          Span(9, 8, "lock.wait", "resolve", 4 * s + 5000, 4 * s + 6000,
               None)]
    got = pt.program_metrics(sp, 1.0, 5.0)
    assert got["launch_ms.dev"] == pytest.approx(200e-6)
    assert got["queue_wait_ms.live"] == pytest.approx(4000e-6)
    assert got["resolve_host_ms.live"] == pytest.approx(6000e-6)
    assert got["capture_s"] == pytest.approx(0.3, abs=1e-8)
    assert "stage_ms.live" not in got and "blend_device_ms.dev" not in got


def recorded():
    with open(DATA / "trace_dev_marks.json") as f:
        rec = json.load(f)
    events = [pt.Dev(*e) for e in rec["events"]]
    spans = [Span(*s) for s in rec["spans"]]
    anchors = [Anchor(*a) for a in rec["anchors"]]
    return rec, events, spans, anchors


def test_recorded_stage_split_and_markers():
    rec, events, spans, _ = recorded()
    work, marks = pt.strip_marks(events)
    assert marks and all("trace_mark" not in d.name for d in events)
    split = pt.stage_split(events)
    assert split["replays"] >= 1
    per = {s: split[f"{s}_ns"] / split["replays"] for s in pt.STAGES}
    assert all(v > 0 for v in per.values())
    assert per["blend"] == max(per.values())
    # the warp stage is K1, and nothing else of weight
    assert split["k1_ns"] == pytest.approx(split["warp_ns"], rel=0.02)
    # the markers leave the card's busy and device time as they were
    w0, w1 = rec["w0"], rec["w1"]
    plain = [(d.name, d.kind, d.t0 / 1e9, d.t1 / 1e9) for d in work]
    plain += [("window", "mark", w0 / 1e9, w0 / 1e9),
              ("window", "mark", w1 / 1e9, w1 / 1e9)]
    red = trace.reduce(plain, w0 / 1e9, w1 / 1e9)
    with_marks = trace.reduce(
        plain + [(d.name, "kernel", d.t0 / 1e9, d.t1 / 1e9) for d in marks],
        w0 / 1e9, w1 / 1e9)
    assert red["device_s"] < with_marks["device_s"]
    assert with_marks["device_s"] - red["device_s"] <= sum(
        d.t1 - d.t0 for d in marks) / 1e9 + 1e-12
    clipped = [d._replace(t0=max(d.t0, w0), t1=min(d.t1, w1)) for d in work
               if d.t1 > w0 and d.t0 < w1]
    assert red["busy_s"] == pytest.approx(pt._busy(clipped) / 1e9)


def test_recorded_gap_is_named_by_the_programs_spans():
    rec, events, spans, _ = recorded()
    points = [tuple(p) for p in rec["points"]]
    named = pt.name_gaps(events, spans, points, rec["w0"], rec["w1"])
    assert named
    longest, seconds = named[0]
    assert seconds > 0
    # where a Runner thread is inside a span at the longest gap's
    # midpoint, the gap is named by it
    g0, g1 = pt.idle_gaps(events, rec["w0"], rec["w1"])[0]
    assert (g1 - g0) / 1e9 == pytest.approx(seconds)
    threads = pt.open_at(spans, pt.to_host(points, (g0 + g1) / 2))
    assert (longest == "idle_in_none") == (not threads)
