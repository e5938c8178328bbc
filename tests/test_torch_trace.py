"""The port's tracer (utils/trace.py) on the CPU: off, a Runner records no
span; on, the spans of the Runner's threads and of the re-solve nest
under the right parents and carry each frame set's id from its
acquisition to its consumption; the program's counters count; the
Runner's StageTimers read the spans; the exporter writes the program's
spans into trace.json, and the Runner stops its profiler only once its
threads have ended; the clock anchors recover a planted offset."""

import dataclasses
import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
from video_stitcher_tpu_torch.pipeline.runner import Runner
from video_stitcher_tpu_torch.utils import devsync, trace

CFG = StitcherConfig(num_images=6, input_width=320, input_height=180,
                     output_width=320, output_height=160, recalibrate=False,
                     pipeline_mode="threaded", sync_timeout_ms=10000.0)

#: the spans every frame set consumed by the threaded Runner carries
FRAME_SPANS = ("acquire", "stage", "queue.staged", "step.launch",
               "lock.wait", "replay", "results.push", "queue.results",
               "consume", "download", "sink")


@pytest.fixture(scope="module")
def rig():
    """A calibrated CPU stitcher (with the CPW mesh) and three NV12 frame
    sets of the synthetic rig."""
    src = SyntheticRigSource(CFG, plan_geometry(CFG)[0], drift_px=7.0)
    rgb = [src.get_frames() for _ in range(3)]
    st = Stitcher(CFG, device="cpu")
    st.calibrate(rgb[0])
    sets = [rgb_to_nv12(torch.from_numpy(f)).numpy() for f in rgb]
    return st, sets


@pytest.fixture(autouse=True)
def _tracer_off(tmp_path, monkeypatch):
    """Each test starts and ends with the tracer off and empty, in a
    directory of its own (the Runner writes calib/result.jpg)."""
    monkeypatch.chdir(tmp_path)
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


class CycleSource:
    def __init__(self, sets, limit=10 ** 6, until=lambda: False):
        self.sets, self.limit, self.until, self.n = sets, limit, until, 0

    def get_frames(self):
        if self.n >= self.limit or self.until():
            return None
        out = self.sets[self.n % len(self.sets)]
        self.n += 1
        return out

    def release(self):
        pass


class Sink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        self.frames.append(out)

    def release(self):
        pass


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_a_runner_records_no_span(rig):
    st, sets = rig
    assert not trace.is_on()
    assert trace.span("a") is trace.span("b")      # one shared no-op
    r = Runner(CFG, source=CycleSource(sets), max_frames=4, stitcher=st,
               sink=Sink())
    r.run()
    assert r.frames_done == 4
    assert trace.spans() == []
    assert trace.stamp() == 0 and trace.new_id() is None and \
        trace.current() is None


def test_spans_nest_and_carry_each_frame_sets_id(rig):
    """The stager's, the step loop's, the consumer's and the re-solve's
    spans under their parents, each frame set's id from acquire to
    consume, and the re-solve's stages under ``resolve``."""
    st, sets = rig
    cfg = dataclasses.replace(CFG, recalibrate=True, recalib_del_ms=200)
    trace.enable()
    box = []
    sink = Sink()
    source = CycleSource(sets, until=lambda: (
        box[0].recalibs_done >= 1 and box[0].frames_done >= 6))
    r = Runner(cfg, source=source, max_frames=400, stitcher=st, sink=sink)
    box.append(r)
    r.run()
    trace.disable()
    spans = trace.spans()
    ids = {s.id: s for s in spans}
    names = by_name(spans)
    consumed = {s.frame for s in names["consume"]}
    assert len(consumed) == len(sink.frames) >= 6
    for fid in consumed:
        got = {s.name for s in spans if s.frame == fid}
        assert set(FRAME_SPANS) <= got, (fid, set(FRAME_SPANS) - got)
    threads = {n: {s.thread for s in names[n]} for n in (
        "acquire", "stage", "step.launch", "consume", "resolve")}
    assert threads["acquire"] == threads["stage"] == {"stager"}
    assert threads["consume"] == {"consumer"}
    assert threads["resolve"] == {"resolve"}
    assert threading.current_thread().name in threads["step.launch"]
    # the parents
    # each frame set's replay under its launch (the first set's calib.jpg
    # stitch replays under its consume)
    for fid in consumed:
        assert any(ids[s.parent].name == "step.launch" and
                   ids[s.parent].frame == fid for s in names["replay"]
                   if s.frame == fid)
    for name in ("download", "sink"):
        for s in names[name]:
            assert ids[s.parent].name == "consume"
            assert ids[s.parent].frame == s.frame
    for s in names["results.push"]:
        q = ids.get(s.parent)
        if q is not None:
            assert q.name == "queue.results" and q.frame == s.frame
    assert all(s.thread == "queue" for s in names["queue.staged"]
               + names["queue.results"])
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent in ids:
            p = ids[s.parent]
            if p.thread == s.thread:
                assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    # the stages of a re-solve that installed its mesh
    installs = {s.parent for s in names["resolve.install"]}
    solve = next(s for s in names["resolve"] if s.id in installs)
    kids = {s.name for s in spans if s.parent == solve.id}
    assert {"resolve.warp", "resolve.detect", "resolve.match",
            "resolve.ransac", "resolve.fetch", "resolve.filter",
            "resolve.solve", "resolve.compose", "resolve.install"} <= kids
    install = next(s for s in spans if s.parent == solve.id
                   and s.name == "resolve.install")
    assert any(s.parent == install.id and s.name == "lock.wait"
               for s in spans)


def test_counters_count(rig):
    """The counters are the program's own plain integers: the Runner's
    frames and re-solves, each program's replays and captures."""
    st, sets = rig
    Runner(CFG, source=CycleSource(sets, limit=2), stitcher=st).run()
    progs = st.programs.programs
    replays0 = sum(p.replays for p in progs.values())
    captures0 = dict(st.programs.captures)
    r = Runner(CFG, source=CycleSource(sets, limit=5), stitcher=st)
    r.run()
    # run()'s first read warms the programs up; the stager acquires the rest
    assert r.frames_done == 4 and r.recalibs_done == 0
    # the first set's stitch_out and stitch, then one replay a frame set
    assert sum(p.replays for p in progs.values()) - replays0 >= 5
    # the first run built the Runner's programs: the second builds none
    assert captures0 and st.programs.captures == captures0
    # the CPU captures nothing: no capture time
    assert all(p.capture_s == 0.0 for p in progs.values())


@pytest.mark.parametrize("on", [False, True])
def test_runner_timers_read_the_spans(rig, on):
    st, sets = rig
    if on:
        trace.enable()
    r = Runner(CFG, source=CycleSource(sets), max_frames=5, stitcher=st)
    r.run()
    trace.disable()
    assert list(r.timers.sums) == ["acquire", "upload", "launch", "output"]
    assert r.timers.counts["launch"] == 5
    assert r.timers.counts["upload"] >= 5 and r.timers.counts["output"] == 5
    if not on:
        assert trace.spans() == []
        return
    names = by_name(trace.spans())
    for stage, span in (("acquire", "acquire"), ("upload", "stage"),
                        ("launch", "step.launch"), ("output", "consume")):
        got = names[span]
        assert r.timers.counts[stage] == len(got)
        assert r.timers.sums[stage] == pytest.approx(
            sum(s.t1 - s.t0 for s in got) / 1e9, rel=1e-9, abs=1e-9)


def test_swap_ms_and_the_rewarp_log_read_their_spans(rig, monkeypatch):
    st, sets = rig
    cfg = dataclasses.replace(CFG, recalibrate=True, recalib_interp=True,
                              recalib_del_ms=300)
    steps = max(2, cfg.recalib_del_ms // 60)
    logged = []
    from video_stitcher_tpu_torch.pipeline import runner as runner_mod
    monkeypatch.setattr(runner_mod.log, "info",
                        lambda msg, *a: logged.append(msg % a))
    trace.enable()
    box = []
    source = CycleSource(sets, until=lambda: len(box[0].swap_ms) >= steps - 1)
    r = Runner(cfg, source=source, max_frames=400, stitcher=st)
    box.append(r)
    r.run()
    trace.disable()
    names = by_name(trace.spans())
    # each timed swap is a span; the animation's last swap is one too
    spans_ms = [round((s.t1 - s.t0) / 1e6, 6) for s in names["resolve.swap"]]
    assert len(r.swap_ms) >= steps - 1
    assert len(spans_ms) > len(r.swap_ms)
    for x in r.swap_ms:
        spans_ms.remove(round(x, 6))       # raises unless a span has it
    # each logged re-solve's ms is one resolve span's, rounded
    rewarps = [float(m.split()[1]) for m in logged if m.startswith("Rewarp:")]
    assert rewarps
    ms = [(s.t1 - s.t0) / 1e6 for s in names["resolve"]]
    for x in rewarps:
        assert min(abs(x - y) for y in ms) <= 0.51


def test_a_span_in_a_deadline_worker_nests_under_the_callers():
    trace.enable()
    with trace.span("outer", frame=7) as outer:
        devsync.call_deadline(lambda: trace.span("inner").__enter__()
                              .__exit__(None, None, None), 5.0)
    trace.disable()
    names = by_name(trace.spans())
    inner, = names["inner"]
    assert inner.parent == outer.sid and inner.frame == 7
    assert inner.thread != names["outer"][0].thread


def test_gc_is_a_span_under_tracing():
    trace.enable()
    gc.collect()
    trace.disable()
    gcs = by_name(trace.spans())["gc"]
    assert any(s.arg == 2 for s in gcs)
    n = len(trace.spans())
    gc.collect()                          # off: not recorded
    assert len(trace.spans()) == n


def test_markers_launch_nothing_off_or_off_the_card(monkeypatch):
    def fail():
        raise AssertionError("the markers' library was loaded")
    monkeypatch.setattr(trace, "_marks_lib", fail)
    monkeypatch.setattr(trace, "_launch", fail)
    trace.mark("step.begin")                      # off
    trace.enable()
    trace.mark("step.begin", torch.device("cpu"))  # on, not a card
    trace.mark("step.begin", "cpu")
    assert trace.mark_names() == {} or "step.begin" not in \
        trace.mark_names().values()


def test_the_ring_is_bounded():
    trace.enable(capacity=10)
    for i in range(25):
        with trace.span("s", frame=i):
            pass
    got = trace.spans()
    assert len(got) == 10 and [s.frame for s in got] == list(range(15, 25))
    trace.enable(capacity=trace.CAPACITY)


def test_trace_dir_exporter_writes_the_programs_spans(rig, tmp_path):
    """cfg.trace_dir: the tracer records from the Runner's start, and the
    trace.json of its trace_frames holds the Runner's spans; a
    device_trace holds annotate's span, with its frame set's id."""
    st, sets = rig
    cfg = dataclasses.replace(CFG, trace_dir=str(tmp_path / "t"),
                              trace_frames=2)
    r = Runner(cfg, source=CycleSource(sets), max_frames=5, stitcher=st)
    r.run()
    assert not trace.is_on()                  # the Runner switched it off
    with open(tmp_path / "t" / "trace.json") as f:
        got = json.load(f)
    names = {e["name"] for e in got["traceEvents"]
             if e.get("cat") == "program"}
    # the step loop's launches of the traced frames (the consumer may
    # come to them only after the trace stopped)
    assert {"step.launch", "replay"} <= names
    assert "anchored" in got["programClock"]
    with trace.device_trace(str(tmp_path / "u")):
        with trace.span("outer", frame=3):
            with trace.annotate("stitch-span"):
                st.stitch_out(sets[0])
    assert not trace.is_on()
    with open(tmp_path / "u" / "trace.json") as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("name") == "stitch-span"]
    assert len(ev) == 1 and ev[0]["args"]["frame"] == 3
    assert ev[0]["dur"] >= 0 and ev[0]["tid"] == \
        threading.current_thread().name


@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_the_runner_stops_its_profiler_once_its_threads_ended(
        rig, tmp_path, monkeypatch, mode):
    """cfg.trace_dir with the re-solve running: the profiler stops only
    after the Runner's threads have ended, and the trace it writes keeps
    the spans of the trace_frames frames it stamped, not the drain's."""
    st, sets = rig
    cfg = dataclasses.replace(CFG, trace_dir=str(tmp_path / "t"),
                              trace_frames=2, pipeline_mode=mode,
                              recalibrate=True, recalib_del_ms=100)
    box, calls = [], []
    stop = trace.stop_device_trace

    def stopped(until=None):
        calls.append((until, [t.name for t in box[0].threads
                              if t.is_alive()], time.perf_counter_ns()))
        return stop(until=until)
    monkeypatch.setattr(trace, "stop_device_trace", stopped)
    source = CycleSource(sets, until=lambda: (
        box[0].recalibs_done >= 1 and box[0].frames_done >= 6))
    r = Runner(cfg, source=source, max_frames=400, stitcher=st)
    box.append(r)
    r.run()
    assert r.recalibs_done >= 1 and r.frames_done >= 6
    assert len(calls) == 1
    until, alive, t_stop = calls[0]
    assert alive == [] and until is not None and until < t_stop
    with open(tmp_path / "t" / "trace.json") as f:
        got = [e for e in json.load(f)["traceEvents"]
               if e.get("cat") == "program"]
    launched = {e["args"]["frame"] for e in got if e["name"] == "step.launch"}
    # frames 1 and 2 traced (frame 0 is the compile frame), the stamp
    # taken before frame 3's launch: no later frame's launch
    assert launched == {1, 2}
    assert not trace.is_on()


@pytest.mark.parametrize("offset", [-3.25e9, 0.0, 1234567.0, 8.8e12])
def test_anchors_recover_a_planted_offset(offset):
    """Synthetic bursts of brackets around markers whose card start lies
    anywhere inside them, on a card clock that drifts 1 ms a second and
    is set back once: each burst's narrowest bracket gives the offset
    there to within half its width; the markers' names recur, a lost
    marker is skipped, and a stamp between bursts maps by the offsets
    either side."""
    rng = np.random.default_rng(int(abs(offset)) % 1000)

    def true_offset(h):
        t = (h - 5e11) / 1e9
        return offset - 1e-3 * t * 1e9 + (4e6 if t > 0.45 else 0.0)
    anchors, starts, k = [], [], 0
    for burst in range(8):
        for width in rng.choice([180_000, 40_000, 95_000, 61_000], 4,
                                replace=False):
            h0 = int(5e11 + burst * 1e8 + k * 1e5)
            name = f"anchor.{k % trace.ANCHOR_NAMES}"
            anchors.append(trace.Anchor(name, h0, h0 + int(width), burst))
            d = h0 + rng.uniform(0, width)
            if k != 5:                        # the trace lost this one
                starts.append((name, d + true_offset(d)))
            k += 1
    points = trace.clock_points(anchors, starts[::-1])
    assert len(points) == 8
    for mid, off, width in points:
        assert abs(off - true_offset(mid)) <= width / 2 + 200
    # between two bursts of one slope: within the wider half-bracket
    h = 5e11 + 2.5e8
    assert abs(trace.to_card(points, h) - (h + true_offset(h))) <= \
        max(p[2] for p in points) / 2 + 200
    assert trace.to_host(points, trace.to_card(points, h)) == \
        pytest.approx(h, abs=1.0)
    assert trace.clock_points(anchors, []) == []


def test_spans_time_themselves_for_their_readers_while_off():
    got = []
    with trace.span("x", into=got.append):
        time.sleep(0.002)
    with trace.span("y", timed=True) as s:
        time.sleep(0.002)
    assert got[0] >= 0.0015 and s.s >= 0.0015
    assert trace.spans() == []
