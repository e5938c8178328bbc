"""One run of one cell with the program's own tracer on
(``video_stitcher_tpu_torch.utils.trace``), beside the benchmark's
command:

    python3 stitchbench/traced.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> [--record PATH]

from the repository's root. It switches the tracer on before
``harness.run_cell`` builds the Stitcher, so that the programs captured
in set-up hold the step's markers, and runs the cell as
``stitchbench/run.py`` does. With ``--trace 1`` it also anchors the host's
clock at the profiler's start and stop and prints, beside the result,
what the program's trace adds (``stitchbench/program_trace.py``): the
per-layer numbers, the clock's brackets and drift, where the card's work
went, and the idle gaps named by the program's spans. With ``--trace 0``
the tracer records and no profiler runs: the tracer's own cost, and the
ring's size at the end. ``--record`` writes the stretch of the trace
around its longest idle gap, as the tests read it.

Prints one JSON line, the last of standard output: the result line's
``correct``, ``metrics`` and ``device`` and the program's numbers under
``program``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def anchored_window(base, runner_done: threading.Event,
                    every: float = 0.1):
    """stitchbench.trace.Window with a burst of the tracer's anchors
    right after the profiler's start, every `every` seconds of the
    stretch (where the window slept) and at its end, and the profiler
    stopped only once the Runner has returned (`runner_done`): stopping
    it while another thread launched a CUDA graph or recorded an event
    hung 3 of 17 traced runs on an H100, in torch.profiler's stop."""
    from video_stitcher_tpu_torch.utils import trace as ptrace

    class Anchored(base):
        anchors: tuple = ()

        def _run(self) -> None:
            import torch
            try:
                self.source.window_open.wait()
                delay = self.source.t0 + self.offset - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                self.prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                anchors = ptrace.anchor()
                self.t0 = time.perf_counter()
                end = self.t0 + self.length
                while time.perf_counter() + every < end:
                    time.sleep(every)
                    anchors += ptrace.anchor()
                time.sleep(max(0.0, end - time.perf_counter()))
                self.t1 = time.perf_counter()
                self.anchors = anchors + ptrace.anchor()
                runner_done.wait(120.0)
                self.prof.stop()
            except BaseException as e:      # noqa: BLE001 — join() raises
                self.error = e
            finally:
                self._done.set()
    return Anchored


def ring_bytes(spans) -> int:
    """Bytes the recorded spans hold: each record and the numbers in it
    (names and thread names are shared strings)."""
    total = 0
    for s in spans:
        total += sys.getsizeof(s)
        total += sum(sys.getsizeof(v) for v in (s.id, s.parent, s.t0, s.t1,
                                                 s.frame) if v is not None)
    return total


def record(path, events, spans, anchors, w0, w1, points, names):
    """The stretch of the trace 30 ms either side of its longest idle
    gap (a complete step replay or more): the card's events, the
    program's spans and the anchors."""
    from stitchbench import program_trace as pt
    gaps = pt.idle_gaps(events, w0, w1)
    mid = (gaps[0][0] + gaps[0][1]) / 2 if gaps else (w0 + w1) / 2
    lo, hi = max(w0, mid - 30e6), min(w1, mid + 30e6)
    keep = [list(d._replace(name=d.name[:100])) for d in events
            if d.t1 > lo and d.t0 < hi]
    h0, h1 = pt.to_host(points, lo), pt.to_host(points, hi)
    hs = [list(s) for s in spans if s.t1 > h0 and s.t0 < h1]
    with open(path, "w") as f:
        json.dump({"about": "a stretch of a traced run of the port with its "
                            "tracer on, around the longest idle gap: card "
                            "events (ns, profiler clock, stream ids), the "
                            "program's spans (perf_counter ns), the "
                            "clock's points (host ns, offset ns, width ns)",
                   "w0": lo, "w1": hi, "points": points,
                   "mark_names": names, "events": keep, "spans": hs,
                   "anchors": [list(a) for a in anchors]}, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", default="")
    a = p.parse_args(argv)

    import torch
    from stitchbench import harness, program_trace as pt
    from stitchbench import trace as sbtrace
    from video_stitcher_tpu_torch.utils import trace as ptrace
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ptrace.enable()
    got = {}
    collect = sbtrace.collect

    def keep(window, host_spans):
        got["window"] = window
        return collect(window, host_spans)
    sbtrace.collect = keep
    runner_done = threading.Event()
    sbtrace.Window = anchored_window(sbtrace.Window, runner_done)
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    run = Runner.run

    def run_and_tell(self):
        try:
            run(self)
        finally:
            runner_done.set()
    Runner.run = run_and_tell
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              torch.device("cuda", 0), T_START)
    spans = ptrace.spans()
    caps = [s for s in spans if s.name == "capture"]
    prog = {"spans": len(spans), "ring_bytes": ring_bytes(spans),
            "captures": len(caps),
            "capture_s": sum(s.t1 - s.t0 for s in caps) / 1e9}
    src = getattr(got.get("window"), "source", None)
    gcs = [s for s in spans if s.name == "gc" and src is not None
           and src.t0 * 1e9 <= s.t0 <= src.t1 * 1e9]
    if gcs:
        prog["gc_in_window"] = {
            "count": len(gcs), "gen2": sum(1 for s in gcs if s.arg == 2),
            "max_ms": max(s.t1 - s.t0 for s in gcs) / 1e6,
            "sum_ms": sum(s.t1 - s.t0 for s in gcs) / 1e6}
    window = got.get("window")
    if window is not None:
        names = ptrace.mark_names()
        events = pt.device_events(window.prof, names)
        work, marks = pt.strip_marks(events)
        clk = pt.clock(window.anchors, marks)
        points = clk.pop("points", None)
        prog["clock"] = dict(clk, points=len(points or ()))
        src = window.source
        prog["metrics"] = pt.program_metrics(spans, src.t0, src.t1,
                                             events, points)
        prog["stage_split"] = {k: v for k, v in pt.stage_split(
            events).items() if k != "spans"}
        if points:
            w0, w1 = pt.stretch(marks)
            inside = [d for d in events if d.t1 > w0 and d.t0 < w1]
            prog["coverage"] = pt.coverage(inside)
            prog["idle_gaps"] = pt.name_gaps(events, spans, points, w0, w1)
            prog["marks"] = len(marks)
            prog["marks_s"] = sum(d.t1 - d.t0 for d in marks) / 1e9
            # the profiler's clock counts from its start: what the
            # harness's stretch holds before the first anchor and event
            prog["lead_ms"] = {"first_anchor": w0 / 1e6, "first_event": min(
                (d.t0 for d in work), default=0.0) / 1e6}
            prog["clock_offsets_us"] = [round((p[1] - points[0][1]) / 1e3,
                                              1) for p in points]
            if a.record:
                record(a.record, events, spans, window.anchors, w0, w1,
                       points, names)
    out = {"correct": result["correct"], "metrics": result["metrics"],
           "device": result["device"], "program": prog}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
