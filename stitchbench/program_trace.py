"""The program's own trace read beside the card's: its spans
(``video_stitcher_tpu_torch.utils.trace``), its markers in the card's
trace, and the anchors that put both on one clock.

A traced run of the port with its tracer on holds, on the card, one
marker kernel (``trace_mark<id>``) at each boundary the program marks:
the stages of the step inside its CUDA graph (``step.begin``,
``step.warp``, ``step.blend``, ``step.output``, ``step.end``), a bracket
around each replay of the mesh re-solve's programs (``resolve.<step>``
... ``resolve.end``) and the clock anchors (``anchor.<k>``). This
module turns the profiler's events and the program's spans into:

* the device events with each stream's id and the markers named
  (``device_events``), and the markers set apart, so that every sum over
  the card's work leaves them out (``strip_marks``);
* the host -> card clock from the anchors (``clock``: a point each
  burst of anchors, between which a host stamp's offset is interpolated;
  the profiler's card clock drifts from the host's by up to ~1 ms a
  second on an H100, so one offset for a whole stretch does not do);
* the card time of each stage of each complete step replay
  (``stage_split``), and of each re-solve's programs (``resolve_split``);
* the card's idle gaps named by the innermost span each thread had open
  at the gap's midpoint (``name_gaps``);
* the per-layer numbers that read all of this (``program_metrics``).

``stitchbench/traced.py`` runs a cell with the tracer on and prints
them. Everything but ``device_events`` takes plain values, so the CPU
tests run it on a trace recorded on the card.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

MARK = re.compile(r"trace_mark<(\d+)>")
#: the step's markers, in the order a replay meets them, and the stage
#: each one opens
STEP_MARKS = ("step.begin", "step.warp", "step.blend", "step.output",
              "step.end")
STAGES = ("prep", "warp", "blend", "output")


class Dev(NamedTuple):
    """One event of the card: times in ns on the profiler's clock."""
    name: str
    kind: str          # "kernel", "copy" or "mark"
    t0: float
    t1: float
    stream: int


def device_events(prof, mark_names: Dict[int, str]) -> List[Dev]:
    """The CUDA kernels and copies of a finished torch.profiler session,
    each marker renamed by its boundary (kind "mark")."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = MARK.search(e.name)
        if m is not None:
            kind, name = "mark", mark_names.get(int(m.group(1)), e.name)
        else:
            kind = ("copy" if e.name.startswith(("Memcpy", "Memset"))
                    else "kernel")
            name = e.name
        out.append(Dev(name, kind, e.time_range.start * 1e3,
                       e.time_range.end * 1e3,
                       int(e.device_resource_id or 0)))
    return sorted(out, key=lambda d: d.t0)


def strip_marks(events: Sequence[Dev]) -> Tuple[List[Dev], List[Dev]]:
    """(the card's work, the markers)."""
    work = [d for d in events if d.kind != "mark"]
    return work, [d for d in events if d.kind == "mark"]


def clock(anchors, marks: Sequence[Dev]) -> dict:
    """The host -> card clock of a trace: ``points`` (host ns, offset ns,
    width ns), one a burst of `anchors` ((name, h0, h1, burst) tuples)
    whose marker is in `marks`, and in microseconds the widest kept
    bracket (``width_us``), the first and the last (``start_width_us``,
    ``stop_width_us``), the offset's change from the first point to the
    last (``drift_us``) and the largest error of an inner point's offset
    interpolated from its neighbours (``interp_us``). Empty without a
    point."""
    from video_stitcher_tpu_torch.utils.trace import Anchor, clock_points
    pts = clock_points([Anchor(*a) for a in anchors],
                       [(d.name, d.t0) for d in marks
                        if d.name.startswith("anchor.")])
    if not pts:
        return {}
    out = {"points": pts, "width_us": max(p[2] for p in pts) / 1e3,
           "start_width_us": pts[0][2] / 1e3,
           "stop_width_us": pts[-1][2] / 1e3,
           "drift_us": (pts[-1][1] - pts[0][1]) / 1e3, "interp_us": 0.0}
    for a, b, c in zip(pts, pts[1:], pts[2:]):
        f = (b[0] - a[0]) / (c[0] - a[0])
        err = abs(a[1] + f * (c[1] - a[1]) - b[1]) / 1e3
        out["interp_us"] = max(out["interp_us"], err)
    return out


def stretch(marks: Sequence[Dev]) -> Optional[Tuple[float, float]]:
    """The traced stretch on the card's clock, or None without anchors:
    from the first anchor marker to the last, cut at the end of the last
    step replay in it. The window's source closes when the trace stops,
    so after that replay the Runner drains and the card idles, which is
    no gap of the running pipeline."""
    anchors = [d for d in marks if d.name.startswith("anchor.")]
    if not anchors:
        return None
    lo, hi = min(d.t0 for d in anchors), max(d.t1 for d in anchors)
    ends = [d.t1 for d in marks if d.name == "step.end" and lo <= d.t1 <= hi]
    return lo, max(ends) if ends else hi


def to_card(points, h: float) -> float:
    from video_stitcher_tpu_torch.utils.trace import to_card as f
    return f(points, h)


def to_host(points, d: float) -> float:
    from video_stitcher_tpu_torch.utils.trace import to_host as f
    return f(points, d)


def _busy(events: Sequence[Dev]) -> float:
    total, end = 0.0, float("-inf")
    for d in sorted(events, key=lambda d: d.t0):
        if d.t1 > end:
            total += d.t1 - max(d.t0, end)
            end = d.t1
    return total


def stage_split(events: Sequence[Dev]) -> dict:
    """Card ns of each stage of every complete step replay: on the stream
    of its markers, the work that starts between a stage's marker and the
    next. A replay is complete when its five markers follow in order on
    one stream. Returns {"replays", "stream", "<stage>_ns" (summed over
    the replays), "k1_ns" (K1's kernels inside the warp stage), "spans":
    [(begin, end) ns of each complete replay]}."""
    work, marks = strip_marks(events)
    step = [m for m in marks if m.name in STEP_MARKS]
    by_stream: Dict[int, List[Dev]] = {}
    for m in step:
        by_stream.setdefault(m.stream, []).append(m)
    out = {"replays": 0, "stream": None, "k1_ns": 0.0, "spans": [],
           **{f"{s}_ns": 0.0 for s in STAGES}}
    if not by_stream:
        return out
    stream, ms = max(by_stream.items(), key=lambda kv: len(kv[1]))
    out["stream"] = stream
    on = [d for d in work if d.stream == stream]
    i = 0
    while i + 4 < len(ms):
        seq = ms[i:i + 5]
        if tuple(m.name for m in seq) != STEP_MARKS:
            i += 1
            continue
        for k, stage in enumerate(STAGES):
            lo, hi = seq[k].t0, seq[k + 1].t0
            inside = [d for d in on if lo <= d.t0 < hi]
            out[f"{stage}_ns"] += sum(d.t1 - d.t0 for d in inside)
            if stage == "warp":
                out["k1_ns"] += sum(d.t1 - d.t0 for d in inside
                                    if "RemapGain" in d.name)
        out["spans"].append((seq[0].t0, seq[4].t1))
        out["replays"] += 1
        i += 5
    return out


def resolve_split(events: Sequence[Dev], solves: Sequence[Tuple[float,
                                                                float]]
                  ) -> List[float]:
    """Card ns of each re-solve's programs: the work on a bracket's
    stream between a ``resolve.<step>`` marker and its ``resolve.end``.
    `solves`: (start, end) of each ``resolve`` span on the card's clock,
    in order; a bracket belongs to the re-solve whose span started last
    before it. Only re-solves whose span lies inside the trace, with
    every bracket closed, are counted."""
    work, marks = strip_marks(events)
    if not events or not solves:
        return []
    first = min(d.t0 for d in events)
    last = max(d.t1 for d in events)
    opens = [m for m in marks if m.name.startswith("resolve.")
             and m.name != "resolve.end"]
    ends = [m for m in marks if m.name == "resolve.end"]
    starts = [s for s, _ in solves]
    per = [0.0] * len(solves)
    whole = [first <= s and e <= last for s, e in solves]
    for m in opens:
        k = max((j for j, s in enumerate(starts) if s <= m.t0), default=None)
        if k is None:
            continue
        end = next((e for e in ends if e.stream == m.stream
                    and e.t0 > m.t0), None)
        if end is None:
            whole[k] = False
            continue
        per[k] += sum(d.t1 - d.t0 for d in work if d.stream == m.stream
                      and m.t0 <= d.t0 < end.t0)
    return [p for p, w in zip(per, whole) if w]


def idle_gaps(events: Sequence[Dev], w0: float, w1: float
              ) -> List[Tuple[float, float]]:
    """The card's idle gaps in [w0, w1], markers left out, longest
    first."""
    work, _ = strip_marks(events)
    spans = sorted((max(d.t0, w0), min(d.t1, w1)) for d in work
                   if d.t1 > w0 and d.t0 < w1)
    gaps, edge = [], w0
    for s, e in spans + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    return sorted(gaps, key=lambda g: g[0] - g[1])


def open_at(spans, h: float) -> Dict[str, object]:
    """Thread -> the innermost span open at host time `h` (queues,
    which are no thread's work, left out)."""
    inner: Dict[str, object] = {}
    for s in spans:
        if s.thread == "queue" or not (s.t0 <= h <= s.t1):
            continue
        cur = inner.get(s.thread)
        if cur is None or s.t0 >= cur.t0:
            inner[s.thread] = s
    return inner


def gap_name(spans, h: float, by_id: Optional[dict] = None) -> str:
    """``idle_in_`` and, thread by thread, the innermost span open at host
    time `h` (``parent/child`` where the child's name does not start with
    its parent's), joined by ``+``; ``idle_in_none`` when no thread has a
    span open."""
    by_id = by_id if by_id is not None else {s.id: s for s in spans}
    parts = []
    for thread, s in sorted(open_at(spans, h).items()):
        p = by_id.get(s.parent)
        name = s.name
        if p is not None and p.thread == thread and \
                not name.startswith(p.name):
            name = f"{p.name}/{name}"
        parts.append(name)
    return "idle_in_" + ("+".join(parts) or "none")


def name_gaps(events: Sequence[Dev], spans, points, w0: float,
              w1: float, top: int = 10) -> List[list]:
    """The `top` longest idle gaps of [w0, w1] (card ns), each named by
    the spans open at its midpoint on the host's clock (``gap_name``;
    `points`: the clock's), with its seconds."""
    by_id = {s.id: s for s in spans}
    return [[gap_name(spans, to_host(points, (s + e) / 2), by_id),
             (e - s) / 1e9] for s, e in idle_gaps(events, w0, w1)[:top]]


def _mean_ms(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) / 1e6 if values else None


def self_ns(span, spans, waits=("resolve.fetch", "lock.wait")) -> float:
    """The span's ns less those of its descendants named in `waits`
    (counted once: a wait inside a wait is inside the outer one)."""
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    total, todo = span.t1 - span.t0, list(kids.get(span.id, ()))
    while todo:
        s = todo.pop()
        if s.name in waits:
            total -= s.t1 - s.t0
        else:
            todo += kids.get(s.id, ())
    return total


def program_metrics(spans, t0: float, t1: float, events=None,
                    points=None) -> dict:
    """The per-layer numbers of the program's trace. `spans`: the
    program's, `t0`/`t1`: the measured window on perf_counter seconds;
    with the card's `events` and the clock's `points`, the numbers of
    the card too. A number with nothing to read is left out."""
    w0, w1 = int(t0 * 1e9), int(t1 * 1e9)
    inside = [s for s in spans if w0 <= s.t0 and s.t1 <= w1]
    named: Dict[str, list] = {}
    for s in inside:
        named.setdefault(s.name, []).append(s)
    out = {}
    for metric, name in (("launch_ms.dev", "step.launch"),
                         ("stage_ms.live", "stage"),
                         ("download_ms.live", "download")):
        v = _mean_ms(s.t1 - s.t0 for s in named.get(name, ()))
        if v is not None:
            out[metric] = v
    waits: Dict[int, float] = {}
    for name in ("queue.staged", "queue.results"):
        for s in named.get(name, ()):
            waits[s.frame] = waits.get(s.frame, 0.0) + (s.t1 - s.t0)
    v = _mean_ms(waits.values())
    if v is not None:
        out["queue_wait_ms.live"] = v
    solves = [s for s in spans if s.name == "resolve" and w0 <= s.t1 <= w1]
    v = _mean_ms(self_ns(s, spans) for s in solves)
    if v is not None:
        out["resolve_host_ms.live"] = v
    caps = [s.t1 - s.t0 for s in spans if s.name == "capture" and s.t1 <= w0]
    if caps:
        out["capture_s"] = sum(caps) / 1e9
    if events is None or not points:
        return out
    split = stage_split(events)
    if split["replays"]:
        for stage in STAGES:
            out[f"{stage}_device_ms.dev"] = (
                split[f"{stage}_ns"] / split["replays"] / 1e6)
    per = resolve_split(events, [(to_card(points, s.t0),
                                  to_card(points, s.t1))
                                 for s in spans if s.name == "resolve"])
    if per:
        out["resolve_device_ms.live"] = sum(per) / len(per) / 1e6
    return out


def coverage(events: Sequence[Dev]) -> dict:
    """Where the card's work of a traced stretch went, in ns: the step's
    complete replays (its four stages), the re-solve's marked programs,
    the step stream's work outside its replays (the copies in and out of
    the graph, the installs) and the rest, with the rest's largest
    operations by name."""
    work, marks = strip_marks(events)
    split = stage_split(events)
    total = sum(d.t1 - d.t0 for d in work)
    stages = sum(split[f"{s}_ns"] for s in STAGES)
    bracketed = set()
    opens = [m for m in marks if m.name.startswith("resolve.")
             and m.name != "resolve.end"]
    ends = [m for m in marks if m.name == "resolve.end"]
    for m in opens:
        end = next((e for e in ends if e.stream == m.stream
                    and e.t0 > m.t0), None)
        if end is None:
            continue
        bracketed.update(i for i, d in enumerate(work)
                         if d.stream == m.stream and m.t0 <= d.t0 < end.t0)
    replays = split["spans"]
    in_replay = set(i for i, d in enumerate(work)
                    if d.stream == split["stream"]
                    and any(b <= d.t0 < e for b, e in replays))
    outside = [i for i, d in enumerate(work) if d.stream == split["stream"]
               and i not in in_replay]
    rest: Dict[str, float] = {}
    for i, d in enumerate(work):
        if i in in_replay or i in bracketed or d.stream == split["stream"]:
            continue
        rest[d.name[:80]] = rest.get(d.name[:80], 0.0) + (d.t1 - d.t0)
    resolve_ns = sum(work[i].t1 - work[i].t0 for i in bracketed)
    step_out_ns = sum(work[i].t1 - work[i].t0 for i in outside)
    return {"device_ns": total, "busy_ns": _busy(work),
            "stages_ns": stages, "resolve_ns": resolve_ns,
            "step_outside_ns": step_out_ns,
            "share": (stages + resolve_ns + step_out_ns) / total
            if total else None,
            "rest": sorted(([n, t] for n, t in rest.items()),
                           key=lambda x: -x[1])[:8],
            "marks": len(marks)}
