"""The port's tracer: host spans, counters, markers on the card, and one
clock for both (SURVEY §5: the reference's hand-rolled `times[5]`
checkpoints, 360_stitcher/timed.cpp:43-44,61-119).

* **Spans** (``span``, ``record``) time the program's work where it
  happens: a name, the thread, the start and end on
  ``time.perf_counter_ns()``, the span open around it on the same thread
  (its parent) and the frame set's id where there is one (a child takes
  its parent's). They are kept in memory, in a bounded ring, and read out
  with ``spans()``. Off is the default: off, a span site costs one check
  and allocates nothing, unless the site times itself for a reader that
  is always on (``into=``, ``timed=``: the Runner's StageTimers, its
  swap times, its "Rewarp" log). ``enable()`` switches recording on;
  under it every garbage collection is a span ``gc`` with its
  generation. ``carry(fn)`` lets a span opened in another thread (a
  deadline worker, ``utils/devsync``) nest under the caller's.
* **Counters** are the plain integers the program already keeps, always
  on: ``Program.replays`` and ``capture_s``, ``ProgramSet.captures``,
  ``Runner.frames_done`` and ``recalibs_done``; the tracer adds none.
* **Markers** (``mark``) are empty kernels (``csrc/trace_mark.cu``),
  launched on the current stream only while recording: in a CUDA graph
  captured then, they mark the stages of the step on the card, by kernel
  name (``trace_mark<id>``; ``mark_names()`` maps the ids to names). Off,
  nothing is launched and no graph holds one.
* **One clock** (``anchor``, ``clock_points``, ``to_card``): the host
  stamps its clock around a marker launched on a stream of its own and
  waits for it; the marker's start on the card lies between the two
  stamps, which fixes the host -> card offset there to half the
  bracket's width. The profiler's card clock drifts from the host's by
  up to ~1 ms a second and is set back now and then (measured on an
  H100), so a long trace takes a burst of anchors every ~100 ms and maps
  a host stamp by the offsets of the bursts either side of it.
* **The exporter** (``start_device_trace``, ``stop_device_trace``,
  ``device_trace``; the Runner's cfg.trace_dir) records the card's
  activity with torch.profiler (CUDA activity only: recording the host's
  operators stalled the Runner's threads on the card) and writes one
  Chrome trace, ``trace.json`` under the trace directory (Perfetto or
  chrome://tracing), with the program's spans on the card's clock. On a
  host without CUDA it writes the spans alone.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import itertools
import json
import os
import re
import tempfile
import threading
import time
from bisect import bisect_left
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

#: spans kept by the ring before the oldest go
CAPACITY = 1 << 18


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    thread: str
    t0: int                 # perf_counter_ns
    t1: int
    frame: Optional[int]    # the frame set's id
    arg: object = None      # a gc's generation, a capture's program


class Anchor(NamedTuple):
    name: str               # the marker's name (mark_names)
    h0: int                 # perf_counter_ns before its launch
    h1: int                 # and after its stream was synchronised
    burst: int = 0          # the anchor() call it came from


#: the anchors' marker names cycle over this many, so that a marker's
#: name and the offset's mode tell which anchor it was (clock_points)
ANCHOR_NAMES = 8


_on = False
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_tls = threading.local()


# --- spans ---------------------------------------------------------------

class _Null:
    """The span of a site while recording is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Open:
    """An open span: timed always, recorded when the tracer was on at
    its start. `s` holds its seconds once it has ended."""
    __slots__ = ("name", "frame", "arg", "into", "parent", "sid", "t0", "s")

    def __init__(self, name, frame, arg, into, parent):
        self.name, self.frame, self.arg = name, frame, arg
        self.into, self.parent = into, parent
        self.sid = None
        self.s = 0.0

    def __enter__(self):
        if _on:
            st = _stack()
            top = st[-1] if st else None
            if self.parent is None and top is not None:
                self.parent = top[0]
            if self.frame is None and top is not None:
                self.frame = top[1]
            self.sid = next(_ids)
            st.append((self.sid, self.frame))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.s = (t1 - self.t0) / 1e9
        if self.sid is not None:
            st = _stack()
            if st and st[-1][0] == self.sid:
                st.pop()
            _ring.append(Span(self.sid, self.parent, self.name,
                              threading.current_thread().name, self.t0, t1,
                              self.frame, self.arg))
        if self.into is not None:
            self.into(self.s)
        return False


def span(name: str, frame: Optional[int] = None, arg=None,
         into: Optional[Callable[[float], None]] = None,
         timed: bool = False, parent: Optional[int] = None):
    """A context manager around one piece of work. Recorded while the
    tracer is on; with `into` (called with the seconds) or `timed` (the
    seconds in the span's `s`) it is timed whether on or not."""
    if not _on and into is None and not timed:
        return _NULL
    return _Open(name, frame, arg, into, parent)


def annotate(name: str):
    """A named span (the JAX package's name for it); usable as a context
    manager."""
    return span(name)


def stamp() -> int:
    """perf_counter_ns while recording, else 0 (no span can start there)."""
    return time.perf_counter_ns() if _on else 0


def new_id() -> Optional[int]:
    """A span id to give a span recorded later (``record(sid=)``), so that
    spans recorded before it can name it their parent; None when off."""
    return next(_ids) if _on else None


def record(name: str, t0: int, t1: int, frame: Optional[int] = None,
           thread: Optional[str] = None, parent: Optional[int] = None,
           sid: Optional[int] = None, arg=None) -> None:
    """Record a span that ended, timed by the caller: one that starts in
    one thread and ends in another (a queue's wait) names a `thread` of
    its own. Nothing while off, or for a start stamped off (t0 == 0)."""
    if not _on or not t0:
        return
    _ring.append(Span(sid if sid is not None else next(_ids), parent, name,
                      thread or threading.current_thread().name, t0, t1,
                      frame, arg))


def current():
    """(span id, frame id) of this thread's innermost open span, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def carry(fn: Callable) -> Callable:
    """`fn`, which another thread will call, with this thread's innermost
    open span as the parent of the spans it opens there; `fn` itself
    while off."""
    if not _on:
        return fn
    top = current()
    if top is None:
        return fn

    def carried():
        st = _stack()
        st.append(top)
        try:
            return fn()
        finally:
            if st and st[-1] is top:
                st.pop()
    return carried


def _gc_hook(phase: str, info: dict) -> None:
    if phase == "start":
        _tls.gc0 = time.perf_counter_ns()
        return
    t0 = getattr(_tls, "gc0", 0)
    if _on and t0:
        top = current()
        record("gc", t0, time.perf_counter_ns(),
               frame=None if top is None else top[1],
               parent=None if top is None else top[0],
               arg=info.get("generation"))
    _tls.gc0 = 0


def enable(capacity: Optional[int] = None) -> None:
    """Start recording spans and launching markers (a graph captured from
    now on holds the step's markers)."""
    global _on, _ring
    if capacity is not None and capacity != _ring.maxlen:
        _ring = collections.deque(_ring, maxlen=capacity)
    if _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    _on = True


def disable() -> None:
    """Stop recording; the spans recorded stay until ``clear``."""
    global _on
    _on = False
    if _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)


def is_on() -> bool:
    return _on


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most the ring's capacity)."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


# --- markers on the card ------------------------------------------------------

_mark_ids: Dict[str, int] = {}
_mark_lock = threading.Lock()
_lib = None
_anchor_streams: dict = {}
_anchors_taken = itertools.count()
_bursts = itertools.count()
MARK_KERNEL = re.compile(r"trace_mark<(\d+)>")


def _marks_lib():
    global _lib
    if _lib is None:
        from video_stitcher_tpu_torch import _build
        lib = _build.load("trace_mark")
        lib.trace_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.trace_mark_launch.restype = ctypes.c_int
        lib.trace_mark_anchor.argtypes = [
            ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.trace_mark_anchor.restype = ctypes.c_int
        for fn in (lib.trace_mark_count, lib.trace_mark_load):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        err = lib.trace_mark_load()
        if err != 0:
            raise RuntimeError(f"trace markers failed to load: cudaError "
                               f"{err}")
        _lib = lib
    return _lib


def _mark_id(name: str) -> int:
    mid = _mark_ids.get(name)
    if mid is None:
        with _mark_lock:
            mid = _mark_ids.get(name)
            if mid is None:
                if len(_mark_ids) >= _marks_lib().trace_mark_count():
                    raise ValueError(f"no marker id left for {name!r}")
                mid = _mark_ids[name] = len(_mark_ids)
    return mid


def mark_names() -> Dict[int, str]:
    """The markers' ids and names: kernel ``trace_mark<id>`` marks
    boundary ``mark_names()[id]``."""
    return {i: n for n, i in _mark_ids.items()}


def _launch(name: str, stream) -> None:
    mid = _mark_id(name)
    err = _marks_lib().trace_mark_launch(mid, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace marker {name!r} failed to launch: "
                           f"cudaError {err}")


def mark(name: str, device=None) -> None:
    """While recording, launch marker `name` on the current stream of
    `device` (a CUDA device; nothing elsewhere). Captured into a CUDA
    graph, it runs at each replay. Off, nothing."""
    if not _on:
        return
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        return
    _launch(name, torch.cuda.current_stream(device))


def anchor(device=None, n: int = 4) -> List[Anchor]:
    """A burst of `n` brackets of the host clock around a marker each
    (``anchor.<k>``, k cycling over ANCHOR_NAMES), launched on a
    high-priority stream of the tracer's own on `device` and waited for:
    the marker's start on the card lies between the bracket's stamps,
    which the markers' library takes on perf_counter's clock
    (CLOCK_MONOTONIC) without the interpreter's lock. Runs whether the
    tracer is on or not; nothing without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return []
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = _anchor_streams.get(dev)
    if stream is None:
        stream = _anchor_streams[dev] = torch.cuda.Stream(dev, priority=-1)
    lib = _marks_lib()
    out = []
    burst = next(_bursts)
    h0, h1 = ctypes.c_longlong(), ctypes.c_longlong()
    for _ in range(n):
        name = f"anchor.{next(_anchors_taken) % ANCHOR_NAMES}"
        err = lib.trace_mark_anchor(_mark_id(name), stream.cuda_stream,
                                    ctypes.byref(h0), ctypes.byref(h1))
        if err != 0:
            raise RuntimeError(f"trace anchor failed: cudaError {err}")
        out.append(Anchor(name, h0.value, h1.value, burst))
    return out


def clock_points(anchors: Sequence[Anchor],
                 starts: Iterable[Tuple[str, float]]
                 ) -> List[Tuple[float, float, float]]:
    """(host ns, offset ns, width ns) of each burst of `anchors`: its
    narrowest bracket's midpoint, the card's start of that bracket's
    marker less the midpoint, and the bracket's width; a host stamp h
    near it lies at h + offset on the card's clock, to within width / 2.
    `starts`: (marker name, start ns on the card's clock) of the anchor
    markers in the trace. A name recurs every ANCHOR_NAMES anchors, so
    each marker is matched to the anchor of its name whose offset lies
    nearest the offsets' mode: the true pairs agree to within the
    clock's drift over the trace (milliseconds), pairs of anchors taken
    further apart do not. A marker the trace lost leaves its anchor
    out."""
    by_name: Dict[str, list] = {}
    for name, d in starts:
        by_name.setdefault(name, []).append(d)
    cands = sorted(d - (a.h0 + a.h1) / 2 for a in anchors
                   for d in by_name.get(a.name, ()))
    if not cands:
        return []
    best, lo = (0, 0.0), 0
    for hi, c in enumerate(cands):
        while cands[lo] < c - 20e6:
            lo += 1
        if hi - lo + 1 > best[0]:
            best = (hi - lo + 1, cands[(lo + hi) // 2])
    ref = best[1]
    points: Dict[int, Tuple[float, float, float]] = {}
    for a in anchors:
        mid = (a.h0 + a.h1) / 2
        offs = [d - mid for d in by_name.get(a.name, ())]
        if not offs:
            continue
        off = min(offs, key=lambda o: abs(o - ref))
        if abs(off - ref) > 50e6:
            continue
        width = a.h1 - a.h0
        cur = points.get(a.burst)
        if cur is None or width < cur[2]:
            points[a.burst] = (mid, off, width)
    return sorted(points.values())


def _interp(keys: Sequence[float], vals: Sequence[float], x: float) -> float:
    i = bisect_left(keys, x)
    if i == 0:
        return vals[0]
    if i == len(keys):
        return vals[-1]
    f = (x - keys[i - 1]) / (keys[i] - keys[i - 1])
    return vals[i - 1] + f * (vals[i] - vals[i - 1])


def to_card(points: Sequence[Tuple[float, float, float]], h: float) -> float:
    """Host stamp `h` (perf_counter ns) on the card's clock: the offset
    interpolated between the anchor points either side (the nearest one's
    outside them)."""
    return h + _interp([p[0] for p in points], [p[1] for p in points], h)


def to_host(points: Sequence[Tuple[float, float, float]], d: float) -> float:
    """The card's time `d` as a host stamp (to_card's inverse)."""
    return d - _interp([p[0] + p[1] for p in points],
                       [p[1] for p in points], d)


# --- the exporter ---------------------------------------------------------

class _Trace(NamedTuple):
    prof: object
    trace_dir: str
    was_on: bool
    t0: int
    anchors: list


#: the running trace
_active: Optional[_Trace] = None


def start_device_trace(trace_dir: str) -> None:
    """Start recording the card's activity (CUDA only) and the program's
    spans (the tracer is on until ``stop_device_trace``)."""
    global _active
    if _active is not None:
        raise RuntimeError("a device trace is already running")
    import torch
    was_on = _on
    enable()
    prof, anchors = None, []
    if torch.cuda.is_available():
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        anchors = anchor()
    _active = _Trace(prof, trace_dir, was_on, time.perf_counter_ns(),
                     anchors)


def stop_device_trace(until: Optional[int] = None):
    """End the running trace and write ``trace.json`` under its directory:
    the card's events and the spans up to `until` (a perf_counter_ns
    stamp; now by default), so that a caller can stop the profiler once
    its threads have ended and keep the stretch it meant to trace.
    Returns (the profiler, or None without CUDA; the traced stretch's
    wall seconds)."""
    global _active
    if _active is None:
        raise RuntimeError("no device trace is running")
    tr, _active = _active, None
    import torch
    anchors = list(tr.anchors)
    if tr.prof is not None:
        anchors += anchor()
        torch.cuda.synchronize()
        tr.prof.stop()
    t1 = time.perf_counter_ns() if until is None else until
    if not tr.was_on:
        disable()
    os.makedirs(tr.trace_dir, exist_ok=True)
    _write_chrome(tr, anchors, t1, os.path.join(tr.trace_dir, "trace.json"))
    return tr.prof, (t1 - tr.t0) / 1e9


def _write_chrome(tr: _Trace, anchors: list, t1: int, path: str) -> None:
    """The card's events (renaming each marker by its boundary) and the
    spans of [tr.t0, t1], on the card's clock by the anchors, as one
    Chrome trace."""
    events: list = []
    if tr.prof is not None:
        fd, tmp = tempfile.mkstemp(suffix=".json", dir=tr.trace_dir)
        os.close(fd)
        try:
            tr.prof.export_chrome_trace(tmp)
            with open(tmp) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(tmp)
    names = mark_names()
    starts = []
    for e in events:
        m = MARK_KERNEL.search(str(e.get("name", "")))
        if m and int(m.group(1)) in names and "ts" in e:
            e["name"] = "mark:" + names[int(m.group(1))]
            starts.append((e["name"][5:], float(e["ts"]) * 1e3))
    points = clock_points(anchors, starts)
    clock = {"anchored": bool(points)}
    if points:
        clock["width_us"] = max(p[2] for p in points) / 1e3
        clock["drift_us"] = (points[-1][1] - points[0][1]) / 1e3
        end = to_card(points, t1) / 1e3
        events = [e for e in events if float(e.get("ts", 0.0)) <= end]
    else:
        # no marker of the card: the host's clock from the trace's start
        points = [(0.0, -tr.t0, 0.0)]
    for s in spans():
        if s.t1 < tr.t0 or s.t0 > t1:
            continue
        args = {"id": s.id}
        for k in ("parent", "frame", "arg"):
            if getattr(s, k) is not None:
                args[k] = getattr(s, k)
        t0 = to_card(points, s.t0)
        events.append({"ph": "X", "name": s.name, "cat": "program",
                       "pid": "program", "tid": s.thread, "ts": t0 / 1e3,
                       "dur": (to_card(points, s.t1) - t0) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "programClock": clock}, f)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Trace the enclosed block (``start_device_trace``). No-op when
    trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    start_device_trace(trace_dir)
    try:
        yield
    finally:
        stop_device_trace()
