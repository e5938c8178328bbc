"""The traced part of a ``--trace 1`` run: torch.profiler's CUDA
activity (CUPTI) over the last stretch of the window, reduced to plain
events and then to what the per-layer metrics read. The profiler's stop
parses its buffers on the host for a second or more; at the window's end
that falls in the Runner's drain, not in the window.

Only the device is traced. Recording the host's operators as well
(ProfilerActivity.CPU) stalled the Runner's threads on the card: no frame
completed while it was on. The host's side of the timeline is the
benchmark's own record of the Runner's calls (``stitchbench/probe.py``),
on the same clock: the profiler's timestamps count from its start.

``collect`` needs the card; ``reduce`` takes plain events, so the CPU
tests run it on a recorded trace.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

#: (name, kind, start_s, end_s); kind: "kernel", "copy", "host" or "mark"
Event = Tuple[str, str, float, float]


def prepare(device) -> None:
    """One short profiling session in set-up. The process's first one
    initialises CUPTI: on an H100 it took 8 s to start while the
    Runner's threads ran, and then recorded no device activity."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Window:
    """Starts the profiler `offset` seconds after the source's window
    opens, for `length` seconds, on a thread of its own."""

    def __init__(self, source, offset: float, length: float):
        self.source = source
        self.offset = offset
        self.length = length
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self.thread.start()

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
            self.t0 = time.perf_counter()
            time.sleep(self.length)
            self.t1 = time.perf_counter()
            self.prof.stop()
        except BaseException as e:      # noqa: BLE001 — reported by join()
            self.error = e
        finally:
            self._done.set()

    def join(self, timeout: float) -> None:
        self._done.wait(timeout)
        self.thread.join(timeout=1.0)
        if self.error is not None:
            raise self.error
        if self.prof is None or self.t1 is None:
            raise RuntimeError("the traced window did not complete")


def collect(window: Window, host_spans) -> List[Event]:
    """The window's device kernels and copies, the host calls of
    `host_spans` ((name, start, end) on perf_counter) and the window's
    two ends as marks, as plain events in seconds from the profiler's
    start."""
    from torch.autograd import DeviceType
    out: List[Event] = [("window", "mark", 0.0, 0.0),
                        ("window", "mark", window.t1 - window.t0,
                         window.t1 - window.t0)]
    for e in window.prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = ("copy" if e.name.startswith(("Memcpy", "Memset"))
                    else "kernel")
            out.append((e.name, kind, e.time_range.start / 1e6,
                        e.time_range.end / 1e6))
    out += [(n, "host", s - window.t0, e - window.t0)
            for n, s, e in host_spans
            if e > window.t0 and s < window.t1]
    return out


def bounds(events: List[Event]) -> Tuple[float, float]:
    """The traced window [w0, w1]: its two marks."""
    marks = sorted(s for _, k, s, _ in events if k == "mark")
    if len(marks) != 2:
        raise RuntimeError(f"{len(marks)} window marks in the trace")
    return marks[0], marks[1]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: List[Event], w0: float, w1: float) -> dict:
    """Busy and idle time of the device in [w0, w1], device time by
    kernel name, the longest idle gaps named by the host ranges open
    during them."""
    dev = [(max(s, w0), min(e, w1), n, k) for n, k, s, e in events
           if k in ("kernel", "copy") and e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in busy)
    by_name: dict = {}
    counts: dict = {}
    for s, e, n, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        counts[n] = counts.get(n, 0) + 1
    gaps = []
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    host = [(s, e, n) for n, k, s, e in events if k == "host"]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        open_ = sorted({n for hs, he, n in host if hs <= mid <= he})
        named.append(["idle_in_" + ("_".join(open_) or "none"), e - s])
    return {
        "window_s": w1 - w0,
        "busy_s": busy_s,
        "device_s": sum(e - s for s, e, _, _ in dev),
        "by_name": by_name,
        "counts": counts,
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": named,
    }

