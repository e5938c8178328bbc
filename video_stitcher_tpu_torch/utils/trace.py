"""Device-level tracing (SURVEY §5: the reference's hand-rolled
`times[5]` checkpoints, 360_stitcher/timed.cpp:43-44,61-119, become
`torch.profiler` traces + the StageTimers host timers in utils/timing).

A trace records the host's operators and the card's kernels and copies
(CPU and CUDA activities) and is written as a Chrome trace
(``trace.json``, readable by Perfetto or chrome://tracing) under the
trace directory. One trace runs at a time in a process, as the profiler
itself allows.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Tuple

#: the running trace: (profiler, its directory, perf_counter at start)
_active: Optional[Tuple[object, str, float]] = None


def start_device_trace(trace_dir: str) -> None:
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _active is not None:
        raise RuntimeError("a device trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, trace_dir, time.perf_counter())


def stop_device_trace():
    """End the running trace and write it under its directory. Returns
    (the profiler, for key_averages(); the trace's wall seconds)."""
    global _active
    if _active is None:
        raise RuntimeError("no device trace is running")
    prof, trace_dir, t0 = _active
    _active = None
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    wall_s = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return prof, wall_s


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Capture a torch.profiler trace of the enclosed block. No-op when
    trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    start_device_trace(trace_dir)
    try:
        yield
    finally:
        stop_device_trace()


def annotate(name: str):
    """Named sub-span inside a device_trace (torch.profiler's
    record_function); usable as a context manager."""
    from torch.profiler import record_function
    return record_function(name)
