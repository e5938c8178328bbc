"""Deadline-bounded device synchronization.

The reference handles a wedged peer by dropping it: ingest gives a
capture client 3 failed recvs before disconnecting
(360_stitcher/networking.cpp:29-37) and the player link reconnects on
send failure (timed.cpp:334-348). The device-side hazard is the host<->
device link itself: any unbounded wait on it in the live loop would
freeze the whole product silently — no log, no drop, no recovery.

This module gives every sync a deadline. `call_deadline` runs a blocking
call on a REUSABLE daemon worker from a free pool (CUDA copies and
synchronisations release the GIL, so the caller's thread stays live);
the caller waits with a timeout, and a stall becomes a raised StallError
— a logged, counted, skippable event — instead of a hang. A stalled
worker is abandoned: it finishes its in-flight call in the background,
is never returned to the pool, and exits; healthy workers are recycled,
so the live loop's per-frame syncs cost a queue hand-off, not a thread
construction. A cap on concurrently-stalled workers makes a known-wedged
link fail fast instead of accumulating threads.

`read_head` and `to_host` wait for a CUDA tensor's producing work on a
CUDA event recorded behind it on the current stream, polling
`event.query()` until the deadline. Anything else (a CPU tensor, a numpy
array, an object with `ravel` and `__array__`) is read on a worker under
`call_deadline`, as the JAX package reads every array, so a host read
that blocks is bounded too.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

import numpy as np

from video_stitcher_tpu_torch.utils import trace

#: max concurrently-outstanding stalled workers before call_deadline
#: fails fast (link considered wedged; each stalled worker is a leaked
#: daemon thread until its blocking call eventually returns)
MAX_STALLED = 8

_stalled = 0
_lock = threading.Lock()
_idle: list = []                 # free pool of healthy _Worker objects


class StallError(RuntimeError):
    """A device sync exceeded its deadline (link stall, not a crash)."""


def stalled_workers() -> int:
    """Number of deadline-exceeded calls still blocked in the runtime."""
    with _lock:
        return _stalled


class _Worker:
    """One reusable daemon thread. Serves one call at a time from its
    private queue; returns itself to the _idle pool after each healthy
    call, exits after finishing an abandoned (stalled) one."""

    def __init__(self) -> None:
        self._req: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="devsync-worker")
        self._thread.start()

    def submit(self, fn, box, done) -> None:
        self._req.put((fn, box, done))

    def _loop(self) -> None:
        global _stalled
        while True:
            fn, box, done = self._req.get()
            try:
                value, error = fn(), None
            except BaseException as e:      # surfaced to the caller
                value, error = None, e
            # running -> done (worker finished) | stalled (deadline
            # passed first); every transition holds _lock, so the
            # stalled-worker count stays exact under any interleaving
            with _lock:
                abandoned = box["status"] == "stalled"
                if abandoned:
                    _stalled -= 1           # caller gave up; discard
                box.update(status="done", value=value, error=error)
                if not abandoned:
                    _idle.append(self)
            done.set()
            if abandoned:
                return                      # replaced; exit quietly


def call_deadline(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run fn() with a wall-clock deadline.

    Returns fn's result; raises StallError if the deadline passes (the
    call keeps running on its abandoned worker and is discarded when it
    eventually finishes); re-raises fn's own exception otherwise.
    timeout_s <= 0 disables the deadline (plain call).
    """
    if timeout_s is None or timeout_s <= 0:
        return fn()
    global _stalled
    box: dict = {"status": "running"}
    done = threading.Event()
    with _lock:
        if _stalled >= MAX_STALLED:
            raise StallError(
                f"link wedged: {_stalled} syncs already past deadline")
        worker = _idle.pop() if _idle else None
    if worker is None:
        worker = _Worker()
    # a span the worker opens nests under the caller's (utils/trace)
    worker.submit(trace.carry(fn), box, done)
    if not done.wait(timeout_s):
        with _lock:
            if box["status"] == "running":
                box["status"] = "stalled"
                _stalled += 1
                raise StallError(f"device sync exceeded {timeout_s:.1f}s")
    if box["error"] is not None:
        raise box["error"]
    return box["value"]


def _await_ready(x, timeout_s: float) -> None:
    """Wait until the work queued so far on the current stream, which
    produces the CUDA tensor x, has finished: an event recorded behind it,
    polled until timeout_s passes (StallError past it). timeout_s <= 0
    waits without a deadline."""
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    if timeout_s is None or timeout_s <= 0:
        event.synchronize()
        return
    deadline = time.perf_counter() + timeout_s
    pause = 1e-5
    while not event.query():
        if time.perf_counter() >= deadline:
            raise StallError(f"device sync exceeded {timeout_s:.1f}s")
        time.sleep(pause)
        pause = min(pause * 2, 1e-3)


def _host(x) -> np.ndarray:
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _read(x, read: Callable[[], np.ndarray], timeout_s: float
          ) -> np.ndarray:
    """read() of x, bounded by timeout_s: a CUDA tensor after its event
    (_await_ready), anything else on a worker (call_deadline)."""
    import torch
    if isinstance(x, torch.Tensor) and x.is_cuda:
        _await_ready(x, timeout_s)
        return read()
    return call_deadline(read, timeout_s)


def read_head(x, timeout_s: float, n: int = 4) -> np.ndarray:
    """Force completion of a device tensor by waiting for the work that
    produces it, bounded by timeout_s, then read its first n elements
    (the product's standard completion sync, no full-frame download).
    Raises StallError past the deadline."""
    return _read(x, lambda: _host(x.ravel()[:n]), timeout_s)


def to_host(x, timeout_s: float) -> np.ndarray:
    """Full device->host download with a deadline (StallError past it)."""
    return _read(x, lambda: _host(x), timeout_s)
