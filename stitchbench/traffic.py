"""The one traffic generator: a ring of frame sets handed to the Runner as
its source, closed loop or on a fixed schedule, and the sink that stamps
each output frame as it completes.

A traffic mix is a JSON file of parameters (``stitchbench/traffic/``):

* ``loop``: "closed" (the next set as soon as the Runner asks: flat out)
  or "open" (set k is due at ``rate_hz``; the schedule does not slow when
  the stitcher does);
* ``frames_on``: "device" (the ring lies in card memory, as a capture
  board writing over GPUDirect leaves it) or "host" (numpy arrays, as a
  decoder or a capture server leaves them);
* ``output_to``: "device" (the Runner's ``consume_device``: the frame is
  complete on the card) or "host" (downloaded by ``finalize_out``);
* ``ring_sets``, ``pan_texels``, ``displace_px``, ``gain_spread``: the
  scene (``stitchbench/scene.py``);
* ``warmup_frames``: sets handed out before the window opens;
* ``sample_frames``, ``expect_fps``: how many of the window's frames the
  comparison checks, drawn from the seed;
* ``trace_seconds``: the traced part of the window with ``--trace 1``.

Every frame set handed out carries its sequence number (``seq``): 0 is the
set the Runner prewarms on, then the warm-up, then the window.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


class Tagged(np.ndarray):
    """A numpy view that carries its frame set's sequence number."""
    seq: int = -1


def tag(frames, seq: int):
    """A view of `frames` (numpy or tensor) carrying `seq`; no copy."""
    if isinstance(frames, np.ndarray):
        v = frames.view(Tagged)
        v.seq = seq
        return v
    v = frames.view(frames.shape)
    v._sb_seq = seq
    return v


def seq_of(frames) -> Optional[int]:
    if isinstance(frames, Tagged):
        return frames.seq
    return getattr(frames, "_sb_seq", None)


class Source:
    """The Runner's source (``get_frames`` / ``release``) over a ring of
    frame sets. The window opens when the first set after the warm-up is
    handed out (closed loop) or is due (open loop), and closes
    ``seconds`` later: the next call then ends the stream."""

    def __init__(self, ring, traffic: dict, seconds: float):
        self.ring = ring
        self.n = len(ring)
        self.loop = traffic["loop"]
        self.period = (1.0 / traffic["rate_hz"] if self.loop == "open"
                       else 0.0)
        self.warmup = traffic["warmup_frames"]
        self.seconds = seconds
        self.count = 0
        #: the window [t0, t1) on the perf_counter clock, set when it opens
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        #: seq -> due time (open loop) or hand-out time (closed loop)
        self.due: dict = {}
        #: the first seq of the window, and one past its last
        self.first = 1 + self.warmup
        self.end: Optional[int] = None
        self.window_open = threading.Event()
        self._sched0: Optional[float] = None

    def get_frames(self):
        k = self.count
        if self.loop == "open" and k >= 1:
            if self._sched0 is None:
                self._sched0 = time.perf_counter()
            due = self._sched0 + (k - 1) * self.period
            if k == self.first:
                self._open(due)
            if self.t1 is not None and due >= self.t1:
                return self._close(k)
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        else:
            due = time.perf_counter()
            if k == self.first:
                self._open(due)
            if self.t1 is not None and due >= self.t1:
                return self._close(k)
        self.due[k] = due
        self.count = k + 1
        return tag(self.ring[k % self.n], k)

    def _open(self, t: float) -> None:
        self.t0, self.t1 = t, t + self.seconds
        self.window_open.set()

    def _close(self, k: int):
        if self.end is None:
            self.end = k
        return None

    def release(self) -> None:
        pass

    def window_seqs(self):
        """The seqs handed out inside the window."""
        return range(self.first, self.end if self.end is not None
                     else self.count)


class Sink:
    """Stamps each output frame the Runner completes, and keeps the
    frames of the sampled seqs for the comparison."""

    def __init__(self, sample: set):
        self.sample = sample
        #: seq -> perf_counter time the frame was complete where it goes
        self.done: dict = {}
        #: seq -> the output frame (device tensor or host array)
        self.kept: dict = {}

    def write(self, out) -> None:
        now = time.perf_counter()
        seq = seq_of(out)
        if seq is None:
            return
        self.done[seq] = now
        if seq in self.sample:
            # the Runner's outputs are never written again (stitch_out
            # returns a copy of its program's output; finalize_out a host
            # buffer of its own), so a reference is enough
            self.kept[seq] = out

    def release(self) -> None:
        pass


def draw_sample(traffic: dict, seconds: float, seed: int, first: int
                ) -> set:
    """The seqs the comparison checks, drawn from the seed: each window
    seq with the same chance, about ``sample_frames`` of them for a
    window of ``expect_fps * seconds`` frames."""
    expected = max(1, int(traffic["expect_fps"] * seconds))
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pick = rng.random(4 * expected) < traffic["sample_frames"] / expected
    return {first + int(i) for i in np.nonzero(pick)[0]}
