"""What the benchmark reads of the program while it runs: wrappers set on
one Stitcher instance (its class and modules stay as they are).

* each frame set's sequence number is carried from the source through
  ``stage_frames``, ``stitch_out`` and ``finalize_out`` to the sink;
* each state installed (``programs.install``, called under the
  stitcher's swap lock) gets a generation, and each step's program
  (``programs.run``, under the same lock) records the generation it read,
  so the comparison knows which state made which frame;
* ``calibrate`` and ``recalibrate_mesh`` are timed on the host clock;
* in a traced run each wrapped call's span is kept (``spans``), by which
  the trace names the host's work during the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import threading
import time

from stitchbench.traffic import Tagged, seq_of


class Probe:
    def __init__(self, stitcher):
        self.st = stitcher
        #: generation -> the CalibState installed (1: the global-only state
        #: of calibrate, 2: its first mesh, then each re-solve's)
        self.states: dict = {}
        self.gen = 0
        #: seq -> generation of the state its step read
        self.gen_of: dict = {}
        #: (start, end) perf_counter pairs
        self.calibrate_spans: list = []
        self.resolve_spans: list = []
        self.traced = False
        #: (name, start, end) of the wrapped calls, kept when traced
        self.spans: list = []
        self._cur = threading.local()
        self._wrap()

    @contextlib.contextmanager
    def _range(self, name):
        if not self.traced:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def _wrap(self) -> None:
        st, progs = self.st, self.st.programs
        orig_install, orig_run = progs.install, progs.run
        orig = {k: getattr(st, k) for k in (
            "stage_frames", "stitch_out", "finalize_out", "calibrate",
            "recalibrate_mesh")}

        def install(geom, state, plan, **extra):
            orig_install(geom, state, plan, **extra)
            self.gen += 1
            self.states[self.gen] = state

        def run(step_key, step, *inputs):
            seq = getattr(self._cur, "seq", None)
            if seq is not None:
                self.gen_of[seq] = self.gen
            return orig_run(step_key, step, *inputs)

        def stage_frames(frames, slots=3):
            with self._range("stage_frames"):
                dev = orig["stage_frames"](frames, slots=slots)
            seq = seq_of(frames)
            if seq is not None and dev is not frames:
                dev._sb_seq = seq
            return dev

        def stitch_out(frames, device=False):
            self._cur.seq = seq_of(frames)
            try:
                with self._range("stitch_out"):
                    out = orig["stitch_out"](frames, device=device)
            finally:
                self._cur.seq = None
            seq = seq_of(frames)
            if seq is not None and not isinstance(out, Tagged):
                out._sb_seq = seq
            return out

        def finalize_out(frame):
            with self._range("finalize_out"):
                host = orig["finalize_out"](frame)
            seq = seq_of(frame)
            if seq is not None:
                host = host.view(Tagged)
                host.seq = seq
            return host

        def calibrate(frames):
            t0 = time.perf_counter()
            orig["calibrate"](frames)
            self.calibrate_spans.append((t0, time.perf_counter()))

        def recalibrate_mesh(frames):
            t0 = time.perf_counter()
            with self._range("recalibrate_mesh"):
                ok = orig["recalibrate_mesh"](frames)
            self.resolve_spans.append((t0, time.perf_counter()))
            return ok

        progs.install, progs.run = install, run
        st.stage_frames, st.stitch_out = stage_frames, stitch_out
        st.finalize_out, st.calibrate = finalize_out, calibrate
        st.recalibrate_mesh = recalibrate_mesh
