"""Live pipeline runner — the reference main() (360_stitcher/timed.cpp:465-629)
around the per-frame stitch, plus an asynchronous recalibration job that
re-solves the CPW mesh every recalib_del_ms and hot-swaps the CalibState
(timed.cpp:414-463) — an atomic state replacement under the Stitcher's
swap lock instead of mesh mutexes.

Torch twin of the JAX package's ``pipeline/runner.py``. Frame sets reach
the card through ``Stitcher.stage_frames`` (pinned host buffers, uploaded
on a side CUDA stream) and output frames come back through
``Stitcher.finalize_out`` (a pinned download); every wait on the card
carries cfg.sync_timeout_ms (``utils/devsync``). With camera shards a
staged set is one piece per shard (``parallel/shard.ShardedFrames``);
the stitch reads each piece on its device, and the re-solve gathers the
whole set onto the stitcher's device (``Stitcher._frames``).

Two pipeline modes (cfg.pipeline_mode, default "auto"):

* "inline" — ONE host thread runs acquire -> stage -> launch -> consume
  over a small ring of in-flight frames. CUDA launches are asynchronous,
  so a single thread already overlaps host work with the card's: frame
  t's upload and launches happen while t-1..t-depth are still running,
  and consuming frame t-depth (the download) is what waits. It saves the
  queue hand-offs and GIL switches of the threaded pipeline on a small
  host. TCP ingest still overlaps: the native capture server's recv
  threads are C++ (no GIL).

* "threaded" — the reference-shaped 3-stage pipeline (staging thread ->
  stitch loop -> consumer thread, bounded queues). Overlaps host-heavy
  consumption (full-res encode, egress) with the launches on multi-core
  hosts.

"auto" picks inline on small hosts (<= 2 cores) or when consumption is
light, threaded otherwise.

Traced (``utils/trace``; on from the start of run() when cfg.trace_dir
is set), the Runner numbers each frame set when it acquires it, and the
id travels with it through the staged queue, the results queue and the
consumer. Spans: in the stager thread ``acquire`` and ``stage`` (with
the Stitcher's ``stage.pin`` and ``stage.h2d``); ``queue.staged`` (push
-> pop); in the step loop ``step.wait`` (the pop), ``step.launch`` (the
stitch_out call, with the Stitcher's ``lock.wait`` and ``replay``) and
``results.push``, a child of ``queue.results`` (push -> the consumer's
pop); in the consumer ``consume``, with ``consume.sync`` or
``download`` (the Stitcher's ``download.alloc`` and ``download.wait``)
and ``sink``; in the re-solve thread ``resolve`` (the stages of
recalibrate_mesh inside) and ``resolve.swap``. The StageTimers
(``timers``: acquire, upload, launch, output), ``swap_ms`` and the
"Rewarp" log read the same spans, timed whether the tracer records or
not.

Run: python -m video_stitcher_tpu_torch.pipeline.runner --config cfg.json
(the same command line as the JAX package's runner). It runs on the card
and raises on a host without CUDA.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Optional

from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.io_plane.queues import FrameQueue
from video_stitcher_tpu_torch.utils.timing import StageTimers, FpsMeter
from video_stitcher_tpu_torch.utils import log, trace


class Runner:
    def __init__(self, cfg: StitcherConfig, source=None, sink=None,
                 egress=None, max_frames: Optional[int] = None,
                 consume_device: bool = False,
                 collect_latency: bool = False,
                 sync_every: int = 1,
                 staging_depth: int = 2,
                 stitcher=None):
        from video_stitcher_tpu_torch.pipeline.stitcher import Stitcher
        self.cfg = cfg
        #: a pre-calibrated Stitcher skips run()'s calibration phase —
        #: benches/back-to-back runs calibrate ONCE and reuse it (the
        #: reference likewise calibrates once at startup and only
        #: re-solves the mesh afterwards, timed.cpp:465-629)
        self.stitcher = stitcher if stitcher is not None else Stitcher(cfg)
        self.source = source
        self.sink = sink
        self.egress = egress
        self.max_frames = max_frames
        #: bench mode: the consumer forces completion with a wait on the
        #: card and a 4-byte read instead of downloading the full output
        #: frame — isolates the product's loop overhead (queues, swap
        #: lock, staging) from the host link. Sinks still receive the
        #: (device) frame.
        self.consume_device = consume_device
        self.collect_latency = collect_latency
        #: with consume_device, force completion only every Nth frame —
        #: a per-frame sync costs one host<->device round trip, which
        #: would measure the link, not the loop.
        self.sync_every = max(1, sync_every)
        #: staged-frame queue depth. 2 = double-buffered H2D (default,
        #: throughput-optimal); 1 minimizes frames in flight for
        #: latency-critical deployments (each queued stage adds one
        #: frame-time of staged->done latency). The stitcher stages
        #: through staging_depth + 1 pinned host buffers.
        self.staging_depth = max(1, staging_depth)
        #: per-frame end-to-end seconds (source handoff -> consumer done),
        #: filled when collect_latency is set
        self.latencies: list = []
        #: consumer completion perf_counter stamps (same indexing as
        #: latencies) — lets a bench compute sustained fps excluding the
        #: compile/calibration head of the run
        self.done_ts: list = []
        #: perf_counter stamps of successful mesh installs (cadence proof)
        self.recalib_ts: list = []
        #: per-swap milliseconds spent inside swap_state during interp
        #: animations (the new state's tile plan + lock hold) —
        #: attributes swap-window stalls separately from solve contention
        #: (the ``resolve.swap`` spans)
        self.swap_ms: list = []
        self.results = FrameQueue(max_size=cfg.results_max_size,
                                  drop_oldest=cfg.clear_buffers)
        #: the newest staged frame set, the recalibration thread's input
        #: (each thread makes it ready on its own stream: Stitcher._ready)
        self._latest_frames = None
        self._latest_lock = threading.Lock()
        self._stop = threading.Event()
        #: set once run() has its source (with use_stream, the capture
        #: server is listening: _ingest.port says where)
        self.source_ready = threading.Event()
        #: the threads run() started; each has ended or is ending once
        #: run() returns (their joins are bounded)
        self.threads: list = []
        #: mean host times of the stages, from their spans: "acquire"
        #: (source.get_frames), "upload" (``stage``: stage_frames),
        #: "launch" (``step.launch``: the stitch_out call, which queues the
        #: step's replay and returns; the step's completion is what the
        #: consumer's latency stamps see) and "output" (``consume``)
        self.timers = StageTimers(["acquire", "upload", "launch", "output"])
        self._into = {k: functools.partial(self.timers.add, k)
                      for k in self.timers.sums}
        #: the next frame set's id (trace spans)
        self._next_id = 0
        #: cfg.trace_dir: the profiler runs; the traced stretch's end
        self._tracing = False
        self._trace_until: Optional[int] = None
        self.fps = FpsMeter(period=30)
        self.frames_done = 0
        self.recalibs_done = 0
        self._last_recalib_t = 0.0
        self._first_frame = True
        self._consumed = 0
        #: live-loop device syncs that exceeded cfg.sync_timeout_ms and
        #: were dropped (frame skipped, pipeline kept alive) — the
        #: device-side analog of the ingest's per-camera drop counters
        self.sync_stalls = 0
        #: frame stagings (H2D) that exceeded the deadline and were dropped
        self.stage_stalls = 0

    # --- source -------------------------------------------------------
    def _make_source(self):
        if self.source is not None:
            return self.source
        cfg = self.cfg
        if cfg.use_stream:
            from video_stitcher_tpu_torch.io_plane.ingest import CaptureIngest
            ingest = CaptureIngest(cfg)
            ingest.start()
            self._ingest = ingest          # stats surfaced in the fps log

            class _NV12Source:
                """Hands raw NV12 [N, H*3/2, W] straight through — the
                stitch step converts on device (half the upload bytes of
                RGB; defs.h:10-17 capture format).

                Live capture has no EOF — a get_frames timeout is a
                transient stall (board reboot, network hiccup), so it
                retries with logging before giving up, mirroring the
                reference's 3-failed-recv policy (networking.cpp:29-37)
                at rig level. Only repeated exhaustion ends the run."""

                def get_frames(self_inner):
                    for attempt in range(3):
                        frames = ingest.get_frames(timeout=10.0)
                        if frames is not None:
                            return frames
                        log.warning(
                            "capture rig produced no full frame set in "
                            "10 s (attempt %d/3) — retrying", attempt + 1)
                    return None

                def release(self_inner):
                    ingest.stop()

            return _NV12Source()
        if cfg.video_files:
            from video_stitcher_tpu_torch.io_plane.video import VideoFileSource
            return VideoFileSource(cfg.video_files, cfg.offsets,
                                   cfg.skip_frames)
        # fall back to synthetic rig (hardware-free demo)
        from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
        from video_stitcher_tpu_torch.calib.calibration import plan_geometry
        geom, _ = plan_geometry(cfg)
        return SyntheticRigSource(cfg, geom)

    # --- recalibration job (timed.cpp:414-463) --------------------------
    def _recalib_loop(self):
        cfg = self.cfg
        if not (cfg.recalibrate and cfg.enable_local):
            return
        period = cfg.recalib_del_ms / 1000.0
        next_deadline = time.perf_counter() + period
        while not self._stop.is_set():
            # deadline-based cadence: the reference re-solves every
            # RECALIB_DEL ms wall time (defs.h:48); waiting the full period
            # AFTER each solve would stretch the effective period to
            # period + solve_time, so deduct the solve time from the wait
            wait = next_deadline - time.perf_counter()
            if wait > 0 and self._stop.wait(wait):
                break
            start = time.perf_counter()
            # if a solve overran whole periods, skip the missed slots
            # rather than solving back-to-back to "catch up"
            next_deadline += period * max(
                1, int((start - next_deadline) / period) + 1)
            with self._latest_lock:
                frames = self._latest_frames
            if frames is None:
                continue
            t0 = time.perf_counter()
            try:
                old_state = self.stitcher.state
                with trace.span("resolve", timed=True) as solve:
                    ok = self.stitcher.recalibrate_mesh(frames)
                if ok:
                    self.recalibs_done += 1
                    self.recalib_ts.append(time.perf_counter())
                    log.info("Rewarp: %.0f ms (period %.0f ms)",
                             solve.s * 1e3,
                             (t0 - self._last_recalib_t) * 1e3
                             if self._last_recalib_t else 0.0)
                    self._last_recalib_t = t0
                    if cfg.recalib_interp:
                        # animate old -> new mesh at ~33 Hz (timed.cpp:452-459)
                        new_state = self.stitcher.state
                        steps = max(2, cfg.recalib_del_ms // 60)
                        for k in range(1, steps):
                            if self._stop.is_set():
                                break
                            with trace.span("resolve.swap",
                                            into=self._swap_into):
                                self.stitcher.swap_state(
                                    self.stitcher.interpolate_states(
                                        old_state, new_state,
                                        k / (steps - 1)))
                            time.sleep(0.03)
                        with trace.span("resolve.swap"):
                            self.stitcher.swap_state(new_state)
            except Exception as e:          # recalib must never kill the loop
                log.warning("recalibration failed: %s", e)

    def _swap_into(self, seconds: float) -> None:
        self.swap_ms.append(seconds * 1e3)

    # --- consumer (timed.cpp:182-383) -----------------------------------
    def _consume_one(self, item):
        """Consume one stitched frame (shared by the inline loop and the
        threaded consumer): force/await completion, latency stamps,
        one-time calib.jpg/result.jpg, sink/show/egress, fps meter. The
        item: (output, the first set's frames or None, the staged stamp,
        the frame set's id, the results queue's push stamp and span id)."""
        out_dev, first_frames, t_staged, fid, t_push, qid = item
        trace.record("queue.results", t_push, trace.stamp(), frame=fid,
                     thread="queue", sid=qid)
        with trace.span("consume", frame=fid, into=self._into["output"]):
            self._consume(out_dev, first_frames, t_staged)

    def _consume(self, out_dev, first_frames, t_staged):
        cfg = self.cfg
        timeout_s = cfg.sync_timeout_ms / 1e3
        from video_stitcher_tpu_torch.utils.devsync import StallError
        if self.consume_device:
            # force completion without the full-frame download
            self._consumed += 1
            if self._consumed % self.sync_every == 0:
                from video_stitcher_tpu_torch.utils import devsync
                try:
                    with trace.span("consume.sync"):
                        devsync.read_head(out_dev, timeout_s)
                except StallError:
                    # deadline passed: drop this frame's sync and keep
                    # the pipeline alive (networking.cpp:29-37 analog)
                    self.sync_stalls += 1
                    log.warning("device sync stalled past %.1fs "
                                "(%d so far) — frame dropped",
                                timeout_s, self.sync_stalls)
                    return
            out = out_dev
        else:
            from video_stitcher_tpu_torch.utils import devsync
            try:
                with trace.span("download"):
                    out = devsync.call_deadline(
                        lambda: self.stitcher.finalize_out(out_dev),
                        timeout_s)
            except StallError:
                self.sync_stalls += 1
                log.warning("output download stalled past %.1fs "
                            "(%d so far) — frame dropped",
                            timeout_s, self.sync_stalls)
                return
        if self.collect_latency and t_staged is not None:
            now = time.perf_counter()
            self.latencies.append(now - t_staged)
            self.done_ts.append(now)
        if self._first_frame and not self.consume_device:
            from video_stitcher_tpu_torch.utils import viz
            try:
                if first_frames is not None:
                    # one-time full-res pano dump (timed.cpp:255), off
                    # the stitch loop
                    viz.save("calib.jpg", self.stitcher.stitch(first_frames))
                viz.save("result.jpg", out)
            except Exception as e:      # noqa: BLE001 — a debug dump
                # (a missing image library) must not end the run
                log.warning("calib.jpg / result.jpg not written: %s", e)
            if cfg.save_video and self.sink is None:
                from video_stitcher_tpu_torch.io_plane.video import VideoFileSink
                self.sink = VideoFileSink("stitched.avi", out.shape[1],
                                          out.shape[0])
        self._first_frame = False
        with trace.span("sink"):
            self._deliver(out)
        fps = self.fps.tick()
        if fps is not None:
            ing = getattr(self, "_ingest", None)
            log.info("fps: %.2f (%s)%s", fps, self.timers.summary(),
                     " [" + ing.stats_summary() + "]" if ing else "")

    def _deliver(self, out) -> None:
        """The output frame to the sink, the window and the egress."""
        cfg = self.cfg
        if self.sink is not None:
            self.sink.write(out)
        if cfg.show_out:
            from video_stitcher_tpu_torch.utils import viz
            viz.show(out, title="pano", wait_ms=1)   # timed.cpp:365-369
        if self.egress is not None or cfg.send_results:
            if self.egress is None:
                from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
                self.egress = PlayerEgress(cfg)
            try:
                self.egress.send_frame(out)
            except Exception as e:
                log.warning("egress failed: %s", e)

    def _consume_loop(self):
        try:
            while True:
                item = self.results.pop(timeout=1.0)
                if item is None:
                    if self._stop.is_set():
                        break
                    continue
                self._consume_one(item)
        except Exception as e:      # noqa: BLE001 — a dead consumer would
            # otherwise wedge the main thread forever inside
            # results.push(block=True) with nothing to drain the queue
            log.error("consumer thread failed: %s — ending run", e)
            self._stop.set()
            self.results.close()

    # --- staging (double-buffered H2D) ----------------------------------
    _EOF = object()

    def _stage_loop(self, source):
        """Producer thread: acquire + stage frame set t+1 while the
        stitch thread computes t (SURVEY §7(d) — the reference's
        synchronous per-frame upload is its own measured bottleneck,
        timed.cpp:62-71). The bounded queue keeps at most 2 frame sets in
        flight so a slow consumer applies backpressure, and the staged
        device array doubles as the recalibration thread's input (no
        second upload of the same frames)."""
        try:
            while not self._stop.is_set():
                fid, frames = self._acquire(source)
                if frames is None:
                    break
                dev = self._stage_bounded(frames, fid)
                if dev is None:
                    continue                  # staging stalled; frame dropped
                self._staged.push((dev, time.perf_counter(), fid,
                                   trace.stamp()), block=True)
        except Exception as e:  # noqa: BLE001 — without the EOF below a
            # dead stager leaves the main loop polling _staged forever
            log.error("stager thread failed: %s — ending run", e)
        finally:
            self._staged.push(Runner._EOF, block=True)

    def _acquire(self, source):
        """(the next frame set's id, the source's next frame set or
        None), in a span ``acquire``."""
        fid = self._next_id
        self._next_id += 1
        with trace.span("acquire", frame=fid, into=self._into["acquire"]):
            frames = source.get_frames()
        return fid, frames

    def _stage_bounded(self, frames, fid=None):
        """stage_frames with the sync deadline: returns the staged device
        array, or None when the H2D path stalled past cfg.sync_timeout_ms
        (logged + counted; the frame set is dropped, the loop lives)."""
        from video_stitcher_tpu_torch.utils import devsync
        timeout_s = self.cfg.sync_timeout_ms / 1e3
        try:
            with trace.span("stage", frame=fid, into=self._into["upload"]):
                return devsync.call_deadline(
                    lambda: self.stitcher.stage_frames(
                        frames, slots=self.staging_depth + 1), timeout_s)
        except devsync.StallError:
            self.stage_stalls += 1
            log.warning("frame staging stalled past %.1fs (%d so far) — "
                        "frame set dropped", timeout_s, self.stage_stalls)
            return None

    def _trace_tick(self) -> None:
        """One step of the device-trace window policy (shared by both
        pipeline modes): start the profiler after the compile frame, and
        stamp the end of the traced stretch after cfg.trace_frames traced
        frames. ``_trace_stop`` stops the profiler once the Runner's
        threads have ended: stopping torch.profiler while another thread
        replayed a CUDA graph or recorded an event hung it on an H100."""
        cfg = self.cfg
        if cfg.trace_dir and not self._tracing and self.frames_done == 1:
            trace.start_device_trace(cfg.trace_dir)
            self._tracing = True
        elif (self._tracing and self._trace_until is None
              and self.frames_done >= cfg.trace_frames + 1):
            self._trace_until = time.perf_counter_ns()

    def _trace_stop(self) -> None:
        """Stop the profiler (the threads have been joined) and write the
        trace of the stretch ``_trace_tick`` stamped."""
        if self._tracing:
            self._tracing = False
            trace.stop_device_trace(until=self._trace_until)
            log.info("device trace written to %s", self.cfg.trace_dir)

    def _to_rgb_host(self, frames):
        """NV12 [N, H*3/2, W] -> RGB u8 [N, H, W, 3] on the host (one-time,
        for calibration, which needs channel-last RGB), converted on the
        stitcher's device."""
        if frames.ndim != 3:
            return frames
        import torch
        from video_stitcher_tpu_torch.ops.color import nv12_to_rgb
        rgb = nv12_to_rgb(torch.as_tensor(frames,
                                          device=self.stitcher.device))
        return rgb.to(torch.uint8).cpu().numpy()

    # --- pipeline-mode choice -------------------------------------------
    def _use_inline(self) -> bool:
        mode = getattr(self.cfg, "pipeline_mode", "auto")
        if mode in ("inline", "threaded"):
            return mode == "inline"
        # auto: a small host loses more to queue handoffs + GIL context
        # switches than it gains from overlap; heavy consumption (full-res
        # encode + egress/sink) on a multi-core host wants the consumer
        # thread. Count the cpus this PROCESS may use (quota/affinity in a
        # container), not the machine's.
        import os
        try:
            ncpu = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):   # non-Linux / odd containers
            ncpu = os.cpu_count() or 1
        if ncpu <= 2:
            return True
        heavy = (not self.consume_device
                 and (self.sink is not None or self.cfg.save_video
                      or self.cfg.send_results or self.egress is not None
                      or self.cfg.show_out))
        return not heavy

    # --- inline pipelined loop (single host thread) -----------------------
    def _run_inline(self, source) -> None:
        """acquire -> stage -> launch -> consume(t - depth), one thread.

        The in-flight ring is what bounds how far the launches run
        ahead of completion: consuming a frame downloads (or syncs) it,
        which waits for the device. Ring depth = cfg.results_max_size
        (like the threaded results queue); in consume_device bench mode
        only every sync_every-th consume syncs, so the effective bound is
        max(depth, sync_every) frames in flight."""
        import collections
        cfg = self.cfg
        # the ring must be finite — consuming (the D2H/sync) is what
        # completes a frame, so "unbounded" (results_max_size=0, a
        # threaded-mode opt-in) has no inline meaning; fall back to the
        # bounded default rather than never consuming
        if not cfg.results_max_size:
            log.info("inline pipeline: results_max_size=0 (unbounded) has "
                     "no inline meaning; using ring depth 4")
        depth = max(1, cfg.results_max_size or 4)
        ring = collections.deque()
        while not self._stop.is_set():
            fid, frames = self._acquire(source)
            if frames is None:
                log.info("source exhausted")
                break
            dev = self._stage_bounded(frames, fid)
            if dev is None:
                continue                      # staging stalled; frame dropped
            t_staged = time.perf_counter()
            with self._latest_lock:
                self._latest_frames = dev
            self._trace_tick()
            with trace.span("step.launch", frame=fid,
                            into=self._into["launch"]):
                out = self.stitcher.stitch_out(dev, device=True)
            ring.append((out, dev if self.frames_done == 0 else None,
                         t_staged, fid, trace.stamp(), trace.new_id()))
            self.frames_done += 1
            if len(ring) >= depth:
                self._consume_one(ring.popleft())
            if self.max_frames and self.frames_done >= self.max_frames:
                break
        while ring:
            self._consume_one(ring.popleft())

    # --- main loop -------------------------------------------------------
    def run(self) -> None:
        """Run the pipeline until the source ends, max_frames or a stop.
        With cfg.trace_dir the tracer records from here to the end (so the
        programs captured now hold the step's markers), and the trace it
        writes covers cfg.trace_frames frames (``_trace_tick``): the
        profiler records from the second frame to the end of the run."""
        switch = bool(self.cfg.trace_dir) and not trace.is_on()
        if switch:
            trace.enable()
        try:
            self._run()
        finally:
            if switch:
                trace.disable()

    def _run(self) -> None:
        cfg = self.cfg
        source = self._make_source()
        self.source_ready.set()
        try:
            frames = source.get_frames()
            if frames is None:
                raise RuntimeError("couldn't read initial frames")
            if self.stitcher.state is None:
                t0 = time.perf_counter()
                self.stitcher.calibrate(self._to_rgb_host(frames))
                log.info("Calibration done in: %.0f ms",
                         (time.perf_counter() - t0) * 1e3)
            else:
                log.info("using pre-calibrated stitcher")
            # build the programs of the keys the Runner uses (their CUDA
            # graphs on the card; a capture synchronises the device) now,
            # while none of its threads launches work: stitch_out for
            # every frame, stitch for the one calib.jpg, and the live
            # re-solve's for frames of this source's format. The outputs
            # are not used.
            self.stitcher.stitch_out(frames, device=True)
            if not self.consume_device:
                self.stitcher.stitch(frames, device=True)
            if (cfg.recalibrate and cfg.enable_local
                    and self.stitcher.aux is not None):
                self.stitcher.prewarm_mesh(frames)
        except BaseException:
            # pre-loop failure: the ingest server/threads must not be
            # left running (a retry in-process would find the capture
            # port still bound and the boards still being drained)
            source.release()
            raise

        if self._use_inline():
            recalib = threading.Thread(target=self._recalib_loop, daemon=True,
                                       name="resolve")
            self.threads = [recalib]
            recalib.start()
            try:
                self._run_inline(source)
            finally:
                self._stop.set()
                recalib.join(timeout=5)
                self._trace_stop()
                source.release()
                if self.sink is not None:
                    self.sink.release()
                if self.egress is not None:
                    self.egress.close()
            return

        self._staged = FrameQueue(max_size=self.staging_depth,
                                  drop_oldest=False)
        consumer = threading.Thread(target=self._consume_loop, daemon=True,
                                    name="consumer")
        recalib = threading.Thread(target=self._recalib_loop, daemon=True,
                                   name="resolve")
        stager = threading.Thread(target=self._stage_loop, args=(source,),
                                  daemon=True, name="stager")
        self.threads = [consumer, recalib, stager]
        consumer.start()
        recalib.start()
        stager.start()

        try:
            while not self._stop.is_set():
                with trace.span("step.wait"):
                    item = self._staged.pop(timeout=1.0)
                if item is None:
                    continue
                if item is Runner._EOF:
                    log.info("source exhausted")
                    break
                frames, t_staged, fid, t_push = item
                trace.record("queue.staged", t_push, trace.stamp(),
                             frame=fid, thread="queue")
                self._trace_tick()
                with self._latest_lock:
                    self._latest_frames = frames
                with trace.span("step.launch", frame=fid,
                                into=self._into["launch"]):
                    # asynchronous launches — NO per-frame device sync
                    # here: the consumer forces completion when it
                    # downloads (or syncs) the frame, and the bounded
                    # queues bound how far the launches run ahead. The
                    # "launch" stage time is therefore launch cost;
                    # end-to-end completion is what the consumer-side
                    # latency stamps measure.
                    out = self.stitcher.stitch_out(frames, device=True)
                # the consumer renders the one-time calib.jpg full pano
                # from the first frame set (off the hot loop). With a
                # bounded results queue and clear_buffers off, the push
                # BLOCKS (backpressure bounds how far the launches run
                # ahead of completion); with clear_buffers the oldest
                # result drops instead (timed.cpp:141-151 policy)
                qid = trace.new_id()
                with trace.span("results.push", frame=fid, parent=qid):
                    self.results.push((out, frames if self.frames_done == 0
                                       else None, t_staged, fid,
                                       trace.stamp(), qid),
                                      block=not cfg.clear_buffers)
                self.frames_done += 1
                if self.max_frames and self.frames_done >= self.max_frames:
                    break
        finally:
            self._stop.set()
            self._staged.close()               # unblock the stager
            self.results.close()
            stager.join(timeout=5)
            consumer.join(timeout=10)
            # the recalib thread may be mid-solve; give it a moment so the
            # interpreter doesn't tear down under its feet (a C++ exception
            # in a dying daemon thread prints "terminate called" at exit)
            recalib.join(timeout=5)
            self._trace_stop()
            source.release()
            if self.sink is not None:
                self.sink.release()
            if self.egress is not None:
                self.egress.close()


def main(argv=None):
    cfg = StitcherConfig.from_args(argv)
    Runner(cfg).run()


if __name__ == "__main__":
    main()
