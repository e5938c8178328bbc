"""A wedged host-device link gives logged drops, not a frozen process: the
deadline and worker-pool cases of tests/test_stall_tolerance.py on the
port's ``utils/devsync.py``, and its Runner cases that read the output
through ``devsync.read_head`` (``consume_device``): two stalled syncs
dropped in deadline time, and no deadline at all when
``sync_timeout_ms`` is 0. A host read that blocks (a duck-typed array,
as the JAX test's) is bounded as the JAX package bounds it.

Already covered, so left out here: the pass-through and zero-timeout
calls (tests/test_torch_runner.py::test_devsync_deadlines_on_cpu_tensors)
and the stalls of stage_frames and finalize_out in both pipeline modes
(tests/test_torch_runner.py::test_a_stall_drops_the_frame_and_the_loop_lives).
"""

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch.utils import devsync


def _drain(seconds=5.0):
    deadline = time.monotonic() + seconds
    while devsync.stalled_workers() > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    return devsync.stalled_workers()


# --- devsync unit ----------------------------------------------------

def test_call_deadline_stall_raises_and_drains():
    t0 = time.perf_counter()
    with pytest.raises(devsync.StallError):
        devsync.call_deadline(lambda: time.sleep(1.5), 0.1)
    assert time.perf_counter() - t0 < 1.0       # did not wait the sleep out
    assert devsync.stalled_workers() >= 1
    assert _drain() == 0                        # the abandoned worker ends


def test_call_deadline_fail_fast_when_wedged(monkeypatch):
    monkeypatch.setattr(devsync, "MAX_STALLED", 1)
    with pytest.raises(devsync.StallError):
        devsync.call_deadline(lambda: time.sleep(1.0), 0.05)
    # the link is wedged: the next bounded call fails at once, without
    # another worker
    t0 = time.perf_counter()
    with pytest.raises(devsync.StallError):
        devsync.call_deadline(lambda: 1, 10.0)
    assert time.perf_counter() - t0 < 0.5
    time.sleep(1.2)
    assert devsync.stalled_workers() == 0


def test_worker_pool_reuses_threads():
    """Healthy calls recycle their workers (no thread per call),
    concurrent callers each get theirs, and a stalled worker is never
    recycled."""
    for _ in range(5):                       # warm the pool
        devsync.call_deadline(lambda: 1, 1.0)
    before = threading.active_count()
    for i in range(50):
        assert devsync.call_deadline(lambda i=i: i * 2, 1.0) == i * 2
    assert threading.active_count() <= before + 1

    results = []

    def caller(k):
        results.append(devsync.call_deadline(
            lambda: (time.sleep(0.05), k)[1], 2.0))
    ts = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(results) == list(range(8))

    with pytest.raises(devsync.StallError):
        devsync.call_deadline(lambda: time.sleep(0.8), 0.05)
    assert devsync.call_deadline(lambda: "after", 1.0) == "after"
    time.sleep(1.0)
    assert devsync.stalled_workers() == 0


def test_read_head_on_numpy_like():
    class Arr:
        def ravel(self):
            return np.arange(16.0)
    assert devsync.read_head(Arr(), 1.0).tolist() == [0.0, 1.0, 2.0, 3.0]


class _StallArray:
    """A duck-typed device array whose host read blocks for `delay` s."""

    def __init__(self, delay=0.0):
        self.delay = delay

    def ravel(self):
        return self

    def __getitem__(self, sl):
        return self

    def __array__(self, dtype=None, copy=None):
        if self.delay:
            time.sleep(self.delay)
        return np.zeros(4, np.uint8)


def test_blocking_host_reads_are_bounded():
    with pytest.raises(devsync.StallError):
        devsync.read_head(_StallArray(1.0), 0.05)
    with pytest.raises(devsync.StallError):
        devsync.to_host(_StallArray(1.0), 0.05)
    assert devsync.to_host(_StallArray(), 1.0).tolist() == [0, 0, 0, 0]
    assert _drain() == 0


# --- Runner integration ----------------------------------------------

class _FakeStitcher:
    """The Stitcher surface the Runner loop uses: every Nth output stalls
    on its host read (a wedged download)."""

    device = torch.device("cpu")

    def __init__(self, stall_frames=(), delay=3.0):
        self.state = object()                  # "pre-calibrated"
        self.n_stitched = 0
        self.stall_frames = set(stall_frames)
        self.delay = delay

    def stage_frames(self, frames, slots=3):
        return frames

    def stitch_out(self, dev, device=False):
        i = self.n_stitched
        self.n_stitched += 1
        return _StallArray(self.delay if i in self.stall_frames else 0.0)

    def finalize_out(self, frame):
        return np.asarray(frame)


class _Source:
    def __init__(self, n):
        self.left = n
        self.frames = np.zeros((2, 6, 8, 3), np.uint8)

    def get_frames(self):
        if self.left <= 0:
            return None
        self.left -= 1
        return self.frames

    def release(self):
        pass


def _run(cfg_kw, **fake_kw):
    from video_stitcher_tpu_torch.config import StitcherConfig
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    cfg = StitcherConfig(num_images=2, input_width=8, input_height=6,
                         enable_local=False, recalibrate=False,
                         results_max_size=1,
                         **{"sync_timeout_ms": 200.0, **cfg_kw})
    # 9 source frames: run() reads one up front (the calibration frame,
    # dropped for a calibrated stitcher), 8 flow through the loop
    r = Runner(cfg, source=_Source(9), max_frames=8, consume_device=True,
               collect_latency=True, stitcher=_FakeStitcher(**fake_kw))
    t0 = time.perf_counter()
    r.run()
    return r, time.perf_counter() - t0


@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_runner_survives_sync_stalls(mode):
    r, dt = _run({"pipeline_mode": mode}, stall_frames={2, 5})
    # two multi-second stalls: two logged drops, in deadline time
    assert r.sync_stalls == 2
    assert len(r.done_ts) == 8 - 2
    assert dt < 4.0
    time.sleep(3.2)                 # the abandoned workers drain
    assert devsync.stalled_workers() == 0


def test_runner_unbounded_when_disabled():
    # sync_timeout_ms=0 keeps unbounded blocking
    r, dt = _run({"pipeline_mode": "inline", "sync_timeout_ms": 0.0},
                 stall_frames={3}, delay=0.5)
    assert r.sync_stalls == 0
    assert len(r.done_ts) == 8
    assert dt >= 0.5
