"""The port's live Runner on a CPU Stitcher at 6x320x180: every output of
both pipeline modes equals stitch_out of its frame set (the port's
stitch_out is held against the JAX package's by test_torch_stitch_e2e),
TCP NV12 ingest to loopback egress, the live recalibration thread with
its animation, shutdown and EOF races, the deadline cadence, stalls, the
deadline helpers and the command line. The behaviours follow the JAX
package's tests/test_runner_concurrency.py and test_stall_tolerance.py."""

import dataclasses
import socket
import struct
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu.ops import color as jax_color
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
from video_stitcher_tpu_torch.io_plane.ingest import pack_frame
from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
from video_stitcher_tpu_torch.mesh.pipeline import MeshPipeline
from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
from video_stitcher_tpu_torch.pipeline import runner as runner_mod
from video_stitcher_tpu_torch.pipeline.runner import Runner
from video_stitcher_tpu_torch.utils import devsync

CFG = StitcherConfig(num_images=6, input_width=320, input_height=180,
                     output_width=320, output_height=160, recalibrate=False,
                     sync_timeout_ms=10000.0)


@pytest.fixture(scope="module")
def rig():
    """A calibrated CPU stitcher (with the CPW mesh) and three NV12 frame
    sets of the synthetic rig."""
    src = SyntheticRigSource(CFG, plan_geometry(CFG)[0], drift_px=7.0)
    rgb = [src.get_frames() for _ in range(3)]
    st = Stitcher(CFG, device="cpu")
    st.calibrate(rgb[0])
    sets = [rgb_to_nv12(torch.from_numpy(f)).numpy() for f in rgb]
    return st, sets


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # the Runner writes calib/result.jpg


class CycleSource:
    def __init__(self, sets, limit=10 ** 6, until=lambda: False):
        self.sets, self.limit, self.until, self.n = sets, limit, until, 0

    def get_frames(self):
        if self.n >= self.limit or self.until():
            return None
        out = self.sets[self.n % len(self.sets)]
        self.n += 1
        return out

    def release(self):
        pass


class Sink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        self.frames.append(out)

    def release(self):
        pass


def _room(ing, sent: int) -> bool:
    """Whether the capture server has received every one of the `sent`
    frames of each camera and holds at most one of them unread."""
    lib = ing._native                   # None once the Runner stopped it
    return lib is not None and all(
        s["frames_ok"] >= sent for s in ing.stats()) and max(
        lib.stitchio_queue_size(c) for c in range(ing.n)) <= 1


def _run_in_thread(r, timeout=120):
    box = {}

    def drive():
        r.run()
        box["done"] = True
    t = threading.Thread(target=drive)
    t.start()
    return t, box


# --- outputs ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_every_output_equals_stitch_out_of_its_frame_set(rig, mode):
    st, sets = rig
    want = [st.stitch_out(s) for s in sets]
    sink = Sink()
    cfg = dataclasses.replace(CFG, pipeline_mode=mode)
    r = Runner(cfg, source=CycleSource(sets), sink=sink, max_frames=7,
               stitcher=st, collect_latency=True)
    r.run()
    assert r._use_inline() == (mode == "inline")
    assert r.frames_done == 7 and len(sink.frames) == 7
    assert r.sync_stalls == r.stage_stalls == 0
    for i, out in enumerate(sink.frames):
        # the first read is the calibration read, which a calibrated
        # stitcher's Runner discards
        np.testing.assert_array_equal(out, want[(i + 1) % 3])
    assert len(r.latencies) == 7 and all(x > 0 for x in r.latencies)
    assert r.timers.counts["upload"] >= 7     # the stager may run ahead


def test_consume_device_mode_and_shallow_queues(rig):
    st, sets = rig
    cfg = dataclasses.replace(CFG, pipeline_mode="threaded",
                              results_max_size=1)
    r = Runner(cfg, source=CycleSource(sets), max_frames=5, stitcher=st,
               consume_device=True, sync_every=2, collect_latency=True,
               staging_depth=1)
    r.run()
    assert r._staged.max_size == 1 and r.frames_done == 5
    assert len(r.latencies) == 5 and r.sync_stalls == 0


def test_tcp_nv12_ingest_to_loopback_egress(rig):
    """Boards stream framed NV12 over TCP into the Runner, which sends raw
    I420 to a loopback player: each frame the player receives is the
    I420 of stitch_out of the set sent for it."""
    st, sets = rig
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    player = socket.socket()
    player.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    player.bind(("127.0.0.1", ports[1]))
    player.listen(1)
    got = bytearray()

    def play():
        conn, _ = player.accept()
        with conn:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                got.extend(data)
    play_t = threading.Thread(target=play, daemon=True)
    play_t.start()
    rows, w = sets[0].shape[1:]
    cfg = dataclasses.replace(
        CFG, use_stream=True, capture_tcp_port=ports[0],
        capture_framing=True, capture_img_width=w, capture_img_height=rows,
        player_address="127.0.0.1", player_tcp_port=ports[1],
        pipeline_mode="threaded")
    eg = PlayerEgress(cfg, encoder="raw")
    r = Runner(cfg, egress=eg, max_frames=4, stitcher=st)
    t, box = _run_in_thread(r)
    socks = []
    try:
        for cam in range(6):
            for _ in range(200):
                try:
                    socks.append(socket.create_connection(
                        ("127.0.0.1", ports[0]), timeout=5))
                    break
                except OSError:
                    time.sleep(0.05)
            time.sleep(0.15)               # accept order = camera order
        ing = r._ingest
        for k in range(8):
            # keep the capture server's bounded queues from dropping: send
            # once every set sent has arrived and no camera holds more
            # than one frame
            deadline = time.monotonic() + 60
            while (box.get("done") is None and time.monotonic() < deadline
                   and not _room(ing, k)):
                time.sleep(0.002)
            for cam, s in enumerate(socks):
                s.sendall(pack_frame(sets[k % 3][cam].tobytes(), k))
        t.join(timeout=120)
    finally:
        for s in socks:
            s.close()
    play_t.join(timeout=10)
    player.close()
    assert box.get("done") and r.frames_done == 4
    assert r._ingest._lib is not None            # the native server served
    stats = r._ingest.stats()
    assert sum(s["resyncs"] + s["seq_gaps"] for s in stats) == 0
    h = st.stitch_out(sets[0]).shape[0] + 1      # 91 rows, padded even
    frame = h * CFG.output_width * 3 // 2
    assert struct.unpack("<i", bytes(got[:4]))[0] == h
    assert len(got) == 4 + 4 * frame
    for i in range(4):
        want = PlayerEgress._to_i420(eg._pad_even(
            st.stitch_out(sets[(i + 1) % 3])))
        assert bytes(got[4 + i * frame:4 + (i + 1) * frame]) \
            == want.tobytes(), i


def test_runner_calibrates_from_nv12_on_the_stitchers_device(rig):
    """An uncalibrated stitcher calibrates from the first set, converted
    to RGB by the port's nv12_to_rgb (equal to the JAX conversion)."""
    _, sets = rig
    cfg = dataclasses.replace(CFG, enable_local=False, pipeline_mode="inline")
    st = Stitcher(cfg, device="cpu")
    r = Runner(cfg, source=CycleSource(sets), max_frames=1, stitcher=st)
    rgb = r._to_rgb_host(sets[0])
    want = np.stack([np.asarray(jax_color.nv12_to_rgb(jnp.asarray(f)))
                     for f in sets[0]]).astype(np.uint8)
    np.testing.assert_array_equal(rgb, want)
    r.run()
    assert st.state is not None and r.frames_done == 1


# --- the recalibration thread ---------------------------------------------

@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_live_recalibration_installs_and_animates(rig, mode, monkeypatch):
    st, sets = rig
    cfg = dataclasses.replace(CFG, recalibrate=True, recalib_interp=True,
                              recalib_del_ms=300, pipeline_mode=mode)
    box = []
    installs = []
    solve = st.recalibrate_mesh

    def counting(frames):
        ok = solve(frames)
        if ok:
            installs.append(box[0].frames_done)
        return ok
    monkeypatch.setattr(st, "recalibrate_mesh", counting)
    steps = max(2, cfg.recalib_del_ms // 60)
    source = CycleSource(sets, until=lambda: (
        len(box[0].swap_ms) >= steps - 1
        and box[0].frames_done > installs[0] + 1))
    r = Runner(cfg, source=source, max_frames=400, stitcher=st)
    box.append(r)
    r.run()
    assert r.recalibs_done >= 1 and len(r.recalib_ts) == r.recalibs_done
    assert installs and installs[0] >= 1          # while frames flowed
    assert r.frames_done > installs[0] + 1        # and the loop went on
    assert len(r.swap_ms) >= steps - 1 and all(x >= 0 for x in r.swap_ms)
    assert r.sync_stalls == r.stage_stalls == 0


def test_shutdown_during_midflight_recalib_solve(rig, monkeypatch):
    st, sets = rig
    cfg = dataclasses.replace(CFG, recalibrate=True, recalib_del_ms=50,
                              pipeline_mode="threaded")
    solving = threading.Event()
    solve = st.recalibrate_mesh

    def slow(frames):
        solving.set()
        time.sleep(0.8)
        return solve(frames)
    monkeypatch.setattr(st, "recalibrate_mesh", slow)
    r = Runner(cfg, source=CycleSource(sets), max_frames=10 ** 6,
               stitcher=st)
    t, box = _run_in_thread(r)
    assert solving.wait(timeout=60), "the recalibration never started"
    r._stop.set()                          # lands mid-solve
    t.join(timeout=60)
    assert box.get("done") and not t.is_alive()
    assert r.frames_done >= 1


def test_source_eof_during_interp_animation(rig, monkeypatch):
    st, sets = rig
    cfg = dataclasses.replace(CFG, recalibrate=True, recalib_interp=True,
                              recalib_del_ms=50, pipeline_mode="inline")
    eof = threading.Event()
    swap = st.swap_state

    def eof_on_swap(state):
        eof.set()                          # the source dries up mid-way
        time.sleep(0.05)
        return swap(state)
    monkeypatch.setattr(st, "swap_state", eof_on_swap)
    r = Runner(cfg, source=CycleSource(sets, until=eof.is_set),
               max_frames=10 ** 6, stitcher=st)
    t, box = _run_in_thread(r)
    t.join(timeout=120)
    assert box.get("done"), "runner hung after EOF during the animation"
    assert eof.is_set() and r.frames_done >= 1


def test_recalib_deadline_cadence():
    """The wait deducts the solve time: the period is ~max(period, solve),
    never period + solve, and overruns skip the missed slots."""
    def run_loop(period_s, solve_s, n_solves):
        cfg = dataclasses.replace(CFG, recalibrate=True,
                                  recalib_interp=False,
                                  recalib_del_ms=int(period_s * 1000))
        r = Runner(cfg, stitcher=Stitcher(cfg, device="cpu"))
        r._latest_frames = np.zeros((1,), np.uint8)

        def fake_solve(frames):
            time.sleep(solve_s)
            return True
        r.stitcher.recalibrate_mesh = fake_solve
        t = threading.Thread(target=r._recalib_loop)
        t.start()
        deadline = time.monotonic() + 30
        while len(r.recalib_ts) < n_solves and time.monotonic() < deadline:
            time.sleep(0.02)
        r._stop.set()
        t.join(timeout=10)
        assert not t.is_alive() and len(r.recalib_ts) >= n_solves
        return float(np.median(np.diff(r.recalib_ts[:n_solves])))

    assert 0.38 <= run_loop(0.45, 0.15, 5) <= 0.58
    assert 0.45 <= run_loop(0.20, 0.50, 4) <= 0.68


# --- stalls and deadlines ---------------------------------------------------

@pytest.mark.parametrize("mode", ["inline", "threaded"])
@pytest.mark.parametrize("stage", ["stage_frames", "finalize_out"])
def test_a_stall_drops_the_frame_and_the_loop_lives(rig, mode, stage,
                                                    monkeypatch):
    """stage_frames or finalize_out sleeping past sync_timeout_ms on its
    second call: that frame set is dropped and counted, the rest flow."""
    st, sets = rig
    inner = getattr(st, stage)
    calls = []

    def stalled(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            time.sleep(1.5)
        return inner(*args, **kw)
    monkeypatch.setattr(st, stage, stalled)
    cfg = dataclasses.replace(CFG, pipeline_mode=mode, sync_timeout_ms=300.0,
                              results_max_size=1)
    sink = Sink()
    r = Runner(cfg, source=CycleSource(sets, limit=9), max_frames=8,
               stitcher=st, sink=sink, collect_latency=True)
    t0 = time.perf_counter()
    r.run()
    if stage == "stage_frames":
        assert r.stage_stalls == 1 and r.sync_stalls == 0
        assert r.frames_done == 7          # the source ran out first
    else:
        assert r.sync_stalls == 1 and r.stage_stalls == 0
        assert r.frames_done == 8
    assert len(sink.frames) == 7 and len(r.done_ts) == 7
    assert time.perf_counter() - t0 < 30
    deadline = time.monotonic() + 5
    while devsync.stalled_workers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert devsync.stalled_workers() == 0


def test_devsync_deadlines_on_cpu_tensors():
    x = torch.arange(10, dtype=torch.float32)
    assert devsync.read_head(x, 1.0).tolist() == [0.0, 1.0, 2.0, 3.0]
    assert devsync.read_head(x.reshape(2, 5), 0, n=2).tolist() == [0.0, 1.0]
    np.testing.assert_array_equal(devsync.to_host(x, 1.0), x.numpy())
    np.testing.assert_array_equal(devsync.to_host(np.ones(3), 1.0),
                                  np.ones(3))
    assert devsync.call_deadline(lambda: 42, 1.0) == 42
    assert devsync.call_deadline(lambda: "ok", 0) == "ok"
    with pytest.raises(ValueError):
        devsync.call_deadline(lambda: int("x"), 1.0)
    with pytest.raises(devsync.StallError):
        devsync.call_deadline(lambda: time.sleep(0.6), 0.05)
    deadline = time.monotonic() + 5
    while devsync.stalled_workers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert devsync.stalled_workers() == 0


def test_trace_dir_writes_a_profiler_trace(rig, tmp_path):
    """cfg.trace_dir: utils/trace records trace_frames frames under
    torch.profiler and writes a Chrome trace; annotate names a span."""
    import json
    from video_stitcher_tpu_torch.utils import trace
    st, sets = rig
    cfg = dataclasses.replace(CFG, pipeline_mode="inline",
                              trace_dir=str(tmp_path / "t"), trace_frames=2)
    r = Runner(cfg, source=CycleSource(sets), max_frames=4, stitcher=st)
    r.run()
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with trace.device_trace(str(tmp_path / "u")):
        with trace.annotate("stitch-span"):
            st.stitch_out(sets[0])
    with open(tmp_path / "u" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "stitch-span" in names
    with trace.device_trace(""):          # no directory: no trace
        pass
    with pytest.raises(RuntimeError, match="no device trace"):
        trace.stop_device_trace()


# --- the stitcher under the Runner's use ---------------------------------------

def test_a_tensor_on_the_device_passes_through_with_no_copy(rig,
                                                            monkeypatch):
    """The Runner hands the staged tensor to stitch_out and to
    recalibrate_mesh: both use its storage as it is."""
    st, sets = rig
    staged = st.stage_frames(sets[0])
    assert st.stage_frames(staged) is staged
    assert st._frames(staged) is staged
    seen = []
    warp = MeshPipeline.warp

    def spy(self, frames):
        seen.append(frames.data_ptr())
        return warp(self, frames)
    monkeypatch.setattr(MeshPipeline, "warp", spy)
    st.recalibrate_mesh(staged)
    assert seen == [staged.data_ptr()]
    np.testing.assert_array_equal(st.stitch_out(staged),
                                  st.stitch_out(sets[0]))


def test_swaps_from_a_second_thread_never_mix_states(rig):
    """swap_state and interpolate_states from one thread while another
    stitches: every frame is one installed state's frame."""
    st, sets = rig
    frames = torch.as_tensor(sets[0])
    a = st.state
    b = st.interpolate_states(st.state_global, a, 0.5)
    want = []
    for s in (a, b):
        st.swap_state(s)
        want.append(st.stitch_out(frames))
    assert not np.array_equal(want[0], want[1])
    stop = threading.Event()
    swaps = []

    def swapper():
        k = 0
        while not stop.is_set():
            st.swap_state(st.interpolate_states(a, b, float(k % 2)))
            swaps.append(k)
            k += 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=swapper)
    t.start()
    try:
        outs = [st.stitch_out(frames) for _ in range(6)]
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
        st.swap_state(a)
    assert not t.is_alive() and len(swaps) >= 2
    for out in outs:
        assert any(np.array_equal(out, w) for w in want)


# --- the command line ------------------------------------------------------------

def test_main_parses_the_jax_command_line(monkeypatch):
    seen = []

    class FakeRunner:
        def __init__(self, cfg):
            seen.append(cfg)

        def run(self):
            seen.append("ran")
    monkeypatch.setattr(runner_mod, "Runner", FakeRunner)
    runner_mod.main(["--num-images", "6", "--input-width", "320",
                     "--input-height", "180", "--recalib-del-ms", "2000",
                     "--use-stream", "true", "--pipeline-mode", "threaded"])
    cfg = seen[0]
    assert (cfg.num_images, cfg.input_width, cfg.input_height) == (6, 320,
                                                                   180)
    assert cfg.recalib_del_ms == 2000 and cfg.use_stream
    assert cfg.pipeline_mode == "threaded" and seen[1] == "ran"


def test_runner_runs_on_the_card():
    if torch.cuda.is_available():
        assert Runner(CFG).stitcher.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Runner(CFG)
