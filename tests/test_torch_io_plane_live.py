"""The JAX package's live I/O suite (tests/test_io_plane.py) run on the
port: the player egress's height prelude and MJPEG frames, the synthetic
source through the Runner, the network-to-network deployment loop
(BASELINE config 5), a board that drops and reconnects, garbage and a
truncated frame on the framed protocol, the ingest's drop counter, the
Runner's framed-ingest fault recovery, partial pops kept by get_frames,
and stop() closing the accepted connections; on both ingest backends
where the JAX suite runs both.

Each case keeps the JAX suite's rig and bound. What the JAX suite waited
for with fixed sleeps is an event, a join or a bounded poll here; every
listening socket binds port 0 and is read back; every thread and server
a test starts is joined within a bound written in the test and checked to
have ended. No case asserts a rate or a count that depends on time: the
boards pace themselves on what the server has received, so the counters
equal what the test injected."""

import math
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu.config import StitcherConfig as JaxConfig
from video_stitcher_tpu.io_plane import egress as jax_egress
from video_stitcher_tpu.io_plane import ingest as jax_ingest
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane import native
from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
from video_stitcher_tpu_torch.io_plane.ingest import CaptureIngest, pack_frame
from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
from video_stitcher_tpu_torch.pipeline.runner import Runner
from video_stitcher_tpu_torch.utils.synth import make_scene, render_views

WAIT_S = 30.0          # every wait on another thread, socket or server


def _wait(pred, timeout=WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _join(*threads, timeout=WAIT_S) -> None:
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), f"{t.name} did not end"


def _listener():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    s.settimeout(WAIT_S)
    return s, s.getsockname()[1]


def _read_n(conn, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return buf


def _started(backend, max_queue=4, debug_order=None, **kw):
    if backend == "native":
        assert native.load() is not None, "libstitchio did not build"
    ing = CaptureIngest(StitcherConfig(capture_tcp_port=0, **kw),
                        debug_order=debug_order, backend=backend,
                        max_queue=max_queue)
    ing.start()
    assert ing.port > 0
    return ing


def _stop(ing) -> None:
    """stop(), then every thread of the Python server has ended (the
    native server joins its own before stop() returns)."""
    ing.stop()
    _join(*ing._threads)


def _queued(ing, cam: int) -> int:
    if ing._native is not None:
        return ing._native.stitchio_queue_size(cam)
    return len(ing._queues[cam])


def _clients(ing) -> int:
    if ing._native is not None:
        return ing._native.stitchio_clients()
    return len(ing._conns)


def _room(ing, sent: int) -> bool:
    """Every camera has received `sent` frames and holds at most one
    unread: one more frame each cannot overflow the drop-oldest queues."""
    return all(s["frames_ok"] >= sent for s in ing.stats()) and max(
        _queued(ing, c) for c in range(ing.n)) <= 1


# --- egress ---------------------------------------------------------------

def test_egress_height_prelude_and_mjpeg():
    """tests/test_io_plane.py:72: the height prelude, then one
    length-prefixed JPEG, byte-equal to the JAX egress's encoding of the
    same frame."""
    import cv2
    server, port = _listener()
    received = {}

    def player():
        conn, _ = server.accept()
        with conn:
            conn.settimeout(WAIT_S)
            received["height"] = struct.unpack("<i", _read_n(conn, 4))[0]
            ln = struct.unpack("<I", _read_n(conn, 4))[0]
            received["jpeg"] = _read_n(conn, ln)

    t = threading.Thread(target=player)
    t.start()
    cfg = StitcherConfig(player_address="127.0.0.1", player_tcp_port=port,
                         send_results=True)
    eg = PlayerEgress(cfg, encoder="mjpeg")
    frame = np.zeros((120, 200, 3), np.uint8)
    frame[40:80, 50:150] = (255, 128, 0)
    try:
        eg.send_frame(frame)
        _join(t)
    finally:
        eg.close()
        server.close()
    assert received["height"] == 120
    jcfg = JaxConfig(player_address="127.0.0.1", player_tcp_port=port)
    want = jax_egress.PlayerEgress(jcfg, encoder="mjpeg")._encode(frame)
    assert struct.pack("<I", len(received["jpeg"])) + received["jpeg"] \
        == want
    dec = cv2.imdecode(np.frombuffer(received["jpeg"], np.uint8),
                       cv2.IMREAD_COLOR)
    assert dec.shape == (120, 200, 3)
    assert abs(int(dec[60, 100, 2]) - 255) < 30   # the orange block


# --- the Runner over the synthetic source and the network ----------------------

class _Sink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        self.frames.append(np.asarray(out))

    def release(self):
        pass


def test_synthetic_source_and_runner_smoke(tmp_path, monkeypatch):
    """tests/test_io_plane.py:118: the synthetic rig through the Runner
    for 3 frames, each output equal to stitch_out of the set the source
    rendered for it (the first set calibrates)."""
    monkeypatch.chdir(tmp_path)
    cfg = StitcherConfig(num_images=4, input_width=128, input_height=72,
                         enable_local=False, recalibrate=False,
                         output_width=256, output_height=128,
                         save_video=False, show_out=False)
    st = Stitcher(cfg, device="cpu")
    sink = _Sink()
    r = Runner(cfg, stitcher=st, sink=sink, max_frames=3)
    r.run()
    assert r.frames_done == 3 and len(sink.frames) == 3
    twin = SyntheticRigSource(cfg, plan_geometry(cfg)[0])
    sets = [twin.get_frames() for _ in range(4)]
    for out, frames in zip(sink.frames, sets[1:]):
        np.testing.assert_array_equal(out, st.stitch_out(frames))
    assert (tmp_path / "result.jpg").exists()
    _join(*r.threads)


def test_live_pipeline_network_to_network(tmp_path, monkeypatch):
    """tests/test_io_plane.py:130, BASELINE config 5 on loopback: two
    boards stream NV12 into the Runner's capture server, the Runner
    stitches (no re-solve) and sends MJPEG to a player. Each JPEG the
    player gets is byte-equal to the MJPEG of stitch_out of the set the
    boards sent for it."""
    monkeypatch.chdir(tmp_path)
    player_srv, play_port = _listener()
    cfg = StitcherConfig(num_images=2, input_width=64, input_height=48,
                         capture_img_width=64, capture_img_height=48,
                         capture_tcp_port=0, use_stream=True,
                         yaws=(0.0, math.pi / 3), wrap_around=False,
                         player_address="127.0.0.1",
                         player_tcp_port=play_port, send_results=True,
                         enable_local=False, recalibrate=False,
                         output_width=128, output_height=64)
    received = {"frames": []}

    def player():
        conn, _ = player_srv.accept()
        with conn:
            conn.settimeout(WAIT_S)
            try:
                received["height"] = struct.unpack("<i", _read_n(conn, 4))[0]
                for _ in range(2):
                    ln = struct.unpack("<I", _read_n(conn, 4))[0]
                    received["frames"].append(_read_n(conn, ln))
            except EOFError:
                pass

    st = Stitcher(cfg, device="cpu")
    r = Runner(cfg, stitcher=st, max_frames=2)
    player_t = threading.Thread(target=player, name="player")
    runner_t = threading.Thread(target=r.run, name="runner")
    player_t.start()
    runner_t.start()
    socks = []
    try:
        assert r.source_ready.wait(WAIT_S), "capture server never came up"
        port = r._ingest.port
        # the JAX suite's board bytes (4 chunks of 72x64 per camera) cut
        # into the 6 NV12 frames of 64x48 they hold. Both boards connect
        # (the accept order gives the slots), then send each set once the
        # server has room for it, so the 4-deep queues drop nothing while
        # the Runner calibrates from set 0 and stitches sets 1 and 2
        rng = np.random.default_rng(3)
        cams = [np.frombuffer(b"".join(
            rng.integers(0, 255, (72, 64)).astype(np.uint8).tobytes()
            for _ in range(4)), np.uint8).reshape(6, 48, 64)
            for _ in range(2)]
        for c in range(2):
            socks.append(socket.create_connection(("127.0.0.1", port),
                                                  timeout=WAIT_S))
            assert _wait(lambda: _clients(r._ingest) > c)
        for k in range(3):
            assert _wait(lambda: r.frames_done >= 2
                         or _room(r._ingest, k)), f"no room for set {k}"
            for c, s in enumerate(socks):
                s.sendall(cams[c][k].tobytes())
        _join(runner_t, timeout=120)
        _join(player_t)
    finally:
        player_srv.close()
        for s in socks:
            s.close()
    _join(*r.threads)
    assert sum(s["drops"] for s in r._ingest.stats()) == 0
    assert r.frames_done == 2
    assert received.get("height") == 64
    assert len(received["frames"]) == 2
    eg = PlayerEgress(cfg, encoder="mjpeg")
    for k, jpeg in enumerate(received["frames"]):
        want = eg._encode(st.stitch_out(np.stack([c[k + 1] for c in cams])))
        assert struct.pack("<I", len(jpeg)) + jpeg == want, k
    import cv2
    dec = cv2.imdecode(np.frombuffer(received["frames"][0], np.uint8),
                       cv2.IMREAD_COLOR)
    assert dec is not None and dec.shape[1] == cfg.output_width
    assert (tmp_path / "result.jpg").exists()


# --- the capture server: reconnects, byte loss, drops ---------------------------

@pytest.mark.parametrize("backend", ["python", "native"])
def test_tcp_ingest_client_reconnect(backend):
    """tests/test_io_plane.py:250: a board that dies mid-frame and
    reconnects keeps its slot (IP last octet - client_addr_start), and
    the partial frame of the dead connection is discarded."""
    ing = _started(backend, debug_order=False, num_images=1,
                   capture_img_width=64, capture_img_height=48,
                   client_addr_start=1)
    try:
        rng = np.random.default_rng(7)
        frames = [rng.integers(0, 255, (48, 64)).astype(np.uint8)
                  for _ in range(3)]
        fb = 48 * 64
        with socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S) as s:
            s.sendall(frames[0].tobytes() + b"\xAA" * (fb // 2))
            got = ing.pop_frame(0, timeout=WAIT_S)
        assert got is not None
        np.testing.assert_array_equal(got, frames[0])
        with socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S) as s:
            s.sendall(frames[1].tobytes() + frames[2].tobytes())
        for k in (1, 2):
            got = ing.pop_frame(0, timeout=WAIT_S)
            assert got is not None, f"frame {k} missing after reconnect"
            np.testing.assert_array_equal(got, frames[k])
        assert ing.stats()[0]["frames_ok"] == 3
    finally:
        _stop(ing)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_framed_ingest_resync_after_byte_loss(backend):
    """tests/test_io_plane.py:297: 777 garbage bytes and a frame cut by
    100 bytes; the ingest resyncs on the next magic and counts exactly
    that: 2 resyncs, 3 sequence numbers missing, 5 frames delivered with
    the ones after the fault intact."""
    ing = _started(backend, debug_order=True, max_queue=16, num_images=1,
                   capture_img_width=64, capture_img_height=48,
                   capture_framing=True)
    fb = 64 * 48
    try:
        rng = np.random.default_rng(7)
        frames = [rng.integers(0, 255, (48, 64)).astype(np.uint8)
                  for _ in range(6)]
        wire = pack_frame(frames[0].tobytes(), 0)
        wire += pack_frame(frames[1].tobytes(), 1)
        wire += b"\x99" * 777
        wire += pack_frame(frames[2].tobytes(), 2)[:12 + fb - 100]
        wire += pack_frame(frames[3].tobytes(), 5)
        wire += pack_frame(frames[4].tobytes(), 6)
        wire += pack_frame(frames[5].tobytes(), 7)
        with socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S) as s:
            for i in range(0, len(wire), 1024):
                s.sendall(wire[i:i + 1024])
        got = []
        for _ in range(5):
            f = ing.pop_frame(0, timeout=WAIT_S)
            assert f is not None
            got.append(f)
        np.testing.assert_array_equal(got[0], frames[0])
        np.testing.assert_array_equal(got[1], frames[1])
        np.testing.assert_array_equal(got[3], frames[4])
        np.testing.assert_array_equal(got[4], frames[5])
        st = ing.stats()[0]
        assert st["frames_ok"] == 5
        assert st["resyncs"] == 2, st
        assert st["bytes_skipped"] >= 777, st
        assert st["seq_gaps"] == 3, st
        assert "cam0" in ing.stats_summary()
    finally:
        _stop(ing)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_ingest_queue_drop_counter(backend):
    """tests/test_io_plane.py:358: 7 frames into a 2-deep queue with no
    consumer drop exactly 5, the oldest."""
    ing = _started(backend, debug_order=True, max_queue=2, num_images=1,
                   capture_img_width=64, capture_img_height=48)
    try:
        rng = np.random.default_rng(3)
        frames = [rng.integers(0, 255, (48, 64)).astype(np.uint8)
                  for _ in range(7)]
        with socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S) as s:
            s.sendall(b"".join(f.tobytes() for f in frames))
        assert _wait(lambda: ing.stats()[0]["frames_ok"] == 7), ing.stats()
        st = ing.stats()[0]
        assert st["drops"] == 5, st
        assert "drop=5" in ing.stats_summary()
        np.testing.assert_array_equal(ing.pop_frame(0, WAIT_S), frames[5])
        np.testing.assert_array_equal(ing.pop_frame(0, WAIT_S), frames[6])
    finally:
        _stop(ing)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_debug_order_reconnect_reuses_freed_slot(backend):
    """tests/test_io_plane.py:477: in accept order, once every slot was
    handed out, a dropped board's reconnect takes its freed slot."""
    ing = _started(backend, num_images=2, capture_img_width=32,
                   capture_img_height=24)
    assert ing.debug_order
    try:
        rng = np.random.default_rng(11)
        a, b, c = (rng.integers(0, 255, (24, 32)).astype(np.uint8)
                   for _ in range(3))
        s0 = socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S)
        s0.sendall(a.tobytes())
        np.testing.assert_array_equal(ing.pop_frame(0, timeout=WAIT_S), a)
        s1 = socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S)
        s1.sendall(b.tobytes())
        np.testing.assert_array_equal(ing.pop_frame(1, timeout=WAIT_S), b)
        s0.close()
        # slot 0 is free once its receiver saw the close
        assert _wait(lambda: _clients(ing) == 1)
        with socket.create_connection(("127.0.0.1", ing.port),
                                      timeout=WAIT_S) as s2:
            s2.sendall(c.tobytes())
            got = ing.pop_frame(0, timeout=WAIT_S)
        assert got is not None, "reconnected board rejected"
        np.testing.assert_array_equal(got, c)
        s1.close()
    finally:
        _stop(ing)


def test_get_frames_retains_partial_pops():
    """tests/test_io_plane.py:523: a camera's timeout keeps the frames
    already popped for the others; the next call pairs them, as the JAX
    ingest does."""
    f0 = np.full((12, 16), 1, np.uint8)
    f1 = np.full((12, 16), 2, np.uint8)
    kw = dict(num_images=2, capture_img_width=16, capture_img_height=12,
              capture_tcp_port=0)
    outs = []
    for ing in (CaptureIngest(StitcherConfig(**kw), backend="python"),
                jax_ingest.CaptureIngest(JaxConfig(**kw), backend="python")):
        ing._queues[0].push(f0)
        assert ing.get_frames(timeout=0.1) is None     # cam 1 is empty
        ing._queues[1].push(f1)
        outs.append(ing.get_frames(timeout=WAIT_S))
    np.testing.assert_array_equal(outs[0], np.stack([f0, f1]))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("backend", ["python", "native"])
def test_ingest_stop_closes_accepted_connections(backend):
    """tests/test_io_plane.py:542: stop() closes the accepted
    connections, not only the listener: the board's socket sees the
    close."""
    ing = _started(backend, num_images=1, capture_img_width=16,
                   capture_img_height=12)
    s = socket.create_connection(("127.0.0.1", ing.port), timeout=WAIT_S)
    try:
        assert _wait(lambda: _clients(ing) == 1)
        _stop(ing)
        s.settimeout(WAIT_S)
        try:
            closed = s.recv(4096) == b""
        except socket.timeout:
            closed = False
        except OSError:
            closed = True
    finally:
        s.close()
    assert closed, "accepted connection still open after stop()"


# --- the Runner's framed-ingest fault recovery ---------------------------------

def test_runner_framed_ingest_fault_recovery(tmp_path, monkeypatch):
    """tests/test_io_plane.py:392: the Runner over its own capture server
    on the framed protocol, with 1333 garbage bytes injected mid-stream
    by each board after its frame 8. The boards send each set once the
    server has room for it, so nothing drops: every camera counts one
    resync and exactly the bytes injected, no sequence gap, and every
    output after the fault equals stitch_out of its set."""
    monkeypatch.chdir(tmp_path)
    cfg = StitcherConfig(num_images=2, input_width=320, input_height=180,
                         enable_local=False, recalibrate=False,
                         use_stream=True, capture_framing=True,
                         capture_tcp_port=0, capture_img_width=320,
                         capture_img_height=270)
    geom, _ = plan_geometry(cfg)
    rng = np.random.default_rng(5)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(cfg, geom, scene)
    noisy = np.clip(frames.astype(np.int16)
                    + rng.integers(-20, 21, frames.shape), 0, 255
                    ).astype(np.uint8)
    sets = [rgb_to_nv12(torch.from_numpy(f)).numpy() for f in (frames,
                                                               noisy)]
    n_frames, fault_at, garbage = 24, 8, 1333
    st = Stitcher(cfg, device="cpu")
    sink = _Sink()
    r = Runner(cfg, stitcher=st, sink=sink, max_frames=n_frames,
               consume_device=True)
    runner_t = threading.Thread(target=r.run, name="runner")
    runner_t.start()
    socks, errors = [], []
    done = threading.Event()

    def boards():
        try:
            for cam in range(cfg.num_images):
                socks.append(socket.create_connection(
                    ("127.0.0.1", r._ingest.port), timeout=WAIT_S))
                # accept order gives the slots: connect the next board
                # once this one is served
                assert _wait(lambda: _clients(r._ingest) > cam)
            for seq in range(n_frames + 1):
                if not _wait(lambda: done.is_set() or _room(r._ingest,
                                                            seq)):
                    raise TimeoutError(f"no room for set {seq}")
                if done.is_set():
                    return
                for cam, s in enumerate(socks):
                    s.sendall(pack_frame(sets[seq % 2][cam].tobytes(), seq))
                    if seq == fault_at:
                        s.sendall(b"\x7f" * garbage)
        except Exception as e:      # noqa: BLE001 — reported below
            # the Runner sets _stop before it closes its capture server
            if not (done.is_set() or r._stop.is_set()):
                errors.append(repr(e))

    assert r.source_ready.wait(WAIT_S), "capture server never came up"
    board_t = threading.Thread(target=boards, name="boards")
    board_t.start()
    try:
        _join(runner_t, timeout=120)
    finally:
        done.set()
        _join(board_t)
        for s in socks:
            s.close()
    _join(*r.threads)
    assert not errors, errors
    assert r.frames_done == n_frames and len(sink.frames) == n_frames
    stats = r._ingest.stats()
    assert [s["resyncs"] for s in stats] == [1, 1], stats
    assert [s["bytes_skipped"] for s in stats] == [garbage] * 2, stats
    assert [s["seq_gaps"] for s in stats] == [0, 0], stats
    assert [s["drops"] for s in stats] == [0, 0], stats
    want = [st.stitch_out(s) for s in sets]
    for i, out in enumerate(sink.frames):
        # the first set calibrates; output i is of set i + 1
        np.testing.assert_array_equal(out, want[(i + 1) % 2],
                                      err_msg=str(i))
