"""The port's I/O plane against the JAX package's: the frame queue, the
framed wire protocol, the Annex-B framer, the TCP capture ingest (native
and pure-Python servers, raw and framed protocols, loopback boards), the
host colour conversions and the synthetic rig source."""

import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu.calib.calibration import plan_geometry as jax_plan
from video_stitcher_tpu.config import StitcherConfig as JaxConfig
from video_stitcher_tpu.io_plane import egress as jax_egress
from video_stitcher_tpu.io_plane import ingest as jax_ingest
from video_stitcher_tpu.io_plane.video import (
    SyntheticRigSource as JaxSynthetic,
)
from video_stitcher_tpu.ops import color as jax_color
from video_stitcher_tpu_torch import StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane import native
from video_stitcher_tpu_torch.io_plane.egress import AnnexBFramer
from video_stitcher_tpu_torch.io_plane.ingest import (
    HEADER_BYTES, CaptureIngest, pack_frame,
)
from video_stitcher_tpu_torch.io_plane.queues import FrameQueue
from video_stitcher_tpu_torch.io_plane.video import (
    NpzClipSource, SyntheticRigSource, VideoFileSink, VideoFileSource,
)
from video_stitcher_tpu_torch.ops.color import nv12_to_rgb, rgb_to_i420
from video_stitcher_tpu_torch.utils.timing import FpsMeter, StageTimers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- queue, framing -----------------------------------------------------

def test_frame_queue_policies_and_backpressure():
    q = FrameQueue(max_size=2, drop_oldest=True)
    for i in range(4):
        q.push(i)
    assert len(q) == 2 and q.dropped == 2
    assert q.pop(0.1) == 2
    assert FrameQueue().pop(0.05) is None
    q = FrameQueue(max_size=1, drop_oldest=False)
    assert q.push(1, block=True)
    done = []
    t = threading.Thread(target=lambda: done.extend(
        [q.push(2, block=True), q.push(3, block=True)]))
    t.start()
    time.sleep(0.15)
    assert done == []                       # blocked on the full queue
    assert q.pop(timeout=1) == 1
    deadline = time.monotonic() + 5
    while len(q) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and done == [True, False]


def test_pack_frame_matches_the_jax_wire_format():
    payload = bytes(range(256)) * 3
    for seq in (0, 7, 2 ** 32 + 5):
        assert pack_frame(payload, seq) == jax_ingest.pack_frame(payload,
                                                                 seq)
    assert len(pack_frame(b"", 1)) == HEADER_BYTES


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_annexb_framer_equals_the_jax_framer(chunk):
    rng = np.random.default_rng(4)
    units = []
    for k in range(6):
        body = bytes(rng.integers(1, 256, 5 + 7 * k).astype(np.uint8))
        units.append((b"\x00\x00\x00\x01" if k % 2 else b"\x00\x00\x01")
                     + body)
    stream = b"".join(units)
    ours, theirs = AnnexBFramer(), jax_egress.AnnexBFramer()
    got, want = [], []
    for i in range(0, len(stream), chunk):
        got += ours.push(stream[i:i + chunk])
        want += theirs.push(stream[i:i + chunk])
    got.append(ours.flush())
    want.append(theirs.flush())
    assert got == want and got == units


def test_stage_timers_and_fps_meter():
    timers = StageTimers(["a", "b"])
    with timers.time("a"):
        time.sleep(0.01)
    assert timers.mean_ms("a") >= 9.0 and timers.mean_ms("b") == 0.0
    assert timers.summary().startswith("a=")
    meter = FpsMeter(period=3)
    assert [meter.tick() is None for _ in range(3)] == [True, True, False]


# --- TCP capture ingest ---------------------------------------------------

def _boards(port, per_cam, framed, drop=None):
    """Connect one loopback board per camera, in order, and stream its
    frames; drop=(frame, bytes) cuts bytes out of that frame's payload."""
    socks = []
    for cam, frames in enumerate(per_cam):
        for _ in range(100):
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                time.sleep(0.05)
        socks.append(s)
        time.sleep(0.15)                  # accept order = camera order
        data = b""
        for k, f in enumerate(frames):
            raw = f.tobytes()
            if drop is not None and k == drop[0]:
                raw = raw[:100] + raw[100 + drop[1]:]
            data += pack_frame(raw, k) if framed else raw
        for i in range(0, len(data), 4096):
            s.sendall(data[i:i + 4096])
    return socks


@pytest.mark.parametrize("backend,framed,cams", [
    ("python", False, 2), ("python", True, 6),
    ("native", False, 6), ("native", True, 2)])
def test_capture_ingest_loopback(backend, framed, cams):
    """Loopback boards stream 64x54 NV12 (the raw protocol, or the framed
    one): each camera's frames come back in order and equal, and
    get_frames stacks one frame of each camera."""
    if backend == "native":
        assert native.load() is not None, "libstitchio did not build"
    port = _free_port()
    cfg = StitcherConfig(num_images=cams, capture_img_width=64,
                         capture_img_height=54, capture_tcp_port=port,
                         capture_framing=framed)
    ing = CaptureIngest(cfg, debug_order=True, backend=backend)
    ing.start()
    rng = np.random.default_rng(cams)
    per_cam = [[rng.integers(0, 256, (54, 64), dtype=np.uint8)
                for _ in range(3)] for _ in range(cams)]
    socks = []
    try:
        socks = _boards(port, per_cam, framed)
        first = ing.get_frames(timeout=10.0)
        assert first is not None and first.shape == (cams, 54, 64)
        np.testing.assert_array_equal(first, np.stack(
            [f[0] for f in per_cam]))
        for k in (1, 2):
            for cam in range(cams):
                got = ing.pop_frame(cam, timeout=10.0)
                assert got is not None, (cam, k)
                np.testing.assert_array_equal(got, per_cam[cam][k])
        stats = ing.stats()
        assert [s["frames_ok"] for s in stats] == [3] * cams
        assert sum(s["resyncs"] + s["seq_gaps"] for s in stats) == 0
        assert ing.stats_summary() == "ingest ok"
    finally:
        for s in socks:
            s.close()
        ing.stop()


@pytest.mark.parametrize("backend", ["python", "native"])
def test_framed_ingest_resyncs_within_one_frame(backend):
    """Bytes lost inside one frame's payload cost that frame (and, by its
    sequence number, one gap), never the frames after it."""
    if backend == "native":
        assert native.load() is not None, "libstitchio did not build"
    port = _free_port()
    cfg = StitcherConfig(num_images=1, capture_img_width=64,
                         capture_img_height=54, capture_tcp_port=port,
                         capture_framing=True)
    ing = CaptureIngest(cfg, debug_order=True, backend=backend)
    ing.start()
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (54, 64), dtype=np.uint8)
              for _ in range(4)]
    socks = []
    try:
        socks = _boards(port, [frames], True, drop=(1, 37))
        for k in (0, 2, 3):
            got = ing.pop_frame(0, timeout=10.0)
            assert got is not None, k
            np.testing.assert_array_equal(got, frames[k])
        assert ing.pop_frame(0, timeout=0.3) is None
        s = ing.stats()[0]
        assert s["frames_ok"] == 3 and s["resyncs"] == 1
        assert s["seq_gaps"] == 1 and s["bytes_skipped"] > 0
    finally:
        for s in socks:
            s.close()
        ing.stop()


# --- colour conversions -------------------------------------------------

@pytest.mark.parametrize("h,w", [(54, 64), (1170, 16), (36, 48)])
def test_nv12_to_rgb_and_rgb_to_i420_match_jax(h, w):
    """Both conversions against the JAX ops on seeded frames; 1170 rows
    give an odd count (585) of chroma rows, where the I420 U plane ends
    mid-row. Measured: equal bit for bit (tolerance 0)."""
    rng = np.random.default_rng(h + w)
    nv12 = rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)
    got = nv12_to_rgb(torch.from_numpy(nv12)).numpy()
    want = np.asarray(jax_color.nv12_to_rgb(jnp.asarray(nv12)))
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    batch = np.stack([nv12, nv12[::-1]])
    np.testing.assert_array_equal(
        nv12_to_rgb(torch.from_numpy(batch)).numpy()[1],
        np.asarray(jax_color.nv12_to_rgb(jnp.asarray(batch[1]))))
    for rgb in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                (rng.random((h, w, 3)) * 255).astype(np.float32)):
        got = rgb_to_i420(torch.from_numpy(rgb)).numpy()
        want = np.asarray(jax_color.rgb_to_i420(jnp.asarray(rgb)))
        assert got.shape == (h * 3 // 2, w) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# --- sources -----------------------------------------------------------------

def test_synthetic_rig_source_equals_jax():
    kw = dict(num_images=4, input_width=96, input_height=54)
    cfg, jcfg = StitcherConfig(**kw), JaxConfig(**kw)
    ours = SyntheticRigSource(cfg, plan_geometry(cfg)[0], seed=2)
    theirs = JaxSynthetic(jcfg, jax_plan(jcfg)[0], seed=2)
    for _ in range(2):
        got, want = ours.get_frames(), theirs.get_frames()
        assert got.shape == (4, 54, 96, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_npz_clip_source_loops(tmp_path):
    clip = np.arange(2 * 3 * 4 * 5 * 3, dtype=np.uint8).reshape(
        2, 3, 4, 5, 3)
    np.savez(tmp_path / "clip.npz", frames=clip)
    src = NpzClipSource(str(tmp_path / "clip.npz"))
    got = [src.get_frames() for _ in range(3)]
    np.testing.assert_array_equal(got[2], clip[0])
    once = NpzClipSource(str(tmp_path / "clip.npz"), loop=False)
    assert [once.get_frames() is None for _ in range(3)] == [False, False,
                                                             True]


def test_video_files_round_trip_or_a_clear_error(tmp_path, monkeypatch):
    """VideoFileSink / VideoFileSource go through OpenCV: a written clip
    reads back at its size; without cv2 both raise a clear ImportError."""
    path = str(tmp_path / "clip.avi")
    frame = np.zeros((48, 64, 3), np.uint8)
    frame[:, 32:] = (255, 128, 0)
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    if have_cv2:
        sink = VideoFileSink(path, 64, 48)
        for _ in range(3):
            sink.write(frame)
        sink.release()
        src = VideoFileSource([path, path], offsets=(1,))
        got = src.get_frames()
        src.release()
        assert got.shape == (2, 48, 64, 3)
        assert abs(int(got[0, 24, 48, 0]) - 255) < 40     # RGB order kept
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        VideoFileSink(path, 64, 48)
    with pytest.raises(ImportError, match="OpenCV"):
        VideoFileSource([path])
