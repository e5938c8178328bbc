"""The port's egress against the JAX package's: the built-in HEVC encoders
(I_PCM and lossy intra, Python and native) byte for byte, x265 through
libavcodec, PlayerEgress into a loopback player (raw, hevc_intra, hevc),
reconnects, and the debug visualisations."""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu.io_plane import egress as jax_egress
from video_stitcher_tpu.io_plane import hevc_intra as jax_intra
from video_stitcher_tpu.io_plane import hevc_pcm as jax_pcm
from video_stitcher_tpu.utils import viz as jax_viz
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane import hevc_intra, hevc_lavc, hevc_pcm
from video_stitcher_tpu_torch.io_plane.egress import (
    AnnexBFramer, PlayerEgress,
)
from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
from video_stitcher_tpu_torch.ops.color import rgb_to_i420
from video_stitcher_tpu_torch.utils import viz

#: (w, h): CTU-aligned, and one whose dimensions are not multiples of
#: the 32-pixel CTU
SIZES = [(64, 32), (96, 64), (100, 58)]


def _i420(rng, w, h):
    return rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("w,h", SIZES)
def test_pcm_encoders_equal_jax_byte_for_byte(w, h):
    lib = hevc_pcm.load_native()
    assert lib is not None, "libhevcpcm did not build"
    rng = np.random.default_rng(w + h)
    want_enc = jax_pcm.PcmHevcEncoder(w, h)
    ours = [hevc_pcm.PcmHevcEncoder(w, h),
            hevc_pcm.NativePcmHevcEncoder(w, h, lib)]
    for _ in range(2):                         # headers, then a frame
        frame = _i420(rng, w, h)
        want = want_enc.encode(frame)
        for enc in ours:
            assert enc.encode(frame) == want, type(enc).__name__
    ours[1].close()
    assert isinstance(hevc_pcm.create(w, h), hevc_pcm.NativePcmHevcEncoder)


@pytest.mark.parametrize("w,h,qp", [(64, 32, 30), (72, 36, 22),
                                    (100, 58, 40)])
def test_intra_encoders_equal_jax_byte_for_byte(w, h, qp):
    assert hevc_intra.load_native() is not None, "libhevcintra did not build"
    rng = np.random.default_rng(qp)
    want_enc = jax_intra.IntraHevcEncoder(w, h, qp=qp)
    ours = [hevc_intra.IntraHevcEncoder(w, h, qp=qp),
            hevc_intra.NativeIntraHevcEncoder(w, h, qp=qp)]
    for _ in range(2):
        frame = _i420(rng, w, h)
        want = want_enc.encode(frame)
        for enc in ours:
            assert enc.encode(frame) == want, type(enc).__name__
    ours[1].close()


def test_x265_round_trip_or_clean_absence():
    """x265 through libavcodec where its headers are installed: a
    decodable stream of the frames sent. Without them the loader gives
    None and create_encoder declines, so the egress chain moves on."""
    w, h = 96, 64
    if hevc_lavc.load_native() is None:
        assert hevc_lavc.create_encoder(w, h) is None
        return
    rng = np.random.default_rng(5)
    enc = hevc_lavc.create_encoder(w, h)
    frames = [_i420(rng, w, h) for _ in range(3)]
    stream = b"".join(enc.encode(f) for f in frames) + enc.finish()
    enc.close()
    dec = hevc_lavc.LavcHevcDecoder(max_w=w, max_h=h)
    out = dec.decode(stream) + dec.flush()
    dec.close()
    assert len(out) == 3 and all(o[1:] == (w, h) for o in out)
    y = np.frombuffer(out[0][0], np.uint8)[:w * h].astype(np.float64)
    want = np.frombuffer(frames[0], np.uint8)[:w * h].astype(np.float64)
    assert np.abs(y - want).mean() < 64.0    # lossy, but the same picture


def test_to_i420_native_equals_the_torch_op_and_jax():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (58, 100, 3), dtype=np.uint8)
    got = PlayerEgress._to_i420(rgb)
    assert got.shape == (58 * 100 * 3 // 2,)
    np.testing.assert_array_equal(got, rgb_to_i420(
        torch.from_numpy(rgb)).numpy().ravel())
    np.testing.assert_array_equal(got, jax_egress.PlayerEgress._to_i420(rgb))
    with pytest.raises(ValueError, match="even"):
        PlayerEgress._to_i420(rgb[:57])


class _Player:
    """Loopback player: records each connection's bytes; kill_after
    closes the next connection once it holds that many bytes."""

    def __init__(self):
        self.listener = socket.socket()
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(4)
        self.port = self.listener.getsockname()[1]
        self.conns = []
        self.kill_after = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        self.listener.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except (socket.timeout, OSError):
                continue
            buf = bytearray()
            self.conns.append(buf)
            conn.settimeout(0.1)
            with conn:
                while not self._stop.is_set():
                    if self.kill_after is not None \
                            and len(buf) >= self.kill_after:
                        self.kill_after = None
                        break
                    try:
                        data = conn.recv(1 << 16)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                    buf += data

    def wait_bytes(self, conn, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.conns) > conn \
                    and len(self.conns[conn]) >= n:
                return True
            time.sleep(0.01)
        return False

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.listener.close()


def _egress(player, encoder, **kw):
    cfg = StitcherConfig(num_images=2, player_address="127.0.0.1",
                         player_tcp_port=player.port)
    return PlayerEgress(cfg, encoder=encoder, **kw)


def test_player_egress_raw_and_hevc_intra_streams():
    """raw: the height prelude (odd heights edge-padded even), then the
    I420 bytes; hevc_intra: the prelude, then exactly the JAX encoder's
    bitstream of those bytes."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (63, 96, 3), dtype=np.uint8)
              for _ in range(2)]
    padded = [np.pad(f, ((0, 1), (0, 0), (0, 0)), mode="edge")
              for f in frames]
    i420 = [rgb_to_i420(torch.from_numpy(p)).numpy().tobytes()
            for p in padded]
    want_intra = jax_intra.IntraHevcEncoder(96, 64, qp=28)
    for encoder, want in (
            ("raw", b"".join(i420)),
            ("hevc_intra", b"".join(want_intra.encode(b) for b in i420))):
        player = _Player()
        eg = _egress(player, encoder, hevc_qp=28)
        try:
            for f in frames:
                eg.send_frame(f)
            assert player.wait_bytes(0, 4 + len(want)), encoder
        finally:
            eg.close()
            player.stop()
        data = bytes(player.conns[0])
        assert struct.unpack("<i", data[:4])[0] == 64
        assert data[4:] == want, encoder
        assert eg.selected_encoder == ("intra" if encoder == "hevc_intra"
                                       else "raw")


def test_player_egress_hevc_chain_sends_one_picture_per_frame():
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
              for _ in range(3)]
    player = _Player()
    eg = _egress(player, "hevc")
    try:
        for f in frames:
            eg.send_frame(f)
        enc = eg.selected_encoder
        assert enc in ("x265", "kvazaar", "ffmpeg", "pcm")
        time.sleep(0.3)
    finally:
        eg.close()
        player.stop()
    data = bytes(player.conns[0])
    assert struct.unpack("<i", data[:4])[0] == 64
    framer = AnnexBFramer()
    units = framer.push(data[4:]) + [framer.flush()]
    pictures = 0
    for u in units:
        i = u.index(b"\x01") + 1
        if (u[i] >> 1) & 0x3F < 32 and u[i + 2] & 0x80:
            pictures += 1
    if enc in ("x265", "pcm"):          # no lookahead
        assert pictures == len(frames), enc
    else:
        assert 0 < pictures <= len(frames), enc
    if enc == "pcm":                     # lossless: the I420 planes verbatim
        y = rgb_to_i420(torch.from_numpy(frames[0])).numpy()[:64]
        assert y.tobytes()[:96] in data


def test_egress_reconnects_with_a_clean_restart():
    player = _Player()
    eg = _egress(player, "raw")
    frame = np.random.default_rng(0).integers(0, 256, (32, 64, 3),
                                              dtype=np.uint8)
    n = 4 + 32 * 64 * 3 // 2
    try:
        eg.send_frame(frame)
        assert player.wait_bytes(0, n)
        player.kill_after = 0
        for _ in range(100):
            eg.send_frame(frame)
            if len(player.conns) >= 2 and player.wait_bytes(1, n, 0.05):
                break
            time.sleep(0.02)
        assert len(player.conns) >= 2, "egress never reconnected"
        second = bytes(player.conns[-1])
        assert struct.unpack("<i", second[:4])[0] == 32
        assert second[4:n] == PlayerEgress._to_i420(frame).tobytes()
    finally:
        eg.close()
        player.stop()


def test_egress_reconnect_racing_close():
    """A player that drops every connection after a few bytes drives
    send_frame through its reconnect path while close() lands from
    another thread: the sender ends promptly on "egress closed". close()
    comes once the player has taken three connections, so the sender is
    inside its reconnect loop when it lands."""
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(4)
    server.settimeout(0.2)
    stop = threading.Event()
    reconnecting = threading.Event()
    accepted = []

    def flaky_player():
        while not stop.is_set():
            try:
                conn, _ = server.accept()
            except (socket.timeout, OSError):
                continue
            accepted.append(1)
            if len(accepted) >= 3:
                reconnecting.set()
            try:
                conn.recv(64)
            except OSError:
                pass
            conn.close()

    srv_t = threading.Thread(target=flaky_player)
    srv_t.start()
    cfg = StitcherConfig(player_address="127.0.0.1",
                         player_tcp_port=server.getsockname()[1])
    eg = PlayerEgress(cfg, encoder="raw")
    frame = np.zeros((64, 96, 3), np.uint8)
    outcome = {}

    def sender():
        sent = 0
        try:
            while sent < 10_000:
                try:
                    eg.send_frame(frame)
                    sent += 1
                except OSError:
                    time.sleep(0.01)
        except RuntimeError as e:
            outcome["stopped"] = str(e)
        outcome["sent"] = sent

    snd_t = threading.Thread(target=sender)
    snd_t.start()
    try:
        assert reconnecting.wait(timeout=30), "the sender never reconnected"
        eg.close()
        snd_t.join(timeout=30)
    finally:
        eg.close()
        stop.set()
        snd_t.join(timeout=30)
        srv_t.join(timeout=30)
        server.close()
    assert not snd_t.is_alive(), "sender hung after egress close"
    assert not srv_t.is_alive(), "player did not end"
    assert outcome.get("stopped") == "egress closed", outcome


# --- debug visualisations -----------------------------------------------------

def test_viz_drawing_equals_jax():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (3, 40, 60), dtype=np.uint8)   # planar
    b = rng.random((48, 50, 3)).astype(np.float32)          # [0, 1] floats
    xy1 = rng.random((7, 2)) * [60, 40]
    xy2 = rng.random((7, 2)) * [50, 48]
    pairs = np.stack([np.arange(7), rng.permutation(7)], axis=1)
    mask = rng.random(7) > 0.3
    verts = rng.random((4, 5, 2)) * [60, 40]
    for fn, args in (
            ("draw_keypoints", (a, xy1, mask)),
            ("draw_matches", (a, xy1, b, xy2, pairs, mask)),
            ("draw_mesh", (a, verts)),
            ("side_by_side", (a, b, a[0]))):
        got = getattr(viz, fn)(*args)
        want = getattr(jax_viz, fn)(*args)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_visualize_matches_and_mesh_write_their_files(tmp_path):
    """With the debug toggles on, the mesh solve of calibrate writes one
    match image per matched seam and one mesh image per camera."""
    cfg = StitcherConfig(num_images=6, input_width=320, input_height=180,
                         visualize_matches=True, visualize_mesh=True,
                         viz_dir=str(tmp_path / "viz"))
    frames = SyntheticRigSource(cfg, plan_geometry(cfg)[0]).get_frames()
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)
    files = sorted(p.name for p in (tmp_path / "viz").iterdir())
    meshes = [f for f in files if f.startswith("mesh_000_")]
    matches = [f for f in files if f.startswith("matches_000_")]
    assert len(meshes) == 6 and len(matches) >= 3, files
    viz.save(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8))
    assert (tmp_path / "x.png").stat().st_size > 0
