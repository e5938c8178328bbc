"""The JAX package's HEVC suites run on the port's encoders and egress:
tests/test_hevc_intra.py (the lossy intra encoder decodes on FFmpeg's
decoder to exactly its own reconstruction, at its quality and rate),
tests/test_hevc_pcm.py (the I_PCM encoder decodes bit-exact through
cv2's independent FFmpeg), tests/test_hevc_lavc.py (x265 in process)
and tests/test_egress.py's HEVC cases (the subprocess encoder's stream,
the egress pipeline's integrity and its reconnect, a real round trip).

Each case keeps the JAX suite's sizes, QPs and bounds, and where the
encoder is deterministic the port's stream is also held byte for byte
against the JAX encoder's on the same input. Cases skip where the JAX
suite skips (no in-process decoder, no libx265, cv2 without FFmpeg, no
kvazaar or ffmpeg), decided inside each test. Every player thread is
joined within a bound written in the test and checked to have ended."""

import os
import shutil
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu.io_plane import hevc_intra as jax_intra
from video_stitcher_tpu.io_plane import hevc_lavc as jax_lavc
from video_stitcher_tpu.io_plane import hevc_pcm as jax_pcm
from video_stitcher_tpu_torch import StitcherConfig
from video_stitcher_tpu_torch.io_plane import hevc_intra, hevc_lavc, hevc_pcm
from video_stitcher_tpu_torch.io_plane.egress import (
    AnnexBFramer, HevcEncoder, PlayerEgress,
)
from video_stitcher_tpu_torch.ops.color import rgb_to_i420

WAIT_S = 30.0          # every wait on another thread or socket


def _i420(rgb: np.ndarray) -> np.ndarray:
    return rgb_to_i420(torch.from_numpy(rgb)).numpy()


@pytest.fixture
def lavc_decoder():
    """tests/test_hevc_intra.py's gate: an in-process HEVC decoder."""
    if hevc_lavc.load_native() is None:
        pytest.skip("no in-process hevc decoder")
    try:
        hevc_lavc.LavcHevcDecoder().close()
    except RuntimeError:
        pytest.skip("no in-process hevc decoder")


@pytest.fixture
def cv2_hevc():
    """tests/test_hevc_pcm.py's gate: cv2 built with FFmpeg."""
    import cv2
    build = cv2.getBuildInformation()
    if not ("FFMPEG" in build
            and "YES" in build.split("FFMPEG", 1)[1][:40]):
        pytest.skip("cv2 lacks FFmpeg (independent hevc decoder)")


@pytest.fixture
def x265():
    """tests/test_hevc_lavc.py's gate: libavcodec with libx265."""
    if hevc_lavc.load_native() is None \
            or hevc_lavc.create_encoder(64, 64) is None:
        pytest.skip("system libavcodec/libx265 unavailable")


def _decode(stream: bytes):
    dec = hevc_lavc.LavcHevcDecoder()
    try:
        return dec.decode(stream) + dec.flush()
    finally:
        dec.close()


def _cv2_decode_y(stream: bytes, tmp_path, n_frames: int):
    """Annex-B HEVC through cv2's FFmpeg: the raw Y planes."""
    import cv2
    p = tmp_path / "stream.h265"
    p.write_bytes(stream)
    cap = cv2.VideoCapture(str(p))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    planes = []
    for _ in range(n_frames):
        ok, dec = cap.read()
        if not ok:
            break
        planes.append(np.asarray(dec).reshape(-1).copy())
    cap.release()
    return planes


class _Player:
    """Loopback player: one bytearray per accepted connection; kill_after
    closes the current connection once it holds that many bytes."""

    def __init__(self):
        self.listener = socket.socket()
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(2)
        self.listener.settimeout(0.1)
        self.port = self.listener.getsockname()[1]
        self.sessions = []
        self.kill_after = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="player")
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            buf = bytearray()
            self.sessions.append(buf)
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

    def wait(self, pred) -> bool:
        deadline = time.monotonic() + WAIT_S
        while not pred():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=WAIT_S)
        self.listener.close()
        assert not self._thread.is_alive(), "player did not end"


def _egress(player, encoder, **kw):
    cfg = StitcherConfig(num_images=2, player_address="127.0.0.1",
                         player_tcp_port=player.port)
    return PlayerEgress(cfg, encoder=encoder, **kw)


# --- the lossy intra encoder (tests/test_hevc_intra.py) ---------------------------

def _mk(w, h, seed=0, kind="mixed"):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "noise":
        y = rng.integers(0, 255, (h, w)).astype(np.uint8)
        u = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    else:
        y = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
        u = ((xx[::2, ::2] * 5) % 256).astype(np.uint8)
        v = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    return np.concatenate([y.ravel(), u.ravel(), v.ravel()]).tobytes()


def _psnr(a, b):
    a = np.frombuffer(a, np.uint8).astype(np.float64)
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))


def _intra_roundtrip(frames, w, h, qp):
    """The port's Python intra encoder over `frames` (its stream held
    byte for byte against the JAX encoder's), decoded in process."""
    enc = hevc_intra.IntraHevcEncoder(w, h, qp=qp)
    jenc = jax_intra.IntraHevcEncoder(w, h, qp=qp)
    stream, recons = b"", []
    for fr in frames:
        units = enc.encode(fr)
        assert units == jenc.encode(fr)
        stream += units
        recons.append(np.concatenate([enc.recon_y.ravel(),
                                      enc.recon_u.ravel(),
                                      enc.recon_v.ravel()]))
    return stream, _decode(stream), recons


@pytest.mark.parametrize("qp", [20, 30, 40])
def test_intra_decoder_exact_and_quality(lavc_decoder, qp):
    """tests/test_hevc_intra.py:72."""
    w, h = 64, 32
    f = _mk(w, h)
    stream, out, recons = _intra_roundtrip([f], w, h, qp)
    assert len(out) == 1
    assert np.array_equal(np.frombuffer(out[0][0], np.uint8), recons[0]), \
        "decode != encoder recon"
    assert _psnr(f, recons[0]) >= 45 - qp * 0.5
    assert len(stream) < 0.5 * len(f)


def test_intra_multi_frame_stream_and_sizes(lavc_decoder):
    """tests/test_hevc_intra.py:83: 72x36 (the conformance window), 3
    frames."""
    w, h = 72, 36
    frames = [_mk(w, h, seed=s) for s in range(3)]
    _, out, recons = _intra_roundtrip(frames, w, h, qp=30)
    assert len(out) == 3
    for (got, ow, oh), rec in zip(out, recons):
        assert (ow, oh) == (w, h)
        assert np.array_equal(np.frombuffer(got, np.uint8), rec)


def test_intra_noise_worst_case_stays_conformant(lavc_decoder):
    """tests/test_hevc_intra.py:94: pure noise at QP 18, 30 and 45."""
    w, h = 48, 48
    f = _mk(w, h, kind="noise")
    for qp in (18, 30, 45):
        _, out, recons = _intra_roundtrip([f], w, h, qp)
        assert np.array_equal(np.frombuffer(out[0][0], np.uint8),
                              recons[0]), f"qp {qp}"


def test_intra_rate_quality_tradeoff_vs_pcm():
    """tests/test_hevc_intra.py:106: the size falls as QP rises, and at
    QP 30 is under 0.4 of the raw frame (I_PCM is ~1.02x raw); the sizes
    equal the JAX encoder's."""
    w, h = 64, 64
    f = _mk(w, h)
    sizes = {}
    for qp in (20, 30, 40):
        sizes[qp] = len(hevc_intra.IntraHevcEncoder(w, h, qp=qp).encode(f))
        assert sizes[qp] == len(jax_intra.IntraHevcEncoder(
            w, h, qp=qp).encode(f))
    assert sizes[40] < sizes[30] < sizes[20]
    assert sizes[30] < 0.4 * len(f)


def test_cabac_tables_match_the_spec():
    """tests/test_hevc_intra.py:118: the two historically wrong entries
    and the spec tables' structure, and the JAX package's tables."""
    rl, tl = hevc_pcm._RANGE_LPS, hevc_pcm._TRANS_LPS
    assert rl[31, 0] == 29 and int(tl[28]) == 22
    assert rl.shape == (64, 4)
    assert (rl[:-1] >= rl[1:]).all()
    assert (rl[:, 1:] >= rl[:, :-1]).all()
    assert rl[63].tolist() == [2, 2, 2, 2] and int(tl[63]) == 63
    np.testing.assert_array_equal(rl, jax_pcm._RANGE_LPS)
    np.testing.assert_array_equal(tl, jax_pcm._TRANS_LPS)


def test_egress_hevc_intra_mode(lavc_decoder):
    """tests/test_hevc_intra.py:137: encoder="hevc_intra" streams a
    decodable stream, the odd height edge-padded even."""
    player = _Player()
    eg = _egress(player, "hevc_intra", hevc_qp=28)
    frame = np.random.default_rng(1).integers(0, 255, (63, 96, 3)
                                               ).astype(np.uint8)
    try:
        for t in range(2):
            eg.send_frame(np.roll(frame, t, axis=1))
    finally:
        eg.close()
        assert player.wait(lambda: player.sessions)
        player.stop()
    data = bytes(player.sessions[0])
    assert struct.unpack("<i", data[:4])[0] == 64
    out = _decode(data[4:])
    assert len(out) == 2 and out[0][1] == 96 and out[0][2] == 64


def test_intra_native_twin_byte_identical():
    """tests/test_hevc_intra.py:187."""
    assert hevc_intra.load_native() is not None, "libhevcintra did not build"
    rng = np.random.default_rng(3)
    for (w, h, qp) in [(64, 32, 30), (72, 36, 22), (48, 48, 45)]:
        py = hevc_intra.IntraHevcEncoder(w, h, qp=qp)
        nat = hevc_intra.NativeIntraHevcEncoder(w, h, qp=qp)
        for s in range(2):
            f = rng.integers(0, 255, (w * h * 3 // 2,)
                             ).astype(np.uint8).tobytes()
            assert py.encode(f) == nat.encode(f), (w, h, qp, s)
        nat.close()


def test_intra_create_prefers_native():
    """tests/test_hevc_intra.py:205."""
    enc = hevc_intra.create(64, 32, qp=30)
    assert hevc_intra.load_native() is not None
    assert isinstance(enc, hevc_intra.NativeIntraHevcEncoder)
    enc.close()


# --- the I_PCM encoder (tests/test_hevc_pcm.py) -------------------------------------

def test_pcm_ffmpeg_decodes_luma_bit_exact(cv2_hevc, tmp_path):
    """tests/test_hevc_pcm.py:56: 4 frames at 96x64 through cv2's FFmpeg,
    every Y plane equal to the input."""
    w, h = 96, 64
    enc = hevc_pcm.PcmHevcEncoder(w, h)
    jenc = jax_pcm.PcmHevcEncoder(w, h)
    rng = np.random.default_rng(0)
    frames, stream = [], b""
    for _ in range(4):
        f = (rng.random(w * h * 3 // 2) * 255).astype(np.uint8)
        frames.append(f)
        units = enc.encode(f.tobytes())
        assert units == jenc.encode(f.tobytes())
        stream += units
    planes = _cv2_decode_y(stream, tmp_path, len(frames))
    assert len(planes) == len(frames), "decoder rejected some frames"
    for i, (dec, f) in enumerate(zip(planes, frames)):
        assert np.array_equal(dec[:w * h], f[:w * h]), f"frame {i} luma"


def test_pcm_ffmpeg_decodes_chroma_via_luma_reencode(cv2_hevc, tmp_path):
    """tests/test_hevc_pcm.py:73: each chroma plane encoded as the luma
    of a stream of its own decodes to its exact bytes."""
    w, h = 64, 32
    frame = (np.random.default_rng(1).random(w * h * 3 // 2) * 255
             ).astype(np.uint8)
    u = frame[w * h:w * h + w * h // 4]
    v = frame[w * h + w * h // 4:]
    cw, ch = w // 2, h // 2
    for plane in (u, v):
        gray = np.concatenate([plane, np.full(cw * ch // 2, 128, np.uint8)])
        stream = hevc_pcm.PcmHevcEncoder(cw, ch).encode(gray.tobytes())
        dec = _cv2_decode_y(stream, tmp_path, 1)
        assert dec and np.array_equal(dec[0][:cw * ch], plane)


def test_pcm_non_ctb_aligned_dims_decode(cv2_hevc, tmp_path):
    """tests/test_hevc_pcm.py:94: 50x34 through the conformance window."""
    w, h = 50, 34
    f = (np.random.default_rng(2).random(w * h * 3 // 2) * 255
         ).astype(np.uint8)
    stream = hevc_pcm.PcmHevcEncoder(w, h).encode(f.tobytes())
    planes = _cv2_decode_y(stream, tmp_path, 1)
    assert planes, "decoder rejected the cropped stream"
    assert planes[0].size == w * h, "conformance window not honored"
    assert np.array_equal(planes[0], f[:w * h])


def test_pcm_stream_structure():
    """tests/test_hevc_pcm.py:108: VPS, SPS, PPS once, then an IDR per
    frame."""
    enc = hevc_pcm.PcmHevcEncoder(64, 32)
    f = np.full(64 * 32 * 3 // 2, 77, np.uint8).tobytes()
    first, second = enc.encode(f), enc.encode(f)

    def nal_types(stream):
        types, i = [], 0
        while True:
            j = stream.find(b"\x00\x00\x01", i)
            if j < 0:
                return types
            types.append((stream[j + 3] >> 1) & 0x3F)
            i = j + 3
    assert nal_types(first)[:4] == [32, 33, 34, 19]
    assert nal_types(second) == [19]


def test_pcm_native_twin_byte_identical():
    """tests/test_hevc_pcm.py:127: with the emulation-prevention stress
    frames (all zeros, dense zero pairs)."""
    lib = hevc_pcm.load_native()
    assert lib is not None, "libhevcpcm did not build"
    rng = np.random.default_rng(3)
    for (w, h) in [(64, 32), (50, 34), (160, 90)]:
        py = hevc_pcm.PcmHevcEncoder(w, h)
        nat = hevc_pcm.NativePcmHevcEncoder(w, h, lib)
        for fi in range(4):
            f = (rng.random(w * h * 3 // 2) * 255).astype(np.uint8)
            if fi == 2:
                f[:] = 0
            if fi == 3:
                f[::3] = 0
            assert py.encode(f.tobytes()) == nat.encode(f.tobytes()), \
                (w, h, fi)
        nat.close()


def test_egress_hevc_falls_back_to_builtin(cv2_hevc, tmp_path,
                                           monkeypatch):
    """tests/test_hevc_pcm.py:149: with no x265 and no kvazaar or ffmpeg,
    encoder="hevc" streams the built-in I_PCM, VPS first, and both frames
    decode bit-exact."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(hevc_lavc, "create_encoder", lambda *a, **k: None)
    player = _Player()
    eg = _egress(player, "hevc")
    h, w = 32, 64
    frame = (np.random.default_rng(4).random((h, w, 3)) * 255
             ).astype(np.uint8)
    try:
        eg.send_frame(frame)
        eg.send_frame(frame)
        assert eg.selected_encoder == "pcm"
    finally:
        eg.close()
        assert player.wait(lambda: player.sessions)
        player.stop()
    received = bytes(player.sessions[0])
    assert struct.unpack("<i", received[:4])[0] == h
    stream = received[4:]
    assert stream.startswith(b"\x00\x00\x00\x01")
    assert (stream[4] >> 1) & 0x3F == 32, "stream must open with VPS"
    planes = _cv2_decode_y(stream, tmp_path, 2)
    assert len(planes) == 2
    for dec in planes:
        assert np.array_equal(dec[:w * h], _i420(frame).ravel()[:w * h])


# --- x265 in process (tests/test_hevc_lavc.py) ------------------------------------------

def _lavc_frames(w, h, n=5):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = ((xx + 3 * t) % 256).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + t, np.uint8)
        v = ((yy[::2, ::2] + 2 * t) % 256).astype(np.uint8)
        out.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()])
                   .tobytes())
    return out


def test_x265_roundtrip_quality_and_compression(x265):
    """tests/test_hevc_lavc.py:48: >= 35 dB per frame under a tenth of the
    raw bytes; the JAX package's decoder reads the port's stream to the
    same pictures."""
    w, h = 320, 192
    frames = _lavc_frames(w, h)
    enc = hevc_lavc.X265Encoder(w, h, crf=23)
    stream = b"".join(enc.encode(f) for f in frames) + enc.finish()
    enc.close()
    out = _decode(stream)
    assert len(out) == len(frames)
    for (got, ow, oh), ref in zip(out, frames):
        assert (ow, oh) == (w, h)
        a = np.frombuffer(got, np.uint8).astype(np.float32)
        b = np.frombuffer(ref, np.uint8).astype(np.float32)
        assert 10 * np.log10(255.0 ** 2 / max(((a - b) ** 2).mean(),
                                              1e-9)) >= 35.0
    assert len(stream) < 0.10 * sum(len(f) for f in frames)
    jdec = jax_lavc.LavcHevcDecoder()
    try:
        assert jdec.decode(stream) + jdec.flush() == out
    finally:
        jdec.close()


def test_x265_cross_validated_by_cv2_ffmpeg(x265, cv2_hevc, tmp_path):
    """tests/test_hevc_lavc.py:66: cv2's own FFmpeg decodes the port's
    stream to the same luma as the in-process decoder."""
    w, h = 320, 192
    frames = _lavc_frames(w, h, n=3)
    enc = hevc_lavc.X265Encoder(w, h, crf=20)
    stream = b"".join(enc.encode(f) for f in frames) + enc.finish()
    enc.close()
    ours = _decode(stream)
    planes = _cv2_decode_y(stream, tmp_path, len(frames))
    assert len(planes) >= 2, "cv2 decoded too few frames"
    for i, y in enumerate(planes):
        assert np.array_equal(y[:w * h], np.frombuffer(
            ours[i][0], np.uint8)[:w * h]), f"decoder disagreement {i}"


def test_egress_selects_x265_and_streams(x265):
    """tests/test_hevc_lavc.py:96: encoder="hevc" takes x265 and streams
    decodable compressed HEVC after the height prelude."""
    import cv2
    player = _Player()
    eg = _egress(player, "hevc")
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3)
                                              ).astype(np.uint8)
    base = cv2.GaussianBlur(base, (0, 0), 3)
    try:
        for t in range(4):
            eg.send_frame(np.roll(base, 4 * t, axis=1))
        assert isinstance(eg._enc, hevc_lavc.X265Encoder), type(eg._enc)
    finally:
        eg.close()
        assert player.wait(lambda: player.sessions)
        player.stop()
    data = bytes(player.sessions[0])
    assert struct.unpack("<i", data[:4])[0] == 96
    out = _decode(data[4:])
    assert len(out) >= 3 and out[0][1] == 128 and out[0][2] == 96


def test_x265_reopen_after_reconnect_starts_clean(x265):
    """tests/test_hevc_lavc.py:152: a fresh encoder starts VPS first."""
    w, h = 128, 96
    enc = hevc_lavc.X265Encoder(w, h)
    first = enc.encode(_lavc_frames(w, h, n=1)[0])
    enc.close()
    assert first[:4] == b"\x00\x00\x00\x01"
    assert (first[4] >> 1) & 0x3F == 32


# --- the egress's HEVC layers (tests/test_egress.py) ---------------------------------

def test_hevc_encoder_stream_structure():
    """tests/test_egress.py:163: the kvazaar / ffmpeg subprocess opens its
    stream with a VPS."""
    if shutil.which("kvazaar") is None and shutil.which("ffmpeg") is None:
        pytest.skip("no HEVC encoder (kvazaar/ffmpeg) in this env")
    w, h = 64, 32
    enc = HevcEncoder(w, h)
    frame = (np.random.default_rng(0).random((h * 3 // 2, w)) * 255
             ).astype(np.uint8).tobytes()
    out = b"".join(enc.encode(frame) for _ in range(5)) + enc.finish()
    enc.close()
    assert out.startswith(b"\x00\x00\x00\x01") or \
        out.startswith(b"\x00\x00\x01")
    sc = 4 if out.startswith(b"\x00\x00\x00\x01") else 3
    assert (out[sc] >> 1) & 0x3F == 32, "stream does not start with VPS"


#: tests/test_egress.py's protocol-faithful stand-in for kvazaar:
#: parameter sets on open, then per input frame one frame NAL (its index
#: and the CRC of the exact I420 bytes) and an AUD
_FAKE_KVAZAAR = r'''#!/usr/bin/env -S python3 -S
import sys, zlib
args = sys.argv[1:]
w, h = map(int, args[args.index("--input-res") + 1].split("x"))
fb = w * h * 3 // 2
out = sys.stdout.buffer
out.write(b"\x00\x00\x00\x01" + bytes([32 << 1, 1]) + b"\x11\x22\x33")
out.write(b"\x00\x00\x01" + bytes([33 << 1, 1]) + b"\x44\x55")
out.write(b"\x00\x00\x01" + bytes([34 << 1, 1]) + b"\x66")
out.flush()
idx = 0
while True:
    data = sys.stdin.buffer.read(fb)
    if len(data) < fb:
        break
    payload = ("%04d%08x" % (idx, zlib.crc32(data))).encode()
    out.write(b"\x00\x00\x01" + bytes([1 << 1, 1]) + payload)
    out.write(b"\x00\x00\x01" + bytes([35 << 1, 1]) + b"\x50")
    out.flush()
    idx += 1
'''


def _session_nals(session: bytes):
    h = struct.unpack("<i", bytes(session[:4]))[0]
    framer = AnnexBFramer()
    units = framer.push(bytes(session[4:]))
    tail = framer.flush()
    return h, units + ([tail] if tail else [])


def _nal_type(unit: bytes) -> int:
    sc = 4 if unit.startswith(b"\x00\x00\x00\x01") else 3
    return (unit[sc] >> 1) & 0x3F


def _frame_nals(session):
    if len(session) < 4:                   # the height prelude is not in
        return []
    return [u for u in _session_nals(session)[1] if _nal_type(u) == 1]


def test_hevc_pipeline_integrity_and_reconnect(tmp_path, monkeypatch):
    """tests/test_egress.py:251: the subprocess layer with the stand-in
    encoder: every frame's CRC survives encoder -> reader thread -> framer
    -> TCP, the stream opens VPS/SPS/PPS, and after the player drops the
    link the new session restarts with fresh parameter sets and frame
    numbering from 0."""
    monkeypatch.setattr(hevc_lavc, "create_encoder", lambda *a, **k: None)
    exe = tmp_path / "kvazaar"
    exe.write_text(_FAKE_KVAZAAR)
    os.chmod(exe, 0o755)
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: str(exe)
                        if name == "kvazaar" else which(name))
    player = _Player()
    eg = _egress(player, "hevc")
    rng = np.random.default_rng(1)
    h, w = 32, 64
    frames = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
              for _ in range(6)]
    crcs = [zlib.crc32(_i420(f).tobytes()) for f in frames]

    def feed_until(pred, pick):
        # the subprocess's output reaches the socket on a later
        # send_frame (its reader thread), so keep feeding
        deadline = time.monotonic() + WAIT_S
        i = 0
        while not pred():
            assert time.monotonic() < deadline, "egress stalled"
            eg.send_frame(pick(i))
            i += 1
            time.sleep(0.02)

    try:
        for f in frames[:3]:
            eg.send_frame(f)
        assert eg.selected_encoder == "kvazaar"
        feed_until(lambda: player.sessions and len(
            _frame_nals(player.sessions[0])) >= 3, lambda i: frames[2])
        hh, units = _session_nals(player.sessions[0])
        assert hh == h
        assert [_nal_type(u) for u in units[:3]] == [32, 33, 34]
        for k, u in enumerate(_frame_nals(player.sessions[0])[:3]):
            sc = 4 if u.startswith(b"\x00\x00\x00\x01") else 3
            payload = u[sc + 2:].decode()
            assert int(payload[:4]) == k, "frame order corrupted"
            assert int(payload[4:], 16) == crcs[k], f"frame {k} corrupted"
        player.kill_after = 0
        feed_until(lambda: len(player.sessions) >= 2 and _frame_nals(
            player.sessions[-1]), lambda i: frames[3 + i % 3])
        hh2, units2 = _session_nals(player.sessions[-1])
        assert hh2 == h
        assert [_nal_type(u) for u in units2[:3]] == [32, 33, 34], \
            "the reconnected stream must restart with VPS/SPS/PPS"
        f0 = _frame_nals(player.sessions[-1])[0]
        sc = 4 if f0.startswith(b"\x00\x00\x00\x01") else 3
        assert int(f0[sc + 2:sc + 6]) == 0
    finally:
        eg.close()
        player.stop()


def test_hevc_real_roundtrip_psnr(tmp_path):
    """tests/test_egress.py:327: the "hevc" mode's encoder (the subprocess
    where kvazaar or ffmpeg exists, else the built-in I_PCM, whose stream
    equals the JAX encoder's) decoded by cv2's FFmpeg at >= 30 dB."""
    import cv2
    h, w = 64, 96
    rng = np.random.default_rng(2)
    base = (rng.random((h, w, 3)) * 127).astype(np.uint8)
    frames = [np.roll(base, 2 * i, axis=1) for i in range(8)]
    subprocess_layer = bool(shutil.which("kvazaar") or shutil.which("ffmpeg"))
    enc = HevcEncoder(w, h) if subprocess_layer else hevc_pcm.create(w, h)
    jenc = None if subprocess_layer else jax_pcm.create(w, h)
    out = b""
    for f in frames:
        units = enc.encode(_i420(f).tobytes())
        if jenc is not None:
            assert units == jenc.encode(_i420(f).tobytes())
        out += units
    out += enc.finish()
    enc.close()
    path = tmp_path / "stream.h265"
    path.write_bytes(out)
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    ok, dec = cap.read()
    cap.release()
    assert ok, "cv2 could not decode the emitted stream"
    y_ref = _i420(frames[0]).reshape(-1)[:w * h]
    y_dec = np.asarray(dec).reshape(-1)[:w * h]
    err = np.mean((y_dec.astype(np.float64) - y_ref) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(err, 1e-9)) >= 30
