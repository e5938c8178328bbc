"""In-process compressed HEVC via the system libavcodec (x265 backend).

The reference's consumer runs kvazaar in-process and streams compressed
HEVC to the player (360_stitcher/timed.cpp:198-229,320-350). This is the
real-compression equivalent: native/hevc_lavc.cpp links the system
libavcodec (when its build carries libx265) and exposes a tiny
C ABI; this module wraps it with the same duck type as the other egress
encoders (encode/take/finish/close), plus a matching decoder for
validation loops and player-side tooling.

Selection order in PlayerEgress "hevc" mode (io_plane/egress.py):
x265-in-process (this) -> kvazaar/ffmpeg subprocess -> built-in I_PCM
(io_plane/hevc_pcm.py, lossless mux). Each layer degrades cleanly when
its dependency is missing; this one needs only the distro libavcodec.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hevclavc_create.argtypes = [ctypes.c_int] * 6
    lib.hevclavc_create.restype = ctypes.c_void_p
    lib.hevclavc_encode.argtypes = [ctypes.c_void_p, u8p, u8p,
                                    ctypes.c_long]
    lib.hevclavc_encode.restype = ctypes.c_long
    lib.hevclavc_flush.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
    lib.hevclavc_flush.restype = ctypes.c_long
    lib.hevclavc_destroy.argtypes = [ctypes.c_void_p]
    lib.hevclavc_destroy.restype = None
    lib.hevclavc_dec_create.argtypes = []
    lib.hevclavc_dec_create.restype = ctypes.c_void_p
    lib.hevclavc_dec_feed.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
    lib.hevclavc_dec_feed.restype = ctypes.c_long
    lib.hevclavc_dec_frame.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hevclavc_dec_frame.restype = ctypes.c_long
    lib.hevclavc_dec_flush.argtypes = [ctypes.c_void_p]
    lib.hevclavc_dec_flush.restype = ctypes.c_long
    lib.hevclavc_dec_destroy.argtypes = [ctypes.c_void_p]
    lib.hevclavc_dec_destroy.restype = None


def load_native() -> Optional[ctypes.CDLL]:
    from video_stitcher_tpu_torch.io_plane.native import load_or_build
    return load_or_build("libhevclavc.so", _configure)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class X265Encoder:
    """Real compressed HEVC: all-software x265 at ultrafast/zerolatency
    (the live-egress configuration, mirroring the reference's kvazaar
    settings in timed.cpp:198-229). CRF mode by default; set
    bitrate_kbps for capped-rate streaming."""

    def __init__(self, w: int, h: int, fps: int = 30,
                 bitrate_kbps: int = 0, crf: int = 23, gop: int = 30,
                 lib: Optional[ctypes.CDLL] = None):
        self._lib = lib if lib is not None else load_native()
        if self._lib is None:
            raise RuntimeError("libhevclavc unavailable")
        self._enc = self._lib.hevclavc_create(w, h, fps, bitrate_kbps,
                                              crf, gop)
        if not self._enc:
            raise RuntimeError("x265 encoder unavailable in libavcodec")
        self.w, self.h = w, h
        # worst-case output bound: raw size + headroom (x265 can exceed
        # raw on noise at low QP for one frame; PCM-level cap is safe)
        self._cap = w * h * 3 // 2 + (1 << 16)
        self._out = np.empty(self._cap, np.uint8)

    def encode(self, i420_bytes: bytes) -> bytes:
        if not self._enc:
            raise RuntimeError("encoder closed")   # NULL would segfault
        expect = self.w * self.h * 3 // 2
        if len(i420_bytes) != expect:
            raise ValueError(f"I420 frame is {len(i420_bytes)} B, "
                             f"expected {expect}")
        src = np.frombuffer(i420_bytes, np.uint8)
        n = self._lib.hevclavc_encode(self._enc, _u8(src), _u8(self._out),
                                      self._cap)
        if n < 0:
            raise RuntimeError("x265 encode failed")
        return self._out[:n].tobytes()

    def take(self) -> bytes:           # synchronous (zerolatency): empty
        return b""

    def finish(self, timeout: float = 0.0) -> bytes:
        if not self._enc:
            return b""
        n = self._lib.hevclavc_flush(self._enc, _u8(self._out), self._cap)
        if n < 0:
            # same contract as encode(): a native error (double flush,
            # tail packets overflowing the output cap) must not be
            # silently mapped to "no more data" — the stream would lose
            # its final frames with no log or exception
            raise RuntimeError("x265 flush failed")
        return self._out[:n].tobytes()

    def close(self) -> None:
        if self._enc:
            self._lib.hevclavc_destroy(self._enc)
            self._enc = None


class LavcHevcDecoder:
    """In-process HEVC decoder (validation + player-side tooling)."""

    def __init__(self, max_w: int = 8192, max_h: int = 4320,
                 lib: Optional[ctypes.CDLL] = None):
        self._lib = lib if lib is not None else load_native()
        if self._lib is None:
            raise RuntimeError("libhevclavc unavailable")
        self._dec = self._lib.hevclavc_dec_create()
        if not self._dec:
            raise RuntimeError("hevc decoder unavailable in libavcodec")
        self._cap = max_w * max_h * 3 // 2
        self._out = np.empty(self._cap, np.uint8)

    def decode(self, data: bytes) -> list:
        """Feed Annex-B bytes; returns the list of decoded frames, each
        (i420_bytes, w, h)."""
        frames = []
        buf = np.frombuffer(data, np.uint8)
        off = 0
        while off < len(buf):
            used = self._lib.hevclavc_dec_feed(
                self._dec, _u8(buf[off:]), len(buf) - off)
            if used < 0:
                raise RuntimeError("hevc decode failed (feed)")
            off += used
            got = self._poll()
            frames.extend(got)
            if used == 0 and not got:
                raise RuntimeError("decoder stalled without frames")
        frames.extend(self._poll())
        return frames

    def _poll(self) -> list:
        frames = []
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            n = self._lib.hevclavc_dec_frame(
                self._dec, _u8(self._out), self._cap,
                ctypes.byref(w), ctypes.byref(h))
            if n < 0:
                raise RuntimeError("hevc decode failed (frame)")
            if n == 0:
                return frames
            frames.append((self._out[:n].tobytes(), w.value, h.value))

    def flush(self) -> list:
        """End of stream: drain remaining frames."""
        if self._lib.hevclavc_dec_flush(self._dec) < 0:
            raise RuntimeError("hevc decode failed (flush)")
        return self._poll()

    def close(self) -> None:
        if self._dec:
            self._lib.hevclavc_dec_destroy(self._dec)
            self._dec = None


def create_encoder(w: int, h: int, **kw):
    """x265 in-process encoder, or None when unavailable."""
    try:
        return X265Encoder(w, h, **kw)
    except (RuntimeError, OSError):
        return None
