"""Capture-board TCP ingest (NV12 frame streams).

Replaces 360_stitcher/networking.cpp + netlib.c: a TCP server accepts one
client per capture board, orders streams by the last octet of the client IP
minus client_addr_start (debug mode: accept order), reassembles fixed-size
NV12 frames from the byte stream, converts to RGB, and feeds per-camera
queues.

Two backends:
  * native  — libstitchio.so (C++ accept/recv threads + frame queues)
  * python  — threaded stdlib sockets (same wire protocol)
NV12->RGB conversion happens on device (ops/color.py) when frames flow into
the stitcher; host conversion is available for previews.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional

import numpy as np

from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.io_plane.queues import FrameQueue
from video_stitcher_tpu_torch.io_plane import native as native_mod

#: framed wire protocol (opt-in, cfg.capture_framing): each frame is
#: preceded by a 12-byte header  magic u32 | seq u32 | payload_len u32
#: (little-endian). The raw protocol (the reference's,
#: networking.cpp:15-65) cannot resynchronize — one lost byte shears
#: every subsequent frame of that camera forever; the magic scan below
#: recovers within one frame and counts what was lost.
FRAME_MAGIC = 0x53465231          # "1RFS" on the wire (LE)
_MAGIC_BYTES = struct.pack("<I", FRAME_MAGIC)
HEADER_FMT = "<III"
HEADER_BYTES = struct.calcsize(HEADER_FMT)


def pack_frame(payload: bytes, seq: int) -> bytes:
    """Sender-side framing helper (capture boards / tests)."""
    return struct.pack(HEADER_FMT, FRAME_MAGIC, seq & 0xFFFFFFFF,
                       len(payload)) + payload


class CaptureIngest:
    """start() then get_frames() -> u8 [N, H*3/2, W] NV12 stacks."""

    def __init__(self, cfg: StitcherConfig, debug_order: bool = None,
                 backend: str = "auto", max_queue: int = 4):
        self.cfg = cfg
        self.w = cfg.capture_img_width
        self.h_nv12 = cfg.capture_img_height          # = 3/2 * image height
        self.frame_bytes = self.w * self.h_nv12
        self.n = cfg.num_images
        #: slot assignment: accept order (tests/local rigs, every board
        #: connects from 127.0.0.1) vs the reference's IP-octet scheme
        #: (last octet - CLIENT_ADDR_START, networking.cpp:17 /
        #: defs.h:31) for production rigs with fixed camera addresses.
        #: Configurable (cfg.capture_debug_order) — it was a ctor-only
        #: flag no production caller could reach.
        self.debug_order = (cfg.capture_debug_order
                            if debug_order is None else debug_order)
        self.max_queue = max_queue
        #: frames already popped for some cameras while another timed
        #: out — retained so a transient per-camera stall skews pairing
        #: by at most one frame instead of permanently offsetting the
        #: recovered cameras
        self._pending: List[Optional[np.ndarray]] = [None] * self.n
        #: debug_order slot assignment: fresh slots in accept order
        #: first (deterministic for sequential local connects), then a
        #: dropped board's reconnect takes the lowest freed slot (an
        #: ever-incrementing counter rejected rejoins forever)
        self._next_slot = 0
        self._free_slots: List[int] = []
        self._slot_mu = threading.Lock()
        self._conns: List[socket.socket] = []
        self.framing = bool(getattr(cfg, "capture_framing", False))
        #: per-camera counters: frames_ok, resyncs, bytes_skipped, seq_gaps,
        #: drops (frames lost to the bounded queue's drop-oldest policy)
        self._stats = [dict(frames_ok=0, resyncs=0, bytes_skipped=0,
                            seq_gaps=0) for _ in range(self.n)]
        self._native = None
        self._threads: List[threading.Thread] = []
        self._queues = [FrameQueue(max_queue) for _ in range(self.n)]
        self._server: Optional[socket.socket] = None
        self._running = False
        #: the port the server listens on, read back after start():
        #: cfg.capture_tcp_port, or the one the system chose for port 0
        self.port: Optional[int] = None
        if backend == "auto":
            self._lib = native_mod.load()
        elif backend == "native":
            self._lib = native_mod.load()
            if self._lib is None:
                raise RuntimeError("native backend unavailable")
        else:
            self._lib = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._lib is not None:
            rc = self._lib.stitchio_start_server(
                self.cfg.capture_tcp_port, self.n, self.frame_bytes,
                self.cfg.client_addr_start, 1 if self.debug_order else 0,
                self.max_queue, 1 if self.framing else 0)
            if rc != 0:
                raise RuntimeError(f"stitchio_start_server failed: {rc}")
            self._native = self._lib
            self.port = self._lib.stitchio_port()
            return
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("", self.cfg.capture_tcp_port))
        self._server.listen(self.n)
        self.port = self._server.getsockname()[1]
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        if self._native is not None:
            # snapshot counters into the Python-side store first: the C++
            # server's stats die with it, but end-of-run summaries (and
            # tests) read them after release()
            for cam, s in enumerate(self.stats()):
                self._stats[cam].update(s)
            self._native.stitchio_stop_server()
            self._native = None
            return
        self._running = False
        if self._server:
            # shutdown first: close() alone does not wake the accept
            # thread blocked in accept(), which then outlives the server
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        # close accepted per-camera connections too: recv threads would
        # otherwise stay blocked in conn.recv() on live sockets, leaking
        # fds and draining board streams into closed queues forever
        with self._slot_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                # shutdown first: close() alone doesn't send FIN (or wake
                # the recv thread) while another thread is blocked in
                # recv() on the same socket
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for q in self._queues:
            q.close()

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._server.accept()
            except OSError:
                break
            if self.debug_order:
                with self._slot_mu:
                    if self._next_slot < self.n:
                        slot = self._next_slot
                        self._next_slot += 1
                    elif self._free_slots:
                        self._free_slots.sort()
                        slot = self._free_slots.pop(0)
                    else:
                        slot = -1
            else:
                slot = int(addr[0].rsplit(".", 1)[-1]) - self.cfg.client_addr_start
            if not (0 <= slot < self.n):
                conn.close()
                continue
            with self._slot_mu:
                self._conns.append(conn)
            t = threading.Thread(target=self._recv_loop, args=(conn, slot),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _release_slot(self, conn: socket.socket, slot: int) -> None:
        """Recv-loop exit: free the connection record and (debug-order
        mode) return the slot so a reconnecting board can rejoin."""
        with self._slot_mu:
            if conn in self._conns:
                self._conns.remove(conn)
            if self.debug_order and slot not in self._free_slots:
                self._free_slots.append(slot)

    def _recv_loop(self, conn: socket.socket, slot: int) -> None:
        """Frame reassembly incl. the reference's 3-retry policy
        (networking.cpp:26-37). Framed mode adds magic-scan resync."""
        if self.framing:
            self._recv_loop_framed(conn, slot)
            return
        buf = bytearray(self.frame_bytes)
        index = 0
        errors = 0
        st = self._stats[slot]
        while self._running:
            try:
                chunk = conn.recv(65536)
            except OSError:
                errors += 1
                if errors > 3:
                    break
                continue
            if not chunk:
                break
            errors = 0
            off = 0
            while off < len(chunk):
                take = min(self.frame_bytes - index, len(chunk) - off)
                buf[index:index + take] = chunk[off:off + take]
                index += take
                off += take
                if index == self.frame_bytes:
                    frame = np.frombuffer(bytes(buf), np.uint8).reshape(
                        self.h_nv12, self.w)
                    self._queues[slot].push(frame)
                    st["frames_ok"] += 1
                    index = 0
        conn.close()
        self._release_slot(conn, slot)

    def _recv_loop_framed(self, conn: socket.socket, slot: int) -> None:
        """Framed reassembly: validate header at the stream head; on any
        mismatch scan forward for the magic, dropping (and counting) the
        bytes in between — a corrupted/truncated frame costs at most
        itself, not the rest of the stream."""
        st = self._stats[slot]
        pending = bytearray()
        expect_seq = None
        errors = 0
        in_desync = False
        fb = self.frame_bytes
        while self._running:
            try:
                chunk = conn.recv(65536)
            except OSError:
                errors += 1
                if errors > 3:
                    break
                continue
            if not chunk:
                break
            errors = 0
            pending += chunk
            while True:
                if len(pending) < HEADER_BYTES:
                    break
                magic, seq, ln = struct.unpack_from(HEADER_FMT, pending, 0)
                if magic != FRAME_MAGIC or ln != fb:
                    # desync: scan for the next magic (resync counted once
                    # per desync event, not per scanned chunk)
                    i = pending.find(_MAGIC_BYTES, 1)
                    if not in_desync:
                        st["resyncs"] += 1
                        in_desync = True
                    if i < 0:
                        # keep a possible partial magic at the tail
                        keep = min(len(_MAGIC_BYTES) - 1, len(pending))
                        st["bytes_skipped"] += len(pending) - keep
                        del pending[:len(pending) - keep]
                        break
                    st["bytes_skipped"] += i
                    del pending[:i]
                    # in_desync stays set until a VALIDATED header is
                    # consumed below: a candidate magic inside payload
                    # bytes that fails the ln check must not count as a
                    # second desync event
                    continue
                if len(pending) < HEADER_BYTES + fb:
                    break
                in_desync = False
                payload = bytes(pending[HEADER_BYTES:HEADER_BYTES + fb])
                del pending[:HEADER_BYTES + fb]
                if expect_seq is not None and seq != expect_seq:
                    # forward u32 diff = frames lost; a backward jump
                    # (sender reset/rollover without reconnect) would wrap
                    # to ~4.29e9 — count it as one reset event instead
                    diff = (seq - expect_seq) & 0xFFFFFFFF
                    st["seq_gaps"] += diff if diff < 0x80000000 else 1
                expect_seq = (seq + 1) & 0xFFFFFFFF
                self._queues[slot].push(
                    np.frombuffer(payload, np.uint8).reshape(
                        self.h_nv12, self.w))
                st["frames_ok"] += 1
        conn.close()
        self._release_slot(conn, slot)

    # ------------------------------------------------------------------
    def stats(self):
        """Per-camera counters [{frames_ok, resyncs, bytes_skipped,
        seq_gaps, drops}] (native backend: fetched from the C++ server)."""
        if self._native is not None:
            import ctypes
            out = []
            for cam in range(self.n):
                vals = (ctypes.c_long * 5)()
                if self._native.stitchio_stats(cam, vals) == 0:
                    out.append(dict(frames_ok=vals[0], resyncs=vals[1],
                                    bytes_skipped=vals[2], seq_gaps=vals[3],
                                    drops=vals[4]))
                else:
                    out.append(dict(self._stats[cam], drops=0))
            return out
        # python backend: drops live on the queues; post-stop native
        # backend: drops were snapshotted into _stats by stop()
        return [dict(s, drops=s.get("drops", 0) + self._queues[i].dropped)
                for i, s in enumerate(self._stats)]

    def stats_summary(self) -> str:
        s = self.stats()
        bad = sum(x["resyncs"] + x["seq_gaps"] + x["drops"] for x in s)
        if bad == 0:
            return "ingest ok"
        return "ingest " + " ".join(
            f"cam{i}:ok={x['frames_ok']},rs={x['resyncs']},"
            f"skip={x['bytes_skipped']}B,gap={x['seq_gaps']},"
            f"drop={x['drops']}"
            for i, x in enumerate(s)
            if x["resyncs"] or x["seq_gaps"] or x["drops"])

    # ------------------------------------------------------------------
    def pop_frame(self, cam: int, timeout: Optional[float] = None
                  ) -> Optional[np.ndarray]:
        if self._native is not None:
            import ctypes
            out = np.empty((self.h_nv12, self.w), np.uint8)
            ms = -1 if timeout is None else int(timeout * 1000)
            rc = self._native.stitchio_pop_frame(
                cam, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ms)
            return out if rc == 0 else None
        return self._queues[cam].pop(timeout)

    def get_frames(self, timeout: Optional[float] = None
                   ) -> Optional[np.ndarray]:
        """Pop one NV12 frame per camera -> u8 [N, H*3/2, W] (or None).

        Frames already popped before another camera timed out are
        RETAINED (self._pending) and completed by the next call — the
        old discard left the early cameras' streams permanently one
        frame ahead of the stalled one (persistent temporal skew in the
        pano). A retained frame can be up to one stall old, but the
        bounded drop-oldest camera queues keep the streams themselves
        fresh, so pairing re-aligns within a frame of recovery."""
        pend = self._pending
        for cam in range(self.n):
            if pend[cam] is None:
                f = self.pop_frame(cam, timeout)
                if f is None:
                    return None
                pend[cam] = f
        out = np.stack(pend)
        self._pending = [None] * self.n
        return out
