"""The JAX package's all-features soak (tests/test_soak.py) and what its
recalibration-concurrency test (tests/test_runner_concurrency.py:23)
checks beyond tests/test_torch_runner.py, run on the port's Runner with
a CPU Stitcher at 6x320x180.

The soak has every subsystem live at once: framed TCP NV12 ingest from
six loopback boards, the live CPW re-solve with its interpolation
animation and update_masks, and HEVC egress to a loopback player. On the
CPU it asserts what does not depend on the machine's speed: a
re-solve that was triggered lands (the run waits for it on an event set
by the wrapped solve, not on the clock), the egress stream opens with
its height prelude and parses, and every Runner, board and player
thread ends. Its frame count, stall counts and rate are checked on the
card by chip_smoke.py's phase "live"."""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.io_plane import hevc_lavc
from video_stitcher_tpu_torch.io_plane.egress import AnnexBFramer, PlayerEgress
from video_stitcher_tpu_torch.io_plane.ingest import pack_frame
from video_stitcher_tpu_torch.io_plane.video import SyntheticRigSource
from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
from video_stitcher_tpu_torch.pipeline.runner import Runner
from video_stitcher_tpu_torch.utils.synth import make_scene, render_views

WAIT_S = 30.0          # every wait on another thread, socket or server
SOLVE_WAIT_S = 120.0   # a re-solve on a loaded one-core host


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


def _clients(ing) -> int:
    if ing._native is not None:
        return ing._native.stitchio_clients()
    return len(ing._conns)


def _room(ing) -> bool:
    """Every camera's queue holds at most one unread frame."""
    if ing._native is None:
        return max(len(q) for q in ing._queues) <= 1
    return max(ing._native.stitchio_queue_size(c) for c in range(ing.n)) <= 1


def _gate_after(st, monkeypatch, n: int, event: threading.Event):
    """Hold the Runner's stitch step from its n-th frame on until `event`
    is set (bounded): the frames cannot outrun a re-solve."""
    inner = st.stitch_out
    calls = []

    def gated(frames, device=False):
        calls.append(1)
        if len(calls) > n:
            event.wait(timeout=SOLVE_WAIT_S)
        return inner(frames, device)
    monkeypatch.setattr(st, "stitch_out", gated)


def _counting_solves(st, monkeypatch, landed: threading.Event, box):
    """Set `landed` once a re-solve of the running Runner (box[0]) has
    installed; calibrate's own first solve, before any frame, is not
    one."""
    inner = st.recalibrate_mesh
    installs = []

    def counted(frames):
        live = box and box[0].frames_done >= 1
        ok = inner(frames)
        if ok and live:
            installs.append(1)
            landed.set()
        return ok
    monkeypatch.setattr(st, "recalibrate_mesh", counted)
    return installs


def test_all_features_soak(tmp_path, monkeypatch):
    """tests/test_soak.py:42 on the port."""
    monkeypatch.chdir(tmp_path)
    n_cams, w, h = 6, 320, 180
    player_srv = socket.socket()
    player_srv.bind(("127.0.0.1", 0))
    player_srv.listen(1)
    player_srv.settimeout(0.2)
    drained = bytearray()
    stop_player = threading.Event()

    def player():
        while not stop_player.is_set():
            try:
                conn, _ = player_srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(0.2)
            with conn:
                while not stop_player.is_set():
                    try:
                        data = conn.recv(1 << 20)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                    drained.extend(data)

    cfg = StitcherConfig(
        num_images=n_cams, input_width=w, input_height=h,
        enable_local=True, recalibrate=True, recalib_del_ms=1500,
        recalib_interp=True, update_masks=True,
        use_stream=True, capture_framing=True, capture_tcp_port=0,
        capture_img_width=w, capture_img_height=h * 3 // 2,
        output_width=320, output_height=160, keep_aspect_ratio=True,
        player_address="127.0.0.1",
        player_tcp_port=player_srv.getsockname()[1],
        save_video=False, show_out=False)
    geom, _ = plan_geometry(cfg)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h,
                       np.random.default_rng(3))
    nv12 = rgb_to_nv12(torch.from_numpy(render_views(cfg, geom, scene))
                       ).numpy()

    st = Stitcher(cfg, device="cpu")
    landed, box = threading.Event(), []
    installs = _counting_solves(st, monkeypatch, landed, box)
    _gate_after(st, monkeypatch, 10, landed)
    egress = PlayerEgress(cfg, encoder="hevc")
    r = Runner(cfg, stitcher=st, egress=egress, max_frames=20)
    box.append(r)
    done = threading.Event()
    errors, socks = [], []

    def boards():
        # each board streams its camera's view, one frame set once the
        # server holds at most one unread frame of each camera (no flood
        # of the host while the gate holds the Runner)
        try:
            ing = r._ingest
            for cam in range(n_cams):
                socks.append(socket.create_connection(
                    ("127.0.0.1", ing.port), timeout=WAIT_S))
                assert _wait(lambda: done.is_set() or _clients(ing) > cam)
            seq = 0
            while not done.is_set():
                if not _room(ing):
                    done.wait(0.01)
                    continue
                for cam, s in enumerate(socks):
                    s.sendall(pack_frame(nv12[cam].tobytes(), seq))
                seq += 1
        except OSError:
            # the Runner sets _stop before it closes its capture server
            if not (done.is_set() or r._stop.is_set()):
                errors.append("board socket failed while the Runner ran")
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))

    player_t = threading.Thread(target=player, name="player")
    runner_t = threading.Thread(target=r.run, name="runner")
    board_t = threading.Thread(target=boards, name="boards")
    player_t.start()
    runner_t.start()
    try:
        assert r.source_ready.wait(WAIT_S), "capture server never came up"
        board_t.start()
        _join(runner_t, timeout=SOLVE_WAIT_S + 120)
    finally:
        done.set()
        landed.set()                 # release the gate on a failure
        if board_t.ident is not None:
            _join(board_t)
        for s in socks:
            s.close()
        stop_player.set()
        _join(player_t)
        player_srv.close()
    _join(*r.threads, timeout=SOLVE_WAIT_S)
    assert not errors, errors
    assert installs and r.recalibs_done >= 1, "no re-solve landed"
    data = bytes(drained)
    assert len(data) > 4, "egress produced nothing"
    hh = struct.unpack("<i", data[:4])[0]
    oh = st._out_size(st.geom)[0]
    assert hh == oh + (oh & 1)          # the egress pads an odd height
    framer = AnnexBFramer()
    units = framer.push(data[4:]) + [framer.flush()]
    assert units and [(u[u.index(b"\x01") + 1] >> 1) & 0x3F
                      for u in units[:3]] == [32, 33, 34], \
        "the stream must open with VPS/SPS/PPS"
    if hevc_lavc.load_native() is not None:
        dec = hevc_lavc.LavcHevcDecoder()
        try:
            pictures = dec.decode(data[4:]) + dec.flush()
        finally:
            dec.close()
        assert 1 <= len(pictures) <= r.frames_done
        assert all((pw, ph) == (cfg.output_width, hh)
                   for _, pw, ph in pictures)


@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_live_resolve_writes_debug_images(tmp_path, monkeypatch, mode):
    """tests/test_runner_concurrency.py:23 beyond what
    tests/test_torch_runner.py::test_live_recalibration_installs_and_animates
    holds: with the visualisation toggles on, a re-solve of the running
    Runner writes its match and mesh images (sequence 001 on, after
    calibrate's 000), and the consumer writes result.jpg. The source ends
    once a mesh has installed and two animation states were published."""
    monkeypatch.chdir(tmp_path)
    cfg = StitcherConfig(num_images=6, input_width=320, input_height=180,
                         recalibrate=True, enable_local=True,
                         recalib_interp=True, recalib_del_ms=100,
                         visualize_matches=True, visualize_mesh=True,
                         pipeline_mode=mode, viz_dir=str(tmp_path / "viz"))
    src = SyntheticRigSource(cfg, plan_geometry(cfg)[0], drift_px=7.0)
    sets = [src.get_frames() for _ in range(3)]
    st = Stitcher(cfg, device="cpu")
    landed, box = threading.Event(), []
    installs = _counting_solves(st, monkeypatch, landed, box)
    swaps = []
    swap = st.swap_state

    def counting_swap(state):
        swaps.append(1)
        return swap(state)
    monkeypatch.setattr(st, "swap_state", counting_swap)

    class Source:
        """Frame sets until a mesh installed and two states were
        published; the fourth read waits for the re-solve."""
        n = 0

        def get_frames(self):
            self.n += 1
            if self.n == 4:
                landed.wait(timeout=SOLVE_WAIT_S)
            if landed.is_set() and len(swaps) >= 2 or self.n > 600:
                return None
            return sets[self.n % 3]

        def release(self):
            pass

    r = Runner(cfg, stitcher=st, source=Source(), max_frames=600)
    box.append(r)
    r.run()
    _join(*r.threads, timeout=SOLVE_WAIT_S)
    assert installs and r.recalibs_done >= 1
    assert len(swaps) >= 2
    assert 1 <= r.frames_done < 600
    assert (tmp_path / "result.jpg").exists()
    dumped = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert any(f.startswith("matches_001_") for f in dumped), dumped
    assert any(f.startswith("mesh_001_") for f in dumped), dumped
