"""Small behaviours of the port that would regress silently (error
surfacing, recovery paths, resource hygiene): the cases of
tests/test_hardening.py that have a counterpart in the port, on the
port's modules, with the same inputs and bounds.

Left out: ``offset_align`` (in ``tools/``, which the port does not
carry) and the ``commit`` / ``host_eager`` placement case
(``utils/hostdev.py`` is not ported, by design: ROADMAP). Where a native
library is absent here (x265 needs libavcodec's headers), the case
checks that its absence is clean instead of skipping.
"""

import socket
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch.config import StitcherConfig


# --- config validation -------------------------------------------------

def test_config_rejects_short_alphas():
    with pytest.raises(ValueError, match="alphas"):
        StitcherConfig(num_images=2, alphas=(1.0, 0.01))


def test_config_rejects_bad_pipeline_mode():
    with pytest.raises(ValueError, match="pipeline_mode"):
        StitcherConfig(num_images=2, pipeline_mode="threded")


def test_negative_seam_megapix_means_full_res():
    c = StitcherConfig(num_images=2, seam_megapix=-1.0)
    assert c.seam_scale == 1.0


def test_fixed_rig_rejects_yaw_count_mismatch():
    from video_stitcher_tpu_torch.geometry.camera import fixed_rig_cameras
    with pytest.raises(ValueError, match="yaws"):
        fixed_rig_cameras(6, 320, 180, 1.0, yaws=[0.0, 1.0])


# --- timers ------------------------------------------------------------

def test_stage_timers_declared_order_and_zero_stages():
    from video_stitcher_tpu_torch.utils.timing import StageTimers
    t = StageTimers(["a", "b", "c"])
    with t.time("b"):
        pass
    s = t.summary()
    assert s.index("a=") < s.index("b=") < s.index("c=")
    assert "a=0.0ms" in s and "c=0.0ms" in s


# --- viz ---------------------------------------------------------------

def test_viz_scales_normalized_floats():
    from video_stitcher_tpu_torch.utils.viz import _as_u8_rgb
    out = _as_u8_rgb(np.full((4, 4), 0.5, np.float32))
    assert out.dtype == np.uint8 and out.max() >= 120
    out2 = _as_u8_rgb(np.full((4, 4), 200.0, np.float32))
    assert int(out2.max()) == 200


def test_viz_save_falls_back_on_unwritable_path(tmp_path):
    from video_stitcher_tpu_torch.utils import viz
    bad = str(tmp_path / "no_such_dir" / "x.png")
    with pytest.raises(Exception):
        viz.save(bad, np.zeros((4, 4, 3), np.uint8))


# --- encoders ----------------------------------------------------------

def test_native_encoders_raise_after_close():
    """A NULL handle into native code would crash the process: the
    native I_PCM and intra encoders, built with g++ at first use, raise
    after close, and so does x265 where it loads."""
    from video_stitcher_tpu_torch.io_plane import (
        hevc_intra, hevc_lavc, hevc_pcm,
    )
    frame = b"\x00" * (64 * 64 * 3 // 2)
    for mod, kw in ((hevc_pcm, {}), (hevc_intra, {"qp": 30})):
        enc = mod.create(64, 64, **kw)
        assert type(enc).__name__.startswith("Native"), type(enc)
        enc.close()
        with pytest.raises(RuntimeError, match="closed"):
            enc.encode(frame)
    enc = hevc_lavc.create_encoder(64, 64)
    assert (enc is None) == (hevc_lavc.load_native() is None)
    if enc is not None:
        enc.close()
        with pytest.raises(RuntimeError, match="closed"):
            enc.encode(frame)


def test_egress_recovers_from_dead_encoder():
    """send_frame's recovery covers the encode step: an encoder that
    raises OSError is replaced by a fresh encoder and connection."""
    from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress

    drained = {"bytes": 0, "conns": 0}
    ls = socket.socket()
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", 0))
    ls.listen(2)
    stop = threading.Event()

    def player():
        ls.settimeout(1.0)
        while not stop.is_set():
            try:
                c, _ = ls.accept()
            except socket.timeout:
                continue
            drained["conns"] += 1
            c.settimeout(1.0)
            while not stop.is_set():
                try:
                    b = c.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not b:
                    break
                drained["bytes"] += len(b)
            c.close()

    t = threading.Thread(target=player, daemon=True)
    t.start()
    cfg = StitcherConfig(num_images=2, player_address="127.0.0.1",
                         player_tcp_port=ls.getsockname()[1],
                         send_height_info=False)
    eg = PlayerEgress(cfg, encoder="hevc")
    eg.connect()
    frame = np.random.default_rng(0).integers(
        0, 255, (64, 64, 3)).astype(np.uint8)
    eg.send_frame(frame)
    assert eg._enc is not None

    class DeadEncoder:
        def encode(self, b):
            raise BrokenPipeError("encoder subprocess died")

        def close(self):
            raise OSError("already dead")

    eg._enc = DeadEncoder()
    eg.send_frame(frame)          # recovers, does not raise
    assert not isinstance(eg._enc, DeadEncoder), "dead encoder cached"
    eg.send_frame(frame)          # and keeps working
    stop.set()
    eg.close()
    ls.close()
    t.join(timeout=5)
    assert drained["conns"] >= 2 and drained["bytes"] > 0


def test_x265_finish_raises_on_native_error_or_is_cleanly_absent():
    from video_stitcher_tpu_torch.io_plane import hevc_lavc
    enc = hevc_lavc.create_encoder(64, 64)
    if enc is None:
        assert hevc_lavc.load_native() is None
        return
    enc.encode(b"\x10" * (64 * 64 * 3 // 2))
    enc.finish()
    with pytest.raises(RuntimeError, match="flush"):
        enc.finish()              # a double flush is a native error
    enc.close()
