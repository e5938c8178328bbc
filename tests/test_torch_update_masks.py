"""update_masks in the port: re-warping the seam weights through the CPW
mesh and rebuilding the blend weight pyramids
(MultiBandBlender::update_mask, blenders.cpp:297-315), three of the four
cases of tests/test_update_masks.py with its rig (6x320x180, scene seed
11, the CPW mesh on) and bounds: a known shift moves the seam, a real
mesh's rebuilt weights add no black pixels (>= 30 dB against the fixed
weights), and a Runner pass with live re-solves installs a mesh and keeps
the ring lit. Identity parity is
tests/test_torch_mesh_e2e.py::test_update_masks_identity_parity.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu_torch import Stitcher, StitcherConfig

from test_stitch_e2e import make_scene, psnr, render_views


def _small_kw(**kw):
    return {**dict(num_images=6, input_width=320, input_height=180,
                   enable_local=True, recalibrate=False), **kw}


@pytest.fixture(scope="module")
def calibrated():
    """The rig calibrated once (the CPW mesh solved and installed) for
    the two stitcher cases, with the state calibrate installed: the
    JAX test calibrates once per case, and its `recalibrate` flag, which
    differs between them, is read by the Runner only."""
    kw = _small_kw(recalibrate=True)
    geom, _ = j_plan(JConfig(**kw))
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(JConfig(**kw), geom, scene)
    st = Stitcher(StitcherConfig(**kw), device="cpu")
    st.calibrate(frames)
    return st, frames, st.state


def _identity_maps(st):
    lay = st.geom.layout
    yy, xx = np.mgrid[0:lay.band_h, 0:lay.band_w].astype(np.float32)
    return np.broadcast_to(np.stack([xx, yy]), (st.geom.num_images, 2,
                                                lay.band_h,
                                                lay.band_w)).copy()


def test_update_masks_shift_moves_seam(calibrated):
    """A +dx backward-map shift moves the rebuilt level-0 weights by dx:
    new_w(x) = w0(x + dx)."""
    st, _, state = calibrated
    dx = 6
    maps = _identity_maps(st)
    maps[:, 0] += dx
    new_state = st._rebuild_weights(state, torch.as_tensor(maps))
    w_orig = state.weight_pyr[0][:, 0].numpy()
    w_new = new_state.weight_pyr[0][:, 0].numpy()
    np.testing.assert_allclose(w_new[:, :, :-dx], w_orig[:, :, dx:],
                               atol=1e-4)


def test_update_masks_real_mesh_no_black_seams(calibrated):
    """With the installed CPW mesh, the weights re-warped through it
    stitch within 30 dB of the calibration-time weights and add no black
    pixel in the valid region."""
    from video_stitcher_tpu_torch.mesh.mesh2map import upsample_backward_disp
    from video_stitcher_tpu_torch.mesh.pipeline import solve_mesh_maps

    st, frames, state = calibrated
    st.swap_state(state)
    pano_fixed = st.stitch(frames)
    valid = state.valid_mask.numpy() > 0

    disp = solve_mesh_maps(frames, st)
    assert disp is not None
    lay = st.geom.layout
    mesh_maps = upsample_backward_disp(torch.as_tensor(disp), lay.band_h,
                                       lay.band_w)
    new_state = st._rebuild_weights(state, mesh_maps)
    st.swap_state(new_state)
    pano_upd = st.stitch(frames)

    sel = valid & (new_state.valid_mask.numpy() > 0)
    p = psnr(pano_upd[sel], pano_fixed[sel])
    assert p >= 30.0, f"update_masks output diverged: {p:.2f} dB"
    lum_f = pano_fixed.astype(np.float32).sum(-1)
    lum_u = pano_upd.astype(np.float32).sum(-1)
    new_black = ((lum_u < 8) & (lum_f > 60) & sel).sum()
    assert new_black == 0, f"{new_black} new black pixels (black seams)"


def test_update_masks_runner_pass(tmp_path, monkeypatch):
    """A Runner pass with update_masks=True (the synthetic rig source, 40
    frames, a re-solve every 100 ms): it completes, installs at least one
    mesh, and its result.jpg is not dark."""
    import cv2
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(
        StitcherConfig(**_small_kw(recalibrate=True, update_masks=True)),
        recalib_del_ms=100)
    r = Runner(cfg, max_frames=40,
               stitcher=Stitcher(cfg, device="cpu"))
    r.run()
    assert r.frames_done >= 1
    assert r.recalibs_done >= 1, "no mesh install with update_masks on"
    assert os.path.exists(tmp_path / "result.jpg")
    out = np.asarray(cv2.imread(str(tmp_path / "result.jpg")))
    assert out.mean() > 20, out.mean()
