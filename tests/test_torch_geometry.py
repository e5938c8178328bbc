"""The port's geometry against the analytic projection, OpenCV's
cylindrical warper and the band-layout invariants, as
tests/test_geometry.py holds the JAX package's: the same rigs (the
default 6x1920x1080 at compose scale) and the same tolerances."""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.geometry import (
    cylindrical_backward_map, cylindrical_forward, fixed_rig_cameras,
    plan_band_layout,
)
from video_stitcher_tpu_torch.geometry.cylindrical import (
    band_backward_maps, band_backward_maps_device, detect_extents,
)


def _compose_cams(cfg):
    cams = fixed_rig_cameras(cfg.num_images, cfg.input_width,
                             cfg.input_height, cfg.work_scale, cfg.fov_deg,
                             cfg.yaws)
    return [c.scaled(cfg.compose_work_aspect) for c in cams]


@pytest.fixture(scope="module")
def default_ring():
    """The default rig's compose-scale cameras, its wrapped layout and
    the host f64 band maps (one build shared by the tests below)."""
    cfg = StitcherConfig(num_images=6)
    cams = _compose_cams(cfg)
    lay = plan_band_layout(cams, 1578, 887, cfg.blend_strength, wrap=True)
    return cams, lay, band_backward_maps(lay, cams)


def test_focal_matches_reference():
    """calibration.cpp:31-32,63: f = ppx / tan(45deg) = ppx for 90deg FoV."""
    cfg = StitcherConfig()
    cams = fixed_rig_cameras(6, 1920, 1080, cfg.work_scale)
    assert math.isclose(cams[0].focal, 1920 * cfg.work_scale / 2,
                        rel_tol=1e-12)
    assert math.isclose(cams[3].yaw, math.pi, rel_tol=1e-12)


def test_forward_backward_roundtrip():
    cfg = StitcherConfig()
    cams = _compose_cams(cfg)
    s = cams[0].focal
    rng = np.random.default_rng(1)
    for cam in cams:
        x = rng.random(50) * 1577
        y = rng.random(50) * 886
        u, v = cylindrical_forward(cam, s, x, y)
        mx, my = cylindrical_backward_map(cam, s, u, v)
        np.testing.assert_allclose(mx, x, atol=1e-3)
        np.testing.assert_allclose(my, y, atol=1e-3)


def test_backward_matches_opencv_cylindrical():
    """Backward map values against cv2's CylindricalWarper buildMaps
    (build_warp_maps.cu:88-107) for the yaw=0 camera."""
    cv2 = pytest.importorskip("cv2")
    cfg = StitcherConfig()
    cam = _compose_cams(cfg)[0]
    s = cam.focal
    warper = cv2.PyRotationWarper("cylindrical", float(s))
    roi, gx, gy = warper.buildMaps((1578, 887), cam.K.astype(np.float32),
                                   cam.R.astype(np.float32))
    tlx, tly = roi[0], roi[1]
    u = (np.arange(gx.shape[1], dtype=np.float64)[None, :] + tlx
         + np.zeros((gx.shape[0], 1)))
    v = (np.arange(gx.shape[0], dtype=np.float64)[:, None] + tly
         + np.zeros((1, gx.shape[1])))
    mx, my = cylindrical_backward_map(cam, s, u, v)
    good = (gx >= 0) & (gy >= 0) & (mx >= 0) & (my >= 0)
    assert good.mean() > 0.5
    np.testing.assert_allclose(mx[good], gx[good], atol=0.01)
    np.testing.assert_allclose(my[good], gy[good], atol=0.01)


def test_band_layout_invariants(default_ring):
    cams, lay, _ = default_ring
    a = lay.align
    assert lay.pano_w % a == 0 and lay.pano_h % a == 0 and lay.band_w % a == 0
    assert all(c % a == 0 for c in lay.corners)
    assert lay.num_bands >= 4
    assert math.isclose(lay.pano_w, 2 * math.pi * lay.scale, rel_tol=1e-12)
    assert abs(lay.scale - cams[0].focal) / cams[0].focal < 0.01
    urmin, urmax, _, _ = detect_extents(cams[0], lay.scale, 1578, 887)
    for cam, corner in zip(cams, lay.corners):
        ctr = lay.scale * cam.yaw
        assert corner <= ctr + urmin
        assert corner + lay.band_w >= ctr + urmax


def test_band_maps_cover_sources(default_ring):
    _, lay, maps = default_ring
    assert maps.shape == (6, 2, lay.band_h, lay.band_w)
    assert maps.dtype == np.float32
    for i in range(6):
        valid = ((maps[i, 0] >= 0) & (maps[i, 0] <= 1577) &
                 (maps[i, 1] >= 0) & (maps[i, 1] <= 886))
        assert 0.2 < valid.mean() < 0.95


def test_nonwrap_layout():
    cfg = StitcherConfig(num_images=3, wrap_around=False,
                         yaws=(0.0, 2 * math.pi / 6, 4 * math.pi / 6))
    cams = _compose_cams(cfg)
    lay = plan_band_layout(cams, 1578, 887, cfg.blend_strength, wrap=False)
    assert not lay.wrap
    assert min(lay.corners) == 0
    assert max(c + lay.band_w for c in lay.corners) <= lay.pano_w


def test_band_maps_device_matches_host(default_ring):
    """The f32 builder calibration runs (here on CPU tensors) matches the
    host f64 builder to sub-0.01 px, with the same -1 sentinel."""
    cams, lay, h = default_ring
    d = band_backward_maps_device(lay, cams, "cpu").numpy()
    hs = (h[:, 0] == -1) & (h[:, 1] == -1)
    ds = (d[:, 0] == -1) & (d[:, 1] == -1)
    assert (hs == ds).all()
    m = ~hs[:, None, :, :] & np.ones((1, 2, 1, 1), bool)
    assert np.abs(h - d)[m].max() < 0.01
