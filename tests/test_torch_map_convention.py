"""map_convention in the port, as tests/test_map_convention.py holds the
JAX package: under "exact" the fused maps (compose_fused_maps on CPU
tensors) equal the analytic full-resolution projection to sub-millipixel
error, under prewarp through the per-axis cv2 resize pixel-centre
relation; "reference" keeps the reference chain's half-pixel bias."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch.calib.calibration import (
    compose_fused_maps, map_cams, plan_geometry,
)
from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.geometry.camera import fixed_rig_cameras
from video_stitcher_tpu_torch.geometry.cylindrical import band_backward_maps


def _fused_and_truth(cfg):
    geom, cams_compose = plan_geometry(cfg)
    lay = geom.layout
    cams = map_cams(cfg, cams_compose)
    fused = compose_fused_maps(geom, band_backward_maps(lay, cams),
                               device="cpu")
    cams_full = fixed_rig_cameras(cfg.num_images, cfg.input_width,
                                  cfg.input_height, 1.0, cfg.fov_deg,
                                  cfg.yaws)
    truth = band_backward_maps(lay, cams_full)
    inb = ((truth[:, 0] > 1) & (truth[:, 0] < cfg.input_width - 2)
           & (truth[:, 1] > 1) & (truth[:, 1] < cfg.input_height - 2))
    return geom, fused, truth, inb


def test_exact_maps_match_analytic_truth():
    """Mid minification (resize active, fused single-resample path)."""
    cfg = StitcherConfig(num_images=4, input_width=640, input_height=360,
                         compose_megapix=0.12)
    geom, fused, truth, inb = _fused_and_truth(cfg)
    assert not geom.prewarp and abs(geom.compose_scale - 1.0) > 1e-1
    err = np.abs(fused - truth)
    assert err[:, 0][inb].max() < 1e-3
    assert err[:, 1][inb].max() < 1e-3


def test_exact_maps_prewarp_per_axis_resize_relation():
    """Strong minification (prewarp): the full-res projection through the
    per-axis cv2 resize pixel-centre relation."""
    cfg = StitcherConfig(num_images=4, input_width=640, input_height=360,
                         compose_megapix=0.04)
    geom, fused, truth, inb = _fused_and_truth(cfg)
    assert geom.prewarp
    sx = geom.compose_w / geom.src_w
    sy = geom.compose_h / geom.src_h
    want_x = (truth[:, 0] + 0.5) * sx - 0.5
    want_y = (truth[:, 1] + 0.5) * sy - 0.5
    assert np.abs(fused[:, 0] - want_x)[inb].max() < 1e-3
    assert np.abs(fused[:, 1] - want_y)[inb].max() < 1e-3


def test_reference_convention_keeps_the_bias():
    """"reference" keeps a systematic positive offset against the truth
    (0.5*(1-s)/s plus the int-truncated compose-size scale term)."""
    cfg = StitcherConfig(num_images=4, input_width=640, input_height=360,
                         compose_megapix=0.12, map_convention="reference")
    geom, fused, truth, inb = _fused_and_truth(cfg)
    s = geom.compose_scale
    dx = (fused - truth)[:, 0][inb]
    base = 0.5 * (1.0 - s) / s
    assert dx.mean() > 0.8 * base
    assert np.abs(dx).mean() > 0.05


def test_default_is_exact():
    assert StitcherConfig(num_images=2).map_convention == "exact"
    with pytest.raises(ValueError):
        StitcherConfig(num_images=2, map_convention="bogus")
