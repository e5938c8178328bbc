"""The port's feature pipeline (``features/orb.py``, ``match.py``,
``ransac.py``) on natural photographs, the four cases of
tests/test_features_natural.py with its photos (sklearn's china.jpg and
flower.jpg, matplotlib's grace_hopper.jpg, from the installed packages),
its cv2.ORB yardstick and its bounds:

- detector repeatability under a 9 / 5 px shift (>= 0.85, and >= 0.9 x
  cv2's) and under a 5 degree rotation (>= 0.75, and >= 0.85 x cv2's);
- match precision after knn + ratio + RANSAC against a known homography
  (>= 30 inliers, >= 0.85 within 3 px);
- the same CPW mesh from 512 keypoints / 4 levels as from the
  reference's 2500 / 8 on a rig rendered from the tiled photos (median
  |delta| < 0.1 px, max < 2 px).

RANSAC draws from a ``torch.Generator`` seeded 0 where the JAX test uses
``PRNGKey(0)``: the draws differ, the bounds are the same.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

from test_features_natural import (
    _PHOTOS, _cv2_keypoints, _load_gray, _natural_scene, _repeatability,
)
from video_stitcher_tpu_torch.features.match import knn_ratio_match
from video_stitcher_tpu_torch.features.orb import detect_and_describe
from video_stitcher_tpu_torch.features.ransac import ransac_homography


def _detect(gray, max_kp=512, levels=4):
    return detect_and_describe(torch.as_tensor(gray), max_keypoints=max_kp,
                               num_levels=levels)


def _our_keypoints(gray, max_kp=512, levels=4):
    kp = _detect(gray, max_kp, levels)
    return kp.xy.numpy()[kp.valid.numpy()], kp


@pytest.mark.parametrize("photo", _PHOTOS,
                         ids=["china", "flower", "hopper"])
def test_orb_repeatability_shift_vs_cv2(photo):
    gray = _load_gray(photo)
    dx, dy = 9.0, 5.0
    shifted = np.roll(np.roll(gray, int(dy), axis=0), int(dx), axis=1)

    xy1, _ = _our_keypoints(gray)
    xy2, _ = _our_keypoints(shifted)
    r_ours = _repeatability(xy1, xy2, lambda p: p + np.array([dx, dy]))

    c1 = _cv2_keypoints(gray)
    c2 = _cv2_keypoints(shifted)
    r_cv = _repeatability(c1, c2, lambda p: p + np.array([dx, dy]))

    assert len(xy1) >= 200, f"only {len(xy1)} keypoints on a photograph"
    assert r_ours >= 0.85, f"repeatability {r_ours:.2f} (cv2 {r_cv:.2f})"
    assert r_ours >= 0.9 * r_cv, (
        f"ours {r_ours:.2f} < 0.9 x cv2 {r_cv:.2f}")


def test_orb_repeatability_rotation_vs_cv2():
    import cv2
    gray = _load_gray(_PHOTOS[0])
    h, w = gray.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), 5.0, 1.0)
    rot = cv2.warpAffine(gray, m, (w, h), flags=cv2.INTER_LINEAR)

    def tf(p):
        return p @ m[:, :2].T + m[:, 2]

    xy1, _ = _our_keypoints(gray)
    xy2, _ = _our_keypoints(rot)
    r_ours = _repeatability(xy1, xy2, tf)
    r_cv = _repeatability(_cv2_keypoints(gray), _cv2_keypoints(rot), tf)

    assert r_ours >= 0.75, f"rotation repeatability {r_ours:.2f} " \
                           f"(cv2 {r_cv:.2f})"
    assert r_ours >= 0.85 * r_cv, f"ours {r_ours:.2f} < 0.85 x cv2 " \
                                  f"{r_cv:.2f}"


@pytest.mark.parametrize("photo", [_PHOTOS[0], _PHOTOS[2]],
                         ids=["china", "hopper"])
def test_match_precision_after_ransac_known_homography(photo):
    import cv2
    gray = _load_gray(photo)
    h, w = gray.shape
    h_gt = np.array([[1.02, 0.015, 6.0],
                     [-0.01, 0.99, -4.0],
                     [1.5e-5, -1e-5, 1.0]], np.float32)
    warped = cv2.warpPerspective(gray, h_gt, (w, h), flags=cv2.INTER_LINEAR)

    kp1, kp2 = _detect(gray), _detect(warped)
    m = knn_ratio_match(kp1.desc, kp2.desc, kp1.valid, kp2.valid)
    p1 = kp1.xy[m.query]
    p2 = kp2.xy[m.train]
    _, inl, _ = ransac_homography(p1, p2, m.valid,
                                  torch.Generator().manual_seed(0))
    inl = (inl & m.valid).numpy()
    assert inl.sum() >= 30, f"only {int(inl.sum())} RANSAC inliers"

    p1, p2 = p1.numpy(), p2.numpy()
    ones = np.ones((inl.sum(), 1), np.float32)
    proj = np.concatenate([p1[inl], ones], axis=1) @ h_gt.T
    proj = proj[:, :2] / proj[:, 2:3]
    err = np.linalg.norm(proj - p2[inl], axis=1)
    precision = float((err <= 3.0).mean())
    assert precision >= 0.85, (
        f"match precision {precision:.2f}, median err {np.median(err):.2f}px")


def test_orb_512_vs_2500_mesh_equivalence_natural():
    """config.py's claim, for the port: orb_num_features=512 / 4 levels
    solves the same CPW mesh as the reference's 2500 / 8 on natural
    texture."""
    from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
    from video_stitcher_tpu.config import StitcherConfig as JConfig
    from test_stitch_e2e import render_views
    from video_stitcher_tpu_torch import Stitcher, StitcherConfig
    from video_stitcher_tpu_torch.mesh.mesh2map import upsample_backward_disp

    kw = dict(num_images=6, input_width=320, input_height=180,
              enable_local=True, recalibrate=True, orb_num_features=512,
              orb_num_levels=4)
    geom, _ = j_plan(JConfig(**kw))
    scene = _natural_scene(geom.layout.pano_w, geom.layout.pano_h)
    frames = render_views(JConfig(**kw), geom, scene)

    def dense_maps(cfg):
        st = Stitcher(cfg, device="cpu")
        st.calibrate(frames)
        disp = st._mesh_pipe.run(frames)
        if disp is None:
            return None
        lay = st.geom.layout
        return upsample_backward_disp(torch.as_tensor(disp), lay.band_h,
                                      lay.band_w).numpy()

    cfg_a = StitcherConfig(**kw)
    maps_a = dense_maps(cfg_a)
    assert maps_a is not None, "512/4: no mesh solved on natural texture"
    maps_b = dense_maps(dataclasses.replace(cfg_a, orb_num_features=2500,
                                            orb_num_levels=8))
    assert maps_b is not None, "2500/8: no mesh solved on natural texture"

    d = np.abs(maps_a - maps_b)
    assert float(np.median(d)) < 0.1, f"median mesh delta {np.median(d):.3f}px"
    assert float(d.max()) < 2.0, f"max mesh delta {d.max():.3f}px"
