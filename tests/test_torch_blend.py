"""The port's multiband blend against the JAX package's: band placement
with ring wrap and crop exact, weight pyramids within 1e-5, the f32 blend
within 0.05, and bf16 pyramid storage equal to the JAX package's bf16
blend, on the warped bands of the 6x320x180 rig."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.blend import multiband as jmb
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.pipeline.stitcher import warp_bands as j_warp
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch.blend import multiband as tmb
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.config import StitcherConfig

RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False, recalibrate=False)
PAIR = dict(num_images=2, input_width=320, input_height=180,
            wrap_around=False, yaws=(0.0, math.pi / 3), enable_local=False,
            recalibrate=False)


@pytest.fixture(scope="module")
def ring():
    cfg = JConfig(**RING)
    geom, _ = j_plan(cfg)
    rng = np.random.default_rng(3)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(cfg, geom, scene)
    st = JStitcher(cfg)
    st.calibrate(frames)
    bands = np.asarray(j_warp(jnp.asarray(frames), st.state, st.geom))
    return st, bands


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("rig", ["ring", "pair"])
def test_place_and_crop_bands_are_exact(rig):
    lay = plan_geometry(StitcherConfig(**(RING if rig == "ring" else PAIR))
                        )[0].layout
    rng = np.random.default_rng(8)
    for lvl in range(lay.num_bands + 1):
        f = 1 << lvl
        bands = rng.uniform(-50, 300, (len(lay.corners), 3, lay.band_h // f,
                                       lay.band_w // f)).astype(np.float32)
        ref = np.asarray(jmb.place_bands(jnp.asarray(bands), lay, lvl))
        port = tmb.place_bands(_t(bands), lay, lvl).numpy()
        np.testing.assert_array_equal(port, ref)
        for cam in range(len(lay.corners)):
            np.testing.assert_array_equal(
                tmb.crop_band(_t(ref), lay, cam, lvl).numpy(),
                np.asarray(jmb.crop_band(jnp.asarray(ref), lay, cam, lvl)))
    if rig == "ring":
        # some camera's band really straddles the wrap seam
        assert any(c < 0 or c + lay.band_w > lay.pano_w
                   for c in lay.corners)


def test_weight_pyramids_match(ring):
    st, _ = ring
    w0 = np.asarray(st.aux["weights0"])
    ref_pyr, ref_valid = jmb.build_weight_pyramids(jnp.asarray(w0),
                                                   st.geom.layout)
    pyr, valid = tmb.build_weight_pyramids(_t(w0), st.geom.layout)
    for p, r in zip(pyr, ref_pyr):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def _blend(st, bands, precision, port):
    mb, conv = (tmb, _t) if port else (jmb, jnp.asarray)
    weights = tuple(conv(np.asarray(w)) for w in st.state.weight_pyr)
    out = mb.blend_bands(conv(bands), weights, st.geom.layout,
                         conv(np.asarray(st.state.valid_mask)), precision)
    return np.asarray(out.numpy() if port else out, np.float32)


def test_blend_f32_matches_jax(ring):
    st, bands = ring
    np.testing.assert_allclose(_blend(st, bands, "highest", True),
                               _blend(st, bands, "highest", False),
                               atol=0.05, rtol=0)


def test_blend_bf16_storage_matches_jax(ring):
    """bf16 pyramid storage rounds where the JAX package rounds, so the
    two bf16 blends agree exactly, and so do their distances from the f32
    chain. That distance is a property of the rig; chip_smoke.py measures
    the 6x1080p rig on the card."""
    st, bands = ring
    sel = np.asarray(st.state.valid_mask) > 0
    b16 = _blend(st, bands, "bf16", True)
    jb16 = _blend(st, bands, "bf16", False)
    np.testing.assert_array_equal(b16[:, sel], jb16[:, sel])
    f32 = _blend(st, bands, "highest", True)
    jf32 = _blend(st, bands, "highest", False)
    assert psnr(b16[:, sel], f32[:, sel]) == pytest.approx(
        psnr(jb16[:, sel], jf32[:, sel]), abs=0.01)
