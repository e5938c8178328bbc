"""The port against a cv2 CPU gold of the reference chain
(tools/reference_gold.py: calibration.cpp:72-248 + timed.cpp:56-152), the
three cases of tests/test_reference_gold.py with its rigs, seeds and
bounds: >= 40 dB against the float twin of the chain, the int16 twin
against the chain's integer output (its own quantization noise sets
that bound) and the prewarp resize chain (``fuse_maps=False``,
``map_convention="reference"``, as bench.py:642-646 runs it).

The tool reads only ``st.geom``, ``st.cfg``, ``st.stitch`` and
``st.state.valid_mask``, so it takes the port's ``Stitcher(device="cpu")``
as it is. The frames are rendered by the JAX test's own rig. Each case
prints the tool's result (``pytest -s`` shows it).
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.dirname(__file__))

from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu_torch import Stitcher, StitcherConfig

from test_stitch_e2e import SMALL, make_scene, render_views

cv2 = pytest.importorskip("cv2")


def _calibrated(**kw):
    """The JAX test's rig (scene seed 3) through the port's Stitcher."""
    cfg = {**SMALL, **kw}
    geom, _ = j_plan(JConfig(**cfg))
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h,
                       np.random.default_rng(3))
    frames = render_views(JConfig(**cfg), geom, scene)
    st = Stitcher(StitcherConfig(**cfg), device="cpu")
    st.calibrate(frames)
    assert st.geom.layout.__dict__ == geom.layout.__dict__
    return st, frames


def test_psnr_vs_reference_small():
    from reference_gold import psnr_vs_reference
    st, frames = _calibrated()
    geom = st.geom
    pano_i16 = st.stitch_int16(frames)
    out = psnr_vs_reference(st, frames, named_panos={
        "_int16": (pano_i16, st.state.valid_mask)})
    print("6x320x180:", out)
    assert out["compared_px"] > 0.5 * geom.pano_w * geom.pano_h / 2
    assert out["psnr_vs_reference_f32_db"] >= 40.0, out
    assert out["psnr_vs_reference_int16_db"] >= \
        out["reference_int_vs_f32_db"], out
    assert out["psnr_vs_reference_int16_db"] >= 39.0, out
    assert out["reference_int_vs_f32_db"] < 45.0, out
    assert out["psnr_vs_reference_db"] >= \
        out["reference_int_vs_f32_db"] - 4.0, out
    assert out["psnr_vs_reference_db"] >= 33.0, out


def test_psnr_vs_reference_int16_matched_40db():
    """BASELINE.md's fidelity gate, quantization-matched: the int16 twin
    against the integer gold at 960x540, the JAX test's rig."""
    from reference_gold import psnr_vs_reference
    st, frames = _calibrated(input_width=960, input_height=540)
    pano_i16 = st.stitch_int16(frames)
    out = psnr_vs_reference(st, frames, named_panos={
        "_int16": (pano_i16, st.state.valid_mask)})
    print("6x960x540:", out)
    assert out["psnr_vs_reference_int16_db"] >= 40.0, out
    assert abs(out["psnr_vs_reference_int16_f32_db"]
               - out["reference_int_vs_f32_db"]) < 1.5, out


def test_psnr_vs_reference_prewarp_resize_chain():
    """fuse_maps=False replicates the reference's resize-then-warp chain
    (K1 samples the source resized to compose scale) and must reach 40 dB
    against the float gold."""
    from reference_gold import psnr_vs_reference
    st, frames = _calibrated(compose_megapix=0.03, fuse_maps=False,
                             map_convention="reference")
    assert st.geom.prewarp and abs(st.geom.compose_scale - 1.0) > 1e-1
    out = psnr_vs_reference(st, frames)
    print("prewarp chain:", out)
    assert out["psnr_vs_reference_f32_db"] >= 40.0, out
