"""The port's calibration against the JAX package's, rig for rig: the same
geometry, fused maps within 1e-3 px, gains within 1e-5 relative, weight
pyramids within 1e-5, the same valid mask, and the same calibration aux
(overlap masks bit for bit), also when a loaded checkpoint rebuilds it.
Rigs: the 6x320x180 ring of tests/test_stitch_e2e.py, a 2-camera partial
(non-wrap) rig, and the 4x640x360 ring of tests/test_map_convention.py
at compose_megapix=0.12 (compose scale 0.72, no prewarp) in both map
conventions, the only rigs here that take the compose-scale path and
the "reference" back-conversion.

The JAX calibration runs op by op (``jax.disable_jit``). Compiled, XLA may
contract the seam-canvas row coordinate (y + v0) * ratio - v0' into a
fused multiply-add and re-round it, and a band row that lands on an exact
canvas integer then samples the neighbouring mask row;
test_compiled_jax_weights_differ_only_on_integral_canvas_rows pins that.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.utils.synth import make_scene, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu.calib import calibration as jcal
from video_stitcher_tpu_torch.calib import calibration as tcal
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.utils import synth as tsynth

RIGS = {
    "ring6": dict(num_images=6, input_width=320, input_height=180,
                  enable_local=False, recalibrate=False),
    "pair_nonwrap": dict(num_images=2, input_width=320, input_height=180,
                         wrap_around=False, yaws=(0.0, math.pi / 3),
                         enable_local=False, recalibrate=False),
    "ring4_c012_exact": dict(num_images=4, input_width=640,
                             input_height=360, compose_megapix=0.12,
                             enable_local=False, recalibrate=False,
                             map_convention="exact"),
    "ring4_c012_reference": dict(num_images=4, input_width=640,
                                 input_height=360, compose_megapix=0.12,
                                 enable_local=False, recalibrate=False,
                                 map_convention="reference"),
}
COMPOSE_RIGS = ("ring4_c012_exact", "ring4_c012_reference")


@pytest.fixture(scope="module", params=sorted(RIGS))
def calibrated(request):
    kw = RIGS[request.param]
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    gains = np.linspace(0.85, 1.15, jcfg.num_images)
    frames = render_views(jcfg, geom, scene, gains=gains)
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**kw), device="cpu")
    st.calibrate(frames)
    return jst, st, kw, frames, scene


@pytest.mark.parametrize("rig", COMPOSE_RIGS)
def test_compose_scale_rigs_resize_without_prewarp(rig):
    for geom, _ in (j_plan(JConfig(**RIGS[rig])),
                    plan_geometry(StitcherConfig(**RIGS[rig]))):
        assert 0.5 < geom.compose_scale < 0.9
        assert not geom.prewarp


def test_geometry_matches(calibrated):
    jst, st, kw, _, _ = calibrated
    jg, tg = jst.geom, st.geom
    assert tg.layout.__dict__ == jg.layout.__dict__
    for f in ("num_images", "src_w", "src_h", "compose_w", "compose_h",
              "compose_scale", "work_scale", "num_bands", "blend_type",
              "blend_precision", "wrap", "prewarp", "map_convention"):
        assert getattr(tg, f) == getattr(jg, f), f
    assert plan_geometry(StitcherConfig(**kw))[0] == tg


def test_fused_maps_match(calibrated):
    jst, st, _, _, _ = calibrated
    ref = np.asarray(jst.state.fused_maps)
    port = st.state.fused_maps.numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=1e-3, rtol=0)


def test_gains_match(calibrated):
    jst, st, _, _, _ = calibrated
    np.testing.assert_allclose(st.state.gains.numpy(),
                               np.asarray(jst.state.gains), rtol=1e-5)


def test_weight_pyramids_and_valid_mask_match(calibrated):
    jst, st, _, _, _ = calibrated
    assert len(st.state.weight_pyr) == len(jst.state.weight_pyr)
    for p, r in zip(st.state.weight_pyr, jst.state.weight_pyr):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(st.state.valid_mask.numpy(),
                                  np.asarray(jst.state.valid_mask))


def test_seam_masks_and_weights_match(calibrated):
    jst, st, _, _, _ = calibrated
    np.testing.assert_array_equal(st.aux["seam_masks"],
                                  jst.aux["seam_masks"])
    np.testing.assert_allclose(st.aux["weights0"].numpy(),
                               np.asarray(jst.aux["weights0"]), atol=1e-5,
                               rtol=0)


def test_synth_copy_renders_the_same_rig(calibrated):
    """The port's own synth module renders exactly the JAX package's rig."""
    jst, st, kw, frames, scene = calibrated
    rng = np.random.default_rng(7)
    lay = st.geom.layout
    scene2 = tsynth.make_scene(lay.pano_w, lay.pano_h, rng)
    np.testing.assert_array_equal(scene2, scene)
    gains = np.linspace(0.85, 1.15, kw["num_images"])
    frames2 = tsynth.render_views(StitcherConfig(**kw), st.geom, scene2,
                                  gains=gains)
    np.testing.assert_array_equal(frames2, frames)


@pytest.mark.parametrize("convention", ["exact", "reference"])
def test_fused_maps_with_mesh_match_jax(convention):
    """compose_fused_maps_device: the mesh warp (replicate border) and the
    map convention's conversion to warp-source coordinates."""
    kw = dict(RIGS["pair_nonwrap"], map_convention=convention)
    geom, _ = j_plan(JConfig(**kw))
    rng = np.random.default_rng(9)
    n, bh, bw = 2, 24, 40
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    band = np.stack([np.stack([gx * 1.3 + 5 * i, gy * 1.1 - 2])
                     for i in range(n)]).astype(np.float32)
    band[0, :, :3, :4] = -1.0
    mesh = (np.stack([np.stack([gx, gy])] * n)
            + rng.uniform(-2.5, 2.5, (n, 2, bh, bw))).astype(np.float32)
    for m in (None, mesh):
        ref = np.asarray(jcal.compose_fused_maps_device(
            band, m, geom=geom))
        port = tcal.compose_fused_maps_device(
            torch.from_numpy(band), None if m is None
            else torch.from_numpy(m), plan_geometry(StitcherConfig(**kw))[0])
        np.testing.assert_allclose(port.numpy(), ref, atol=1e-4, rtol=0)


def test_compiled_jax_weights_differ_only_on_integral_canvas_rows(
        calibrated):
    """The JAX package's compiled seam-weight program may differ from its
    own op-by-op result (which the port matches) only on band rows whose
    seam-canvas row coordinate is an exact integer."""
    jst, _, kw, _, _ = calibrated
    geom = jst.geom
    sc = jst.aux["seam_canvas"]
    compiled, _ = jcal._compose_products_device(
        jnp.asarray(np.asarray(jst.aux["seam_masks"], np.float32)),
        jnp.asarray(jst.aux["band_maps"]), geom=geom, sc=sc)
    diff = np.abs(np.asarray(compiled) - np.asarray(jst.aux["weights0"]))
    rows = np.unique(np.nonzero(diff > 1e-5)[1])
    canvas_row = (rows + np.float64(np.float32(geom.layout.v0))) \
        * np.float64(np.float32(sc.ratio)) - np.float64(np.float32(sc.v0))
    np.testing.assert_allclose(canvas_row, np.round(canvas_row), atol=1e-4)


def test_overlap_masks_match_jax(calibrated):
    """Bit for bit against the JAX package's op-by-op
    _compose_products_device: warp validity AND >= 2 cameras (none on
    the 4-camera rigs, whose 90-degree views only touch)."""
    jst, st, _, _, _ = calibrated
    port = st.aux["overlap_masks"].numpy()
    np.testing.assert_array_equal(port, np.asarray(jst.aux["overlap_masks"]))
    assert port.dtype == np.float32
    assert set(np.unique(port)) <= {0.0, 1.0}


def test_loaded_calibration_rebuilds_the_aux(calibrated, tmp_path):
    """load_calibration rebuilds what calibrate returned, without frames:
    the seam masks depend on warp validity only."""
    _, st, kw, frames, _ = calibrated
    path = str(tmp_path / "calib.npz")
    st.save_calibration(path)
    loaded = Stitcher(StitcherConfig(**kw), device="cpu")
    loaded.load_calibration(path)
    assert set(loaded.aux) == set(st.aux)
    np.testing.assert_array_equal(loaded.aux["seam_masks"],
                                  st.aux["seam_masks"])
    for key in ("weights0", "overlap_masks", "band_maps"):
        np.testing.assert_array_equal(loaded.aux[key].numpy(),
                                      st.aux[key].numpy())
    np.testing.assert_array_equal(loaded.stitch(frames), st.stitch(frames))
