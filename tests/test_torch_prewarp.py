"""Prewarp: the per-frame source resized to compose scale before the warp
(a compose scale below 0.5, or fuse_maps=False), against the JAX package.

On the 4x640x360 ring at compose_megapix=0.04 (compose scale 0.35,
tests/test_map_convention.py's prewarp rig): the fused NV12 conversion at
compose scale and prewarp_source within 1e-3, the fused maps within 1e-3,
and stitch / stitch_nv12 / stitch_out within 3/255 (BASELINE.md:22) of
the JAX package's. The JAX calibration runs op by op, as
tests/test_torch_calibration.py runs it. Also the two faults that showed
once prewarp was let through: the geometry's warp-source size, and K1's
tile plan built over it (compose size), not over the full-res source.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib import calibration as jcal
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.ops import color as jcolor
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib import calibration as tcal
from video_stitcher_tpu_torch.ops import color as tcolor
from video_stitcher_tpu_torch.ops.remap_strips import plan_remap

ATOL = 1e-3            # f32 values and map coordinates
MAX_ABS = 3            # u8 panoramas, BASELINE.md:22
RIG = dict(num_images=4, input_width=640, input_height=360,
           compose_megapix=0.04, enable_local=False, recalibrate=False,
           output_width=960, output_height=400, keep_aspect_ratio=True,
           add_black_bars=True)


def _diff(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)
                      ).max())


@pytest.fixture(scope="module")
def rig():
    jcfg = JConfig(**RIG)
    geom, _ = jcal.plan_geometry(jcfg)
    rng = np.random.default_rng(5)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    nv12 = np.stack([np.asarray(jcolor.rgb_to_nv12(f)) for f in frames])
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**RIG), device="cpu")
    st.calibrate(frames)
    return dict(jst=jst, st=st, frames=frames, nv12=nv12, scene=scene)


def test_rig_takes_prewarp(rig):
    for geom in (rig["jst"].geom, rig["st"].geom):
        assert geom.prewarp and geom.compose_scale < 0.5


def test_geometry_warp_source_size(rig):
    jg, g = rig["jst"].geom, rig["st"].geom
    assert (g.warp_src_w, g.warp_src_h) == (jg.warp_src_w, jg.warp_src_h)
    assert (g.warp_src_w, g.warp_src_h) == (g.compose_w, g.compose_h)
    full = tcal.plan_geometry(StitcherConfig(num_images=4, input_width=640,
                                             input_height=360))[0]
    assert not full.prewarp
    assert (full.warp_src_w, full.warp_src_h) == (640, 360)


def test_plan_is_built_over_the_warp_source(rig):
    st = rig["st"]
    state, geom, plan = st._snapshot()
    assert (plan.src_h, plan.src_w) == (geom.compose_h, geom.compose_w)
    want = plan_remap(state.fused_maps, geom.compose_h, geom.compose_w)
    assert plan.n_active == want.n_active
    assert torch.equal(plan.order, want.order)
    # over the full-res source the plan marks other tiles, and would leave
    # active ones at zero
    wrong = plan_remap(state.fused_maps, geom.src_h, geom.src_w)
    assert not torch.equal(wrong.active, plan.active)


@pytest.mark.parametrize("out_hw", [(126, 224), (90, 160)])
def test_nv12_to_rgb_planar_scaled_matches_jax(rig, out_hw):
    nv = rig["nv12"][0]
    want = np.asarray(jcolor.nv12_to_rgb_planar_scaled(jnp.asarray(nv),
                                                       *out_hw))
    got = tcolor.nv12_to_rgb_planar_scaled(torch.as_tensor(nv), *out_hw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    batched = tcolor.nv12_to_rgb_planar_scaled(
        torch.as_tensor(rig["nv12"][:2]), *out_hw)
    assert torch.equal(batched[0], got)


def test_prewarp_source_matches_jax(rig):
    geom = rig["st"].geom
    x = np.moveaxis(rig["frames"], -1, 1).astype(np.float32)
    want = np.asarray(jcal.prewarp_source(jnp.asarray(x), rig["jst"].geom))
    got = tcal.prewarp_source(torch.as_tensor(x), geom)
    assert got.shape == (4, 3, geom.compose_h, geom.compose_w)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fused_maps_match_jax(rig):
    jmaps = np.asarray(rig["jst"].state.fused_maps)
    maps = rig["st"].state.fused_maps.numpy()
    assert maps.shape == jmaps.shape
    np.testing.assert_allclose(maps, jmaps, atol=ATOL)


@pytest.mark.parametrize("entry", ["stitch", "stitch_nv12", "stitch_out"])
def test_stitch_matches_jax(rig, entry):
    frames = rig["nv12"] if entry == "stitch_nv12" else rig["frames"]
    got = getattr(rig["st"], entry)(frames)
    want = getattr(rig["jst"], entry)(frames)
    assert got.shape == want.shape
    assert _diff(got, want) <= MAX_ABS


def test_stitch_batch_equals_per_frame(rig):
    st, frames = rig["st"], rig["frames"]
    batch = st.stitch_batch(np.stack([frames, frames]))
    assert _diff(batch[1], st.stitch(frames)) == 0
    batch = st.stitch_batch(np.stack([rig["nv12"]] * 2))
    assert _diff(batch[0], st.stitch_nv12(rig["nv12"])) == 0


def test_psnr_against_the_scene_as_jax(rig):
    """Both packages' stitch of this rig against the scene, over the valid
    central rows: the JAX package's own CPU run scores ~34.8 dB here (two
    resamples of a rig rendered at full res), below the 40 dB of the
    full-scale bench, so the card's 4K->8K prewarp phase gates on parity
    with the host and prints its psnr. The port scores the same within
    0.05 dB."""
    def scene_psnr(st, pano):
        valid = np.asarray(st.state.valid_mask) > 0
        h = pano.shape[0]
        gt = np.moveaxis(rig["scene"], 0, -1)
        sel = valid[h // 4:3 * h // 4]
        return psnr(pano[h // 4:3 * h // 4][sel], gt[h // 4:3 * h // 4][sel])
    p_jax = scene_psnr(rig["jst"], rig["jst"].stitch(rig["frames"]))
    p_port = scene_psnr(rig["st"], rig["st"].stitch(rig["frames"]))
    assert p_jax < 40.0
    assert abs(p_port - p_jax) < 0.05, (p_port, p_jax)
