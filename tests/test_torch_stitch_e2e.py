"""End to end: both packages stitch the same frames from one calibration,
handed across as arrays (``interop.state_from_numpy``) or as a checkpoint
written by either package. The panoramas agree within 3/255 max abs (the
reference's CUDA-vs-CPU bound, BASELINE.md:22) and score >= 40 dB against
the synthetic scene. Covers stitch, stitch_nv12, stitch_out, stitch_batch
and output, on the 6x320x180 ring and a 2-camera partial rig, and the
port's own calibration also on a 4x640x360 ring at compose scale 0.72 in
both map conventions. A state swapped in during stitch_batch does not
reach the batch that was already running."""

import math

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.ops.color import rgb_to_nv12
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips

MAX_ABS = 3
MIN_PSNR = 40.0
RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False, recalibrate=False)
PAIR = dict(num_images=2, input_width=320, input_height=180,
            wrap_around=False, yaws=(0.0, math.pi / 3), enable_local=False,
            recalibrate=False)
RING4_C012 = dict(num_images=4, input_width=640, input_height=360,
                  compose_megapix=0.12, enable_local=False,
                  recalibrate=False)


def _scene_psnr(pano, scene, valid, u0=0.0):
    """psnr over the valid central rows, pano col x at cylinder u0 + x."""
    gt = np.roll(np.moveaxis(scene, 0, -1), -int(round(u0)), axis=1)
    h = pano.shape[0]
    sel = valid[h // 4:3 * h // 4]
    return psnr(pano[h // 4:3 * h // 4][sel], gt[h // 4:3 * h // 4][sel])


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    jcfg = JConfig(**RING)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    noisy = np.clip(frames.astype(np.int32)
                    + rng.integers(-20, 20, frames.shape), 0, 255
                    ).astype(np.uint8)
    jst = JStitcher(jcfg)
    jst.calibrate(frames)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_calib.npz")
    jst.save_calibration(ckpt)

    cfg = StitcherConfig(**RING)
    by_arrays = Stitcher(cfg, device="cpu")
    by_arrays.swap_state(state_from_numpy(
        np.asarray(jst.state.fused_maps), np.asarray(jst.state.gains),
        [np.asarray(w) for w in jst.state.weight_pyr],
        np.asarray(jst.state.valid_mask), device="cpu"))
    by_ckpt = Stitcher(cfg, device="cpu")
    by_ckpt.load_calibration(ckpt)
    return dict(jst=jst, ports={"arrays": by_arrays, "checkpoint": by_ckpt},
                frames=frames, noisy=noisy, scene=scene, tmp=ckpt)


@pytest.mark.parametrize("handed", ["arrays", "checkpoint"])
def test_stitch_matches_jax(ring, handed):
    st, jst = ring["ports"][handed], ring["jst"]
    before = remap_strips.launches
    pano = st.stitch(ring["frames"])
    assert remap_strips.launches == before     # CPU: the plain version
    jpano = jst.stitch(ring["frames"])
    assert _diff(pano, jpano) <= MAX_ABS
    valid = st.state.valid_mask.numpy() > 0
    assert _scene_psnr(pano, ring["scene"], valid) >= MIN_PSNR
    assert _diff(st.stitch(ring["noisy"]), jst.stitch(ring["noisy"])) \
        <= MAX_ABS


@pytest.mark.parametrize("handed", ["arrays", "checkpoint"])
def test_stitch_nv12_matches_jax(ring, handed):
    st, jst = ring["ports"][handed], ring["jst"]
    nv12 = np.stack([np.asarray(rgb_to_nv12(f)) for f in ring["frames"]])
    pano = st.stitch_nv12(nv12)
    jpano = jst.stitch_nv12(nv12)
    assert _diff(pano, jpano) <= MAX_ABS
    # 4:2:0 chroma caps what NV12 input can score against the scene,
    # below the RGB bound for both packages: hold the port to the
    # reference's score instead
    valid = st.state.valid_mask.numpy() > 0
    assert _scene_psnr(pano, ring["scene"], valid) == pytest.approx(
        _scene_psnr(jpano, ring["scene"], valid), abs=0.05)


@pytest.mark.parametrize("handed", ["arrays", "checkpoint"])
def test_stitch_out_and_output_match_jax(ring, handed):
    st, jst = ring["ports"][handed], ring["jst"]
    out = st.stitch_out(ring["frames"])
    assert out.shape[1] == 4096 and out.shape[0] <= 2048
    assert _diff(out, jst.stitch_out(ring["frames"])) <= MAX_ABS
    pano = st.stitch(ring["frames"])
    assert _diff(st.output(pano), jst.output(pano)) <= MAX_ABS
    # the fused blend+resize agrees with the two-step path
    assert _diff(out, st.output(pano)) <= MAX_ABS


def test_stitch_batch_matches_jax_and_per_frame(ring):
    st, jst = ring["ports"]["arrays"], ring["jst"]
    batch = np.stack([ring["frames"], ring["noisy"]])
    panos = st.stitch_batch(batch)
    assert panos.shape[0] == 2
    assert _diff(panos, jst.stitch_batch(batch)) <= MAX_ABS
    for i in range(2):
        np.testing.assert_array_equal(panos[i], st.stitch(batch[i]))


def test_stitch_batch_blends_with_the_state_it_warped_with(ring,
                                                           monkeypatch):
    """A swap_state from another caller while a batch is being blended
    reaches the next call, not the running batch."""
    import video_stitcher_tpu_torch.pipeline.stitcher as stitcher_mod
    st = Stitcher(StitcherConfig(**RING), device="cpu")
    st.swap_state(ring["ports"]["arrays"].state)
    old_state = st.state
    new_state = old_state._replace(gains=old_state.gains * 0.5)
    batch = np.stack([ring["frames"], ring["noisy"]])
    want = [st.stitch(b) for b in batch]
    original = stitcher_mod.blend_pack
    swaps = []

    def swapping_blend_pack(bands, state, geom):
        if not swaps:
            st.swap_state(new_state)
            swaps.append(state)
        return original(bands, state, geom)

    monkeypatch.setattr(stitcher_mod, "blend_pack", swapping_blend_pack)
    panos = st.stitch_batch(batch)
    assert len(swaps) == 1 and st.state is not old_state
    for got, ref in zip(panos, want):
        np.testing.assert_array_equal(got, ref)
    # the swap took effect for the next call
    assert _diff(st.stitch(batch[0]), want[0]) > 0


def test_port_checkpoint_loads_in_jax(ring, tmp_path):
    st, jst = ring["ports"]["arrays"], ring["jst"]
    path = str(tmp_path / "port_calib.npz")
    st.save_calibration(path)
    jst2 = JStitcher(JConfig(**RING))
    jst2.load_calibration(path)
    np.testing.assert_array_equal(jst2.stitch(ring["frames"]),
                                  jst.stitch(ring["frames"]))


@pytest.mark.parametrize("rig", ["ring", "pair", "pair_feather"])
def test_port_calibration_stitches_like_jax(rig):
    """Each package calibrates for itself; the panoramas still agree. The
    JAX calibration runs op by op, as in tests/test_torch_calibration.py
    (compiled, it can re-round a seam-canvas row and blacken that row of
    its ring panorama, which the port does not)."""
    kw = {"ring": RING, "pair": PAIR,
          "pair_feather": dict(PAIR, blend_type="feather")}[rig]
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**kw), device="cpu")
    st.calibrate(frames)
    pano = st.stitch(frames)
    assert _diff(pano, jst.stitch(frames)) <= MAX_ABS
    valid = st.state.valid_mask.numpy() > 0
    assert _scene_psnr(pano, scene, valid, geom.layout.u0) >= MIN_PSNR
    # no holes anywhere in the valid region (the scene is >= 10 everywhere)
    assert int((pano.max(axis=-1)[valid] < 5).sum()) == 0


@pytest.mark.parametrize("convention", ["exact", "reference"])
def test_port_calibration_at_compose_scale_stitches_like_jax(convention):
    """Each package calibrates the 4x640x360 ring at compose scale 0.72
    for itself (the JAX one op by op); the panoramas agree within 3/255
    and score the same against the scene: 35.84 dB ("exact") and
    32.62 dB ("reference", whose half-pixel bias the maps keep) for both
    packages, below the 40 dB the other rigs reach, so the port is held
    to the reference's score here."""
    kw = dict(RING4_C012, map_convention=convention)
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**kw), device="cpu")
    st.calibrate(frames)
    pano, jpano = st.stitch(frames), jst.stitch(frames)
    assert _diff(pano, jpano) <= MAX_ABS
    valid = st.state.valid_mask.numpy() > 0
    assert _scene_psnr(pano, scene, valid) == pytest.approx(
        _scene_psnr(jpano, scene, valid), abs=0.05)
