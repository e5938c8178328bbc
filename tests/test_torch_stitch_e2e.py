"""End to end: both packages stitch the same frames from one calibration,
handed across as arrays (``interop.state_from_numpy``) or as a checkpoint
written by either package. The panoramas agree within 3/255 max abs (the
reference's CUDA-vs-CPU bound, BASELINE.md:22) and score >= 40 dB against
the synthetic scene. Covers stitch, stitch_nv12, stitch_out, stitch_batch
and output, on the 6x320x180 ring and a 2-camera partial rig, and the
port's own calibration also on a 4x640x360 ring at compose scale 0.72 in
both map conventions. A state swapped in during stitch_batch does not
reach the batch that was already running.

The JAX package's own end-to-end suite (tests/test_stitch_e2e.py) runs
on the port too, each case on its rig and seed with its own bound, and
the port held against the JAX package on the same inputs: psnr, no
black seams, the gains recovered, the weight pyramids' partition of
unity, the bf16 blend against f32, a loaded calibration that re-solves,
the output aspect, the two-camera feather rig, the fused stitch_out
against the two-step path, the non-wrapping partial rings and the
minified prewarp from RGB and NV12. Its strip-path cases test the TPU
strip planner, which is not ported by design."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.blend import multiband as j_multiband
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.ops.pyramid import gaussian_pyramid as j_gaussian
from video_stitcher_tpu.ops.color import rgb_to_nv12
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.blend.multiband import (
    WEIGHT_EPS, blend_bands, place_bands,
)
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.ops.pyramid import gaussian_pyramid
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


# --- the JAX package's end-to-end suite (tests/test_stitch_e2e.py) ---------------

SEED_PSNR = 30.0       # tests/test_stitch_e2e.py's bound on its rigs


def _central(pano, gt, valid):
    h = pano.shape[0]
    sel = valid[h // 4:3 * h // 4]
    assert sel.any()
    return psnr(pano[h // 4:3 * h // 4][sel], gt[h // 4:3 * h // 4][sel])


def _both_calibrated(kw, seed, gains=None, smooth=None):
    """The rig's scene and views (tests/test_stitch_e2e.py's rendering),
    calibrated by the port and, op by op, by the JAX package."""
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(seed)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng,
                       **({} if smooth is None else {"smooth": smooth}))
    frames = render_views(jcfg, geom, scene,
                          **({} if gains is None else {"gains": gains}))
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**kw), device="cpu")
    st.calibrate(frames)
    return st, jst, geom, scene, frames


@pytest.fixture(scope="module")
def small_stitch():
    """tests/test_stitch_e2e.py's small_stitch: the 6x320x180 ring, scene
    seed 7, each package calibrating for itself."""
    st, jst, geom, scene, frames = _both_calibrated(RING, 7)
    return dict(st=st, jst=jst, geom=geom, scene=scene, frames=frames,
                pano=st.stitch(frames), jpano=jst.stitch(frames))


def test_e2e_psnr(small_stitch):
    """tests/test_stitch_e2e.py:40."""
    s = small_stitch
    valid = s["st"].state.valid_mask.numpy() > 0
    gt = np.moveaxis(s["scene"], 0, -1)
    assert _central(s["pano"], gt, valid) > SEED_PSNR
    assert _diff(s["pano"], s["jpano"]) <= MAX_ABS


def test_e2e_no_black_seams(small_stitch):
    """tests/test_stitch_e2e.py:53: inside the valid region, no near-zero
    holes in the central rows, for either package."""
    s = small_stitch
    h = s["geom"].pano_h
    vsel = (s["st"].state.valid_mask.numpy() > 0)[h // 4:3 * h // 4]
    for pano in (s["pano"], s["jpano"]):
        dark = (pano[h // 4:3 * h // 4].max(axis=-1) < 5) & vsel
        assert dark.mean() < 1e-4


def test_gain_compensation_recovered():
    """tests/test_stitch_e2e.py:64: views rendered at different exposures;
    the solved gains flatten them (and equal the JAX package's), and the
    stitched exposure stays within 10% of the scene's."""
    gains_true = np.array([1.0, 0.8, 1.2, 0.9, 1.1, 1.0])
    st, jst, geom, scene, frames = _both_calibrated(RING, 7,
                                                    gains=gains_true)
    solved = st.state.gains.numpy()
    np.testing.assert_allclose(solved, np.asarray(jst.state.gains),
                               rtol=1e-4)
    ratio = solved * gains_true
    assert ratio.std() / ratio.mean() < 0.05
    pano = st.stitch(frames)
    assert _diff(pano, jst.stitch(frames)) <= MAX_ABS
    valid = st.state.valid_mask.numpy() > 0
    h = geom.pano_h
    sel = valid[h // 4:3 * h // 4]
    p = pano[h // 4:3 * h // 4][sel].mean()
    g = np.moveaxis(scene, 0, -1)[h // 4:3 * h // 4][sel].mean()
    assert abs(p - g) / g < 0.1


def test_weight_pyramids_partition_of_unity(small_stitch):
    """tests/test_stitch_e2e.py:87: the placed normalised weights are
    total / (total + eps) of the raw ones, ~1 where the raw total is not
    vanishing; the port's placed weights equal the JAX package's."""
    s = small_stitch
    st, jst, lay = s["st"], s["jst"], s["geom"].layout
    raw = gaussian_pyramid(st.aux["weights0"][:, None], lay.num_bands)
    jraw = j_gaussian(jnp.asarray(jst.aux["weights0"])[:, None],
                      lay.num_bands)
    for lvl, (w, jw) in enumerate(zip(st.state.weight_pyr,
                                      jst.state.weight_pyr)):
        total = place_bands(raw[lvl], lay, lvl)[0].numpy()
        replaced = place_bands(w, lay, lvl)[0].numpy()
        np.testing.assert_allclose(replaced, total / (total + WEIGHT_EPS),
                                   atol=1e-4)
        sel = total > 0.1
        assert sel.any()
        np.testing.assert_allclose(replaced[sel], 1.0, atol=1e-3)
        jtotal = np.asarray(j_multiband.place_bands(jraw[lvl], lay, lvl))[0]
        np.testing.assert_allclose(total, jtotal, atol=1e-4)
        np.testing.assert_allclose(replaced, np.asarray(
            j_multiband.place_bands(jw, lay, lvl))[0], atol=1e-4)


def test_blend_bf16_storage_matches_f32(small_stitch):
    """tests/test_stitch_e2e.py:138: on white-noise bands the bf16-stored
    blend is >= 40 dB from the f32 chain; with the JAX package's weights
    the port's f32 blend is within 1e-3 of the JAX blend, and its bf16
    blend equal to it."""
    s = small_stitch
    st, jst, lay = s["st"], s["jst"], s["geom"].layout
    rng = np.random.default_rng(11)
    bands = rng.uniform(0, 255, (6, 3, lay.band_h, lay.band_w)
                        ).astype(np.float32)
    tb = torch.from_numpy(bands)
    f32 = blend_bands(tb, st.state.weight_pyr, lay, st.state.valid_mask,
                      "highest").numpy()
    b16 = blend_bands(tb, st.state.weight_pyr, lay, st.state.valid_mask,
                      "bf16").numpy()
    sel = st.state.valid_mask.numpy() > 0
    assert psnr(np.clip(f32[:, sel], 0, 255),
                np.clip(b16[:, sel], 0, 255)) >= 40.0
    jw = [torch.from_numpy(np.array(w)) for w in jst.state.weight_pyr]
    jvalid = torch.from_numpy(np.array(jst.state.valid_mask))
    for precision, tol in (("highest", 1e-3), ("bf16", 0.0)):
        ours = blend_bands(tb, jw, lay, jvalid, precision).numpy()
        theirs = np.asarray(j_multiband.blend_bands(
            jnp.asarray(bands), jst.state.weight_pyr, lay,
            jst.state.valid_mask, precision))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol,
                                   err_msg=precision)


def test_loaded_calibration_supports_recalib(tmp_path):
    """tests/test_stitch_e2e.py:171: a loaded meshed calibration rebuilds
    its aux (the weights equal the calibrating stitcher's, and the JAX
    package's rebuild from the same file), stitches like the JAX package
    loading it, and re-solves the mesh, also with update_masks."""
    kw = dict(num_images=6, input_width=320, input_height=180,
              enable_local=True, recalibrate=False)
    cfg = StitcherConfig(**kw)
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng,
                       smooth=4)
    frames = render_views(jcfg, geom, scene)
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)
    path = str(tmp_path / "calib.npz")
    st.save_calibration(path)
    st2 = Stitcher(cfg, device="cpu")
    st2.load_calibration(path)
    for k in ("band_maps", "weights0", "cams_compose", "overlap_masks"):
        assert k in st2.aux, k
    np.testing.assert_allclose(st2.aux["weights0"].numpy(),
                               st.aux["weights0"].numpy(), atol=1e-5)
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.load_calibration(path)
    np.testing.assert_allclose(st2.aux["weights0"].numpy(),
                               np.asarray(jst.aux["weights0"]), atol=1e-5)
    assert _diff(st2.stitch(frames), jst.stitch(frames)) <= MAX_ABS
    assert st2.recalibrate_mesh(frames), "re-solve failed on a loaded state"
    st2.cfg = dataclasses.replace(cfg, update_masks=True)
    assert st2.recalibrate_mesh(frames)
    assert st2.stitch(frames).shape == (geom.pano_h, geom.pano_w, 3)


def test_output_frame_aspect(small_stitch):
    """tests/test_stitch_e2e.py:204: the output is output_width wide and
    at most output_height tall, as the JAX package's of the same pano."""
    s = small_stitch
    out = s["st"].output(s["pano"])
    cfg = s["st"].cfg
    assert out.shape[1] == cfg.output_width
    assert out.shape[0] <= cfg.output_height
    assert _diff(out, s["jst"].output(s["pano"])) <= MAX_ABS


def test_stitch_out_fused_matches_two_step(small_stitch):
    """tests/test_stitch_e2e.py:264: the fused blend+resize is within 3
    (mean under 0.2) of output(stitch(frames)), and within 3 of the JAX
    package's stitch_out."""
    s = small_stitch
    st = s["st"]
    fused = st.stitch_out(s["frames"])
    ref = st.output(s["pano"])
    assert fused.shape == ref.shape
    diff = np.abs(fused.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 3 and diff.mean() < 0.2, (diff.max(), diff.mean())
    assert _diff(fused, s["jst"].stitch_out(s["frames"])) <= MAX_ABS


#: tests/test_stitch_e2e.py's other rigs: (config, scene seed)
SEED_RIGS = {
    "two_cam_feather": (dict(num_images=2, wrap_around=False,
                             input_width=320, input_height=180,
                             yaws=(0.0, math.pi / 3), blend_type="feather",
                             enable_local=False, recalibrate=False), 13),
    "nonwrap_partial_ring": (dict(num_images=3, wrap_around=False,
                                  input_width=320, input_height=180,
                                  yaws=(0.0, 2 * math.pi / 6,
                                        4 * math.pi / 6),
                                  enable_local=False, recalibrate=False), 11),
    "nonwrap_weight_coverage": (dict(num_images=3, input_width=320,
                                     input_height=180, wrap_around=False,
                                     yaws=(0.0, 0.6, 1.2),
                                     enable_local=False,
                                     recalibrate=False), 3),
    "prewarp_minified": (dict(num_images=6, input_width=640,
                              input_height=360, compose_megapix=0.04,
                              enable_local=False, recalibrate=False), 3),
}


@pytest.mark.parametrize("rig", list(SEED_RIGS))
def test_seed_rig_stitches_like_jax(rig):
    """tests/test_stitch_e2e.py:211 (BASELINE config 1: two cameras,
    feather blend), :278 (a 3-camera partial ring on a non-periodic
    pano), :335 (the non-wrap weights land on the pano: coverage > 0.9)
    and :314 (compose scale < 0.5: the fused maps stay in compose
    coordinates and the source is resized first): > 30 dB against the
    scene (pano col x at cylinder u0 + x), within 3 of the JAX pano."""
    kw, seed = SEED_RIGS[rig]
    st, jst, geom, scene, frames = _both_calibrated(kw, seed)
    lay = geom.layout
    if rig == "two_cam_feather":
        assert geom.blend_type == "feather"
    if rig.startswith("nonwrap"):
        assert not lay.wrap and lay.u0 != 0
    if rig == "prewarp_minified":
        assert geom.prewarp and geom.warp_src_w == geom.compose_w
    pano = st.stitch(frames)
    assert _diff(pano, jst.stitch(frames)) <= MAX_ABS
    valid = st.state.valid_mask.numpy() > 0
    gt = np.roll(np.moveaxis(scene, 0, -1), -int(round(lay.u0)), axis=1)
    assert _central(pano, gt, valid) > SEED_PSNR
    if rig == "nonwrap_weight_coverage":
        total = place_bands(st.aux["weights0"][:, None], lay, 0)[0].numpy()
        assert float((total[valid] > 0.5).mean()) > 0.9


def test_e2e_prewarp_nv12():
    """tests/test_stitch_e2e.py:367: NV12 in under prewarp agrees with the
    RGB-fed pano to > 35 dB, and with the JAX package's stitch_nv12."""
    kw, seed = SEED_RIGS["prewarp_minified"]
    st, jst, _, _, frames = _both_calibrated(kw, seed)
    nv = np.stack([np.asarray(rgb_to_nv12(f)) for f in frames])
    a = st.stitch_nv12(nv)
    b = st.stitch(frames)
    assert a.shape == b.shape
    assert psnr(a, b) > 35.0
    assert _diff(a, jst.stitch_nv12(nv)) <= MAX_ABS
