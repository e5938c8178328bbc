"""K2's path against the JAX experiment ``experiments/remap_separable.py``
on the 2-camera 48x256 -> 16x128 case of its own test (same seed, same
maps: a monotone global x-map, a smooth +-2 px x perturbation, a -1
corner): the plan bit for bit, ``pass_h`` within 1.0 (bf16 product),
``pass_v_plain`` (the path a CPU tensor takes through ``pass_v``) within
1.5 of the TPU kernel in interpret mode and of the gather gold, exact
zeros in the invalid corner. Then the separable warp on a calibrated
6x320x180 global rig, its x-map derived from the state, within 2.0 of
K1's plain path (the bf16 bound the JAX package states for K1's TPU
kernel, ops/remap_strips.py:64-70)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.ops.remap import remap_planar as j_remap
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.experiments import remap_separable as sep
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips
from video_stitcher_tpu_torch.utils.synth import make_scene, render_views

_EXP = pathlib.Path(__file__).resolve().parents[1] / "experiments" \
    / "remap_separable.py"


def _load_jax_experiment():
    # loaded from its file: a sys.path insert would outlive this module
    spec = importlib.util.spec_from_file_location("_jax_remap_separable",
                                                  _EXP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsep = _load_jax_experiment()

SRC_H, SRC_W, BH, BW = 48, 256, 16, 128


def _mk(rng, src_h=SRC_H, src_w=SRC_W, bh=BH, bw=BW):
    """experiments/test_remap_separable.py::_mk, line for line."""
    frames = rng.integers(0, 255, (2, src_h, src_w, 3)).astype(np.uint8)
    xb = np.arange(bw, dtype=np.float64)
    fused = np.empty((2, 2, bh, bw), np.float32)
    gmx = np.empty((2, bw), np.float32)
    for i in range(2):
        mxg = 4.0 + (i + 1) * 0.02 + xb * (src_w - 10.0) / bw
        gmx[i] = mxg.astype(np.float32)
        gy = np.arange(bh, dtype=np.float64)[:, None]
        dx = 2.0 * np.sin(gy / 5.0 + i) * np.cos(xb[None] / 17.0)
        my = 3.0 + gy * (src_h - 8.0) / bh + 1.5 * np.sin(xb[None] / 23.0)
        fused[i, 0] = (mxg[None] + dx).astype(np.float32)
        fused[i, 1] = np.broadcast_to(my, (bh, bw)).astype(np.float32)
    fused[0, :, :4, :8] = -1.0
    return frames, fused, gmx


@pytest.fixture(scope="module")
def case():
    frames, fused, gmx = _mk(np.random.default_rng(1234))
    jplan = jsep.plan_separable(fused, gmx, SRC_H, SRC_W)
    plan = sep.plan_separable(fused, gmx, SRC_H, SRC_W)
    src = sep.source_planar(torch.from_numpy(frames), plan.i1_hp)
    src_j = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16)
    wx_j = jnp.asarray(jplan.wx).astype(jnp.bfloat16)
    i1_j = jsep.pass_h(src_j, wx_j)
    return dict(frames=frames, fused=fused, gmx=gmx, plan=plan,
                jplan=jplan, src=src, i1_j=i1_j,
                i1=torch.from_numpy(np.asarray(i1_j, np.float32)
                                    ).to(torch.bfloat16))


def test_plan_is_bit_equal_to_jax(case):
    plan, jplan = case["plan"], case["jplan"]
    np.testing.assert_array_equal(plan.wx, jplan.wx)
    np.testing.assert_array_equal(plan.vmaps, jplan.vmaps)
    assert (plan.i1_hp, plan.bh_p, plan.bw_p) == (jplan.i1_hp, jplan.bh_p,
                                                  jplan.bw_p)


def test_pass_h_matches_jax(case):
    plan = case["plan"]
    i1 = sep.pass_h(case["src"], torch.from_numpy(plan.wx).to(
        torch.bfloat16))
    ref = np.asarray(case["i1_j"], np.float32)
    assert i1.dtype == torch.bfloat16 and tuple(i1.shape) == ref.shape
    assert i1.shape[3] == BW + sep.XPAD + sep.LANE_PAD_R
    np.testing.assert_allclose(i1.float().numpy(), ref, atol=1.0, rtol=0)
    # the halo lanes are zero
    assert float(i1[..., :sep.XPAD].abs().max()) == 0.0
    assert float(i1[..., sep.XPAD + BW:].abs().max()) == 0.0


def test_pass_v_plain_matches_the_tpu_kernel_in_interpret_mode(case):
    """Measured: max abs 0.0 on this case (the kernel's bf16 x weights
    and f32 y weights are reproduced exactly); the bound is 1.5."""
    jplan, plan = case["jplan"], case["plan"]
    ref = np.asarray(jsep.pass_v(
        case["i1_j"], jnp.asarray(jplan.vmaps), jnp.asarray(jplan.strip_off),
        jnp.asarray(jplan.chunk_row), sh=jplan.sh, whc=jplan.whc,
        interpret=True))
    out = sep.pass_v(case["i1"], torch.from_numpy(plan.vmaps)).numpy()
    assert out.shape == ref.shape == (2, 3, BH, BW)
    np.testing.assert_allclose(out, ref, atol=1.5, rtol=0)


def test_pass_v_plain_matches_the_gather_gold(case):
    plan = case["plan"]
    out = sep.pass_v_plain(case["i1"], torch.from_numpy(plan.vmaps)).numpy()
    i1 = case["i1"].float().numpy()
    for i in range(2):
        gold = np.asarray(j_remap(
            jnp.asarray(i1[i][:, :, sep.XPAD:sep.XPAD + BW]),
            jnp.asarray(plan.vmaps[i, 0]), jnp.asarray(plan.vmaps[i, 1]),
            border="constant"))
        np.testing.assert_allclose(out[i], gold, atol=1.5, rtol=0)


def test_invalid_corner_is_exactly_zero(case):
    plan = case["plan"]
    assert np.all(plan.vmaps[0, :, :4, :8] == -2.0)
    out = sep.warp_separable(case["src"], torch.from_numpy(plan.wx).to(
        torch.bfloat16), torch.from_numpy(plan.vmaps))
    assert float(out[0, :, :4, :8].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0


def test_plan_rejects_a_residual_past_the_halo(case):
    fused = case["fused"].copy()
    fused[1, 0, 5, 60] += 20.0 * (SRC_W - 10.0) / BW
    with pytest.raises(ValueError, match="XPAD"):
        sep.plan_separable(fused, case["gmx"], SRC_H, SRC_W)
    with pytest.raises(ValueError, match="XPAD"):
        jsep.plan_separable(fused, case["gmx"], SRC_H, SRC_W)


def test_plan_rejects_unpadded_maps(case):
    with pytest.raises(ValueError, match="padded"):
        sep.plan_separable(case["fused"][:, :, :, :100],
                           case["gmx"][:, :100], SRC_H, SRC_W)


def test_global_x_map_checks_its_precondition(case):
    fused = np.stack([case["fused"][1]] * 2)
    fused[:, 0] = case["gmx"][1]                         # pure yaw
    np.testing.assert_array_equal(sep.global_x_map(fused)[0],
                                  case["gmx"][1])
    with pytest.raises(ValueError, match="pure-yaw"):
        sep.global_x_map(case["fused"])                  # x varies by row
    with pytest.raises(ValueError, match="rise strictly"):
        sep.global_x_map(fused[:, :, :, ::-1])
    fused[:, :, :, :3] = -1.0                            # left the frustum
    with pytest.raises(ValueError, match="rise strictly"):
        sep.global_x_map(fused)


def test_pass_v_checks_its_inputs(case):
    i1, vmaps = case["i1"], torch.from_numpy(case["plan"].vmaps)
    with pytest.raises(ValueError, match="XPAD"):
        sep.pass_v(i1[..., :-1], vmaps)
    with pytest.raises(ValueError, match="maps"):
        sep.pass_v(i1[:1], vmaps)
    with pytest.raises(TypeError, match="bfloat16"):
        sep.pass_v(i1.float(), vmaps)
    with pytest.raises(ValueError, match="no K2 kernel"):
        sep.pass_v(i1.to("meta"), vmaps.to("meta"))


@pytest.fixture(scope="module")
def ring():
    cfg = StitcherConfig(num_images=6, input_width=320, input_height=180,
                         enable_local=False)
    st = Stitcher(cfg, device="cpu")
    from video_stitcher_tpu_torch.calib.calibration import plan_geometry
    geom, _ = plan_geometry(cfg)
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(cfg, geom, scene)
    st.calibrate(frames)
    return st, frames


def test_separable_warp_matches_k1_on_a_calibrated_rig(ring):
    st, frames = ring
    fused = st.state.fused_maps.numpy()
    n, _, bh, bw = fused.shape
    maps_p, gmx_p = sep.pad_maps(fused, sep.global_x_map(fused))
    plan = sep.plan_separable(maps_p, gmx_p, st.geom.src_h, st.geom.src_w)
    assert (plan.bh_p, plan.bw_p) == (288, 384) and plan.i1_hp == 192
    # the global path: every valid pixel reads its own band column
    valid = plan.vmaps[:, 0, :bh, :bw] > -1
    np.testing.assert_array_equal(
        plan.vmaps[:, 0, :bh, :bw][valid],
        np.broadcast_to(np.arange(bw, dtype=np.float32), valid.shape)[valid])
    f = torch.from_numpy(frames)
    bands = sep.warp_separable(sep.source_planar(f, plan.i1_hp),
                               torch.from_numpy(plan.wx).to(torch.bfloat16),
                               torch.from_numpy(plan.vmaps))
    gains = st.state.gains
    got = torch.clamp(bands[:, :, :bh, :bw] * gains[:, None, None, None],
                      0.0, 255.0)
    want = remap_strips(f.permute(0, 3, 1, 2).contiguous(),
                        st.state.fused_maps, gains)
    err = float((got - want).abs().max())
    assert err <= 2.0, err
    print('max abs vs K1', err)
    assert float(bands[:, :, :, bw:].abs().max()) == 0.0   # padded columns
