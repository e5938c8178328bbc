"""The port's multiband blend against the JAX package's: band placement
with ring wrap and crop exact, weight pyramids within 1e-5, the f32 blend
within 0.05, and bf16 pyramid storage equal to the JAX package's bf16
blend, on the warped bands of the 6x320x180 rig. And the blend's kernels
(blend/levels.py): their plain versions bit-equal to the chain of plain
pyramid helpers they replace, their input checks, and the tap windows
their tiles assume."""

import dataclasses
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
from video_stitcher_tpu_torch.blend import levels
from video_stitcher_tpu_torch.blend import multiband as tmb
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.ops.pyramid import (
    _down_matrix, _up_matrix, gaussian_pyramid, laplacian_pyramid, pyr_up,
    storage_dtype,
)
from video_stitcher_tpu_torch.ops.resize import matrix_taps

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


# --- the blend's kernels (blend/levels.py) --------------------------------

PRECISIONS = ("bf16", "highest")


def _layout(rig, size):
    """The ring's or the pair's layout; "odd": band and panorama sizes
    made odd, so that every level rounds and a level's ceil and floor
    differ (the ring's corners still put a band across the wrap seam)."""
    lay = plan_geometry(StitcherConfig(**(RING if rig == "ring" else PAIR))
                        )[0].layout
    if size == "odd":
        lay = dataclasses.replace(lay, band_w=lay.band_w - 3,
                                  band_h=lay.band_h - 5,
                                  pano_w=lay.pano_w - 1)
    return lay


def _inputs(rig, size, ring):
    """(bands f32 [N, 3, bh, bw], weight pyramid, valid, layout): the ring
    fixture's warped bands, weights and mask for the ring as planned, else
    values drawn from a seed at the layout's shapes."""
    lay = _layout(rig, size)
    if rig == "ring" and size == "aligned":
        st, bands = ring
        assert repr(st.geom.layout) == repr(lay)   # the JAX package's type
        return (_t(bands), [_t(np.asarray(w)) for w in st.state.weight_pyr],
                _t(np.asarray(st.state.valid_mask)), lay)
    rng = np.random.default_rng(22)
    n = len(lay.corners)
    bands = rng.uniform(0, 255, (n, 3, lay.band_h, lay.band_w))
    wp = [torch.from_numpy(rng.uniform(0, 1, tuple(x.shape)).astype(
        np.float32)) for x in gaussian_pyramid(
            torch.zeros((n, 1, lay.band_h, lay.band_w)), lay.num_bands)]
    valid = rng.uniform(0, 1, (lay.band_h, lay.pano_w)) > 0.1
    return (torch.from_numpy(bands.astype(np.float32)), wp,
            torch.from_numpy(valid.astype(np.float32)), lay)


def _chain(bands, wp, lay, precision, valid, corners=None):
    """The blend as the port ran it before the kernels: laplacian_pyramid,
    the product with the weights in the storage dtype, place_bands, and
    the collapse through pyr_up (levels and panorama)."""
    dt = storage_dtype(precision)
    lap = laplacian_pyramid(bands, lay.num_bands, precision)
    acc = [tmb.place_bands(lap[lvl] * wp[lvl].to(dt), lay, lvl, corners)
           for lvl in range(lay.num_bands + 1)]
    out, outs = acc[-1], [acc[-1]]
    for lvl in range(lay.num_bands - 1, -1, -1):
        out = acc[lvl].to(torch.float32) + pyr_up(
            out, acc[lvl].shape[-2], acc[lvl].shape[-1], precision,
            out_dtype=torch.float32)
        if precision == "bf16" and lvl > 0:
            out = out.to(dt)
        outs.insert(0, out)
    outs[0] = out.to(torch.float32) * valid[None]
    return acc, outs


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("size", ["aligned", "odd"])
@pytest.mark.parametrize("rig", ["ring", "pair"])
def test_blend_kernels_plain_versions_equal_the_chain(rig, size, precision,
                                                      ring):
    """Each kernel's plain version, level by level on the chain's own
    inputs, and the blend through them (weighted_levels, collapse_levels,
    a camera shard with its corners too) bit-equal to the chain of plain
    pyramid helpers; on the CPU no launch is counted."""
    bands, wp, valid, lay = _inputs(rig, size, ring)
    nb = lay.num_bands
    acc, outs = _chain(bands, wp, lay, precision, valid)
    gauss = gaussian_pyramid(bands, nb, precision)
    counts = [k.launches for k in levels.KERNELS]
    for lvl in range(nb):
        _equal(levels.down_plain(gauss[lvl] if lvl else bands, precision),
               gauss[lvl + 1])
    for lvl in range(nb + 1):
        _equal(levels.lap_place_plain(
            bands if lvl == 0 else gauss[lvl],
            gauss[lvl + 1] if lvl < nb else None, wp[lvl], lay, lvl,
            None, precision), acc[lvl])
    for lvl in range(nb):
        _equal(levels.collapse_plain(acc[lvl], outs[lvl + 1], precision,
                                     lvl == 0, valid), outs[lvl])
    got = tmb.weighted_levels(bands, wp, lay, precision)
    for a, b in zip(got, acc):
        _equal(a, b)
    _equal(tmb.collapse_levels(got, precision, valid), outs[0])
    lo, hi = 1, max(2, len(lay.corners) // 2 + 1)
    shard = tmb.weighted_levels(bands[lo:hi], [w[lo:hi] for w in wp], lay,
                                precision, lay.corners[lo:hi])
    want, _ = _chain(bands[lo:hi], [w[lo:hi] for w in wp], lay, precision,
                     valid, lay.corners[lo:hi])
    for a, b in zip(shard, want):
        _equal(a, b)
    assert [k.launches for k in levels.KERNELS] == counts


def test_blend_kernels_check_their_inputs():
    """A CPU tensor takes the plain version; another device, a dtype or a
    shape the kernels do not take raises."""
    lay = _layout("ring", "aligned")
    n, h, w = len(lay.corners), lay.band_h, lay.band_w
    g = torch.zeros((n, 3, h, w))
    g1 = torch.zeros((n, 3, h // 2, w // 2), dtype=torch.bfloat16)
    wt = torch.zeros((n, 1, h, w))
    pw = lay.pano_w
    place = (lay, 0, None, "bf16")
    assert levels.down(g, "bf16").shape == g1.shape
    assert levels.lap_place(g, g1, wt, *place).shape == (3, h, pw)
    acc = torch.zeros((3, h, pw), dtype=torch.bfloat16)
    acc1 = torch.zeros((3, h // 2, pw // 2), dtype=torch.bfloat16)
    assert levels.collapse(acc, acc1, "bf16", True, torch.ones((h, pw))
                           ).dtype == torch.float32
    with pytest.raises(ValueError, match="no down kernel"):
        levels.down(g.to("meta"), "bf16")
    with pytest.raises(ValueError, match="no lap_place kernel"):
        levels.lap_place(g.to("meta"), g1.to("meta"), wt.to("meta"), *place)
    with pytest.raises(ValueError, match="no collapse kernel"):
        levels.collapse(acc.to("meta"), acc1.to("meta"), "bf16")
    with pytest.raises(TypeError, match="dtype"):
        levels.down(g.half(), "bf16")
    with pytest.raises(TypeError, match="dtype"):
        levels.down(g1, "highest")                 # bf16 under f32 storage
    with pytest.raises(ValueError, match=r"want x \[N, C, h, w\]"):
        levels.down(g[0], "bf16")
    with pytest.raises(TypeError, match="weight dtype"):
        levels.lap_place(g, g1, wt.double(), *place)
    with pytest.raises(ValueError, match="weight"):
        levels.lap_place(g, g1, wt[:, :, 1:], *place)
    with pytest.raises(ValueError, match="g_next"):
        levels.lap_place(g, g1[:, :, 1:], wt, *place)
    with pytest.raises(TypeError, match="g_next dtype"):
        levels.lap_place(g, g1.float(), wt, *place)
    with pytest.raises(ValueError, match="corners for"):
        levels.lap_place(g, g1, wt, lay, 0, lay.corners[1:], "bf16")
    narrow = (n, 3, h, w - 2)                      # narrower than its band
    with pytest.raises(ValueError, match="does not fit"):
        levels.lap_place(torch.zeros(narrow), None,
                         torch.zeros((n, 1, h, w - 2)), lay, 0, None, "bf16")
    with pytest.raises(TypeError, match="acc dtype"):
        levels.collapse(acc.float(), acc1, "bf16")
    with pytest.raises(ValueError, match="does not go up"):
        levels.collapse(acc, acc1[:, :, :-2], "bf16")
    with pytest.raises(ValueError, match="valid"):
        levels.collapse(acc, acc1, "bf16", True, torch.ones((h, pw - 1)))


def test_the_kernels_tap_windows_hold():
    """The kernels' tiles keep the rows a pass reads in shared memory:
    down's output o reads input [2o - 2, 2o + 2], pyrUp's output o reads
    next-level [o // 2 - 1, o // 2 + 1] (the next level half the size,
    rounded either way), at most 5 and 3 taps, and each row's first tap
    has a weight (padding of weight 0 comes last)."""
    for n in list(range(1, 130)) + [640, 1280, 1664, 4928]:
        for m, lo, width, most in (
                [(_down_matrix(n), lambda o: 2 * o - 2, 4, 5)]
                + [(_up_matrix(k, n), lambda o: o // 2 - 1, 2, 3)
                   for k in {n // 2, (n + 1) // 2} if k >= 1]):
            idx, w = matrix_taps(m)
            assert idx.shape[0] <= most
            o = np.arange(m.shape[0])
            assert (w[0] != 0).all()
            nz = w != 0
            assert (np.diff(nz.astype(int), axis=0) <= 0).all()
            start = lo(o)[None].repeat(idx.shape[0], 0)
            assert ((idx >= start) & (idx <= start + width))[nz].all(), n
