"""The int16 parity twin of the port against the JAX package's and cv2.

- ``ops/pyramid_int.py``: pyr_down_i16, pyr_up_i16 and
  laplacian_pyramid_i16 bit-equal to the JAX functions and to
  cv2.pyrDown / cv2.pyrUp on int16 input with negatives, at
  tests/test_reference_int16.py's shapes and odd ones.
- ``blend_bands_int16``: within 1 of the JAX blend with >= 99% of pixels
  equal, on test_reference_int16.py's full-canvas 64x128 rig and its
  wrapping 2-camera ring. The f32 weight pyramid sums its taps in
  another order than JAX's "highest" einsum, so a trunc can flip by one
  at a boundary (the cause test_reference_int16.py states against cv2).
  Against the port's own f32 blend it sits in the reference's
  integer-vs-float band (35-50 dB).
- ``Stitcher.stitch_int16`` against the JAX one on the 6x320x180 ring at
  compose scale 0.72, both packages calibrating for themselves (the JAX
  one op by op), with state_global and with a live state whose maps carry
  a smooth displacement: within 3 with >= 99% of valid pixels equal.
- ``ops/filters.py``: gaussian_blur within 1e-5 of the JAX function.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.blend import multiband as jmb
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.geometry.cylindrical import BandLayout as JLayout
from video_stitcher_tpu.ops import filters as jfilters
from video_stitcher_tpu.ops import pyramid_int as jpi
from video_stitcher_tpu.utils.synth import make_scene, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.blend import multiband as tmb
from video_stitcher_tpu_torch.geometry.cylindrical import BandLayout
from video_stitcher_tpu_torch.ops import filters as tfilters
from video_stitcher_tpu_torch.ops import pyramid_int as tpi
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips

DOWN_SHAPES = ((16, 24), (30, 42), (64, 128), (15, 21), (17, 23))
UP_SHAPES = ((8, 12), (15, 21), (32, 64), (9, 13))
RING = dict(num_images=6, input_width=320, input_height=180,
            compose_megapix=0.03, enable_local=False, recalibrate=False)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("hw", DOWN_SHAPES)
def test_pyr_down_i16_bit_equal_jax_and_cv2(rng, hw):
    x = rng.integers(-3000, 3000, hw).astype(np.int16)
    got = tpi.pyr_down_i16(_t(x[None])).numpy()[0]
    assert got.dtype == np.int32
    want = np.asarray(jpi.pyr_down_i16(x[None]))[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.pyrDown(x).astype(np.int32))


@pytest.mark.parametrize("hw", UP_SHAPES)
def test_pyr_up_i16_bit_equal_jax_and_cv2(rng, hw):
    x = rng.integers(-8000, 8000, hw).astype(np.int16)
    got = tpi.pyr_up_i16(_t(x[None])).numpy()[0]
    want = np.asarray(jpi.pyr_up_i16(x[None]))[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.pyrUp(x).astype(np.int32))
    # an explicit odd output size, as the Laplacian pyramid asks for
    oh, ow = 2 * hw[0] - 1, 2 * hw[1] - 1
    np.testing.assert_array_equal(
        tpi.pyr_up_i16(_t(x[None]), oh, ow).numpy()[0],
        cv2.pyrUp(x, dstsize=(ow, oh)).astype(np.int32))


@pytest.mark.parametrize("hw", [(64, 128), (45, 77)])
def test_laplacian_pyramid_i16_bit_equal_jax_and_cv2(rng, hw):
    x = rng.integers(0, 256, (3,) + hw).astype(np.int16)
    got = [l.numpy() for l in tpi.laplacian_pyramid_i16(_t(x), 3)]
    want = [np.asarray(l) for l in jpi.laplacian_pyramid_i16(x, 3)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(int(g.min()) for g in got[:-1]) < 0     # negative bands
    gauss = [x[c] for c in range(3)]
    for lvl in range(3):
        down = [cv2.pyrDown(g) for g in gauss]
        up = [cv2.pyrUp(d, dstsize=(g.shape[1], g.shape[0]))
              for d, g in zip(down, gauss)]
        lap = np.stack([g.astype(np.int32) - u for g, u in zip(gauss, up)])
        np.testing.assert_array_equal(got[lvl], lap)
        gauss = down
    np.testing.assert_array_equal(got[3], np.stack(gauss))


def _canvas_rig(rng, nb):
    """test_reference_int16.py's full-canvas 2-image rig, 64x128."""
    h, w = 64, 128
    imgs = rng.integers(0, 256, (2, 3, h, w)).astype(np.float32)
    masks = np.zeros((2, h, w), np.float32)
    masks[0, :, : w // 2 + 5] = 1.0
    masks[1, :, w // 2 + 5:] = 1.0
    kw = dict(scale=1.0, pano_w=w, pano_h=h, v0=0.0, u0=0.0, band_w=w,
              band_h=h, corners=(0, 0), num_bands=nb, wrap=False, gap=0)
    return imgs, masks, kw, None


def _ring_rig(rng, nb=3):
    """test_reference_int16.py's 2-camera ring: bands 160 wide on a 256
    panorama, camera 1 wrapping x = 0 (two place_bands segments)."""
    h, pw, bw = 32, 256, 160
    imgs = rng.integers(0, 256, (2, 3, h, bw)).astype(np.float32)
    masks = np.zeros((2, h, bw), np.float32)
    masks[:, :, 16:144] = 1.0
    kw = dict(scale=1.0, pano_w=pw, pano_h=h, v0=0.0, u0=0.0, band_w=bw,
              band_h=h, corners=(0, pw // 2), num_bands=nb, wrap=True, gap=0)
    _, valid = jmb.build_weight_pyramids(masks, JLayout(**kw))
    return imgs, masks, kw, np.asarray(valid)


@pytest.mark.parametrize("rig,nb", [("canvas", 2), ("canvas", 4),
                                    ("ring", 3)])
def test_blend_bands_int16_matches_jax(rng, rig, nb):
    imgs, masks, kw, valid = (_canvas_rig(rng, nb) if rig == "canvas"
                              else _ring_rig(rng, nb))
    # non-integral, out-of-range band values exercise the rint and clip
    imgs = imgs + rng.uniform(-0.6, 0.6, imgs.shape).astype(np.float32)
    imgs[0, 0, :4] = -7.0
    imgs[1, 2, -4:] = 300.0
    want = np.asarray(jmb.blend_bands_int16(
        imgs, masks, JLayout(**kw), None if valid is None else valid))
    got = tmb.blend_bands_int16(
        _t(imgs), _t(masks), BandLayout(**kw),
        None if valid is None else _t(valid)).numpy()
    d = np.abs(got - want)
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 \
        and got.max() <= 255


def test_blend_int16_vs_f32_production_band(rng):
    """The twin against the port's own f32 blend: the reference's
    integer-vs-float band (test_reference_int16.py's bounds)."""
    imgs, masks, kw, valid = _ring_rig(rng)
    lay = BandLayout(**kw)
    wpyr, tvalid = tmb.build_weight_pyramids(_t(masks), lay)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    f32 = tmb.blend_bands(_t(imgs), wpyr, lay, tvalid).numpy()
    i16 = tmb.blend_bands_int16(_t(imgs), _t(masks), lay, tvalid).numpy()
    sel = np.broadcast_to(valid > 0, f32.shape)
    d = np.rint(f32[sel]) - i16[sel]
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(d * d))
    assert 35.0 < psnr < 50.0, psnr
    assert np.abs(d).mean() < 2.0
    assert (np.abs(d) <= 3).mean() > 0.85


def test_place_bands_raises_for_a_band_wider_than_its_panorama():
    lay = BandLayout(scale=1.0, pano_w=64, pano_h=8, v0=0.0, u0=0.0,
                     band_w=96, band_h=8, corners=(0, 32), num_bands=1,
                     wrap=True, gap=0)
    with pytest.raises(ValueError, match="does not fit"):
        tmb.place_bands(torch.zeros((2, 1, 8, 96)), lay, 0)
    with pytest.raises(ValueError, match="does not fit"):
        tmb.place_bands(torch.zeros((2, 1, 4, 48)), lay, 1)
    with pytest.raises(ValueError, match="does not fit"):
        tmb.place_bands(torch.zeros((2, 1, 8, 96)),
                        dataclasses.replace(lay, wrap=False), 0)


@pytest.fixture(scope="module")
def ring():
    jcfg = JConfig(**RING)
    geom, _ = j_plan(jcfg)
    assert 0.7 < geom.compose_scale < 0.75 and not geom.prewarp
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    jst = JStitcher(jcfg)
    with jax.disable_jit():
        jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**RING), device="cpu")
    st.calibrate(frames)
    # a live state beside the global one: both packages' maps with the
    # same smooth displacement (the kind a CPW mesh adds)
    maps = st.state.fused_maps.numpy()
    _, _, bh, bw = maps.shape
    gy = np.arange(bh)[:, None]
    gx = np.arange(bw)[None]
    disp = (1.5 * np.sin(gy / 7.0) * np.cos(gx / 11.0)).astype(np.float32)

    def moved(m):
        m = np.array(m)
        m[:, 0] = np.where(m[:, 0] > -1, m[:, 0] + disp, m[:, 0])
        return m
    jst.swap_state(jst.state._replace(
        fused_maps=jnp.asarray(moved(jst.state.fused_maps))))
    st.swap_state(st.state._replace(fused_maps=_t(moved(maps))))
    return dict(jst=jst, st=st, frames=frames)


@pytest.mark.parametrize("which", ["state_global", "live"])
def test_stitch_int16_matches_jax(ring, which):
    st, jst, frames = ring["st"], ring["jst"], ring["frames"]
    kw = {} if which == "live" else {"state": st.state_global}
    jkw = {} if which == "live" else {"state": jst.state_global}
    before = remap_strips.launches
    pano = st.stitch_int16(frames, **kw)
    assert remap_strips.launches == before       # CPU: the plain version
    jpano = np.asarray(jst.stitch_int16(frames, **jkw))
    assert pano.shape == jpano.shape and pano.dtype == np.uint8
    valid = st.state.valid_mask.numpy() > 0
    d = np.abs(pano.astype(np.int32) - jpano.astype(np.int32))[valid]
    assert d.max() <= 3, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    # the global and the live states give different panoramas
    other = st.stitch_int16(frames, **({"state": st.state_global}
                                       if which == "live" else {}))
    assert not np.array_equal(pano, other)


def test_stitch_int16_of_the_live_state_is_the_default(ring):
    st, frames = ring["st"], ring["frames"]
    np.testing.assert_array_equal(st.stitch_int16(frames),
                                  st.stitch_int16(frames, state=st.state))


@pytest.mark.parametrize("hw,ksize,sigma", [((31, 45), 5, 0.0),
                                            ((32, 48), 7, 1.3),
                                            ((9, 8), 3, 0.0)])
def test_gaussian_blur_matches_jax(rng, hw, ksize, sigma):
    x = rng.uniform(0, 255, (2, 3) + hw).astype(np.float32)
    assert tfilters.gaussian_kernel(ksize, sigma) == \
        jfilters.gaussian_kernel(ksize, sigma)
    got = tfilters.gaussian_blur(_t(x), ksize, sigma).numpy()
    want = np.asarray(jfilters.gaussian_blur(x, ksize, sigma))
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
