"""Gold tests of the port's ops against OpenCV, as tests/test_ops_gold.py
holds the JAX package's: the same inputs (the `rng` fixture's seed), the
same cv2 calls and the same tolerances, through the port's functions on
CPU tensors.

Left out: test_ops_gold.py's banded-tile twin of the fused NV12
conversion (`_BAND_THRESHOLD` tiling is TPU layout; the port applies the
same matrices through their nonzero taps only)."""

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch.ops import (
    color, dilate3x3, pyr_down, pyr_up, remap, resize,
)
from video_stitcher_tpu_torch.ops.pyramid import (
    collapse_laplacian, laplacian_pyramid,
)

BORDER_MAP = {
    "constant": cv2.BORDER_CONSTANT,
    "replicate": cv2.BORDER_REPLICATE,
    "reflect": cv2.BORDER_REFLECT,
    "reflect101": cv2.BORDER_REFLECT_101,
    "wrap": cv2.BORDER_WRAP,
}


def _rand_img(rng, h=37, w=53, c=3):
    return rng.integers(0, 256, (h, w, c)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("border",
                         ["constant", "replicate", "reflect", "reflect101"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_remap_vs_cv2(rng, border, interp):
    img = _rand_img(rng)
    h, w = img.shape[:2]
    mx = (rng.random((29, 31)).astype(np.float32) * (w + 16)) - 8
    my = (rng.random((29, 31)).astype(np.float32) * (h + 16)) - 8
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_NEAREST
    gold = cv2.remap(img, mx, my, flag, borderMode=BORDER_MAP[border],
                     borderValue=(0, 0, 0))
    got = remap(_t(img), _t(mx), _t(my), interpolation=interp,
                border=border).numpy()
    if interp == "nearest":
        # exact-half coordinates may round differently: left out
        frac_x = np.abs((mx + 0.5) - np.round(mx + 0.5)) < 1e-3
        frac_y = np.abs((my + 0.5) - np.round(my + 0.5)) < 1e-3
        mask = ~(frac_x | frac_y)
        np.testing.assert_allclose(got[mask], gold[mask], atol=1e-3)
    else:
        # cv2 uses 5-bit fixed point interp coefficients
        np.testing.assert_allclose(got, gold, atol=6.0)


@pytest.mark.parametrize("border", ["constant", "replicate"])
def test_remap_cubic_vs_cv2(rng, border):
    img = _rand_img(rng)
    h, w = img.shape[:2]
    mx = (rng.random((29, 31)).astype(np.float32) * (w + 16)) - 8
    my = (rng.random((29, 31)).astype(np.float32) * (h + 16)) - 8
    gold = cv2.remap(img, mx, my, cv2.INTER_CUBIC,
                     borderMode=BORDER_MAP[border], borderValue=(0, 0, 0))
    got = remap(_t(img), _t(mx), _t(my), interpolation="cubic",
                border=border).numpy()
    np.testing.assert_allclose(got, gold, atol=6.0)


def test_remap_linear_exact_float(rng):
    """Against a scalar float reference (no fixed point), tight tol."""
    img = _rand_img(rng, 17, 19, 1)[..., 0]
    mx = rng.random((11, 13)).astype(np.float32) * 18
    my = rng.random((11, 13)).astype(np.float32) * 16
    gold = np.zeros((11, 13), np.float32)

    def tap(ix, iy):
        if 0 <= ix < 19 and 0 <= iy < 17:
            return img[iy, ix]
        return 0.0
    for y in range(11):
        for x in range(13):
            sx, sy = mx[y, x], my[y, x]
            x0, y0 = int(np.floor(sx)), int(np.floor(sy))
            fx, fy = sx - x0, sy - y0
            gold[y, x] = (tap(x0, y0) * (1 - fx) * (1 - fy)
                          + tap(x0 + 1, y0) * fx * (1 - fy)
                          + tap(x0, y0 + 1) * (1 - fx) * fy
                          + tap(x0 + 1, y0 + 1) * fx * fy)
    got = remap(_t(img), _t(mx), _t(my)).numpy()
    assert got.shape == (11, 13)
    np.testing.assert_allclose(got, gold, atol=1e-3)


@pytest.mark.parametrize("shape", [((40, 60), (80, 130)),
                                   ((64, 48), (31, 23)),
                                   ((37, 53), (37, 53))])
def test_resize_vs_cv2(rng, shape):
    (h, w), (oh, ow) = shape
    img = _rand_img(rng, h, w)
    gold = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = resize(_t(img), oh, ow).numpy()
    # cv2 quantizes interpolation coefficients (fixed point): 2 levels
    np.testing.assert_allclose(got, gold, atol=2.0)


def test_pyr_down_vs_cv2(rng):
    img = _rand_img(rng, 64, 96)
    gold = cv2.pyrDown(img)
    got = pyr_down(_t(img).permute(2, 0, 1)).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, gold, atol=1.0)


def test_pyr_up_vs_cv2(rng):
    img = _rand_img(rng, 32, 48)
    gold = cv2.pyrUp(img)
    got = pyr_up(_t(img).permute(2, 0, 1)).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, gold, atol=1.0)


def test_laplacian_roundtrip(rng):
    planar = _t(np.moveaxis(_rand_img(rng, 64, 128), -1, 0))
    rec = collapse_laplacian(laplacian_pyramid(planar, 4))
    np.testing.assert_allclose(rec.numpy(), planar.numpy(), atol=1e-2)


def test_nv12_to_rgb_vs_cv2(rng):
    h, w = 32, 64
    nv12 = rng.integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)
    gold = cv2.cvtColor(nv12, cv2.COLOR_YUV2RGB_NV12).astype(np.float32)
    got = color.nv12_to_rgb(_t(nv12)).numpy()
    assert np.mean(np.abs(got - gold)) < 1.0
    assert np.max(np.abs(got - gold)) <= 3.0


def test_rgb_to_gray_vs_cv2(rng):
    img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    gold = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
    got = color.rgb_to_gray(_t(img.astype(np.float32))).numpy()
    assert np.max(np.abs(np.round(got) - gold)) <= 1.0


def test_rgb_to_i420_vs_cv2(rng):
    img = rng.integers(0, 256, (32, 64, 3)).astype(np.uint8)
    gold = cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420)
    got = color.rgb_to_i420(_t(img)).numpy()
    assert got.shape == gold.shape
    assert np.mean(np.abs(got.astype(np.int32) - gold.astype(np.int32))) \
        < 1.5


def test_dilate3x3_vs_cv2(rng):
    m = (rng.random((20, 30)) > 0.8).astype(np.float32) * 255
    gold = cv2.dilate(m, np.ones((3, 3), np.uint8))
    np.testing.assert_allclose(dilate3x3(_t(m)).numpy(), gold)


def test_nv12_planar_matches_hwc(rng):
    nv = _t(rng.integers(0, 255, (24, 64)).astype(np.uint8))
    hwc = color.nv12_to_rgb(nv).numpy()
    planar = color.nv12_to_rgb_planar(nv).numpy()
    np.testing.assert_allclose(np.moveaxis(planar, 0, -1), hwc, atol=1e-3)


def test_nv12_scaled_matches_unfused_chain(rng):
    """nv12_to_rgb_planar_scaled equals convert-then-resize on in-gamut
    content (the clip happens at compose scale in the fused form)."""
    from video_stitcher_tpu_torch.ops.resize import resize_planar
    h, w = 96, 128
    rgb = cv2.GaussianBlur(
        rng.integers(0, 256, (h, w, 3)).astype(np.uint8), (0, 0), 3)
    nv = color.rgb_to_nv12(_t(rgb))
    for oh, ow in ((39, 53), (48, 64), (130, 170)):   # down, half, up
        old = resize_planar(color.nv12_to_rgb_planar(nv), oh, ow).clamp(
            0, 255).numpy()
        new = color.nv12_to_rgb_planar_scaled(nv, oh, ow).numpy()
        assert new.shape == (3, oh, ow)
        np.testing.assert_allclose(new, old, atol=2e-2)


def test_stitch_nv12_matches_rgb():
    """stitch_nv12 agrees with stitch() fed the converted RGB."""
    from video_stitcher_tpu_torch import Stitcher, StitcherConfig
    rng = np.random.default_rng(5)
    cfg = StitcherConfig(num_images=2, input_width=128, input_height=64,
                         enable_local=False, recalibrate=False,
                         yaws=(0.0, 1.0), wrap_around=False,
                         blend_dtype="float32")
    nv = rng.integers(0, 255, (2, 96, 128)).astype(np.uint8)
    rgb = color.nv12_to_rgb(_t(nv)).numpy().astype(np.uint8)
    st = Stitcher(cfg, device="cpu")
    st.calibrate(rgb)
    diff = np.abs(st.stitch_nv12(nv).astype(int) - st.stitch(rgb).astype(int))
    # the RGB path quantizes the converted frames to u8 first
    assert diff.max() <= 2, diff.max()


def test_remap_nearest_half_to_even():
    """cv2 INTER_NEAREST rounds half to even (cvRound)."""
    from video_stitcher_tpu_torch.ops.remap import remap_planar
    img = np.arange(16, dtype=np.float32).reshape(2, 8)
    mx = np.array([[1.5, 2.5, 3.5, 4.5]], np.float32)
    my = np.zeros_like(mx)
    gold = cv2.remap(img, mx, my, cv2.INTER_NEAREST)
    got = remap_planar(_t(img[None]), _t(mx), _t(my),
                       interpolation="nearest")[0].numpy()
    np.testing.assert_array_equal(got, gold)
