"""The JAX package's public helpers in the port, each against the JAX
function on the same numpy inputs (CPU, one thread):

- remap / resize (HWC and HW wrappers) in every mode tests/test_torch_ops.py
  covers, resize_scale, apply_interp_w / _h: within 1e-3 (f32);
- nv12_to_bgr, rgb_to_gray, bgr_to_gray, swap_rb: within 1e-3 (swap_rb
  exact);
- collapse_laplacian: within 1e-3;
- detect_v_range and the host band_backward_maps (6 cameras at
  320x180): equal (the same f64 numpy arithmetic);
- compose_fused_maps with and without mesh maps, device="cpu", against
  the JAX host entry run op by op (jax.disable_jit(), ROADMAP Queue 3):
  within 1e-3 px.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.calib import calibration as jcal
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.geometry import cylindrical as jcyl
from video_stitcher_tpu.ops import color as jcolor
from video_stitcher_tpu.ops import pyramid as jpyr
from video_stitcher_tpu_torch.calib import calibration as tcal
from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.geometry import cylindrical as tcyl
from video_stitcher_tpu_torch.ops import color as tcolor
from video_stitcher_tpu_torch.ops import pyramid as tpyr

# the packages' __init__ re-export the functions remap and resize under
# their modules' names
jremap = importlib.import_module("video_stitcher_tpu.ops.remap")
jresize = importlib.import_module("video_stitcher_tpu.ops.resize")
tremap = importlib.import_module("video_stitcher_tpu_torch.ops.remap")
tresize = importlib.import_module("video_stitcher_tpu_torch.ops.resize")

ATOL = 1e-3          # f32 ops, 0-255 scale (tests/test_torch_ops.py)
MAP_ATOL = 1e-3      # fused maps, source pixels
RIG = dict(num_images=6, input_width=320, input_height=180,
           enable_local=False)


def _close(port, ref, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, atol=atol, rtol=0)


def _maps(rng, h, w, src_h, src_w):
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = gx * rng.uniform(0.6, 1.6) + rng.uniform(-6, 6) \
        + 2 * np.sin(gy / rng.uniform(3, 7))
    my = gy * rng.uniform(0.6, 1.6) + rng.uniform(-6, 6) \
        + 2 * np.cos(gx / rng.uniform(3, 7))
    mx[:3, :5] = -1.0
    mx[-2:, -4:] = src_w + 40.0
    return mx.astype(np.float32), my.astype(np.float32)


def _image(rng, hwc: bool, h=23, w=37):
    return rng.uniform(0, 255, (h, w, 3) if hwc else (h, w)).astype(
        np.float32)


@pytest.mark.parametrize("hwc", [True, False], ids=["hwc", "hw"])
@pytest.mark.parametrize("interpolation", ["linear", "nearest", "cubic"])
@pytest.mark.parametrize("border",
                         ["constant", "replicate", "reflect", "reflect101",
                          "wrap"])
def test_remap_matches_jax(hwc, interpolation, border):
    rng = np.random.default_rng(1)
    img = _image(rng, hwc)
    mx, my = _maps(rng, 19, 29, 23, 37)
    kw = dict(interpolation=interpolation, border=border, border_value=7.0)
    ref = jremap.remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my),
                       **kw)
    _close(tremap.remap(torch.from_numpy(img), torch.from_numpy(mx),
                        torch.from_numpy(my), **kw), ref)


@pytest.mark.parametrize("hwc", [True, False], ids=["hwc", "hw"])
@pytest.mark.parametrize("out_hw", [(17, 29), (64, 96), (23, 37), (9, 80)])
def test_resize_matches_jax(hwc, out_hw):
    img = _image(np.random.default_rng(2), hwc)
    _close(tresize.resize(torch.from_numpy(img), *out_hw),
           jresize.resize(jnp.asarray(img), *out_hw))


@pytest.mark.parametrize("hwc", [True, False], ids=["hwc", "hw"])
@pytest.mark.parametrize("scale", [0.5, 0.82])
def test_resize_scale_matches_jax(hwc, scale):
    img = _image(np.random.default_rng(3), hwc, 45, 80)
    _close(tresize.resize_scale(torch.from_numpy(img), scale),
           jresize.resize_scale(jnp.asarray(img), scale))




@pytest.mark.parametrize("matrix", ["bilinear", "chroma_dedup"])
@pytest.mark.parametrize("axis", ["w", "h"])
def test_apply_interp_matches_jax(matrix, axis):
    x = np.random.default_rng(4).uniform(0, 255, (2, 3, 18, 32)).astype(
        np.float32)
    if matrix == "bilinear":
        m = tresize._interp_matrix(32 if axis == "w" else 18, 11)
    else:
        # the NV12 conversion's composed interp-and-dedup matrices for
        # 36x32 luma: M_h @ D_v [13, 18] and M_w @ S_u [21, 32]
        mh, mw, _ = tcolor._nv12_scaled_mats(36, 32, 13, 21)
        m = mw if axis == "w" else mh
    fn = "apply_interp_" + axis
    _close(getattr(tresize, fn)(torch.from_numpy(x), m),
           getattr(jresize, fn)(jnp.asarray(x), m))


def test_apply_interp_takes_a_dense_matrix_only():
    m = tresize._interp_matrix(32, 11)
    with pytest.raises(TypeError, match="dense"):
        tresize.apply_interp_w(torch.zeros(4, 32), ((0, 0, m),))


@pytest.mark.parametrize("name", ["nv12_to_bgr", "rgb_to_gray",
                                  "bgr_to_gray", "swap_rb"])
def test_color_helpers_match_jax(name):
    rng = np.random.default_rng(5)
    if name == "nv12_to_bgr":
        x = rng.integers(0, 256, (27, 32)).astype(np.uint8)
    else:
        x = rng.integers(0, 256, (18, 32, 3)).astype(np.uint8)
    port = getattr(tcolor, name)(torch.from_numpy(x))
    ref = getattr(jcolor, name)(jnp.asarray(x))
    if name == "swap_rb":
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    else:
        assert port.dtype == torch.float32
        _close(port, ref)


@pytest.mark.parametrize("hw,levels", [((64, 96), 4), ((23, 37), 3)])
def test_collapse_laplacian_matches_jax(hw, levels):
    x = np.random.default_rng(6).uniform(0, 255, (3,) + hw).astype(
        np.float32)
    lap = [np.array(l) for l in jpyr.laplacian_pyramid(jnp.asarray(x),
                                                       levels)]
    ref = jpyr.collapse_laplacian([jnp.asarray(l) for l in lap])
    _close(tpyr.collapse_laplacian([torch.from_numpy(l) for l in lap]), ref)
    _close(tpyr.collapse_laplacian(tpyr.laplacian_pyramid(
        torch.from_numpy(x), levels)), x, atol=1e-2)


def _cams_and_layouts():
    tgeom, tcams = tcal.plan_geometry(StitcherConfig(**RIG))
    jgeom, jcams = jcal.plan_geometry(JConfig(**RIG))
    return tgeom, tcams, jgeom, jcams


def test_detect_v_range_matches_jax():
    tgeom, tcams, _, jcams = _cams_and_layouts()
    s = tgeom.layout.scale
    for tc, jc in zip(tcams, jcams):
        got = tcyl.detect_v_range(tc, s, 320, 180)
        assert got == jcyl.detect_v_range(jc, s, 320, 180)
        assert got[0] < 0 < got[1]


def test_band_backward_maps_matches_jax():
    tgeom, tcams, jgeom, jcams = _cams_and_layouts()
    assert dataclasses.asdict(tgeom.layout) == dataclasses.asdict(
        jgeom.layout)
    got = tcyl.band_backward_maps(tgeom.layout, tcams)
    lay = tgeom.layout
    assert got.shape == (6, 2, lay.band_h, lay.band_w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jcyl.band_backward_maps(
        jgeom.layout, jcams))


def _mesh_maps(n, bh, bw):
    """An identity mesh map with a smooth few-pixel displacement, and a
    corner pushed past the band edge (the replicate border)."""
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float64)
    m = np.empty((n, 2, bh, bw), np.float32)
    for i in range(n):
        m[i, 0] = gx + 2.5 * np.sin(gy / 9.0 + i) * np.cos(gx / 13.0)
        m[i, 1] = gy + 1.5 * np.cos(gx / 11.0 - i)
    m[:, 0, :4, :4] = -3.0
    return m


@pytest.mark.parametrize("mesh", [False, True], ids=["global", "mesh"])
@pytest.mark.parametrize("rig,prewarp", [
    (dict(), False),                                      # scale 1
    (dict(compose_megapix=0.03), False),                  # 0.72, fused
    (dict(compose_megapix=0.01), True),
    (dict(compose_megapix=0.03, map_convention="reference"), False),
], ids=["scale1", "fused", "prewarp", "reference"])
def test_compose_fused_maps_matches_jax(rig, prewarp, mesh):
    cfg = dict(RIG, **rig)
    tgeom, tcams = tcal.plan_geometry(StitcherConfig(**cfg))
    jgeom, jcams = jcal.plan_geometry(JConfig(**cfg))
    assert tgeom.prewarp == jgeom.prewarp == prewarp
    lay = tgeom.layout
    band_maps = jcyl.band_backward_maps(
        jgeom.layout, jcal.map_cams(JConfig(**cfg), jcams))
    mesh_maps = _mesh_maps(6, lay.band_h, lay.band_w) if mesh else None
    with jax.disable_jit():
        ref = jcal.compose_fused_maps(jgeom, band_maps, mesh_maps)
    got = tcal.compose_fused_maps(tgeom, band_maps, mesh_maps, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _close(got, ref, atol=MAP_ATOL)
