"""The port's plain ops against the JAX package's, on the same numpy
inputs: remap (every interpolation and border mode), resize, NV12
conversion and the pyramid passes, within 1e-3 in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.ops import color as jcolor
from video_stitcher_tpu.ops import pyramid as jpyr
from video_stitcher_tpu.ops.remap import remap_planar as j_remap
from video_stitcher_tpu.ops.resize import resize_planar as j_resize
from video_stitcher_tpu_torch.ops import pyramid as tpyr
from video_stitcher_tpu_torch.ops.color import nv12_to_rgb_planar, rgb_to_nv12
from video_stitcher_tpu_torch.ops.remap import remap_planar as t_remap
from video_stitcher_tpu_torch.ops.resize import resize_planar as t_resize

ATOL = 1e-3


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


def _maps(rng, h, w, src_h, src_w):
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = gx * rng.uniform(0.6, 1.6) + rng.uniform(-6, 6) \
        + 2 * np.sin(gy / rng.uniform(3, 7))
    my = gy * rng.uniform(0.6, 1.6) + rng.uniform(-6, 6) \
        + 2 * np.cos(gx / rng.uniform(3, 7))
    mx[:3, :5] = -1.0                             # the invalid sentinel
    mx[-2:, -4:] = src_w + 40.0                   # far out of range
    mx[4, :6] = np.linspace(-0.99, -0.01, 6)      # partial left taps
    my[5, :6] = np.linspace(-0.99, -0.01, 6)
    return mx.astype(np.float32), my.astype(np.float32)


@pytest.mark.parametrize("interpolation", ["linear", "nearest", "cubic"])
@pytest.mark.parametrize("border",
                         ["constant", "replicate", "reflect", "reflect101",
                          "wrap"])
def test_remap_planar_matches_jax(interpolation, border):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (3, 23, 37)).astype(np.float32)
    mx, my = _maps(rng, 19, 29, 23, 37)
    ref = j_remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my),
                  interpolation=interpolation, border=border,
                  border_value=7.0)
    port = t_remap(torch.from_numpy(img), torch.from_numpy(mx),
                   torch.from_numpy(my), interpolation=interpolation,
                   border=border, border_value=7.0)
    _close(port, ref)


@pytest.mark.parametrize("out_hw", [(17, 29), (64, 96), (23, 37), (9, 80)])
def test_resize_planar_matches_jax(out_hw):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (2, 3, 23, 37)).astype(np.float32)
    ref = j_resize(jnp.asarray(img), *out_hw)
    _close(t_resize(torch.from_numpy(img), *out_hw), ref)


def test_nv12_to_rgb_planar_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 18, 32
    nv12 = rng.integers(0, 256, (2, h * 3 // 2, w)).astype(np.uint8)
    port = nv12_to_rgb_planar(torch.from_numpy(nv12))
    for i in range(2):
        ref = jcolor.nv12_to_rgb_planar(jnp.asarray(nv12[i]))
        _close(port[i], ref)


def test_rgb_to_nv12_matches_jax():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (2, 18, 32, 3)).astype(np.uint8)
    port = rgb_to_nv12(torch.from_numpy(rgb)).numpy()
    for i in range(2):
        ref = np.asarray(jcolor.rgb_to_nv12(jnp.asarray(rgb[i])))
        assert np.abs(port[i].astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(32, 48), (23, 37), (2, 5)])
def test_pyr_down_up_match_jax(hw):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (2, 3) + hw).astype(np.float32)
    ref_d = jpyr.pyr_down(jnp.asarray(x))
    port_d = tpyr.pyr_down(torch.from_numpy(x))
    _close(port_d, ref_d)
    ref_u = jpyr.pyr_up(ref_d, hw[0], hw[1])
    port_u = tpyr.pyr_up(port_d, hw[0], hw[1])
    _close(port_u, ref_u)


def test_laplacian_pyramid_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (3, 3, 64, 96)).astype(np.float32)
    ref = jpyr.laplacian_pyramid(jnp.asarray(x), 4)
    port = tpyr.laplacian_pyramid(torch.from_numpy(x), 4)
    assert len(port) == len(ref) == 5
    for p, r in zip(port, ref):
        _close(p, r)


def test_pyramid_bf16_storage_matches_jax():
    """bf16 mode stores every pass in bfloat16; both packages round at the
    same places, so they agree to a bf16 ulp at 255 (one step = 1.0)."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 255, (2, 3, 32, 48)).astype(np.float32)
    ref = jpyr.laplacian_pyramid(jnp.asarray(x), 3, "bf16")
    port = tpyr.laplacian_pyramid(torch.from_numpy(x), 3, "bf16")
    for p, r in zip(port, ref):
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(r, np.float32), atol=2.0)
