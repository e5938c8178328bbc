"""K1's plain version (the path a CPU tensor takes through
``remap_strips``) against the JAX package: its gold gather warp
``remap_planar(border="constant")`` x gains, clipped, within 1e-3, and the
TPU strip-warp kernel run in interpret mode within 2.0 on the 0-255 scale
(that kernel's bf16 tent weights bound its own error there,
tests/test_remap_strips.py). The cases are those of
tests/test_remap_strips.py: invalid regions, random geometries, batched
frame sets, coordinates in (-1, 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.ops.remap import remap_planar as j_remap
from video_stitcher_tpu.ops.remap_strips import (
    CHUNK_W, ROW_BLOCK, pad_maps, plan_strips, prep_source, repack_maps_lane,
    remap_strips as j_remap_strips,
)
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips

GOLD_ATOL = 1e-3
PALLAS_ATOL = 2.0


def _gold(frames_u8, maps, gains):
    """JAX gather gold: remap_planar(constant) x gain, clipped to u8 range,
    camera n through maps[n % n_maps]."""
    out = []
    for n in range(frames_u8.shape[0]):
        m = maps[n % maps.shape[0]]
        img = np.moveaxis(frames_u8[n], -1, 0).astype(np.float32)
        b = np.asarray(j_remap(jnp.asarray(img), jnp.asarray(m[0]),
                               jnp.asarray(m[1]), border="constant"))
        out.append(np.clip(b * gains[n], 0.0, 255.0))
    return np.stack(out)


def _pallas(frames_u8, maps, gains, src_h, src_w):
    """The TPU kernel in interpret mode (maps padded to its tile grid)."""
    mp = pad_maps(maps)
    plan = plan_strips(mp, src_h, src_w)
    out = j_remap_strips(prep_source(jnp.asarray(frames_u8)),
                         repack_maps_lane(jnp.asarray(mp)),
                         jnp.asarray(plan.strip_off),
                         jnp.asarray(plan.chunk_packed),
                         jnp.asarray(plan.groups), sh=plan.sh, whc=plan.whc,
                         slab_w=plan.slab_w, gains=jnp.asarray(gains),
                         interpret=True)
    return np.asarray(out)[:, :, :maps.shape[2], :maps.shape[3]]


def _port(frames_u8, maps, gains):
    src = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(frames_u8, -1, 1)))
    return remap_strips(src, torch.from_numpy(maps),
                        torch.from_numpy(gains)).numpy()


def _smooth_maps(rng, n, bh, bw, src_h, src_w):
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    maps = np.empty((n, 2, bh, bw), np.float32)
    for i in range(n):
        maps[i, 0] = gx * rng.uniform(0.5, 1.8) + rng.uniform(-8, 8) \
            + rng.uniform(0, 3) * np.sin(gy / rng.uniform(3, 9))
        maps[i, 1] = gy * rng.uniform(0.5, 2.5) + rng.uniform(-8, 8) \
            + rng.uniform(0, 3) * np.cos(gx / rng.uniform(3, 9))
    return maps


def _check(frames, maps, gains, src_h, src_w, pallas=True):
    port = _port(frames, maps, gains)
    np.testing.assert_allclose(port, _gold(frames, maps, gains),
                               atol=GOLD_ATOL, rtol=0)
    if pallas:
        np.testing.assert_allclose(port, _pallas(frames, maps, gains,
                                                 src_h, src_w),
                                   atol=PALLAS_ATOL, rtol=0)
    return port


def test_invalid_regions_are_exact_zeros():
    rng = np.random.default_rng(0)
    src_h, src_w = 24, 256
    bh, bw = ROW_BLOCK, 128
    frames = rng.integers(1, 255, (1, src_h, src_w, 3)).astype(np.uint8)
    mx = np.full((bh, bw), -1.0, np.float32)
    my = np.full((bh, bw), -1.0, np.float32)
    mx[:, :32] = 50.0
    my[:, :32] = 10.0
    mx[:, 32:40] = 500.0            # out of range
    my[:, 32:40] = 10.0
    maps = np.stack([mx, my])[None]
    out = _check(frames, maps, np.ones(1, np.float32), src_h, src_w)
    assert np.all(out[0, :, :, :32] > 0)
    assert np.all(out[0, :, :, 32:] == 0.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_geometries(seed):
    rng = np.random.default_rng(seed)
    src_h, src_w = int(rng.integers(2, 4)) * 16, 256
    bh, bw = 2 * ROW_BLOCK, 128
    frames = rng.integers(0, 255, (1, src_h, src_w, 3)).astype(np.uint8)
    maps = _smooth_maps(rng, 1, bh, bw, src_h, src_w)
    y0, x0 = rng.integers(0, bh), rng.integers(0, bw)
    maps[0, :, y0:, x0:x0 + 16] = -1.0
    maps[0, 0, :2, :8] = 7777.0
    gains = rng.uniform(0.7, 1.4, 1).astype(np.float32)
    _check(frames, maps, gains, src_h, src_w)


def test_coordinates_between_minus_one_and_zero():
    """(-1, 0) keeps the partial weight of the in-source taps; the same
    holds past the right and bottom edges."""
    rng = np.random.default_rng(4)
    src_h, src_w = 16, 256
    bh, bw = ROW_BLOCK, CHUNK_W * 4
    frames = rng.integers(1, 255, (1, src_h, src_w, 3)).astype(np.uint8)
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    mx = (gx * 0.5 + 3.0).astype(np.float32)
    my = (gy + 2.0).astype(np.float32)
    mx[:, :16] = np.linspace(-0.99, -0.01, 16)[None]
    my[0, :] = -0.5
    mx[:, -CHUNK_W:] = np.linspace(src_w - 20.0, src_w - 0.01, CHUNK_W)[None]
    my[-1, :] = src_h - 0.5
    maps = np.stack([mx, my])[None].astype(np.float32)
    out = _check(frames, maps, np.ones(1, np.float32), src_h, src_w)
    assert np.all(out[0, :, 1:-1, :16] > 0)


@pytest.mark.parametrize("batch", [1, 2])
def test_batched_frames_reuse_the_maps(batch):
    """N = batch * n_maps cameras: camera n reads maps[n % n_maps] and its
    own gain (stitch_batch's layout)."""
    rng = np.random.default_rng(5)
    src_h, src_w, n_maps = 32, 256, 3
    bh, bw = 2 * ROW_BLOCK, 128
    frames = rng.integers(0, 255, (batch * n_maps, src_h, src_w, 3)
                          ).astype(np.uint8)
    maps = _smooth_maps(rng, n_maps, bh, bw, src_h, src_w)
    gains = rng.uniform(0.7, 1.4, batch * n_maps).astype(np.float32)
    port = _port(frames, maps, gains)
    np.testing.assert_allclose(port, _gold(frames, maps, gains),
                               atol=GOLD_ATOL, rtol=0)
    # the TPU kernel reuses its per-camera plan cyclically the same way
    np.testing.assert_allclose(
        port, _pallas(frames, maps, gains, src_h, src_w),
        atol=PALLAS_ATOL, rtol=0)
    for n in range(batch * n_maps):
        solo = _port(frames[n:n + 1], maps[n % n_maps][None], gains[n:n + 1])
        np.testing.assert_array_equal(port[n], solo[0])


def test_float_source_matches_u8_source():
    """stitch_nv12 feeds K1 an f32 planar source; on integral values it
    equals the u8 path."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 255, (2, 20, 40, 3)).astype(np.uint8)
    maps = _smooth_maps(rng, 2, 12, 24, 20, 40)
    gains = np.array([0.9, 1.3], np.float32)
    src = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 1)))
    a = remap_strips(src, torch.from_numpy(maps), torch.from_numpy(gains))
    b = remap_strips(src.float(), torch.from_numpy(maps),
                     torch.from_numpy(gains))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a.max()) <= 255.0 and float(a.min()) >= 0.0
