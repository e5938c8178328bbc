"""The CPW mesh's feature machinery against the JAX package's: 3x3
dilation, gray conversion, ORB detection and description, Hamming kNN
ratio matching and RANSAC, on inputs made from numpy seeds.

- ``dilate3x3``, ``rgb_to_gray_planar``, ``hamming_matrix`` and
  ``knn_ratio_match`` exactly, ties included (Hamming distances are small
  integers; both packages take the lowest index first).
- ORB on a seeded textured image with a mask, against the JAX pipeline's
  compiled detect: the same valid keypoints at the same positions in the
  same order, responses within 1e-5 relative (XLA fuses the Harris
  arithmetic), angles within 1e-4 rad (the intensity centroid is a sum
  over ~700 pixels, reduced in another order), and at least 99% of the
  descriptors bit-equal, none more than 4 bits apart: a BRIEF sample at
  an exact half pixel may round the other way under a 1e-5 rad angle.
- ``ransac_homography`` with the JAX draws fed to the port's
  ``sample_hypotheses``: the same inlier mask and count, and H projecting
  the points within 1e-3 px of the JAX H (its SVD sign may differ; a
  homography is scale-free).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.features import match as jmatch
from video_stitcher_tpu.features import ransac as jransac
from video_stitcher_tpu.mesh.pipeline import _detect_one
from video_stitcher_tpu.ops import color as jcolor
from video_stitcher_tpu.ops.morphology import dilate3x3 as j_dilate
from video_stitcher_tpu_torch.features import ransac
from video_stitcher_tpu_torch.features.match import (
    hamming_matrix, knn_ratio_match,
)
from video_stitcher_tpu_torch.features.orb import detect_and_describe
from video_stitcher_tpu_torch.interop import (
    keypoints_from_numpy, matches_from_numpy,
)
from video_stitcher_tpu_torch.ops.color import rgb_to_gray_planar
from video_stitcher_tpu_torch.ops.morphology import dilate3x3

RESP_RTOL = 1e-5
ANGLE_ATOL = 1e-4
DESC_EQUAL = 0.99      # share of bit-equal descriptors
DESC_BITS = 4          # most bits apart for the rest
PROJ_ATOL = 1e-3       # px


def test_dilate3x3_exact():
    rng = np.random.default_rng(0)
    x = rng.random((3, 37, 53)).astype(np.float32)
    m = (rng.random((2, 40, 30)) > 0.9).astype(np.float32) * 255
    for a in (x, m, m[0]):
        np.testing.assert_array_equal(dilate3x3(torch.as_tensor(a)).numpy(),
                                      np.asarray(j_dilate(jnp.asarray(a))))


def test_rgb_to_gray_planar_exact():
    rng = np.random.default_rng(1)
    x = (rng.random((2, 3, 20, 30)) * 255).astype(np.float32)
    np.testing.assert_array_equal(
        rgb_to_gray_planar(torch.as_tensor(x), axis=1).numpy(),
        np.asarray(jcolor.rgb_to_gray_planar(jnp.asarray(x), axis=1)))


@pytest.fixture(scope="module")
def orb():
    rng = np.random.default_rng(5)
    h, w = 180, 240
    img = gaussian_filter(rng.random((h, w)) * 255, 1.5)
    img = ((img - img.min()) / (img.max() - img.min()) * 255
           ).astype(np.float32)
    mask = np.ones((h, w), np.float32)
    mask[:, :30] = 0
    mask[150:] = 0
    jk = jax.tree_util.tree_map(np.array, _detect_one(
        jnp.asarray(img), jnp.asarray(mask), max_kp=512, num_levels=4,
        scale_factor=1.2))
    tk = detect_and_describe(torch.as_tensor(img), torch.as_tensor(mask),
                             max_keypoints=512)
    return img, mask, jk, tk


def test_orb_keypoints_match_jax(orb):
    _, _, jk, tk = orb
    np.testing.assert_array_equal(tk.valid.numpy(), jk.valid)
    assert jk.valid.sum() > 100
    np.testing.assert_array_equal(tk.xy.numpy(), jk.xy)
    np.testing.assert_allclose(tk.response.numpy(), jk.response,
                               rtol=RESP_RTOL)
    np.testing.assert_allclose(tk.angle.numpy(), jk.angle, atol=ANGLE_ATOL)


def test_orb_descriptors_match_jax(orb):
    _, _, jk, tk = orb
    jd = torch.as_tensor(jk.desc.view(np.int32))
    bits = hamming_matrix(jd, tk.desc).diagonal()
    assert (bits == 0).float().mean() >= DESC_EQUAL
    assert int(bits.max()) <= DESC_BITS


def test_orb_batched_equals_single(orb):
    img, mask, _, tk = orb
    imgs = torch.as_tensor(np.stack([img, img[::-1].copy()]))
    masks = torch.as_tensor(np.stack([mask, mask]))
    kb = detect_and_describe(imgs, masks, max_keypoints=512)
    for a, b in zip(kb, tk):
        assert torch.equal(a[0], b)


def test_orb_fewer_corners_than_slots():
    """A flat image with a few corners: the -inf slots tie, and both
    packages fill them lowest index first."""
    img = np.full((96, 128), 100.0, np.float32)
    img[40:56, 50:70] = 200.0
    jk = jax.tree_util.tree_map(np.array, _detect_one(
        jnp.asarray(img), jnp.ones_like(jnp.asarray(img)), max_kp=64,
        num_levels=2, scale_factor=1.2))
    tk = detect_and_describe(torch.as_tensor(img), max_keypoints=64,
                             num_levels=2)
    assert 0 < jk.valid.sum() < 64
    np.testing.assert_array_equal(tk.valid.numpy(), jk.valid)
    np.testing.assert_array_equal(tk.xy.numpy(), jk.xy)
    np.testing.assert_array_equal(tk.desc.numpy(), jk.desc.view(np.int32))


def _tied_descriptors(rng, k, words=8):
    """Descriptors that differ in few bits, so many distances tie."""
    base = rng.integers(0, 2 ** 32, (1, words), dtype=np.uint64)
    flips = rng.integers(0, 32, (k, 3))
    d = np.repeat(base, k, 0)
    for j in range(3):
        d[np.arange(k), rng.integers(0, words, k)] ^= (
            np.uint64(1) << flips[:, j].astype(np.uint64))
    return d.astype(np.uint32)


@pytest.mark.parametrize("source", ["orb", "tied"])
def test_knn_ratio_match_exact(orb, source):
    rng = np.random.default_rng(2)
    if source == "orb":
        d1 = orb[2].desc
        d2 = np.roll(d1, 7, 0) ^ (rng.random(d1.shape) < 0.02).astype(
            np.uint32)
        v1, v2 = orb[2].valid, np.roll(orb[2].valid, 7)
    else:
        d1, d2 = _tied_descriptors(rng, 96), _tied_descriptors(rng, 80)
        v1 = rng.random(96) > 0.1
        v2 = rng.random(80) > 0.1
    want = matches_from_numpy(*(np.asarray(f) for f in jmatch.knn_ratio_match(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        0.7)), device="cpu")
    a = keypoints_from_numpy(np.zeros((len(d1), 2)), np.zeros(len(d1)),
                             np.zeros(len(d1)), v1, d1, device="cpu")
    b = keypoints_from_numpy(np.zeros((len(d2), 2)), np.zeros(len(d2)),
                             np.zeros(len(d2)), v2, d2, device="cpu")
    got = knn_ratio_match(a.desc, b.desc, a.valid, b.valid, 0.7)
    np.testing.assert_array_equal(
        hamming_matrix(a.desc, b.desc, a.valid, b.valid).numpy(),
        np.asarray(jmatch.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2),
                                         jnp.asarray(v1), jnp.asarray(v2))))
    for name in ("query", "train", "distance", "valid"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if source == "tied":
        assert int(want.valid.sum()) < len(d1)   # ties fail the ratio test


def _homography_pairs(rng, k=120, outliers=30):
    h = np.array([[1.02, 0.03, 12.0], [-0.02, 0.98, -5.0],
                  [1e-5, -2e-5, 1.0]])
    p1 = rng.uniform(0, 300, (k, 2))
    q = np.c_[p1, np.ones(k)] @ h.T
    p2 = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (k, 2))
    p2[:outliers] = rng.uniform(0, 300, (outliers, 2))
    valid = rng.random(k) > 0.1
    return p1.astype(np.float32), p2.astype(np.float32), valid


def test_ransac_matches_jax_with_its_draws(monkeypatch):
    rng = np.random.default_rng(4)
    p1, p2, valid = _homography_pairs(rng)
    key = jax.random.PRNGKey(9)
    hj, inl_j, n_j = (np.asarray(x) for x in jransac.ransac_homography(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), key))
    probs = jnp.asarray(valid).astype(jnp.float32) + 1e-6
    draws = np.array(jax.random.categorical(
        key, jnp.log(probs)[None, :].repeat(256 * 4, 0))).reshape(256, 4)
    monkeypatch.setattr(ransac, "sample_hypotheses",
                        lambda v, s, g: torch.as_tensor(draws)[None])
    ht, inl_t, n_t = ransac.ransac_homography(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(valid),
        torch.Generator())
    np.testing.assert_array_equal(inl_t.numpy(), inl_j)
    assert int(n_t) == int(n_j) > 60

    def proj(h):
        q = np.c_[p1, np.ones(len(p1))] @ np.asarray(h, np.float64).T
        return q[:, :2] / q[:, 2:]
    np.testing.assert_allclose(proj(ht.numpy()), proj(hj), atol=PROJ_ATOL)


def test_sample_hypotheses_draws_from_the_generator():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[10:20] = True
    a = ransac.sample_hypotheses(valid, 64, torch.Generator().manual_seed(3))
    b = ransac.sample_hypotheses(valid, 64, torch.Generator().manual_seed(3))
    assert a.shape == (64, 4) and torch.equal(a, b)
    assert ((a >= 10) & (a < 20)).float().mean() > 0.99
    rng = np.random.default_rng(4)
    p1, p2, v = _homography_pairs(rng)
    _, inl, n = ransac.ransac_homography(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(v),
        torch.Generator().manual_seed(0))
    good = v.copy()
    good[:30] = False
    assert int(n) >= 0.95 * good.sum() and not inl.numpy()[~v].any()
