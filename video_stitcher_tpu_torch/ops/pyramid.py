"""Gaussian / Laplacian pyramid ops (batched, planar layout).

Torch twin of the JAX package's ``ops/pyramid.py`` (cv::cuda::pyrDown /
pyrUp semantics): 5-tap [1 4 6 4 1]/16 separable Gaussian with
BORDER_REFLECT_101 and even-phase decimation; pyrUp zero-stuffs and
convolves with the same kernel times 4. Each axis pass is a banded map
(built as the JAX package builds its matrices) applied through its taps,
in f32; the "bf16" precision stores every pass's result in bfloat16. The
blend's kernels (blend/levels.py) read the same tap tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stitcher_tpu_torch.ops.resize import apply_taps, device_taps

# [1, 4, 6, 4, 1] / 16
_K = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """cv BORDER_REFLECT_101 index fold (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    m = np.where(m < 0, m + period, m)
    return np.where(m >= n, period - m, m)


@functools.lru_cache(maxsize=256)
def _down_matrix(n: int) -> np.ndarray:
    """[ceil(n/2), n]: 5-tap blur + even-phase decimate, reflect101."""
    n2 = (n + 1) // 2
    m = np.zeros((n2, n), np.float64)
    rows = np.arange(n2)
    for t in range(5):
        idx = _reflect101(2 * rows + t - 2, n)
        np.add.at(m, (rows, idx), _K[t])
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _up_matrix(n: int, n_out: int) -> np.ndarray:
    """[n_out, n]: zero-stuff + 5-tap conv * 4 (cv::pyrUp). cv reflects in
    the zero-stuffed domain: the leading pad is reflect101 (a[-1] -> a[1]),
    the trailing pad replicates (a[n] -> a[n-1])."""
    m = np.zeros((n_out, n), np.float64)

    def fold(i):
        i = np.where(i < 0, -i, i)
        return np.minimum(i, n - 1)

    rows = np.arange(n_out)
    even = rows % 2 == 0
    i = rows // 2
    for t, w in ((-1, _K[0]), (0, _K[2]), (1, _K[4])):     # even outputs
        np.add.at(m, (rows[even], fold(i[even] + t)), 2.0 * w)
    for t, w in ((0, _K[1]), (1, _K[3])):                  # odd outputs
        np.add.at(m, (rows[~even], fold(i[~even] + t)), 2.0 * w)
    return m.astype(np.float32)


def storage_dtype(precision: str) -> torch.dtype:
    """The pyramid's storage dtype: bf16 under precision "bf16", else
    f32."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def pyr_down(x, precision: str = "highest"):
    """[..., H, W] -> [..., ceil(H/2), ceil(W/2)]: blur, then even-phase
    decimate."""
    dt = storage_dtype(precision)
    h, w = x.shape[-2], x.shape[-1]
    y = apply_taps(x.to(dt).float(), device_taps(_down_matrix, (w,), x.device),
                   -1).to(dt)
    return apply_taps(y.float(), device_taps(_down_matrix, (h,), x.device),
                      -2).to(dt)


def pyr_up(x, out_h=None, out_w=None, precision: str = "highest",
           out_dtype=None):
    """[..., h, w] -> [..., out_h, out_w]: zero-stuff, then blur with the 4x
    kernel (cv::pyrUp). out_dtype overrides the storage dtype of the result
    (the blend collapse accumulates in f32 over bf16-stored levels)."""
    dt = storage_dtype(precision)
    h, w = x.shape[-2], x.shape[-1]
    out_h = out_h or 2 * h
    out_w = out_w or 2 * w
    y = apply_taps(x.to(dt).float(),
                   device_taps(_up_matrix, (w, out_w), x.device), -1).to(dt)
    return apply_taps(y.float(), device_taps(_up_matrix, (h, out_h), x.device),
                      -2).to(out_dtype or dt)


def gaussian_pyramid(x, levels: int, precision: str = "highest"):
    """Returns [x, down(x), ..., down^levels(x)] (levels+1 entries)."""
    pyr = [x.to(storage_dtype(precision))]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1], precision))
    return pyr


def laplacian_pyramid(x, levels: int, precision: str = "highest"):
    """lap[i] = gauss[i] - pyrUp(gauss[i+1]); lap[levels] = gauss[levels]
    (blenders.cpp:713-719)."""
    gauss = gaussian_pyramid(x, levels, precision)
    lap = []
    for i in range(levels):
        lap.append(gauss[i] - pyr_up(gauss[i + 1], gauss[i].shape[-2],
                                     gauss[i].shape[-1], precision))
    lap.append(gauss[levels])
    return lap


def collapse_laplacian(lap):
    """Inverse of laplacian_pyramid (blenders.cpp:786-790), in f32: the
    blend's own collapse is blend/multiband.py::collapse_levels."""
    x = lap[-1]
    for lvl in reversed(lap[:-1]):
        x = lvl + pyr_up(x, lvl.shape[-2], lvl.shape[-1])
    return x
