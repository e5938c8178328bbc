"""16S integer Gaussian/Laplacian pyramids, bit-exact to cv::pyrDown/pyrUp.

Torch twin of the JAX package's ``ops/pyramid_int.py``. The reference's
production blend runs on CV_16S pyramids (blenders.cpp:700-749); this
module reproduces OpenCV's integer pyramid arithmetic for the opt-in
int16 parity blend (``blend/multiband.py::blend_bands_int16``):

  pyrDown(16S): separable [1 4 6 4 1] int conv, BORDER_REFLECT_101,
                even-phase decimate, single cast (sum + 128) >> 8
  pyrUp(16S):   zero-stuff, separable conv (leading border reflect101,
                trailing replicate), single cast (sum + 32) >> 6

Each axis is the f32 pyramid's banded matrix (``ops/pyramid.py``) scaled
to integers, applied through its taps on int32 tensors (PyTorch has no
int32 matmul on CUDA, and the taps are what the f32 pyramid uses too).
Integer sums are exact in any order, so the result is the same on every
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stitcher_tpu_torch.ops.pyramid import _down_matrix, _up_matrix
from video_stitcher_tpu_torch.ops.resize import (
    apply_taps, hand_out, matrix_taps,
)


@functools.lru_cache(maxsize=256)
def _down_matrix_i(n: int) -> np.ndarray:
    """Integer (x16) version of the pyrDown band matrix."""
    return np.rint(_down_matrix(n).astype(np.float64) * 16).astype(np.int32)


@functools.lru_cache(maxsize=256)
def _up_matrix_i(n: int, n_out: int) -> np.ndarray:
    """Integer (x8) version of the pyrUp band matrix."""
    return np.rint(_up_matrix(n, n_out).astype(np.float64) * 8
                   ).astype(np.int32)


@functools.lru_cache(maxsize=256)
def _cached_int_taps(make_matrix, args: tuple, device: torch.device):
    m = make_matrix(*args)
    idx, w = matrix_taps(m)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(np.rint(w).astype(np.int32), device=device))


def _int_taps(make_matrix, args: tuple, device: torch.device):
    """The integer matrix's taps as (idx i64, w int32) tensors on
    `device`, cached and handed out as resize.device_taps hands out its
    tables (a program keeps them)."""
    return hand_out(_cached_int_taps(make_matrix, args, device))


_int_taps.cache_clear = _cached_int_taps.cache_clear


def _apply_i32(x: torch.Tensor, taps_w, taps_h) -> torch.Tensor:
    return apply_taps(apply_taps(x, taps_w, -1), taps_h, -2)


def pyr_down_i16(x: torch.Tensor) -> torch.Tensor:
    """int [..., H, W] -> int32 [..., ceil(H/2), ceil(W/2)], cv-exact."""
    x = x.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    z = _apply_i32(x, _int_taps(_down_matrix_i, (w,), x.device),
                   _int_taps(_down_matrix_i, (h,), x.device))
    return (z + 128) >> 8


def pyr_up_i16(x: torch.Tensor, out_h=None, out_w=None) -> torch.Tensor:
    """int [..., h, w] -> int32 [..., out_h, out_w], cv-exact pyrUp."""
    x = x.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    out_h = out_h or 2 * h
    out_w = out_w or 2 * w
    z = _apply_i32(x, _int_taps(_up_matrix_i, (w, out_w), x.device),
                   _int_taps(_up_matrix_i, (h, out_h), x.device))
    return (z + 32) >> 6


def laplacian_pyramid_i16(x: torch.Tensor, levels: int):
    """16S Laplacian pyramid, mirroring createLaplacePyr on CV_16SC3:
    lap[i] = gauss[i] - pyrUp(gauss[i+1]), lap[levels] = gauss[levels].
    Values stay int32 (every intermediate fits)."""
    gauss = [x.to(torch.int32)]
    for _ in range(levels):
        gauss.append(pyr_down_i16(gauss[-1]))
    lap = []
    for i in range(levels):
        lap.append(gauss[i] - pyr_up_i16(gauss[i + 1], gauss[i].shape[-2],
                                         gauss[i].shape[-1]))
    lap.append(gauss[levels])
    return lap
