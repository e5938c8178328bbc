"""Bilinear resize with cv INTER_LINEAR semantics, and the banded-tap
helpers the pyramid and colour ops share.

Torch twin of the JAX package's ``ops/resize.py``. Each axis of a resize
(and of a pyramid pass) is a banded linear map, built on the host as a
small dense matrix exactly as the JAX package builds it; here only its few
nonzero taps per output row are kept, and the map is applied as that many
``index_select`` + multiply-adds along the axis (the dense matmul would
spend almost all of its work on structural zeros).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (OpenCV convention:
    src = (dst + 0.5) * in/out - 0.5, edge-clamped taps)."""
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = (src - i0).astype(np.float64)
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0c), (1.0 - f).astype(np.float32))
    np.add.at(m, (rows, i1c), f.astype(np.float32))
    return m


def matrix_taps(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n_out, n_in] banded matrix -> (idx i64 [T, n_out], w f32 [T, n_out]):
    each row's nonzero columns in ascending order, padded with weight 0."""
    nz = m != 0
    t = max(1, int(nz.sum(1).max()))
    cols = np.argsort(~nz, axis=1, kind="stable")[:, :t]
    w = np.take_along_axis(m, cols, axis=1).astype(np.float32)
    return np.ascontiguousarray(cols.T), np.ascontiguousarray(w.T)


def _dense_taps(m: np.ndarray, device: torch.device):
    """matrix_taps(m) as tensors on `device`."""
    if not isinstance(m, np.ndarray) or m.ndim != 2:
        raise TypeError("expected a dense [out, in] numpy matrix")
    idx, w = matrix_taps(m)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


@functools.lru_cache(maxsize=256)
def _cached_taps(make_matrix: Callable[..., np.ndarray], args: tuple,
                 device: torch.device):
    return _dense_taps(make_matrix(*args), device)


#: the lists registered by keeping_taps
_KEEPERS: List[list] = []


def hand_out(table):
    """Append a cached device table to every list registered by
    keeping_taps, and return it: what each cache of device tables calls
    on every table it hands out."""
    for keep in _KEEPERS:
        keep.append(table)
    return table


def device_taps(make_matrix: Callable[..., np.ndarray], args: tuple,
                device: torch.device):
    """_dense_taps(make_matrix(*args), device), cached so the per-frame
    path uploads no index arrays. Each table handed out is also appended
    to every list registered by keeping_taps."""
    return hand_out(_cached_taps(make_matrix, args, device))


device_taps.cache_clear = _cached_taps.cache_clear
device_taps.cache_info = _cached_taps.cache_info


@functools.lru_cache(maxsize=256)
def _cached_constant(make: Callable, args: tuple, device: torch.device):
    value = make(*args)
    if isinstance(value, tuple):
        return tuple(torch.as_tensor(v, device=device) for v in value)
    return torch.as_tensor(value, device=device)


def device_constant(make: Callable, args: tuple, device: torch.device):
    """make(*args) (a numpy array, or a tuple of them) as tensors on
    `device`, built once and cached: a program reads it at its address,
    and a capture may not upload from pageable host memory. Handed out as
    device_taps hands out its tables."""
    return hand_out(_cached_constant(make, args, device))


device_constant.cache_clear = _cached_constant.cache_clear


@contextlib.contextmanager
def keeping_taps(keep: list):
    """Append to `keep` every table a cache hands out in this block
    (device_taps, device_constant and the other caches that call
    hand_out), on any thread. A captured CUDA graph reads its tables at their
    addresses, so its owner keeps them (pipeline/step_graph.py): a table
    the cache evicts is freed, and its memory may hold anything by the
    next replay."""
    _KEEPERS.append(keep)
    try:
        yield keep
    finally:
        _KEEPERS.remove(keep)


def apply_taps(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Apply a banded map along `axis` (-1 or -2) of f32 x."""
    idx, w = taps
    shape = [1] * x.dim()
    shape[axis] = idx.shape[1]
    out = None
    for t in range(idx.shape[0]):
        term = x.index_select(axis, idx[t]) * w[t].view(shape)
        out = term if out is None else out + term
    return out


def apply_interp_w(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """x [..., H, W] -> f32 [..., H, Wo] through a dense [Wo, W]
    interp-like numpy matrix (its nonzero taps only)."""
    return apply_taps(x.to(torch.float32), _dense_taps(m, x.device), -1)


def apply_interp_h(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """x [..., H, W] -> f32 [..., Ho, W] through a dense [Ho, H]
    interp-like numpy matrix (its nonzero taps only)."""
    return apply_taps(x.to(torch.float32), _dense_taps(m, x.device), -2)


def resize_planar(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """img [..., H, W] -> f32 [..., out_h, out_w], bilinear (width pass,
    then height pass, as the JAX package orders them)."""
    h, w = img.shape[-2], img.shape[-1]
    x = img.to(torch.float32)
    if w != out_w:
        x = apply_taps(x, device_taps(_interp_matrix, (w, out_w), x.device),
                       -1)
    if h != out_h:
        x = apply_taps(x, device_taps(_interp_matrix, (h, out_h), x.device),
                       -2)
    return x


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """HWC / HW wrapper around resize_planar."""
    if img.dim() == 2:
        return resize_planar(img, out_h, out_w)
    return resize_planar(img.movedim(-1, 0), out_h, out_w).movedim(0, -1)


def resize_scale(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale both axes like cv::resize(img, (), fx=scale, fy=scale):
    output size = round(dim * scale)."""
    h, w = img.shape[0], img.shape[1]
    return resize(img, int(round(h * scale)), int(round(w * scale)))
