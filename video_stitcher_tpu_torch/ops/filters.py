"""Separable Gaussian filtering (cv::cuda::createGaussianFilter equivalent,
declared at 360_stitcher/timed.cpp:53; the reference's apply call is
commented out at timed.cpp:110 but the op belongs to the surface).

Torch twin of the JAX package's ``ops/filters.py``, with its arithmetic:
planar layout [..., H, W], BORDER_REFLECT_101, each axis a sum of the
shifted padded input times the taps, in tap order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from video_stitcher_tpu_torch.ops.pyramid import _reflect101


@lru_cache(maxsize=32)
def gaussian_kernel(ksize: int, sigma: float = 0.0) -> tuple:
    """cv::getGaussianKernel: sigma<=0 -> 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    return tuple(float(v) for v in k)


def _conv_axis(x: torch.Tensor, k: tuple, axis: int) -> torch.Tensor:
    r = (len(k) - 1) // 2
    n = x.shape[axis]
    idx = torch.as_tensor(_reflect101(np.arange(-r, n + r), n),
                          device=x.device)
    xp = x.index_select(axis, idx)
    out = None
    for i, w in enumerate(k):
        term = w * xp.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def gaussian_blur(x: torch.Tensor, ksize: int = 5, sigma: float = 0.0
                  ) -> torch.Tensor:
    """[..., H, W] separable Gaussian blur, f32."""
    k = gaussian_kernel(ksize, sigma)
    y = _conv_axis(x.to(torch.float32), k, -1)
    return _conv_axis(y, k, -2)
