"""Backward-map resampling (the reference's hot op: cv::cuda::remap).

Torch twin of the JAX package's ``ops/remap.py``. Semantics match OpenCV
remap with INTER_LINEAR / INTER_NEAREST / INTER_CUBIC and BORDER_CONSTANT /
BORDER_REPLICATE / BORDER_REFLECT / BORDER_REFLECT_101 / BORDER_WRAP.
Calibration uses it directly; the per-frame warp goes through the CUDA
kernel of ``ops/remap_strips.py``, whose plain version is the
``border="constant"`` linear path below.
"""

from __future__ import annotations

import torch

_BORDERS = ("constant", "replicate", "reflect", "reflect101", "wrap")


def _reflect_index(idx, n: int, mode: str):
    """Map integer indices into [0, n) per OpenCV border rules."""
    if mode == "replicate":
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(idx, n)
    if mode == "reflect":        # fedcba|abcdefgh|hgfedcb
        period = 2 * n
        m = torch.remainder(idx, period)
        return torch.where(m >= n, period - 1 - m, m)
    if mode == "reflect101":     # gfedcb|abcdefgh|gfedcba
        if n == 1:
            return torch.zeros_like(idx)
        period = 2 * (n - 1)
        m = torch.remainder(idx, period)
        return torch.where(m >= n, period - m, m)
    raise ValueError(f"unknown border mode {mode!r}")


def _gather2d(img_flat, ix, iy, w: int):
    """img_flat: [C, H*W]; ix, iy: [...] int64 -> [C, ...]."""
    idx = (iy * w + ix).reshape(-1)
    out = img_flat.index_select(1, idx)
    return out.reshape((img_flat.shape[0],) + tuple(ix.shape))


def remap_planar(img, map_x, map_y, *, interpolation="linear",
                 border="constant", border_value=0.0):
    """Resample a planar image through a backward map.

    img:   [C, H, W] (any real dtype; computed in f32)
    map_x: f32 [Ho, Wo] source x-coordinate for each output pixel
    map_y: f32 [Ho, Wo]
    Returns f32 [C, Ho, Wo].
    """
    if border not in _BORDERS:
        raise ValueError(f"unknown border mode {border!r}")
    c, h, w = img.shape
    img_flat = img.to(torch.float32).reshape(c, h * w)
    mx = map_x.to(torch.float32)
    my = map_y.to(torch.float32)
    # a Python scalar: no upload (a capture refuses one from pageable
    # host memory)
    fill = float(border_value)

    if interpolation == "nearest":
        # cvRound is round-half-to-even, as torch.round
        ix = torch.round(mx).to(torch.int64)
        iy = torch.round(my).to(torch.int64)
        if border == "constant":
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            out = _gather2d(img_flat, ix.clamp(0, w - 1),
                            iy.clamp(0, h - 1), w)
            return torch.where(valid[None], out, fill)
        return _gather2d(img_flat, _reflect_index(ix, w, border),
                         _reflect_index(iy, h, border), w)

    if interpolation not in ("linear", "cubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")

    x0f = torch.floor(mx)
    y0f = torch.floor(my)
    fx = mx - x0f
    fy = my - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)

    if border == "constant":
        def tap(ix, iy):
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            v = _gather2d(img_flat, ix.clamp(0, w - 1), iy.clamp(0, h - 1), w)
            return torch.where(valid[None], v, fill)
    else:
        def tap(ix, iy):
            return _gather2d(img_flat, _reflect_index(ix, w, border),
                             _reflect_index(iy, h, border), w)

    if interpolation == "cubic":
        # OpenCV INTER_CUBIC (interpolateCubic, A = -0.75): 4x4 taps at
        # x0-1..x0+2
        def cubic_w(f):
            a = -0.75
            w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
            w1 = ((a + 2) * f - (a + 3)) * f * f + 1
            g = 1 - f
            w2 = ((a + 2) * g - (a + 3)) * g * g + 1
            return w0, w1, w2, 1 - w0 - w1 - w2

        wx = cubic_w(fx)
        wy = cubic_w(fy)
        out = torch.zeros((c,) + tuple(mx.shape), dtype=torch.float32,
                          device=img.device)
        for j in range(4):
            row = torch.zeros_like(out)
            for i in range(4):
                row = row + tap(x0 - 1 + i, y0 - 1 + j) * wx[i][None]
            out = out + row * wy[j][None]
        return out

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)
    w00 = ((1 - fx) * (1 - fy))[None]
    w01 = (fx * (1 - fy))[None]
    w10 = ((1 - fx) * fy)[None]
    w11 = (fx * fy)[None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def remap(img, map_x, map_y, *, interpolation="linear", border="constant",
          border_value=0.0):
    """HWC (or HW) wrapper around remap_planar: img [H, W, C] or [H, W]
    -> f32 [Ho, Wo, C] or [Ho, Wo]."""
    planar = img[None] if img.dim() == 2 else img.movedim(-1, 0)
    out = remap_planar(planar, map_x, map_y, interpolation=interpolation,
                       border=border, border_value=border_value)
    return out[0] if img.dim() == 2 else out.movedim(0, -1)
