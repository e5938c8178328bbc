"""Colour conversions: NV12 -> planar RGB (full or compose scale) or
channel-last RGB / BGR, RGB -> NV12, RGB -> I420, RGB / BGR -> gray
(planar or channel-last), BGR <-> RGB.

Torch twin of the JAX package's ``ops/color.py`` (the reference's
NV12->BGR cvtColor, networking.cpp:46, and BGR->GRAY,
featurefinder.cpp:35): OpenCV's BT.601 video-range coefficients, luma
excursion clamped at 0, chroma upsampled by nearest neighbour (each 2x2
block shares one U,V pair).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stitcher_tpu_torch.ops.resize import (
    _interp_matrix, apply_taps, device_taps, resize_planar,
)


def nv12_to_rgb_planar(nv12: torch.Tensor, dtype=torch.float32):
    """nv12: u8 [..., H*3/2, W] (Y plane, then the half-height plane of
    interleaved U,V) -> planar RGB [..., 3, H, W] in [0, 255]."""
    rows, w = nv12.shape[-2], nv12.shape[-1]
    h = rows * 2 // 3
    y = nv12[..., :h, :].to(torch.float32)
    uv = nv12[..., h:, :].to(torch.float32)                 # [..., h/2, w]
    u = uv[..., 0::2].repeat_interleave(2, dim=-1)[..., :w]
    v = uv[..., 1::2].repeat_interleave(2, dim=-1)[..., :w]
    u = u.repeat_interleave(2, dim=-2) - 128.0
    v = v.repeat_interleave(2, dim=-2) - 128.0
    ycc = 1.163999 * torch.clamp(y - 16.0, min=0.0)
    r = ycc + 1.596027 * v
    g = ycc - 0.812968 * v - 0.391762 * u
    b = ycc + 2.017232 * u
    return torch.clamp(torch.stack([r, g, b], dim=-3), 0.0, 255.0).to(dtype)


def nv12_to_rgb(nv12: torch.Tensor) -> torch.Tensor:
    """nv12: u8 [..., H*3/2, W] -> f32 channel-last RGB [..., H, W, 3] in
    [0, 255] (the layout calibration takes)."""
    return nv12_to_rgb_planar(nv12).movedim(-3, -1)


def nv12_to_bgr(nv12: torch.Tensor) -> torch.Tensor:
    """nv12_to_rgb with the channels reversed: f32 BGR [..., H, W, 3]."""
    return nv12_to_rgb(nv12).flip(-1)


def rgb_to_nv12(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [..., H, W, 3] -> NV12 u8 [..., H*3/2, W]: the capture boards'
    frame format (360_stitcher/defs.h:10-17), BT.601 video range, chroma
    from the top-left pixel of each 2x2 block."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.256788 * r + 0.504129 * g + 0.097906 * b + 16.0
    u = (-0.148223 * r - 0.290993 * g + 0.439216 * b + 128.0)[..., 0::2, 0::2]
    v = (0.439216 * r - 0.367788 * g - 0.071427 * b + 128.0)[..., 0::2, 0::2]
    uv = torch.stack([u, v], dim=-1).flatten(-2)             # [..., h/2, w]
    out = torch.cat([y, uv], dim=-2)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def rgb_to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """RGB u8/f32 [H, W, 3] -> I420 u8 [H*3/2, W]: the Y plane, then the
    quarter-resolution U plane, then V, as one flat buffer viewed as
    [H*3/2, W] (COLOR_BGR2YUV_I420's layout, the HEVC encoder's input,
    360_stitcher/timed.cpp:311). With an odd count of chroma rows the U
    plane ends mid-row and V starts there. Chroma from the top-left pixel
    of each 2x2 block."""
    h, w = rgb.shape[0], rgb.shape[1]
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.256788 * r + 0.504129 * g + 0.097906 * b + 16.0
    u = (-0.148223 * r - 0.290993 * g + 0.439216 * b + 128.0)[0::2, 0::2]
    v = (0.439216 * r - 0.367788 * g - 0.071427 * b + 128.0)[0::2, 0::2]
    flat = torch.cat([p.reshape(-1) for p in (y, u, v)])
    return torch.clamp(torch.round(flat), 0, 255).to(torch.uint8).reshape(
        h * 3 // 2, w)


@functools.lru_cache(maxsize=32)
def _nv12_scaled_mats(h: int, w: int, out_h: int, out_w: int):
    """The matrices of nv12_to_rgb_planar_scaled, as the JAX package
    builds them: the full-res chroma plane is the nearest upsample of the
    half-res samples, u_full = D_v @ uvrow @ S_u^T (D_v [h, h/2] row
    duplication, S_u [w, w] the even-lane dedup), so the compose-scale
    resize folds in exactly: resize(u_full) = (M_h @ D_v) @ uvrow @
    (M_w @ S_u)^T. Returns (M_h @ D_v [out_h, h/2], M_w @ S_u and
    M_w @ S_v [out_w, w])."""
    mv = _interp_matrix(h, out_h)                   # [out_h, h]
    cv_mat = np.zeros((out_h, h // 2), np.float32)  # M_h @ D_v
    np.add.at(cv_mat.T, np.arange(h) // 2, mv.T)
    mw = _interp_matrix(w, out_w)                   # [out_w, w]
    cu = np.zeros_like(mw)                          # M_w @ S_u / @ S_v
    cvv = np.zeros_like(mw)
    lanes = np.arange(w)
    np.add.at(cu.T, 2 * (lanes // 2), mw.T)
    np.add.at(cvv.T, 2 * (lanes // 2) + 1, mw.T)
    return cv_mat, cu, cvv


def _nv12_scaled_mat(i: int, h: int, w: int, out_h: int, out_w: int):
    return _nv12_scaled_mats(h, w, out_h, out_w)[i]


def nv12_to_rgb_planar_scaled(nv12: torch.Tensor, out_h: int, out_w: int,
                              dtype=torch.float32):
    """nv12 u8 [..., H*3/2, W] -> planar RGB [..., 3, out_h, out_w] at
    compose scale, without full-res RGB: luma is transferred at full res
    and resized; chroma goes through the composed interp-and-dedup maps
    of _nv12_scaled_mats on the half-height interleaved UV rows (width
    pass, then height pass). Equal to nv12_to_rgb_planar + resize_planar
    up to f32 rounding, except that out-of-gamut RGB clips at compose
    scale."""
    rows, w = nv12.shape[-2], nv12.shape[-1]
    h = rows * 2 // 3
    y = nv12[..., :h, :].to(torch.float32)
    ycc = resize_planar(1.163999 * torch.clamp(y - 16.0, min=0.0),
                        out_h, out_w)
    uvrow = nv12[..., h:, :].to(torch.float32)
    dev = nv12.device
    key = (h, w, out_h, out_w)
    t_h = device_taps(_nv12_scaled_mat, (0,) + key, dev)

    def chroma(i):
        x = apply_taps(uvrow, device_taps(_nv12_scaled_mat, (i,) + key, dev),
                       -1)
        return apply_taps(x, t_h, -2) - 128.0
    u, v = chroma(1), chroma(2)
    r = ycc + 1.596027 * v
    g = ycc - 0.812968 * v - 0.391762 * u
    b = ycc + 2.017232 * u
    return torch.clamp(torch.stack([r, g, b], dim=-3), 0.0, 255.0).to(dtype)


def rgb_to_gray_planar(rgb: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """Planar RGB with the channels on `axis` -> f32 gray, OpenCV's
    coefficients (R*0.299 + G*0.587 + B*0.114)."""
    r, g, b = (rgb.select(axis, i).to(torch.float32) for i in range(3))
    return r * 0.299 + g * 0.587 + b * 0.114


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> f32 [...] gray: rgb_to_gray_planar on the last
    axis."""
    return rgb_to_gray_planar(rgb, axis=-1)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    return rgb_to_gray(bgr.flip(-1))


def swap_rb(img: torch.Tensor) -> torch.Tensor:
    """BGR <-> RGB on the last axis."""
    return img.flip(-1)
