"""NV12 -> planar RGB, the production ingest conversion.

Torch twin of ``nv12_to_rgb_planar`` in the JAX package's ``ops/color.py``
(the reference's NV12->BGR cvtColor, networking.cpp:46): OpenCV's BT.601
video-range coefficients, luma excursion clamped at 0, chroma upsampled by
nearest neighbour (each 2x2 block shares one U,V pair).
"""

from __future__ import annotations

import torch


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
