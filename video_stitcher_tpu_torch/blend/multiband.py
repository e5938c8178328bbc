"""Batched multiband (Laplacian) blending with static band placement.

Torch twin of the JAX package's ``blend/multiband.py`` (the reference's
MultiBandBlender, sources/modules/stitching/src/blenders.cpp:219-853): all
cameras are one tensor [N, C, bandH, bandW] on a static ``BandLayout``; the
seam weight pyramids are normalized once at calibration; each level's
contributions are summed into the panorama at static corners, with ring
wraparound as at most two slices per camera.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from video_stitcher_tpu_torch.geometry.cylindrical import BandLayout
from video_stitcher_tpu_torch.ops.pyramid import (
    gaussian_pyramid, laplacian_pyramid, pyr_up,
)

WEIGHT_EPS = 1e-5   # blenders.cpp WEIGHT_EPS


def _level_geom(layout: BandLayout, level: int):
    f = 1 << level
    return layout.pano_w // f, layout.pano_h // f, layout.band_w // f, \
        [c // f for c in layout.corners]


def _segments(corner: int, band_w: int, pano_w: int, wrap: bool):
    """Static (pano_x, band_x, width) copy segments, wrapping if needed."""
    if not wrap:
        c = max(0, min(corner, pano_w - band_w))
        return [(c, 0, band_w)]
    c = corner % pano_w
    if c + band_w <= pano_w:
        return [(c, 0, band_w)]
    first = pano_w - c
    return [(c, 0, first), (0, first, band_w - first)]


def place_bands(bands: torch.Tensor, layout: BandLayout, level: int):
    """Sum per-camera bands into the panorama at their static corners, in
    camera order. bands: [N, ..., h_l, bw_l] -> [..., h_l, pw_l]."""
    pw, _, bw, corners = _level_geom(layout, level)
    pano = bands.new_zeros(tuple(bands.shape[1:-1]) + (pw,))
    for i, corner in enumerate(corners):
        for px, bx, wseg in _segments(corner, bw, pw, layout.wrap):
            pano[..., px:px + wseg] += bands[i, ..., bx:bx + wseg]
    return pano


def crop_band(pano: torch.Tensor, layout: BandLayout, cam: int, level: int):
    """Extract camera `cam`'s band view from a panorama-sized level array."""
    pw, _, bw, corners = _level_geom(layout, level)
    c = corners[cam]
    if not layout.wrap:
        c = max(0, min(c, pw - bw))
        return pano[..., c:c + bw]
    c = c % pw
    if c + bw <= pw:
        return pano[..., c:c + bw]
    first = pw - c
    return torch.cat([pano[..., c:], pano[..., :bw - first]], dim=-1)


def build_weight_pyramids(weights0: torch.Tensor, layout: BandLayout):
    """Normalized per-camera weight pyramids + panorama validity.

    weights0: f32 [N, bandH, bandW] in [0, 1] (seam mask AND warp validity).
    Returns (tuple of f32 [N, 1, h_l, w_l], valid f32 [pano_h, pano_w]).
    """
    w0 = weights0.to(torch.float32)[:, None]                 # [N,1,H,W]
    pyr = gaussian_pyramid(w0, layout.num_bands)
    norm = []
    for lvl, wl in enumerate(pyr):
        total = place_bands(wl, layout, lvl)                 # [1, h_l, pw_l]
        inv = 1.0 / (total + WEIGHT_EPS)
        norm.append(torch.stack([wl[i] * crop_band(inv, layout, i, lvl)
                                 for i in range(w0.shape[0])]))
    total0 = place_bands(w0, layout, 0)[0]
    valid = (total0 > WEIGHT_EPS).to(torch.float32)
    return tuple(norm), valid


def blend_bands(bands: torch.Tensor, weight_pyr: Sequence[torch.Tensor],
                layout: BandLayout, valid=None, precision: str = "highest"):
    """Per-frame multiband blend.

    bands: f32 [N, C, bandH, bandW] (warped, gain-compensated);
    weight_pyr: from build_weight_pyramids; precision: "highest" (f32
    chain) or "bf16" (bf16-stored pyramid tensors, each level's collapse
    sum in f32). Returns pano f32 [C, pano_h, pano_w].
    """
    levels = layout.num_bands
    bf16 = precision == "bf16"
    dt = torch.bfloat16 if bf16 else torch.float32
    lap = laplacian_pyramid(bands, levels, precision)
    acc = [place_bands(lap[lvl] * weight_pyr[lvl].to(dt), layout, lvl)
           for lvl in range(levels + 1)]
    out = acc[-1]
    for lvl in range(levels - 1, -1, -1):
        out = acc[lvl].to(torch.float32) + pyr_up(
            out, acc[lvl].shape[-2], acc[lvl].shape[-1], precision,
            out_dtype=torch.float32)
        if bf16 and lvl > 0:
            out = out.to(dt)
    out = out.to(torch.float32)
    if valid is not None:
        out = out * valid[None]
    return out


def blend_feather(bands, weights0_norm, layout: BandLayout, valid=None):
    """Single-level feather blend: pano = sum_c w_c * I_c with
    pre-normalized weights."""
    acc = place_bands(bands * weights0_norm[:, None], layout, 0)
    if valid is not None:
        acc = acc * valid[None]
    return acc


def feather_weights(masks, sharpness: float = 0.02) -> np.ndarray:
    """Distance-ramp feather weights from binary masks (u8 [N, H, W]),
    OpenCV FeatherBlender::createWeightMaps: w = min(1, dist * sharpness)."""
    from scipy import ndimage
    out = np.zeros(masks.shape, np.float32)
    for i in range(masks.shape[0]):
        d = ndimage.distance_transform_edt(masks[i] > 0)
        out[i] = np.minimum(d * sharpness, 1.0)
    return out
