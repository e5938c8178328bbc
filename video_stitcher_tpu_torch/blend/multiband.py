"""Batched multiband (Laplacian) blending with static band placement.

Torch twin of the JAX package's ``blend/multiband.py`` (the reference's
MultiBandBlender, sources/modules/stitching/src/blenders.cpp:219-853): all
cameras are one tensor [N, C, bandH, bandW] on a static ``BandLayout``; the
seam weight pyramids are normalized once at calibration; each level's
contributions are summed into the panorama at static corners, with ring
wraparound as at most two slices per camera. On the card a frame's blend
(``weighted_levels``, ``collapse_levels``) runs as the kernels of
``blend/levels.py``. ``blend_bands_int16`` is the reference's 16S integer
blend, a parity twin off the production path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from video_stitcher_tpu_torch.blend.levels import collapse, down, lap_place
from video_stitcher_tpu_torch.geometry.cylindrical import BandLayout
from video_stitcher_tpu_torch.ops.pyramid import gaussian_pyramid
from video_stitcher_tpu_torch.ops.pyramid_int import (
    laplacian_pyramid_i16, pyr_up_i16,
)

WEIGHT_EPS = 1e-5   # blenders.cpp WEIGHT_EPS


def _level_geom(layout: BandLayout, level: int):
    f = 1 << level
    return layout.pano_w // f, layout.pano_h // f, layout.band_w // f, \
        [c // f for c in layout.corners]


def _segments(corner: int, band_w: int, pano_w: int, wrap: bool):
    """Static (pano_x, band_x, width) copy segments, wrapping if needed.
    Raises for a band wider than the panorama, which no segment list can
    place without writing out of range."""
    if band_w > pano_w:
        raise ValueError(f"band {band_w} px wide does not fit a {pano_w} px "
                         f"panorama level")
    if not wrap:
        c = max(0, min(corner, pano_w - band_w))
        return [(c, 0, band_w)]
    c = corner % pano_w
    if c + band_w <= pano_w:
        return [(c, 0, band_w)]
    first = pano_w - c
    return [(c, 0, first), (0, first, band_w - first)]


def _placement(layout: BandLayout, level: int, corners=None):
    """A level's panorama and band widths and each camera's corner at it;
    `corners` (level-0 x offsets, one per band) default to the layout's."""
    pw, _, bw, lvl_corners = _level_geom(layout, level)
    if corners is not None:
        lvl_corners = [c // (1 << level) for c in corners]
    return pw, bw, lvl_corners


def place_bands(bands: torch.Tensor, layout: BandLayout, level: int,
                corners=None):
    """Sum per-camera bands into the panorama at their static corners, in
    camera order. bands: [N, ..., h_l, bw_l] -> [..., h_l, pw_l], a new
    tensor. `corners` (level-0 x offsets, one per band) default to the
    layout's; a camera shard passes its own cameras' (parallel/shard.py)."""
    pw, bw, lvl_corners = _placement(layout, level, corners)
    pano = bands.new_zeros(tuple(bands.shape[1:-1]) + (pw,))
    for i, corner in enumerate(lvl_corners):
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
    return collapse_levels(weighted_levels(bands, weight_pyr, layout,
                                           precision), precision, valid)


def weighted_levels(bands: torch.Tensor, weight_pyr: Sequence[torch.Tensor],
                    layout: BandLayout, precision: str = "highest",
                    corners=None):
    """The panorama's Laplacian levels: each camera's Laplacian pyramid
    times its weight pyramid, in the storage dtype, placed at its corner
    (`corners` as in place_bands). bands: f32 [N, C, bandH, bandW]. On
    the card the kernels of blend/levels.py, one down and one lap_place
    launch a level; on the CPU their plain versions, which equal
    laplacian_pyramid, the product with weight_pyr[lvl].to(storage
    dtype) and place_bands."""
    nb = layout.num_bands
    gauss = [bands]
    for _ in range(nb):
        gauss.append(down(gauss[-1], precision))
    return [lap_place(gauss[lvl], gauss[lvl + 1] if lvl < nb else None,
                      weight_pyr[lvl], layout, lvl, corners, precision)
            for lvl in range(nb + 1)]


def collapse_levels(acc: Sequence[torch.Tensor], precision: str = "highest",
                    valid=None) -> torch.Tensor:
    """Panorama Laplacian levels -> pano f32 [C, pano_h, pano_w]: each
    level's sum in f32, stored between levels in the blend's storage
    dtype, then masked by `valid`; one collapse launch a level below the
    top (blend/levels.py)."""
    *lower, out = acc
    if not lower:
        return collapse(out, None, precision, True, valid)
    for lvl in range(len(lower) - 1, -1, -1):
        out = collapse(lower[lvl], out, precision, lvl == 0, valid)
    return out


def blend_bands_int16(bands: torch.Tensor, weights0: torch.Tensor,
                      layout: BandLayout, valid=None) -> torch.Tensor:
    """Quantization-matched 16S twin of the reference's integer blend
    (the JAX package's blend_bands_int16, step for step): the feed
    (blenders.cpp:651-662, dst16 += short(lap16 * w32), truncating toward
    zero), the normalisation (blenders.cpp:908-912, short(acc / (w +
    eps))), 16S pyramids bit-exact to cv::pyrDown/pyrUp
    (ops/pyramid_int.py) and the saturating 16S collapse. A parity path,
    not the production blend.

    bands:    f32 [N, C, bandH, bandW] warped + gain-compensated
    weights0: f32 [N, bandH, bandW] raw (un-normalized) seam weights
              (calibration aux["weights0"])
    Returns pano f32 [C, pano_h, pano_w] holding exact integers 0..255.
    """
    nb = layout.num_bands
    # the reference hands the blender u8 images (round half to even, as
    # jnp.rint)
    img16 = torch.clamp(torch.round(bands), 0, 255).to(torch.int32)
    lap = laplacian_pyramid_i16(img16, nb)
    wpyr = gaussian_pyramid(weights0[:, None].to(torch.float32), nb)
    norm = []
    for lvl in range(nb + 1):
        t = torch.trunc(lap[lvl].to(torch.float32) * wpyr[lvl]
                        ).to(torch.int32)
        acc = place_bands(t, layout, lvl)
        wsum = place_bands(wpyr[lvl], layout, lvl)
        q = torch.trunc(acc.to(torch.float32) / (wsum + WEIGHT_EPS))
        norm.append(torch.clamp(q, -32768, 32767).to(torch.int32))
    out = norm[-1]
    for lvl in range(nb - 1, -1, -1):
        up = pyr_up_i16(out, norm[lvl].shape[-2], norm[lvl].shape[-1])
        out = torch.clamp(norm[lvl] + up, -32768, 32767)   # saturating add
    pano = torch.clamp(out, 0, 255).to(torch.float32)
    if valid is not None:
        pano = pano * valid[None]
    return pano


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
