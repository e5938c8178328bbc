"""ORB-style feature detection and description, batched over cameras.

Torch twin of the JAX package's ``features/orb.py`` (which replaces
cv::cuda::ORB as used at 360_stitcher/featurefinder.cpp:15,38): the FAST-9
segment test as 16 shifted views and a run-length AND over their
rotations, Harris ranking, 3x3 non-maximum suppression on the FAST margin
score, a sub-pixel quadratic fit, intensity-centroid orientation and
rotated BRIEF over the JAX package's fixed 256-pair pattern, on a pyramid
of ``num_levels`` levels. Keypoints are fixed-size arrays with a validity
mask.

The JAX package ranks with ``lax.top_k`` / ``approx_max_k`` (an exact
top-k on the CPU), which put the lower index first on ties; ties are the
rule among the -inf slots of a level with fewer corners than keypoints.
Here every ranking is a stable descending sort, the same
lowest-index-first rule, so both packages keep the same keypoints in the
same order. Descriptors are int32 [K, 8]: the bits of the JAX package's
uint32 words (PyTorch's uint32 supports few operations).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from video_stitcher_tpu_torch.ops.resize import device_constant, resize_planar

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], np.int32)

PATCH_R = 15          # orientation/descriptor patch radius (31x31 like ORB)


class Keypoints(NamedTuple):
    xy: torch.Tensor        # f32 [..., K, 2] (x, y) in level-0 image coords
    response: torch.Tensor  # f32 [..., K]
    angle: torch.Tensor     # f32 [..., K] radians
    valid: torch.Tensor     # bool [..., K]
    desc: torch.Tensor      # int32 [..., K, 8] packed 256-bit descriptors


@functools.lru_cache(maxsize=1)
def _brief_pattern() -> np.ndarray:
    """[256, 2, 2] (pair, point, (dy, dx)) sampling offsets, sigma =
    patch/5, from the JAX package's seed."""
    rng = np.random.default_rng(0x0B12EF)
    pts = rng.normal(0.0, PATCH_R / 2.5, size=(256, 2, 2))
    return np.clip(np.round(pts), -(PATCH_R - 2), PATCH_R - 2).astype(np.int32)


def top_k(x: torch.Tensor, k: int):
    """The k largest of x [..., n] along the last axis, sorted descending,
    ties lowest index first (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """[B, H, W] padded by replicating its edges."""
    return F.pad(x[:, None], (left, right, top, bottom),
                 mode="replicate")[:, 0]


def _fast_corners(gray: torch.Tensor, threshold: float):
    """FAST-9/16 segment-test mask and margin score of gray f32 [B, H, W]
    (taps wrap around the border; the caller masks the border out)."""
    taps = torch.stack([torch.roll(gray, (-int(dy), -int(dx)), (-2, -1))
                        for dy, dx in _CIRCLE])              # [16, B, H, W]
    bright = taps > gray[None] + threshold
    dark = taps < gray[None] - threshold

    def arc9(m):
        # m9[k] = AND of m[k..k+8] (circular): a >= 9 arc iff any m9
        m2 = m & torch.roll(m, -1, 0)
        m4 = m2 & torch.roll(m2, -2, 0)
        m8 = m4 & torch.roll(m4, -4, 0)
        m9 = m8 & torch.roll(m, -8, 0)
        return m9.any(0)

    corner = arc9(bright) | arc9(dark)
    score = torch.maximum(
        torch.clamp(taps - gray[None] - threshold, min=0.0).sum(0),
        torch.clamp(gray[None] - taps - threshold, min=0.0).sum(0))
    return corner, score


def _harris(gray: torch.Tensor, k: float = 0.04, block: int = 7):
    """Harris response of [B, H, W] with Sobel gradients and a box window
    (ORB's HARRIS_SCORE), edge-padded."""
    gp = _pad_edge(gray, 1, 1, 1, 1)
    h, w = gray.shape[-2], gray.shape[-1]

    def s(dy, dx):
        return gp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    ix = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1)
                                               + s(1, -1))
    iy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0)
                                               + s(-1, 1))

    def box(x):
        # separable, rows then columns, each a running sum in tap order
        r = block // 2
        xp = _pad_edge(x, r, r, 0, 0)
        x = sum(xp[:, dy:dy + h] for dy in range(block))
        xp = _pad_edge(x, 0, 0, r, r)
        return sum(xp[:, :, dx:dx + w] for dx in range(block))

    sxx, syy, sxy = box(ix * ix), box(iy * iy), box(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """True where resp [B, H, W] is >= each of its 8 neighbours."""
    rp = F.pad(resp, (1, 1, 1, 1), value=-float("inf"))
    h, w = resp.shape[-2], resp.shape[-1]
    is_max = torch.ones_like(resp, dtype=torch.bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            is_max = is_max & (resp >= rp[:, dy:dy + h, dx:dx + w])
    return is_max


def _gather(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """img [B, H, W] at integer pixels px, py [B, ...] -> [B, ...]."""
    b, h, w = img.shape
    flat = img.reshape(b, h * w)
    idx = (py * w + px).reshape(b, -1).long()
    return flat.gather(1, idx).reshape(px.shape)


def _patch_offsets():
    """(dy, dx) f32 [P] of the pixels of the orientation patch's disc."""
    r = PATCH_R
    dys, dxs = np.mgrid[-r:r + 1, -r:r + 1]
    circ = (dys ** 2 + dxs ** 2) <= r * r
    return dys[circ].astype(np.float32), dxs[circ].astype(np.float32)


def _brief_offsets():
    return _brief_pattern().astype(np.float32)


def _level_tables(w0: int, h0: int, shapes: tuple):
    """Per level of `shapes` ((h, w), ...): its x offset in the level
    atlas, and its x and y scale against the h0 x w0 level 0, f32."""
    widths = [w for _, w in shapes]
    return (np.cumsum([0] + widths[:-1]).astype(np.float32),
            np.asarray([w / w0 for w in widths], np.float32),
            np.asarray([h / h0 for h, _ in shapes], np.float32))


def _orientation(smooth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Intensity-centroid angle per keypoint (orb.cpp IC_Angle): smooth
    [B, H, W], xs, ys [B, K] -> [B, K]. The patch offsets are device
    constants (ops/resize.device_constant): nothing is uploaded per
    call."""
    dys_f, dxs_f = device_constant(_patch_offsets, (), smooth.device)
    h, w = smooth.shape[-2], smooth.shape[-1]
    pxc = torch.clamp((xs[..., None] + dxs_f).to(torch.int32), 0, w - 1)
    pyc = torch.clamp((ys[..., None] + dys_f).to(torch.int32), 0, h - 1)
    vals = _gather(smooth, pxc, pyc)                          # [B, K, P]
    m10 = (vals * dxs_f).sum(-1)
    m01 = (vals * dys_f).sum(-1)
    return torch.atan2(m01, m10)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., 256] -> int32 [..., 8]: bit j of word i is bits[32i + j],
    the uint32 words of the JAX package read as int32."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _describe(smooth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
              angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF 256-bit descriptors -> int32 [B, K, 8]."""
    pat = device_constant(_brief_offsets, (), smooth.device)  # [256, 2, 2]
    h, w = smooth.shape[-2], smooth.shape[-1]
    ca = torch.cos(angles)[..., None, None]                   # [B, K, 1, 1]
    sa = torch.sin(angles)[..., None, None]
    dy, dx = pat[..., 0], pat[..., 1]                         # [256, 2]
    rx = dx * ca - dy * sa                                    # [B, K, 256, 2]
    ry = dx * sa + dy * ca
    px = torch.clamp(torch.round(xs[..., None, None] + rx).to(torch.int32),
                     0, w - 1)
    py = torch.clamp(torch.round(ys[..., None, None] + ry).to(torch.int32),
                     0, h - 1)
    vals = _gather(smooth, px, py)                            # [B, K, 256, 2]
    return _pack_bits(vals[..., 0] < vals[..., 1])


def _box5(img: torch.Tensor) -> torch.Tensor:
    """5x5 box smoothing of [B, H, W] (ORB's integral-image smoothing),
    separable, edge-padded."""
    h, w = img.shape[-2], img.shape[-1]
    xp = _pad_edge(img, 2, 2, 0, 0)
    img = sum(xp[:, dy:dy + h] for dy in range(5))
    xp = _pad_edge(img, 0, 0, 2, 2)
    return sum(xp[:, :, dx:dx + w] for dx in range(5)) / 25.0


def detect_and_describe(gray: torch.Tensor, mask=None, *,
                        max_keypoints: int = 512, num_levels: int = 4,
                        scale_factor: float = 1.2,
                        fast_threshold: float = 20.0) -> Keypoints:
    """gray f32 [H, W] or [B, H, W] (0..255); mask the same shape or None
    (>0 = allowed). Returns fixed-size Keypoints, [K] or [B, K] per field
    (invalid slots flagged)."""
    single = gray.dim() == 2
    gray = gray.to(torch.float32)
    if single:
        gray = gray[None]
        mask = None if mask is None else mask[None]
    b, h0, w0 = gray.shape
    k_per_level = max_keypoints
    dev = gray.device

    cand_resp, cand_x, cand_y, cand_lvl = [], [], [], []
    imgs = []
    for lvl in range(num_levels):
        s = scale_factor ** lvl
        hs, ws = max(32, int(round(h0 / s))), max(32, int(round(w0 / s)))
        img = gray if lvl == 0 else resize_planar(gray, hs, ws)
        imgs.append(img)
        corner, fscore = _fast_corners(img, fast_threshold)
        harris = _harris(img)
        border = PATCH_R + 4
        hh, wh = img.shape[-2], img.shape[-1]
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(wh, device=dev)[None, :]
        inb = ((yy >= border) & (yy < hh - border) & (xx >= border)
               & (xx < wh - border))
        # NMS on the FAST margin score over corner pixels; Harris only
        # ranks (ORB's HARRIS_SCORE)
        fsc = torch.where(corner, fscore,
                          torch.full_like(fscore, -float("inf")))
        ok = corner & _nms3(fsc) & inb
        if mask is not None:
            m01 = (mask > 0).to(torch.float32)
            m = m01 if lvl == 0 else (resize_planar(m01, hh, wh) > 0.5)
            ok = ok & (m > 0)
        resp = torch.where(ok, harris, torch.full_like(harris,
                                                       -float("inf")))
        top_v, top_i = top_k(resp.reshape(b, -1), k_per_level)
        ys_l = torch.div(top_i, wh, rounding_mode="floor").to(torch.float32)
        xs_l = (top_i % wh).to(torch.float32)
        # sub-pixel refinement: 1-D quadratic fit of the FAST margin score
        # around the peak, concave peaks only
        sp = _pad_edge(fscore, 1, 1, 1, 1)
        c0 = fscore
        oxn, oxp = sp[:, 1:-1, :-2], sp[:, 1:-1, 2:]
        oyn, oyp = sp[:, :-2, 1:-1], sp[:, 2:, 1:-1]
        dx_den = oxn - 2.0 * c0 + oxp
        dy_den = oyn - 2.0 * c0 + oyp
        zero = torch.zeros_like(c0)
        off_x = torch.where(dx_den < -1e-6, 0.5 * (oxn - oxp) / dx_den, zero)
        off_y = torch.where(dy_den < -1e-6, 0.5 * (oyn - oyp) / dy_den, zero)
        off_x = torch.clamp(off_x, -0.5, 0.5).reshape(b, -1).gather(1, top_i)
        off_y = torch.clamp(off_y, -0.5, 0.5).reshape(b, -1).gather(1, top_i)
        cand_resp.append(top_v)
        cand_x.append((xs_l + off_x) * (w0 / wh))
        cand_y.append((ys_l + off_y) * (h0 / hh))
        cand_lvl.append(torch.full((b, k_per_level), lvl, dtype=torch.int64,
                                   device=dev))

    best_v, best_i = top_k(torch.cat(cand_resp, 1), max_keypoints)
    xs = torch.cat(cand_x, 1).gather(1, best_i)
    ys = torch.cat(cand_y, 1).gather(1, best_i)
    lvls = torch.cat(cand_lvl, 1).gather(1, best_i)
    valid = torch.isfinite(best_v)

    # orientation and descriptors in one pass over a level atlas: the
    # smoothed levels side by side along x, each keypoint mapped into its
    # own level's rectangle (the in-bounds border keeps every tap inside)
    atlas = torch.cat([F.pad(_box5(im), (0, 0, 0, h0 - im.shape[-2]))
                       for im in imgs], dim=2)
    offs, sx_l, sy_l = device_constant(
        _level_tables, (w0, h0, tuple(tuple(im.shape[-2:]) for im in imgs)),
        dev)
    ax = xs * sx_l[lvls] + offs[lvls]
    ay = ys * sy_l[lvls]
    angles = _orientation(atlas, ax, ay)
    descs = _describe(atlas, ax, ay, angles)

    kp = Keypoints(xy=torch.stack([xs, ys], dim=-1),
                   response=torch.where(valid, best_v,
                                        torch.zeros_like(best_v)),
                   angle=angles, valid=valid, desc=descs)
    if single:
        kp = Keypoints(*(f[0] for f in kp))
    return kp
