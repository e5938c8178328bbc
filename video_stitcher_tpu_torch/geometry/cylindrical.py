"""Cylindrical projection + panorama band layout.

Projection math mirrors OpenCV's CylindricalProjector
(sources/modules/stitching/include/opencv2/stitching/detail/warpers_inl.hpp:278-307
and the CUDA twin cv/stitching/src/cuda/build_warp_maps.cu:88-107):

  forward :  q = R * K^-1 * (x, y, 1);  u = s*atan2(q.x, q.z),  v = s*q.y/hypot(q.x, q.z)
  backward:  d = (sin(u/s), v/s, cos(u/s));  p = K * R^T * d;  (x, y) = (p.x/p.z, p.y/p.z)

Band layout — a deliberate redesign. OpenCV's detectResultRoi takes
raw atan2 values, so the yaw=pi camera straddles the +-pi branch cut and its
ROI spans the whole panorama; the reference then carries hardcoded split
handling (360_stitcher/meshwarper.cpp:93-102, theta=4.25/-0.25 at :620-627).
Here every camera's angular window is unwrapped around its own yaw (the rig
rotation is pure yaw, so u = s*(yaw + atan2_local)), giving N identical-size
bands -> one batched [N, C, bandH, bandW] tensor, with wraparound as static
slicing on an exactly periodic panorama (width forced to a multiple of
2^num_bands by micro-adjusting the warp scale).

Coordinate convention: panorama pixel x (integer = pixel center) IS the
cylinder coordinate u; v = v0 + y. Angle theta = u / scale.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from video_stitcher_tpu_torch.geometry.camera import CameraParams


# ----------------------------------------------------------------------
# projection
# ----------------------------------------------------------------------

def cylindrical_forward(cam: CameraParams, scale: float, x, y):
    """Source pixel(s) -> (u, v) cylinder px, with u unwrapped around cam.yaw.

    Valid for pure-yaw rigs: R = Ry(yaw) only shifts atan2 by yaw and leaves
    v invariant, so we evaluate atan2 in the camera-local frame (range
    (-pi/2..pi/2) for any forward-facing pixel) and add s*yaw.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    kinv = np.linalg.inv(cam.K)
    xl = kinv[0, 0] * x + kinv[0, 2]
    yl = kinv[1, 1] * y + kinv[1, 2]
    zl = 1.0
    u = scale * (cam.yaw + np.arctan2(xl, zl))
    v = scale * yl / np.hypot(xl, zl)
    return u, v


def detect_extents(cam: CameraParams, scale: float, src_w: int, src_h: int,
                   samples: int = 257) -> Tuple[float, float, float, float]:
    """(u_rel_min, u_rel_max, v_min, v_max) over the source border.

    Extrema of both u and v occur on the image border for this projection;
    the reference scans every pixel (RotationWarperBase::detectResultRoi),
    we scan a dense border sampling. u is relative to s*yaw.
    """
    xs = np.linspace(0, src_w - 1, samples)
    ys = np.linspace(0, src_h - 1, samples)
    bx = np.concatenate([xs, xs, np.zeros_like(ys), np.full_like(ys, src_w - 1)])
    by = np.concatenate([np.zeros_like(xs), np.full_like(xs, src_h - 1), ys, ys])
    u, v = cylindrical_forward(cam, scale, bx, by)
    u_rel = u - scale * cam.yaw
    return float(u_rel.min()), float(u_rel.max()), float(v.min()), float(v.max())


def detect_v_range(cam: CameraParams, scale: float, src_w: int, src_h: int):
    """(v_min, v_max) over the source border (detect_extents)."""
    _, _, vmin, vmax = detect_extents(cam, scale, src_w, src_h)
    return vmin, vmax


def cylindrical_backward_map(cam: CameraParams, scale: float,
                             u: np.ndarray, v: np.ndarray):
    """(u, v) cylinder px grids -> (map_x, map_y) source px coords.

    Out-of-frustum rays (p.z <= 0) map to (-1, -1) like the CUDA kernel
    (build_warp_maps.cu:103-106).
    """
    theta = np.asarray(u, np.float64) / scale
    dx = np.sin(theta)
    dz = np.cos(theta)
    dy = np.asarray(v, np.float64) / scale
    krinv = cam.K @ cam.R.T    # K * R^T, as warpers_cuda.cpp:134
    px = krinv[0, 0] * dx + krinv[0, 1] * dy + krinv[0, 2] * dz
    py = krinv[1, 0] * dx + krinv[1, 1] * dy + krinv[1, 2] * dz
    pz = krinv[2, 0] * dx + krinv[2, 1] * dy + krinv[2, 2] * dz
    good = pz > 0
    safe = np.where(good, pz, 1.0)
    mx = np.where(good, px / safe, -1.0).astype(np.float32)
    my = np.where(good, py / safe, -1.0).astype(np.float32)
    return mx, my


# ----------------------------------------------------------------------
# layout planning
# ----------------------------------------------------------------------

def _align_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align_down(x: int, m: int) -> int:
    return (x // m) * m


@dataclass(frozen=True)
class BandLayout:
    """Static panorama/band geometry (frozen, hashable)."""
    scale: float                 # cylinder px per radian at compose scale
    pano_w: int                  # periodic width if wrap, else union width
    pano_h: int
    v0: float                    # v of pano row 0 (v = v0 + y)
    u0: float                    # u of pano col 0 (u = u0 + x)
    band_w: int
    band_h: int
    corners: Tuple[int, ...]     # per-camera band-left x in pano coords (unwrapped)
    num_bands: int
    wrap: bool
    gap: int

    @property
    def align(self) -> int:
        return 1 << self.num_bands


def plan_band_layout(cams: Sequence[CameraParams], src_w: int, src_h: int,
                     blend_strength: float, wrap: bool,
                     max_bands: int | None = None) -> BandLayout:
    """Plan the compose-scale panorama. cams must already be at compose scale.

    Band count follows calibration.cpp:183-194: blend_width =
    sqrt(pano_area) * strength/100, num_bands = ceil(log2(blend_width)) - 1.
    """
    s0 = cams[0].focal                     # warped_image_scale * aspect, cal.cpp:291
    urmin, urmax, vmin, vmax = detect_extents(cams[0], s0, src_w, src_h)
    u_extent = urmax - urmin
    v_extent = vmax - vmin

    # First-pass pano size estimate for the band count
    est_w = s0 * 2 * math.pi if wrap else u_extent + s0 * (
        max(c.yaw for c in cams) - min(c.yaw for c in cams))
    est_area = est_w * v_extent
    blend_width = math.sqrt(est_area) * blend_strength / 100.0
    if blend_width < 1.0:
        num_bands = 0
    else:
        num_bands = max(0, int(math.ceil(math.log2(blend_width))) - 1)
        max_len = max(est_w, v_extent)
        num_bands = min(num_bands, int(math.ceil(math.log2(max_len))))
    if max_bands is not None:
        num_bands = min(num_bands, max_bands)
    align = 1 << num_bands
    gap = 3 * align                         # blenders.cpp:355 "gap = 3 * (1 << bands)"

    if wrap:
        pano_w = max(align, int(round(s0 * 2 * math.pi / align)) * align)
        scale = pano_w / (2 * math.pi)      # exact periodicity (deliberate deviation)
        # re-detect with the adjusted scale
        urmin, urmax, vmin, vmax = detect_extents(cams[0], scale, src_w, src_h)
        u_extent = urmax - urmin
        v_extent = vmax - vmin
    else:
        scale = s0

    pano_h = _align_up(int(math.ceil(v_extent)) + 2 * gap, align)
    v0 = (vmin + vmax) / 2.0 - pano_h / 2.0

    band_w = min(_align_up(int(math.ceil(u_extent)) + 2 * gap, align),
                 _align_up(int(math.ceil(s0 * 2 * math.pi)), align) if wrap else 1 << 30)
    if wrap:
        band_w = min(band_w, pano_w)

    # NOTE: windows are centered at scale*yaw with extents detected from
    # cams[0] — this assumes per-camera u-extents symmetric about the
    # yaw (true for the centered-principal-point rigs this framework
    # and the reference target; the 2*gap margin = 6*2^bands px then
    # absorbs the ~1 px W/2-vs-(W-1)/2 asymmetry). A rig with per-camera
    # FOV differences or principal-point offsets beyond the gap margin
    # would clip warped content at the band edge; such rigs need
    # per-camera extents and (urmin+urmax)/2 centering, like v0 does
    # for the v axis above.
    centers = [scale * c.yaw for c in cams]
    corners = [_align_down(int(round(ctr - band_w / 2.0)), align) for ctr in centers]

    if wrap:
        u0 = 0.0
        return BandLayout(scale=scale, pano_w=pano_w, pano_h=pano_h, v0=v0, u0=u0,
                          band_w=band_w, band_h=pano_h, corners=tuple(corners),
                          num_bands=num_bands, wrap=True, gap=gap)

    x0 = min(corners)
    x1 = max(c + band_w for c in corners)
    pano_w = _align_up(x1 - x0, align)
    corners = [c - x0 for c in corners]
    return BandLayout(scale=scale, pano_w=pano_w, pano_h=pano_h, v0=v0, u0=float(x0),
                      band_w=band_w, band_h=pano_h, corners=tuple(corners),
                      num_bands=num_bands, wrap=False, gap=gap)


def band_backward_maps(layout: BandLayout, cams: Sequence[CameraParams]
                       ) -> np.ndarray:
    """The host f64 builder of the per-camera band maps (replaces
    CylindricalWarperGpu::buildMaps, warpers_cuda.cpp:254-276): numpy f32
    [N, 2, band_h, band_w] of (map_x, map_y) source-pixel coords for the
    band whose pano-left is layout.corners[i]. The reference the card's
    band_backward_maps_device is held to; calibration uses the latter."""
    ys = np.arange(layout.band_h, dtype=np.float64) + layout.v0
    out = np.empty((len(cams), 2, layout.band_h, layout.band_w), np.float32)
    for i, cam in enumerate(cams):
        xs = (np.arange(layout.band_w, dtype=np.float64) + layout.u0
              + layout.corners[i])
        u, v = np.meshgrid(xs, ys)
        out[i, 0], out[i, 1] = cylindrical_backward_map(cam, layout.scale,
                                                        u, v)
    return out


def band_backward_maps_device(layout: BandLayout, cams: Sequence[CameraParams],
                              device) -> torch.Tensor:
    """Per-camera backward maps over each camera's band (replaces
    CylindricalWarperGpu::buildMaps, warpers_cuda.cpp:254-276), evaluated
    in f32 on `device` (f32 resolves sub-0.001 px at these magnitudes).
    Returns f32 [N, 2, band_h, band_w] of (map_x, map_y) source-pixel
    coords for the band whose pano-left is layout.corners[i]."""
    krinv = torch.as_tensor(
        np.stack([(cam.K @ cam.R.T) for cam in cams]).astype(np.float32),
        device=device)
    corners = torch.as_tensor(np.asarray(layout.corners, np.float32),
                              device=device)
    xs = (torch.arange(layout.band_w, dtype=torch.float32, device=device)
          + np.float32(layout.u0))
    u = xs[None, None, :] + corners[:, None, None]               # [N, 1, bw]
    v = (torch.arange(layout.band_h, dtype=torch.float32, device=device)
         + np.float32(layout.v0))[None, :, None]                 # [1, bh, 1]
    mx, my = eval_cyl_backward(krinv, u, v, np.float32(layout.scale))
    return torch.stack([mx, my], dim=1)


def eval_cyl_backward(krinv: torch.Tensor, u, v, scale):
    """Analytic per-camera cylindrical backward map at arbitrary pano
    coordinates (the math of CylindricalWarperGpu::buildMaps,
    warpers_cuda.cpp:254-276). krinv f32 [N, 3, 3] = K @ R.T per camera;
    u, v pano coords broadcastable to [N, h, w] (already offset by
    layout.u0 + corner and layout.v0); scale the cylinder radius. Returns
    (mx, my) with the -1 sentinel where the ray exits behind the camera
    (pz <= 0)."""
    theta = u / float(scale)
    dx = torch.sin(theta)
    dz = torch.cos(theta)
    dy = (v / float(scale)) + torch.zeros_like(theta)
    k = krinv[:, :, :, None, None]                               # [N,3,3,1,1]
    px = k[:, 0, 0] * dx + k[:, 0, 1] * dy + k[:, 0, 2] * dz
    py = k[:, 1, 0] * dx + k[:, 1, 1] * dy + k[:, 1, 2] * dz
    pz = k[:, 2, 0] * dx + k[:, 2, 1] * dy + k[:, 2, 2] * dz
    good = pz > 0
    safe = torch.where(good, pz, torch.ones_like(pz))
    mx = torch.where(good, px / safe, torch.full_like(px, -1.0))
    my = torch.where(good, py / safe, torch.full_like(py, -1.0))
    return mx, my
