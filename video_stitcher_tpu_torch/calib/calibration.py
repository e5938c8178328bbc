"""Offline calibration: frames -> (StitchGeometry, CalibState).

Torch twin of the JAX package's ``calib/calibration.py``. The phases of
stitch_calib / warpImages (360_stitcher/calibration.cpp:72-311):

  1. scales from WORK/SEAM/COMPOSE megapix      (calibration.cpp:269-281,147-153)
  2. fixed-rig camera model                      (calibration.cpp:28-68)
  3. seam-scale cylindrical warp of images+masks (calibration.cpp:91-127)
  4. gain solve + Voronoi seams (dilated when the
     CPW mesh is on)                             (calibration.cpp:131-135,208-234)
  5. compose-scale backward maps + seam weights
     -> weight pyramids                          (calibration.cpp:210-240)

Phases 3-4 are a tiny control plane and run on the host (numpy, scipy and
torch on the CPU); phase 5 builds the compose-scale tensors on the
card (or the device the caller names), where they stay. The CPW mesh
itself (phase 6, calibration.cpp:299-309) is solved by
``Stitcher.calibrate`` through ``mesh/pipeline.py`` and folded into the
maps by ``compose_fused_maps_from_disp``; a mesh the caller already has
goes in through ``calibrate(..., mesh_maps=...)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from video_stitcher_tpu_torch.blend.multiband import (
    build_weight_pyramids, crop_band, feather_weights, place_bands,
)
from video_stitcher_tpu_torch.calib.gain import solve_gains
from video_stitcher_tpu_torch.calib.seam import find_seams
from video_stitcher_tpu_torch.calib.state import CalibState
from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.geometry.camera import (
    CameraParams, fixed_rig_cameras,
)
from video_stitcher_tpu_torch.geometry.cylindrical import (
    BandLayout, band_backward_maps_device, cylindrical_backward_map,
    eval_cyl_backward, plan_band_layout,
)
from video_stitcher_tpu_torch.mesh.mesh2map import upsample_mesh
from video_stitcher_tpu_torch.ops.morphology import dilate3x3
from video_stitcher_tpu_torch.ops.remap import remap_planar
from video_stitcher_tpu_torch.ops.resize import device_constant, resize_planar
from video_stitcher_tpu_torch.utils import trace
from video_stitcher_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class StitchGeometry:
    """Static geometry of one configuration."""
    layout: BandLayout
    num_images: int
    src_w: int                 # full-res input size
    src_h: int
    compose_w: int
    compose_h: int
    compose_scale: float
    work_scale: float
    num_bands: int
    blend_type: str
    #: blend pyramid mode: "highest" (f32) or "bf16" (bf16 storage)
    blend_precision: str
    wrap: bool
    #: True when the per-frame path resizes the source to compose scale
    #: before warping (the reference's resize -> remap chain,
    #: timed.cpp:75-90): strong minification, or cfg.fuse_maps=False.
    prewarp: bool = False
    #: "exact" or "reference" (see StitcherConfig.map_convention)
    map_convention: str = "exact"

    @property
    def pano_w(self) -> int:
        return self.layout.pano_w

    @property
    def pano_h(self) -> int:
        return self.layout.pano_h

    #: dims of the source the warp samples: compose under prewarp
    @property
    def warp_src_w(self) -> int:
        return self.compose_w if self.prewarp else self.src_w

    @property
    def warp_src_h(self) -> int:
        return self.compose_h if self.prewarp else self.src_h

    #: dims of the coordinate system the raw band maps are built in:
    #: full-res for "exact", compose for "reference"
    @property
    def map_built_w(self) -> int:
        return self.src_w if self.map_convention == "exact" \
            else self.compose_w

    @property
    def map_built_h(self) -> int:
        return self.src_h if self.map_convention == "exact" \
            else self.compose_h


def _compose_size(cfg: StitcherConfig) -> Tuple[int, int]:
    # timed.cpp:77 / calibration.cpp:161-165: resize only if |scale-1| > 0.1
    if abs(cfg.compose_scale - 1.0) > 1e-1:
        return (int(cfg.input_width * cfg.compose_scale),
                int(cfg.input_height * cfg.compose_scale))
    return cfg.input_width, cfg.input_height


def plan_geometry(cfg: StitcherConfig
                  ) -> Tuple[StitchGeometry, List[CameraParams]]:
    cams_work = fixed_rig_cameras(cfg.num_images, cfg.input_width,
                                  cfg.input_height, cfg.work_scale,
                                  cfg.fov_deg, cfg.yaws)
    cw, ch = _compose_size(cfg)
    cams_compose = [c.scaled(cfg.compose_work_aspect) for c in cams_work]
    max_bands = None if cfg.blend_type == "multiband" else 0
    layout = plan_band_layout(cams_compose, cw, ch, cfg.blend_strength,
                              wrap=cfg.wrap_around, max_bands=max_bands)
    compose_scale = cw / cfg.input_width
    resizes = abs(compose_scale - 1.0) > 1e-1    # timed.cpp:75 condition
    geom = StitchGeometry(
        layout=layout, num_images=cfg.num_images,
        src_w=cfg.input_width, src_h=cfg.input_height,
        compose_w=cw, compose_h=ch,
        compose_scale=compose_scale,
        work_scale=cfg.work_scale,
        num_bands=layout.num_bands, blend_type=cfg.blend_type,
        blend_precision=("bf16" if cfg.blend_dtype == "bfloat16"
                         else "highest"),
        wrap=cfg.wrap_around,
        prewarp=(compose_scale < 0.5
                 or (not cfg.fuse_maps and resizes)),
        map_convention=cfg.map_convention)
    return geom, cams_compose


def map_cams(cfg: StitcherConfig, cams_compose: List[CameraParams]
             ) -> List[CameraParams]:
    """Cameras the backward band maps are evaluated with: source-resolution
    intrinsics for "exact", the compose intrinsics for "reference"
    (calibration.cpp:171-173)."""
    if cfg.map_convention == "exact":
        return fixed_rig_cameras(cfg.num_images, cfg.input_width,
                                 cfg.input_height, 1.0, cfg.fov_deg,
                                 cfg.yaws)
    return cams_compose


# ----------------------------------------------------------------------
# seam-scale canvases
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class SeamCanvas:
    w: int
    h: int
    scale: float       # cylinder px/radian at seam scale
    ratio: float       # seam px per compose px (exact)
    v0: float


def _plan_seam_canvas(geom: StitchGeometry, cfg: StitcherConfig
                      ) -> SeamCanvas:
    ratio = cfg.seam_scale / geom.compose_scale
    s = geom.layout.scale * ratio
    if geom.wrap:
        w = max(8, int(round(s * 2 * math.pi)))
    else:
        w = max(8, int(math.ceil(geom.pano_w * ratio)))
    h = max(8, int(math.ceil(geom.pano_h * ratio)))
    return SeamCanvas(w=w, h=h, scale=s, ratio=ratio,
                      v0=geom.layout.v0 * ratio)


def _seam_canvas_maps(geom: StitchGeometry, sc: SeamCanvas,
                      cams_compose: List[CameraParams], cfg: StitcherConfig):
    """Backward maps from the full seam canvas into seam-scale sources."""
    ratio_cam = cfg.seam_scale / geom.compose_scale
    cams_seam = [c.scaled(ratio_cam) for c in cams_compose]
    u = (np.arange(sc.w, dtype=np.float64)
         + geom.layout.u0 * sc.ratio)[None, :] + np.zeros((sc.h, 1))
    v = (np.arange(sc.h, dtype=np.float64) + sc.v0)[:, None] \
        + np.zeros((1, sc.w))
    return [cylindrical_backward_map(cam, sc.scale, u, v)
            for cam in cams_seam]


def _validity(mx, my, w, h):
    """Warp validity like remap-NEAREST of a 255 canvas with BORDER_CONSTANT
    (calibration.cpp:224-227). numpy or torch."""
    return (mx > -0.5) & (mx < w - 0.5) & (my > -0.5) & (my < h - 0.5)


def _seam_size(cfg: StitcherConfig) -> Tuple[int, int]:
    """(w, h) of the seam-scale source images."""
    return (int(round(cfg.input_width * cfg.seam_scale)),
            int(round(cfg.input_height * cfg.seam_scale)))


def _seam_masks(masks: np.ndarray, cfg: StitcherConfig,
                geom: StitchGeometry) -> np.ndarray:
    """Voronoi seams over the seam-scale warp masks, dilated 3x3 when the
    CPW mesh is on (calibration.cpp:131-135,208-234)."""
    seam_masks = find_seams(masks, periodic_x=geom.wrap)
    if cfg.enable_local:
        seam_masks = dilate3x3(torch.from_numpy(
            seam_masks.astype(np.float32))).numpy()
    return seam_masks


def _seam_phase(frames: np.ndarray, cfg: StitcherConfig,
                geom: StitchGeometry, cams_compose):
    """Seam-scale host control plane: warps, gain solve, Voronoi seams
    (calibration.cpp:91-135)."""
    sc = _plan_seam_canvas(geom, cfg)
    seam_w, seam_h = _seam_size(cfg)
    canvas_maps = _seam_canvas_maps(geom, sc, cams_compose, cfg)
    warped = np.zeros((cfg.num_images, sc.h, sc.w, 3), np.float32)
    masks = np.zeros((cfg.num_images, sc.h, sc.w), np.uint8)
    for i, (mx, my) in enumerate(canvas_maps):
        small = resize_planar(
            torch.from_numpy(np.moveaxis(frames[i], -1, 0).astype(np.float32)),
            seam_h, seam_w)
        out = remap_planar(small, torch.from_numpy(mx), torch.from_numpy(my))
        warped[i] = np.moveaxis(out.numpy(), 0, -1)
        masks[i] = _validity(mx, my, seam_w, seam_h).astype(np.uint8) * 255
    with trace.span("calibrate.gains"):
        gains = solve_gains(warped, masks)
    with trace.span("calibrate.seams"):
        seam_masks = _seam_masks(masks, cfg, geom)
    return sc, gains, seam_masks


def _compose_products_device(seam_masks: torch.Tensor,
                             band_maps: torch.Tensor, geom: StitchGeometry,
                             sc: SeamCanvas):
    """Compose-scale blend weights and overlap masks, f32 [N, bandH,
    bandW] each on band_maps' device. weights0: the seam mask sampled at
    each band pixel AND warp validity (calibration.cpp:224-240 as fed to
    init_gpu). overlap_masks: warp validity AND >= 2 cameras cover the
    pano pixel."""
    lay = geom.layout
    dev = band_maps.device
    valid = _validity(band_maps[:, 0], band_maps[:, 1],
                      geom.map_built_w, geom.map_built_h)
    f32 = np.float32
    ys = ((torch.arange(lay.band_h, dtype=torch.float32, device=dev)
           + float(f32(lay.v0))) * float(f32(sc.ratio)) - float(f32(sc.v0)))
    corners = torch.as_tensor(np.asarray(lay.corners, np.float32),
                              device=dev)
    # canvas col of band col x of camera i: (x + corners[i]) * ratio (the
    # canvas origin's u0*ratio cancels, as ys subtracts sc.v0)
    xs = ((torch.arange(lay.band_w, dtype=torch.float32, device=dev)[None, :]
           + corners[:, None]) * float(f32(sc.ratio)))            # [N, bw]
    border = "wrap" if geom.wrap else "replicate"
    mys = ys[:, None].expand(lay.band_h, lay.band_w)
    seam_band = torch.stack([
        remap_planar(seam_masks[i][None], xs[i][None, :].expand(
            lay.band_h, lay.band_w), mys, border=border)[0]
        for i in range(band_maps.shape[0])])
    weights0 = torch.where(valid, seam_band / 255.0,
                           torch.zeros_like(seam_band))
    vb = valid.to(torch.float32)
    counts = place_bands(vb[:, None], lay, 0)
    overlap_masks = torch.stack([
        vb[i] * (crop_band(counts, lay, i, 0)[0] >= 2.0)
        for i in range(vb.shape[0])])
    return weights0, overlap_masks


def _f32(values: tuple) -> np.ndarray:
    return np.asarray(values, np.float32)


def _prewarp_scale(compose_w: int, compose_h: int, src_w: int,
                   src_h: int) -> np.ndarray:
    """f32 [1, 2, 1, 1]: the compose size over the source size, x then
    y."""
    return np.asarray([np.float32(compose_w / src_w),
                       np.float32(compose_h / src_h)],
                      np.float32).reshape(1, 2, 1, 1)


def _to_warp_source(maps, geom: StitchGeometry):
    """Raw band-map values [N, 2, bh, bw] -> warp-source pixel
    coordinates. "exact": the maps already are full-res source coords;
    under prewarp they go forward into the resized source's coords by the
    cv2 resize pixel-centre relation per axis (dst = (src + 0.5) * out/in
    - 0.5). "reference": they were built in compose coordinates; when the
    online path skips the resize (timed.cpp:75 condition) convert back
    through the rounded compose scale, reproducing the reference's
    half-pixel + truncation bias."""
    if geom.map_convention == "exact":
        if geom.prewarp:
            sc = device_constant(_prewarp_scale, (
                geom.compose_w, geom.compose_h, geom.src_w, geom.src_h),
                maps.device)
            maps = (maps + np.float32(0.5)) * sc - np.float32(0.5)
        return maps
    s = geom.compose_scale
    if not geom.prewarp and abs(s - 1.0) > 1e-1:
        maps = (maps + 0.5) / s - 0.5
    return maps


def compose_fused_maps_device(band_maps: torch.Tensor,
                              mesh_maps: Optional[torch.Tensor],
                              geom: StitchGeometry) -> torch.Tensor:
    """Fold the mesh warp (optional) and the compose resize into the global
    band maps (timed.cpp:77-103 semantics); mesh coords past the band edge
    sample the clamped edge of the global map (replicate border)."""
    maps = band_maps
    if mesh_maps is not None:
        maps = torch.stack([
            remap_planar(bm, mm[0], mm[1], border="replicate")
            for bm, mm in zip(band_maps, mesh_maps)])
    return _to_warp_source(maps, geom).contiguous()


def compose_fused_maps(geom: StitchGeometry, band_maps: np.ndarray,
                       mesh_maps: Optional[np.ndarray] = None,
                       device=None) -> np.ndarray:
    """The host entry of compose_fused_maps_device: numpy band maps (and
    mesh maps) [N, 2, band_h, band_w] in, numpy f32 fused maps out,
    computed on `device` (the card unless the caller asks for another;
    raises on a host without CUDA)."""
    dev = resolve_device(device)
    mesh = None if mesh_maps is None else torch.as_tensor(
        np.asarray(mesh_maps, np.float32), device=dev)
    return compose_fused_maps_device(
        torch.as_tensor(np.asarray(band_maps, np.float32), device=dev),
        mesh, geom).cpu().numpy()


def krinv_device(cams: List[CameraParams], device) -> torch.Tensor:
    """K @ R.T per camera, f32 [N, 3, 3] on `device`: the only camera
    state compose_fused_maps_from_disp needs."""
    return torch.as_tensor(
        np.stack([c.K @ c.R.T for c in cams]).astype(np.float32),
        device=device)


def compose_fused_maps_from_disp(krinv: torch.Tensor, disp_c: torch.Tensor,
                                 geom: StitchGeometry) -> torch.Tensor:
    """The fused maps of a solved mesh, gather-free: the coarse backward
    mesh displacement is upsampled to the band (align-corners matmuls)
    and the analytic cylindrical backward map is evaluated at the
    mesh-warped band coordinates. krinv f32 [N, 3, 3] (krinv_device);
    disp_c f32 [N, 2, hc, wc] in full-res pixels (coarse_backward_disp).
    Returns fused maps f32 [N, 2, band_h, band_w] in warp-source
    coordinates, as compose_fused_maps_device."""
    lay = geom.layout
    bh, bw = lay.band_h, lay.band_w
    dev = disp_c.device
    bd = upsample_mesh(disp_c, bh, bw)                   # [N, 2, bh, bw]
    gx = torch.arange(bw, dtype=torch.float32, device=dev)[None, None, :]
    gy = torch.arange(bh, dtype=torch.float32, device=dev)[None, :, None]
    corners = device_constant(_f32, (tuple(lay.corners),), dev)
    u = gx - bd[:, 0] + np.float32(lay.u0) + corners[:, None, None]
    v = gy - bd[:, 1] + np.float32(lay.v0)
    mx, my = eval_cyl_backward(krinv, u, v, np.float32(lay.scale))
    return _to_warp_source(torch.stack([mx, my], dim=1), geom).contiguous()


def prewarp_source(x: torch.Tensor, geom: StitchGeometry) -> torch.Tensor:
    """Planar f32 frames [..., H, W] resized to the warp source (compose)
    size under prewarp, the reference's per-frame cuda::resize
    (timed.cpp:77); unchanged otherwise."""
    if not geom.prewarp:
        return x
    return resize_planar(x, geom.compose_h, geom.compose_w)


def _compose_aux(cfg: StitcherConfig, geom: StitchGeometry,
                 cams_compose: List[CameraParams], sc: SeamCanvas,
                 seam_masks: np.ndarray, device) -> dict:
    """The compose-scale calibration products on `device`: band maps,
    blend weights (feathered for blend_type="feather") and overlap masks,
    with the host-side seam products they came from."""
    cams_map = map_cams(cfg, cams_compose)
    band_maps = band_backward_maps_device(geom.layout, cams_map, device)
    weights0, overlap_masks = _compose_products_device(
        torch.as_tensor(seam_masks.astype(np.float32), device=device),
        band_maps, geom=geom, sc=sc)
    if geom.blend_type == "feather":
        w0_np = weights0.cpu().numpy()
        w = feather_weights((w0_np > 0.5).astype(np.uint8) * 255)
        weights0 = torch.as_tensor(
            np.where(w0_np > 0, w, 0.0).astype(np.float32), device=device)
    return {"cams_compose": cams_compose, "cams_map": cams_map,
            "band_maps": band_maps, "weights0": weights0,
            "seam_masks": seam_masks, "seam_canvas": sc,
            "overlap_masks": overlap_masks}


def calibrate(frames: np.ndarray, cfg: StitcherConfig,
              mesh_maps=None, device=None):
    """frames: u8 [N, H, W, 3]. Returns (geom, CalibState, aux dict), the
    state's tensors on `device` (the card unless the caller asks for
    another; raises on a host without CUDA).

    mesh_maps: optional f32 [N, 2, band_h, band_w] CPW backward maps in
    band coordinates (numpy or a tensor), composed into the fused maps;
    None gives the global warp alone (Stitcher.calibrate then solves the
    CPW mesh itself).

    Traced (utils/trace), each phase is a span: ``calibrate.cameras``
    (the geometry), ``calibrate.warps`` (the seam-scale warps, with
    ``calibrate.gains`` and ``calibrate.seams`` in it), ``calibrate.maps``
    (the compose-scale maps, weights and overlaps) and
    ``calibrate.weights`` (the weight pyramids and the fused maps)."""
    device = resolve_device(device)
    frames = np.asarray(frames)
    if frames.shape[0] != cfg.num_images:
        raise ValueError(f"{frames.shape[0]} frames for {cfg.num_images} "
                         f"cameras")
    with trace.span("calibrate.cameras"):
        geom, cams_compose = plan_geometry(cfg)
    with trace.span("calibrate.warps"):
        sc, gains, seam_masks = _seam_phase(frames, cfg, geom, cams_compose)
    with trace.span("calibrate.maps"):
        aux = _compose_aux(cfg, geom, cams_compose, sc, seam_masks, device)
    with trace.span("calibrate.weights"):
        weight_pyr, valid_mask = build_weight_pyramids(aux["weights0"],
                                                       geom.layout)
        state = CalibState(
            fused_maps=compose_fused_maps_device(
                aux["band_maps"], None if mesh_maps is None else
                torch.as_tensor(mesh_maps, dtype=torch.float32,
                                device=device), geom),
            gains=torch.as_tensor(np.asarray(gains, np.float32),
                                  device=device),
            weight_pyr=tuple(w.contiguous() for w in weight_pyr),
            valid_mask=valid_mask,
        )
    return geom, state, aux


def rebuild_aux(cfg: StitcherConfig, geom: StitchGeometry,
                device=None) -> dict:
    """The calibration aux dict without frames, for a loaded checkpoint
    (Stitcher.load_calibration): the seam masks are Voronoi over warp
    validity only (calibration.cpp:118-135), never image content, so
    every member but the gains (kept in the CalibState) follows from the
    geometry and equals what calibrate returned. On `device`, as
    calibrate."""
    device = resolve_device(device)
    _, cams_compose = plan_geometry(cfg)
    sc = _plan_seam_canvas(geom, cfg)
    seam_w, seam_h = _seam_size(cfg)
    masks = np.stack([
        _validity(mx, my, seam_w, seam_h).astype(np.uint8) * 255
        for mx, my in _seam_canvas_maps(geom, sc, cams_compose, cfg)])
    return _compose_aux(cfg, geom, cams_compose, sc,
                        _seam_masks(masks, cfg, geom), device)
