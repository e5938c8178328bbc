"""K2: the separable two-pass warp for pure-yaw cylindrical rigs.

Torch twin of the JAX package's ``experiments/remap_separable.py``. For
R = Ry(yaw) the cylindrical backward map factors exactly: the source x
is a function of the band column only (``global_mx``), the source y a
per-column affine function of the band row. The per-frame resample then
splits into

  Pass H   I1[n, c, y, xb] = sum_s src[n, c, y, s] * Wx[n, xb, s]
           one banded-matrix product per camera (``pass_h``: a bf16
           ``torch.bmm`` with f32 accumulation), every source row
           resampled by the same x-map;
  Pass V   out[n, c, yb, xb] = bilinear(I1[n, c], x=vmaps[n, 0, yb, xb],
                                        y=vmaps[n, 1, yb, xb])
           (``pass_v``: kernel K2, ``csrc/remap_separable.cu``). For the
           global path vmaps x == xb; a mesh adds a local displacement,
           bounded by the XPAD lane halo around I1.

Like the TPU kernel, K2 rounds its x tent weights to bf16 and keeps the y
weights and the sums in f32, evaluating the tents with the TPU kernel's
f32 arithmetic, so on the same I1 it gives the TPU kernel's values. Taps
outside I1 add 0, so the -2 marker that ``plan_separable`` writes for
invalid pixels gives exactly 0.

Nothing on the stitcher's path calls this module, as the JAX Stitcher
does not call its experiment: it is the counterpart of the TPU kernel,
driven by ``chip_smoke.py`` and the tests. The TPU kernel's strip
schedule (``strip_off``, ``chunk_row``, ``sh``, ``whc``) only orders its
DMAs and is not carried; ``plan_separable`` still rejects maps whose
rows the TPU kernel's row windows could not cover.

K2 walks the tile plan of its vmaps (``plan_pass_v``,
``ops/warp_tiles.py``), built once by the caller that keeps its vmaps,
otherwise by each call. A tensor on the CPU goes through
``pass_v_plain``; a CUDA tensor goes through K2 or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_stitcher_tpu_torch.ops.warp_tiles import (
    TilePlan, check_launchable, plan_tiles,
)

ROW_BLOCK = 8
CHUNK_W = 32
XPAD = 16                  # static x halo around each band column (mesh
                           # residual), zero lanes left of I1
LANE_PAD_R = 128 - XPAD    # right zero lanes: the padded width stays a
                           # multiple of 128, as the TPU kernel needs
ROW_ALIGN = 16
_ROW_SLACK = 8             # the TPU planner's default row slack
_X_MAP_ATOL = 1e-3         # px a pure-yaw x map may vary down a column


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SepPlan(NamedTuple):
    """Pass-H matrix, Pass-V maps and the padded sizes."""
    wx: np.ndarray           # f32 [N, bw_p, src_w] Pass-H matrix
    vmaps: np.ndarray        # f32 [N, 2, bh_p, bw_p]: (band-x, source-y)
    i1_hp: int               # padded I1 height (= padded source height)
    bh_p: int
    bw_p: int


def global_x_map(fused_maps: np.ndarray) -> np.ndarray:
    """The y-independent source x of each band column, f32 [N, bw], from
    fused backward maps f32 [N, 2, bh, bw] of a pure-yaw global warp.

    Raises ValueError unless the maps meet the separable warp's
    precondition: the x map agrees down each band column within
    _X_MAP_ATOL px (x a function of the column only), and it rises
    strictly over the band. A column that leaves the frustum carries the
    -1 marker and breaks the rise; a column past the source's edge
    (x < -1 or x >= W) is kept, and Pass H gives it no taps."""
    mx = np.asarray(fused_maps, np.float32)[:, 0]
    gmx = mx[:, 0]
    spread = float(np.abs(mx - gmx[:, None]).max())
    if spread > _X_MAP_ATOL:
        raise ValueError(f"the x map varies by {spread:.3g} px down a band "
                         f"column: the separable warp needs a pure-yaw "
                         f"global warp (x a function of the column only)")
    if not (np.diff(gmx, axis=1) > 0).all():
        raise ValueError("the global x map does not rise strictly over "
                         "the band (a column outside the frustum carries "
                         "the -1 marker)")
    return gmx.copy()


def pad_maps(fused_maps: np.ndarray, global_mx: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad fused maps [N, 2, bh, bw] to ROW_BLOCK / 128 multiples with -1
    (invalid, so padded outputs are 0) and extend global_mx [N, bw]
    linearly, so it keeps rising over the padded columns."""
    n, _, bh, bw = fused_maps.shape
    ph, pw = _round_up(bh, ROW_BLOCK), _round_up(bw, 128)
    maps = np.full((n, 2, ph, pw), -1.0, np.float32)
    maps[:, :, :bh, :bw] = fused_maps
    step = global_mx[:, -1:] - global_mx[:, -2:-1]
    ext = global_mx[:, -1:] + step * np.arange(1, pw - bw + 1)
    gmx = np.concatenate([global_mx, ext], axis=1).astype(np.float32)
    return maps, gmx


def plan_separable(fused_maps: np.ndarray, global_mx: np.ndarray,
                   src_h: int, src_w: int) -> SepPlan:
    """fused_maps: f32 [N, 2, bh_p, bw_p] (full warp incl. any mesh);
    global_mx: f32 [N, bw_p], the y-independent global x-map (full-res
    source coords per band column). Both padded as ``pad_maps`` pads.

    Raises ValueError when a pixel's x residual against its band column
    does not fit the XPAD halo, or when the TPU kernel's row windows
    could not cover the rows a pixel reads."""
    n, _, bh, bw = fused_maps.shape
    if bh % ROW_BLOCK or bw % 128:
        raise ValueError(f"maps {bh}x{bw} are not padded to "
                         f"{ROW_BLOCK}x128 multiples (pad_maps)")
    i1_hp = _round_up(src_h, ROW_ALIGN)

    # --- Pass-H banded matrix (bilinear tap weights of global_mx) ---
    wx = np.zeros((n, bw, src_w), np.float32)
    cols = np.arange(bw)
    for i in range(n):
        mxg = global_mx[i]
        x0 = np.floor(mxg).astype(np.int64)
        fx = (mxg - x0).astype(np.float32)
        ok0 = (x0 >= 0) & (x0 < src_w)
        ok1 = (x0 + 1 >= 0) & (x0 + 1 < src_w)
        np.add.at(wx[i], (cols[ok0], x0[ok0]), (1.0 - fx)[ok0])
        np.add.at(wx[i], (cols[ok1], np.clip(x0 + 1, 0, src_w - 1)[ok1]),
                  fx[ok1])

    # --- Pass-V maps: x through the inverse of global_mx, y unchanged ---
    vmaps = np.empty((n, 2, bh, bw), np.float32)
    for i in range(n):
        mxg = global_mx[i].astype(np.float64)
        order = np.argsort(mxg)
        mx_f = fused_maps[i, 0].astype(np.float64)
        inv = np.interp(mx_f.ravel(), mxg[order],
                        np.arange(bw, dtype=np.float64)[order],
                        left=-2.0, right=-2.0).reshape(bh, bw)
        # invalid: the -1.0 marker (<= -1 after any scale conversion) or a
        # fused x outside the global map's range (inv pinned to -2)
        invalid = (mx_f <= -1) | (inv <= -1.5)
        vmaps[i, 0] = np.where(invalid, -2.0, np.clip(inv, 0.0, bw - 1.0))
        vmaps[i, 1] = np.where(invalid, -2.0, fused_maps[i, 1])

    # the x residual must fit the static halo
    gx = np.arange(bw, dtype=np.float32)[None, None, :]
    valid_x = vmaps[:, 0] > -1
    resid = np.abs(vmaps[:, 0] - gx)
    rmax = float(resid[valid_x].max()) if valid_x.any() else 0.0
    if rmax + 2 > XPAD:
        raise ValueError(f"x-residual {rmax:.1f}px exceeds XPAD={XPAD}")

    _check_row_windows(vmaps[:, 1], src_h, i1_hp)
    return SepPlan(wx=wx, vmaps=vmaps, i1_hp=i1_hp, bh_p=bh, bw_p=bw)


def _check_row_windows(my: np.ndarray, src_h: int, i1_hp: int) -> None:
    """The TPU kernel's tap-coverage condition on the Pass-V y map
    [N, bh, bw]: each ROW_BLOCK x CHUNK_W chunk reads its rows through a
    window of whc rows, aligned to ROW_ALIGN inside a strip of sh rows
    that starts on a multiple of 8, both sized by the largest need and
    capped at i1_hp. Raises ValueError for maps whose rows those windows
    would not cover; the windows themselves are not kept (K2 reads I1
    directly)."""
    n, bh, bw = my.shape
    nrb, ncc = bh // ROW_BLOCK, bw // CHUNK_W
    my = my.reshape(n, nrb, ROW_BLOCK, ncc, CHUNK_W)
    mv = (my > -1) & (my < src_h)
    big = 1e9
    my_min = np.where(mv, my, big).min(axis=(2, 4))
    my_max = np.where(mv, my, -big).max(axis=(2, 4))
    empty = my_min > my_max
    my_min[empty] = 0.0
    my_max[empty] = 0.0
    req_lo = np.clip(np.floor(my_min) - 1, 0, i1_hp - 1).astype(np.int64)
    req_hi = np.clip(np.floor(my_max) + 1, 0, i1_hp - 1).astype(np.int64)

    whc = int((req_hi - req_lo + 1).max()) + (ROW_ALIGN - 1) + _ROW_SLACK
    whc = min(_round_up(max(whc, ROW_ALIGN), ROW_ALIGN), i1_hp)

    big_i = np.int64(1 << 40)
    rb_lo = np.where(empty, big_i, req_lo).min(axis=2)
    rb_hi = np.where(empty, np.int64(-1), req_hi).max(axis=2)
    bad = rb_lo > rb_hi
    rb_lo = np.where(bad, 0, rb_lo)
    rb_hi = np.where(bad, 0, rb_hi)
    rb_lo8 = (rb_lo // 8) * 8
    sh = int((rb_hi - rb_lo8 + 1).max()) + _ROW_SLACK
    sh = min(_round_up(max(sh, whc, ROW_ALIGN), ROW_ALIGN), i1_hp)

    strip_off = np.minimum(rb_lo8, i1_hp - sh)
    chunk_row = ((req_lo - strip_off[:, :, None]) // ROW_ALIGN) * ROW_ALIGN
    win_lo = strip_off[:, :, None] + np.minimum(chunk_row, sh - whc)
    cover = (win_lo <= req_lo) & (win_lo + whc > req_hi)
    if not cover[~empty].all():
        raise ValueError("the y map spans more rows per chunk than the "
                         "TPU kernel's row windows cover")


def source_planar(frames_u8: torch.Tensor, i1_hp: int) -> torch.Tensor:
    """u8 RGB frames [N, H, W, 3] -> Pass-H source bf16 [N, 3, i1_hp, W]
    (exact: bf16 holds every integer up to 256), rows past H zero."""
    src = frames_u8.permute(0, 3, 1, 2).to(torch.bfloat16)
    return F.pad(src, (0, 0, 0, i1_hp - src.shape[2])).contiguous()


def pass_h(src: torch.Tensor, wx_bf16: torch.Tensor) -> torch.Tensor:
    """src bf16 [N, C, Hp, S] x wx bf16 [N, bw, S] -> I1 bf16
    [N, C, Hp, XPAD + bw + LANE_PAD_R]: one product per camera,
    accumulated in f32 and rounded to bf16 once, with the zero lane halo
    applied."""
    n, c, hp, s = src.shape
    bw = wx_bf16.shape[1]
    # cuBLAS may reduce a bf16 product's partial sums in bf16 unless this
    # flag is off; the TPU's Pass H accumulates in f32
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        i1 = torch.bmm(src.reshape(n, c * hp, s), wx_bf16.transpose(1, 2))
    finally:
        flags.allow_bf16_reduced_precision_reduction = before
    return F.pad(i1.reshape(n, c, hp, bw), (XPAD, LANE_PAD_R)).contiguous()


def _check(i1, vmaps):
    if i1.dim() != 4 or vmaps.dim() != 4 or vmaps.shape[1] != 2:
        raise ValueError(f"want i1 [N, C, Hp, Wp] and vmaps [N, 2, bh, bw], "
                         f"got {tuple(i1.shape)} and {tuple(vmaps.shape)}")
    if i1.shape[0] != vmaps.shape[0]:
        raise ValueError(f"{i1.shape[0]} I1 images for {vmaps.shape[0]} "
                         f"maps")
    if i1.shape[3] != vmaps.shape[3] + XPAD + LANE_PAD_R:
        raise ValueError(f"I1 width {i1.shape[3]} != band width "
                         f"{vmaps.shape[3]} + XPAD + LANE_PAD_R")
    if i1.dtype != torch.bfloat16 or vmaps.dtype != torch.float32:
        raise TypeError("i1 must be bfloat16 and vmaps float32")
    if i1.device != vmaps.device:
        raise ValueError("i1 and vmaps must share a device")


def pass_v_plain(i1: torch.Tensor, vmaps: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2 (any device): the same gather, the
    same weight arithmetic and rounding, the same order of sums."""
    _check(i1, vmaps)
    n, ch, hp, wp = i1.shape
    bh, bw = vmaps.shape[2], vmaps.shape[3]
    # the TPU kernel's x arithmetic: the tent is evaluated relative to the
    # first lane of the output column's CHUNK_W window, which decides
    # where f32 rounds; outside lanes [-2, wp + 1] every tap is out
    base = ((torch.arange(bw, device=vmaps.device) // CHUNK_W) * CHUNK_W
            - XPAD).to(torch.float32)
    lx = torch.clamp(vmaps[:, 0], -2.0 - XPAD, wp + 1.0 - XPAD) - base
    ly = torch.clamp(vmaps[:, 1], -2.0, hp + 1.0)
    kx, ky = torch.floor(lx), torch.floor(ly)
    wx0 = (1.0 - (lx - kx)).to(torch.bfloat16).float()[:, None]
    wx1 = (1.0 - ((kx + 1.0) - lx)).to(torch.bfloat16).float()[:, None]
    wy0 = (1.0 - (ly - ky))[:, None]
    wy1 = (1.0 - ((ky + 1.0) - ly))[:, None]
    x0 = (kx + base + XPAD).to(torch.int64)
    y0 = ky.to(torch.int64)
    flat = i1.float().reshape(n, ch, hp * wp)

    def tap(ix, iy):
        ok = (ix >= 0) & (ix < wp) & (iy >= 0) & (iy < hp)
        idx = (iy.clamp(0, hp - 1) * wp + ix.clamp(0, wp - 1)).reshape(
            n, 1, bh * bw).expand(n, ch, bh * bw)
        v = torch.gather(flat, 2, idx).reshape(n, ch, bh, bw)
        return torch.where(ok[:, None], v, torch.zeros_like(v))

    h0 = wx0 * tap(x0, y0) + wx1 * tap(x0 + 1, y0)
    h1 = wx0 * tap(x0, y0 + 1) + wx1 * tap(x0 + 1, y0 + 1)
    return wy0 * h0 + wy1 * h1


def tap_origins(vmaps: torch.Tensor, hp: int, wp: int):
    """The top-left tap (padded lane x0, row y0) of each pixel's 2x2
    footprint in I1, f32 [N, bh, bw] each, as K2 computes it
    (``pass_v_plain``'s arithmetic; a NaN clamps to the low bound, as
    fmaxf does)."""
    bw = vmaps.shape[3]
    base = ((torch.arange(bw, device=vmaps.device) // CHUNK_W) * CHUNK_W
            - XPAD).to(torch.float32)
    lo_x = -2.0 - XPAD
    lx = torch.clamp(torch.nan_to_num(vmaps[:, 0], nan=lo_x), lo_x,
                     wp + 1.0 - XPAD) - base
    ly = torch.clamp(torch.nan_to_num(vmaps[:, 1], nan=-2.0), -2.0,
                     hp + 1.0)
    return torch.floor(lx) + base + XPAD, torch.floor(ly)


def plan_pass_v(vmaps: torch.Tensor, hp: int, wp: int) -> TilePlan:
    """K2's tile plan of vmaps f32 [N, 2, bh, bw] over an I1 of hp rows
    and wp padded lanes, on the vmaps' device."""
    return plan_tiles(*tap_origins(vmaps, hp, wp), hp, wp)


def _lib_fn():
    from video_stitcher_tpu_torch import _build
    fn = _build.load("remap_separable").remap_separable_v
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pass_v(i1: torch.Tensor, vmaps: torch.Tensor,
           plan: TilePlan | None = None) -> torch.Tensor:
    """K2: i1 bf16 [N, C, Hp, bw + XPAD + LANE_PAD_R] (``pass_h``'s
    output), vmaps f32 [N, 2, bh, bw] -> f32 [N, C, bh, bw]; `plan` is
    ``plan_pass_v`` of these vmaps and this I1 size, built here when None.
    Counts its CUDA launches in ``pass_v.launches``."""
    _check(i1, vmaps)
    if i1.device.type == "cpu":
        return pass_v_plain(i1, vmaps)
    if i1.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {i1.device}")
    n, ch, hp, wp = i1.shape
    bh, bw = vmaps.shape[2], vmaps.shape[3]
    if plan is None:
        plan = plan_pass_v(vmaps, hp, wp)
    plan.check(n, bh, bw, hp, wp, vmaps.device)
    check_launchable("K2", vmaps, {"i1": i1, "plan order": plan.order,
                                   "plan count": plan.count}, ch, bw)
    out = torch.empty((n, ch, bh, bw), dtype=torch.float32, device=i1.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(i1.device):
        fn = _lib_fn()
        stream = torch.cuda.current_stream(i1.device).cuda_stream
        err = fn(i1.data_ptr(), vmaps.data_ptr(), out.data_ptr(),
                 plan.order.data_ptr(), plan.count.data_ptr(), n, ch, hp, wp,
                 bh, bw, XPAD, CHUNK_W, stream)
    if err != 0:
        raise RuntimeError(f"K2 remap_separable launch failed: cudaError "
                           f"{err}")
    pass_v.launches += 1
    return out


pass_v.launches = 0


def warp_separable(src: torch.Tensor, wx_bf16: torch.Tensor,
                   vmaps: torch.Tensor,
                   plan: TilePlan | None = None) -> torch.Tensor:
    """The two-pass warp: src bf16 [N, C, Hp, S] -> bands f32
    [N, C, bh, bw]; `plan` as for ``pass_v``."""
    return pass_v(pass_h(src, wx_bf16), vmaps, plan)
