"""K1: the per-frame warp, one launch for all cameras.

``remap_strips`` has the name of the JAX package's TPU strip-warp kernel
(video_stitcher_tpu/ops/remap_strips.py) that it replaces; on the card it
launches the hand-written CUDA kernel ``csrc/remap_gain.cu``. Contract:

    out[n, c] = clip(gains[n] * remap_planar(src[n, c], maps[n % n_maps],
                                             border="constant"), 0, 255)

src [N, C, H, W] u8 (RGB frames, exact) or f32 (NV12-converted frames);
maps f32 [n_maps, 2, bh, bw] (x then y, in source pixels, -1 = invalid);
gains f32 [N]; N a multiple of n_maps (batched frame sets reuse the maps
cyclically). Returns f32 [N, C, bh, bw].

The kernel walks the tile plan of the maps (``plan_remap``,
``ops/warp_tiles.py``): the caller that keeps its maps builds it once
(``Stitcher`` does, with its state), otherwise each call builds it.

A tensor on the CPU goes through ``remap_strips_plain``; a CUDA tensor goes
through the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from video_stitcher_tpu_torch.ops.remap import remap_planar
from video_stitcher_tpu_torch.ops.warp_tiles import (
    TilePlan, check_launchable, plan_tiles,
)

_SYMBOLS = {torch.uint8: "remap_gain_u8", torch.float32: "remap_gain_f32"}


def _check(src, maps, gains):
    if src.dim() != 4 or maps.dim() != 4 or maps.shape[1] != 2:
        raise ValueError(f"want src [N, C, H, W] and maps [n_maps, 2, bh, bw]"
                         f", got {tuple(src.shape)} and {tuple(maps.shape)}")
    n, n_maps = src.shape[0], maps.shape[0]
    if n_maps == 0 or n % n_maps:
        raise ValueError(f"{n} cameras do not tile {n_maps} maps")
    if gains.shape != (n,):
        raise ValueError(f"gains {tuple(gains.shape)} != ({n},)")
    if src.dtype not in _SYMBOLS:
        raise TypeError(f"src dtype {src.dtype} is not u8 or f32")
    if maps.dtype != torch.float32 or gains.dtype != torch.float32:
        raise TypeError("maps and gains must be float32")
    if not (src.device == maps.device == gains.device):
        raise ValueError("src, maps and gains must share a device")


def remap_strips_plain(src, maps, gains):
    """The plain PyTorch version of K1 (any device)."""
    _check(src, maps, gains)
    n_maps = maps.shape[0]
    bands = torch.stack([
        remap_planar(src[i], maps[i % n_maps, 0], maps[i % n_maps, 1],
                     border="constant") for i in range(src.shape[0])])
    return torch.clamp(bands * gains[:, None, None, None], 0.0, 255.0)


def tap_origins(maps: torch.Tensor, src_h: int, src_w: int):
    """The top-left tap (x0, y0) of each pixel's 2x2 footprint, f32
    [n_maps, bh, bw] each, as K1 computes it: the coordinate clamped to
    [-2, size + 1] (a NaN to -2, as fmaxf does), then floored."""
    mx = torch.clamp(torch.nan_to_num(maps[:, 0], nan=-2.0), -2.0,
                     src_w + 1.0)
    my = torch.clamp(torch.nan_to_num(maps[:, 1], nan=-2.0), -2.0,
                     src_h + 1.0)
    return torch.floor(mx), torch.floor(my)


def plan_remap(maps: torch.Tensor, src_h: int, src_w: int) -> TilePlan:
    """K1's tile plan of maps f32 [n_maps, 2, bh, bw] over a src_h x src_w
    source, on the maps' device."""
    return plan_tiles(*tap_origins(maps, src_h, src_w), src_h, src_w)


def _lib_fn(dtype):
    from video_stitcher_tpu_torch import _build
    fn = getattr(_build.load("remap_gain"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def remap_strips(src, maps, gains, plan: TilePlan | None = None):
    """K1 (see the module docstring): `plan` is ``plan_remap`` of these
    maps and this source size, built here when None. Counts its CUDA
    launches in ``remap_strips.launches``; a launch recorded into a CUDA
    graph capture counts in ``remap_strips.captured`` instead (it runs
    when the graph is replayed, and ``pipeline/step_graph.py`` counts it
    then)."""
    _check(src, maps, gains)
    if src.device.type == "cpu":
        return remap_strips_plain(src, maps, gains)
    if src.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {src.device}")
    n, c, h, w = src.shape
    n_maps, _, bh, bw = maps.shape
    if plan is None:
        plan = plan_remap(maps, h, w)
    plan.check(n_maps, bh, bw, h, w, maps.device)
    check_launchable("K1", maps, {"src": src, "gains": gains,
                                  "plan order": plan.order,
                                  "plan count": plan.count}, c, bw)
    out = torch.empty((n, c, bh, bw), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        fn = _lib_fn(src.dtype)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), maps.data_ptr(), gains.data_ptr(),
                 out.data_ptr(), plan.order.data_ptr(), plan.count.data_ptr(),
                 n, n_maps, c, h, w, bh, bw, stream)
    if err != 0:
        raise RuntimeError(f"K1 remap_gain launch failed: cudaError {err}")
    if torch.cuda.is_current_stream_capturing():
        remap_strips.captured += 1
    else:
        remap_strips.launches += 1
    return out


remap_strips.launches = 0
remap_strips.captured = 0
