"""The multiband blend's pyramid passes as hand-written CUDA kernels
(``csrc/blend_levels.cu``), each beside its plain PyTorch version:

* ``down``: the next Gaussian level, ``pyr_down``;
* ``lap_place``: one level of the panorama's Laplacian sum: each camera's
  Laplacian (its level minus pyrUp of the next) times its weight, added
  in camera order where ``blend/multiband.place_bands`` puts its band;
* ``collapse``: one step of the collapse: a level's sum plus pyrUp of the
  collapsed level above.

``blend/multiband.py``'s ``weighted_levels`` and ``collapse_levels`` run
a frame's blend through them. Each rounds to the storage dtype (bf16
under precision "bf16", f32 under "highest") where the plain chain
(``laplacian_pyramid``, the product with the weights, ``place_bands``,
the collapse) rounds, and the kernels read the tap tables the plain
passes read (``device_taps``) and sum in their order, so on the card a
kernel equals its plain version. Every tensor comes in whole and
contiguous; nothing is kept between calls.

A tensor on the CPU goes through the plain version, a CUDA tensor
through the kernel; another device, a dtype or a shape the kernel does
not take raises. Each wrapper counts its CUDA launches in ``.launches``,
and a launch recorded into a CUDA graph capture in ``.captured`` instead
(``pipeline/step_graph.py`` counts it at each replay), as K1's does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from video_stitcher_tpu_torch.geometry.cylindrical import BandLayout
from video_stitcher_tpu_torch.ops.pyramid import (
    _down_matrix, _up_matrix, pyr_down, pyr_up, storage_dtype,
)
from video_stitcher_tpu_torch.ops.resize import device_taps

#: the most cameras a lap_place launch takes, and the channels of
#: lap_place and collapse
MAX_CAMS = 64
CHANNELS = 3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "blend_down": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _I] + [_I] * 5 + [_P],
    "blend_lap_place": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                        ctypes.POINTER(ctypes.c_int)] + [_I] * 9 + [_P],
    "blend_collapse": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I]
    + [_I] * 5 + [_P],
}


def _lib_fn(name: str):
    from video_stitcher_tpu_torch import _build
    fn = getattr(_build.load("blend_levels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _on_card(x: torch.Tensor, kernel: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one
    (the kernel); raises for another device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    return True


def _want(x: torch.Tensor, what: str, shape, dtypes, device) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} {tuple(x.shape)} != {tuple(shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what} dtype {x.dtype} is not one of "
                        f"{[str(d) for d in dtypes]}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, not {device}")


def _up_size(n_next: int, n: int, what: str) -> None:
    """The kernels read pyrUp's taps of output i from next-level rows
    i // 2 - 1 .. i // 2 + 1, which holds when the next level is half the
    size, rounded either way."""
    if abs(2 * n_next - n) > 1:
        raise ValueError(f"{what}: a level of {n_next} does not go up to "
                         f"{n}")


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def _taps(make, args: tuple, device: torch.device):
    """A pass's tap table (the plain pass's own, device_taps) as the
    kernels' three arguments: index and weight pointers, taps a row."""
    idx, w = device_taps(make, args, device)
    return idx.data_ptr(), w.data_ptr(), idx.shape[0]


def _ptr(x: Optional[torch.Tensor]):
    if x is None:
        return None
    if not x.is_contiguous():
        raise ValueError("the blend kernels take contiguous tensors")
    return x.data_ptr()


# --- down ----------------------------------------------------------------

def down_plain(x: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """The plain version of ``down``: ``pyr_down``."""
    return pyr_down(x, precision)


def down(x: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """The next Gaussian level: x [N, C, h, w] in f32 (the warped bands,
    rounded to the storage dtype as they are read) or in the storage
    dtype -> [N, C, ceil(h / 2), ceil(w / 2)] in the storage dtype."""
    dt = storage_dtype(precision)
    if x.dim() != 4:
        raise ValueError(f"want x [N, C, h, w], got {tuple(x.shape)}")
    _want(x, "x", x.shape, (torch.float32, dt), x.device)
    if not _on_card(x, "down"):
        return down_plain(x, precision)
    n, c, h, w = x.shape
    out = torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=dt,
                      device=x.device)
    if out.numel() == 0:
        return out
    _launch(down, "blend_down", x.device, _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[dt], _ptr(x), out.data_ptr(),
            *_taps(_down_matrix, (w,), x.device),
            *_taps(_down_matrix, (h,), x.device),
            n * c, h, w, out.shape[2], out.shape[3])
    return out


down.launches = 0
down.captured = 0


# --- lap_place -----------------------------------------------------------

def lap_place_plain(g: torch.Tensor, g_next: Optional[torch.Tensor],
                    weight: torch.Tensor, layout: BandLayout, level: int,
                    corners=None, precision: str = "highest") -> torch.Tensor:
    """The plain version of ``lap_place``: the Laplacian times the weight
    in the storage dtype, placed by ``place_bands``."""
    from video_stitcher_tpu_torch.blend.multiband import place_bands
    dt = storage_dtype(precision)
    lap = g.to(dt)
    if g_next is not None:
        lap = lap - pyr_up(g_next, g.shape[-2], g.shape[-1], precision)
    return place_bands(lap * weight.to(dt), layout, level, corners)


def lap_place(g: torch.Tensor, g_next: Optional[torch.Tensor],
              weight: torch.Tensor, layout: BandLayout, level: int,
              corners=None, precision: str = "highest") -> torch.Tensor:
    """One level of the panorama's Laplacian sum, [C, h, pano_w] in the
    storage dtype: camera i's Laplacian (g[i] minus pyr_up of g_next[i];
    g[i] itself at the top, g_next None) times its weight rounded to the
    storage dtype, added from 0 in camera order, each sum rounded, where
    ``place_bands`` puts its band at `level` (`corners` as there). g
    [N, C, h, w] in f32 (level 0: the bands, rounded as they are read) or
    the storage dtype; g_next [N, C, ceil(h / 2), ceil(w / 2)] in the
    storage dtype; weight f32 [N, 1, h, w]."""
    # blend/multiband.py places the bands, and imports this module
    from video_stitcher_tpu_torch.blend.multiband import (
        _placement, _segments)
    dt = storage_dtype(precision)
    if g.dim() != 4:
        raise ValueError(f"want g [N, C, h, w], got {tuple(g.shape)}")
    n, c, h, w = g.shape
    _want(g, "g", g.shape, (torch.float32, dt), g.device)
    _want(weight, "weight", (n, 1, h, w), (torch.float32,), g.device)
    if g_next is not None:
        _want(g_next, "g_next", (n, c, (h + 1) // 2, (w + 1) // 2), (dt,),
              g.device)
    pw, bw, lvl_corners = _placement(layout, level, corners)
    if len(lvl_corners) != n:
        raise ValueError(f"{len(lvl_corners)} corners for {n} cameras")
    if not 0 < bw <= w:
        raise ValueError(f"band {bw} px wide does not fit a {w} px level")
    # the panorama column of each band's column 0 (where its first
    # segment starts); the kernel wraps the rest modulo pw
    starts = [_segments(x, bw, pw, layout.wrap)[0][0] for x in lvl_corners]
    if not _on_card(g, "lap_place"):
        return lap_place_plain(g, g_next, weight, layout, level, corners,
                               precision)
    if n > MAX_CAMS or c != CHANNELS:
        raise ValueError(f"the lap_place kernel takes at most {MAX_CAMS} "
                         f"cameras of {CHANNELS} channels, got {n} of {c}")
    out = torch.empty((c, h, pw), dtype=dt, device=g.device)
    up = ((_taps(_up_matrix, (g_next.shape[3], w), g.device)
           + _taps(_up_matrix, (g_next.shape[2], h), g.device))
          if g_next is not None else (None, None, 0) * 2)
    h2, w2 = (0, 0) if g_next is None else g_next.shape[2:]
    _launch(lap_place, "blend_lap_place", g.device, _DTYPE_CODES[g.dtype],
            _DTYPE_CODES[dt], _ptr(g), _ptr(g_next), _ptr(weight),
            out.data_ptr(), *up, (ctypes.c_int * n)(*starts), n,
            int(layout.wrap), pw, bw, c, h, w, h2, w2)
    return out


lap_place.launches = 0
lap_place.captured = 0


# --- collapse ------------------------------------------------------------

def collapse_plain(acc: torch.Tensor, out_next: Optional[torch.Tensor],
                   precision: str = "highest", final: bool = False,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``collapse``."""
    out = acc.to(torch.float32)
    if out_next is not None:
        out = out + pyr_up(out_next, acc.shape[-2], acc.shape[-1], precision,
                           out_dtype=torch.float32)
    if not final:
        return out.to(storage_dtype(precision))
    return out if valid is None else out * valid[None]


def collapse(acc: torch.Tensor, out_next: Optional[torch.Tensor],
             precision: str = "highest", final: bool = False,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the collapse: acc [C, h, w] (a level of the panorama's
    Laplacian sum, in the storage dtype) in f32 plus pyr_up of out_next
    (the collapsed level above, [C, h2, w2] in the storage dtype, h2 and
    w2 half of h and w rounded either way; None for a one-level
    pyramid), its height pass in f32. Returns the sum in the storage
    dtype, or with `final` in f32 and times `valid` (f32 [h, w]) when
    given (unread below the final level)."""
    dt = storage_dtype(precision)
    if acc.dim() != 3:
        raise ValueError(f"want acc [C, h, w], got {tuple(acc.shape)}")
    c, h, w = acc.shape
    _want(acc, "acc", acc.shape, (dt,), acc.device)
    if out_next is not None:
        if out_next.dim() != 3 or out_next.shape[0] != c:
            raise ValueError(f"want out_next [{c}, h2, w2], got "
                             f"{tuple(out_next.shape)}")
        _want(out_next, "out_next", out_next.shape, (dt,), acc.device)
        _up_size(out_next.shape[1], h, "height")
        _up_size(out_next.shape[2], w, "width")
    if not final:
        valid = None
    elif valid is not None:
        _want(valid, "valid", (h, w), (torch.float32,), acc.device)
    if not _on_card(acc, "collapse"):
        return collapse_plain(acc, out_next, precision, final, valid)
    if c != CHANNELS:
        raise ValueError(f"the collapse kernel takes {CHANNELS} channels, "
                         f"got {c}")
    out = torch.empty((c, h, w), dtype=torch.float32 if final else dt,
                      device=acc.device)
    up = ((_taps(_up_matrix, (out_next.shape[2], w), acc.device)
           + _taps(_up_matrix, (out_next.shape[1], h), acc.device))
          if out_next is not None else (None, None, 0) * 2)
    h2, w2 = (0, 0) if out_next is None else out_next.shape[1:]
    _launch(collapse, "blend_collapse", acc.device, _DTYPE_CODES[dt],
            int(final), _ptr(acc), _ptr(out_next), _ptr(valid),
            out.data_ptr(), *up, c, h, w, h2, w2)
    return out


collapse.launches = 0
collapse.captured = 0

#: the wrappers whose launches a graph replay counts (step_graph.Program)
KERNELS = (down, lap_place, collapse)
