"""The plain reference of one stitched output frame, in float64.

Written from the semantics the upstream stitcher uses (OpenCV's, as
360_stitcher/timed.cpp:56-152 chains them), not from the program:

* source: NV12 -> RGB with OpenCV's BT.601 video-range coefficients
  (luma excursion clamped at 0, each 2x2 block sharing its U, V), or the
  u8 RGB frame as it is;
* warp: cv::remap INTER_LINEAR, BORDER_CONSTANT 0, through each camera's
  backward map (band pixel -> source pixel, x then y), times the camera's
  gain, clamped to [0, 255];
* blend: cv::detail::MultiBandBlender: Gaussian pyramids of the seam
  weights (pyrDown: [1 4 6 4 1]/16, BORDER_REFLECT_101, even rows and
  columns), each level normalised by the weights' sum + 1e-5 over the
  panorama, Laplacian pyramids of the bands (pyrUp: zero-stuffed, 4x the
  kernel, reflect-101 before the first sample and replicate after the
  last), each camera's levels times its weights summed at its band's
  corner on the ring, collapsed, masked where no weight lies;
* output: cv::resize INTER_LINEAR to the output size, rounded half to
  even, clamped, u8.

It imports nothing of the program. It takes the benchmark's own frames
and, of the program's calibration, only what the comparison follows the
program through (see ``stitchbench/judge.py``): the backward maps, the
gains, the seam weights and the band layout's integers.

``ring_gains`` works the calibration's gains out again, from the frames
and the rig alone: cv::detail::GainCompensator (alpha 0.01, beta 100)
over the seam-scale cylindrical warps of the fixed ring, as
360_stitcher/calibration.cpp:91-135 feeds it.

``store`` rounds every stored pyramid tensor: the identity for the
reference, and a lower precision for the control.
"""

from __future__ import annotations

from typing import Callable, Sequence

import math

import torch

F64 = torch.float64
WEIGHT_EPS = 1e-5


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_store(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 and back: the control's storage, the step
    below the bfloat16 the configuration states (blend_dtype)."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def nv12_to_rgb(nv12: torch.Tensor) -> torch.Tensor:
    """u8 [n, h*3/2, w] -> f64 planar RGB [n, 3, h, w] in [0, 255]."""
    rows, w = nv12.shape[-2], nv12.shape[-1]
    h = rows * 2 // 3
    y = nv12[:, :h].to(F64)
    uv = nv12[:, h:].to(F64)
    u = uv[..., 0::2].repeat_interleave(2, -1).repeat_interleave(2, -2) - 128
    v = uv[..., 1::2].repeat_interleave(2, -1).repeat_interleave(2, -2) - 128
    yc = 1.163999 * (y - 16.0).clamp(min=0.0)
    r = yc + 1.596027 * v
    g = yc - 0.812968 * v - 0.391762 * u
    b = yc + 2.017232 * u
    return torch.stack([r, g, b], 1).clamp(0.0, 255.0)


def source_planar(frames: torch.Tensor) -> torch.Tensor:
    """A frame set (u8 RGB [n, h, w, 3] or NV12 [n, h*3/2, w]) -> f64
    planar [n, 3, h, w]."""
    if frames.dim() == 3:
        return nv12_to_rgb(frames)
    return frames.permute(0, 3, 1, 2).to(F64)


def remap_linear(src: torch.Tensor, mx: torch.Tensor, my: torch.Tensor
                 ) -> torch.Tensor:
    """src f64 [c, h, w]; maps [bh, bw] -> f64 [c, bh, bw], bilinear,
    taps outside the source read 0."""
    c, h, w = src.shape
    mx = mx.to(F64)
    my = my.to(F64)
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    x0 = x0.long()
    y0 = y0.long()
    flat = src.reshape(c, h * w)
    out = torch.zeros((c,) + tuple(mx.shape), dtype=F64, device=src.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx = x0 + dx
            yy = y0 + dy
            ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)
            v = flat.index_select(1, idx).reshape(out.shape)
            out += torch.where(ok, v * (wx * wy), torch.zeros_like(v))
    return out


def warp(frames: torch.Tensor, maps: torch.Tensor, gains: torch.Tensor
         ) -> torch.Tensor:
    """frames -> gain-compensated bands f64 [n, 3, bh, bw]."""
    src = source_planar(frames)
    bands = torch.stack([remap_linear(src[i], maps[i, 0], maps[i, 1])
                         for i in range(src.shape[0])])
    return (bands * gains.to(F64)[:, None, None, None]).clamp(0.0, 255.0)


# --- pyramids ---------------------------------------------------------------
_K = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def _reflect101(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    n = x.shape[dim]
    left = [x.narrow(dim, i, 1) for i in range(pad, 0, -1)]
    right = [x.narrow(dim, n - 1 - i, 1) for i in range(1, pad + 1)]
    return torch.cat(left + [x] + right, dim)


def _down_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    p = _reflect101(x, dim, 2)
    blur = sum(k * p.narrow(dim, t, n) for t, k in enumerate(_K))
    return blur.narrow(dim, 0, n)[(slice(None),) * (dim % x.dim())
                                   + (slice(0, None, 2),)]


def pyr_down(x: torch.Tensor, store: Callable) -> torch.Tensor:
    return store(_down_axis(store(_down_axis(x, -1)), -2))


def _up_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """cv::pyrUp along one axis: out[2i] = (a[i-1] + 6 a[i] + a[i+1]) / 8,
    out[2i+1] = (a[i] + a[i+1]) / 2, a[-1] = a[1], a[n] = a[n-1]."""
    n = x.shape[dim]
    nd = dim % x.dim()
    prev = torch.cat([x.narrow(dim, min(1, n - 1), 1),
                      x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = (prev + 6 * x + nxt) / 8
    odd = (x + nxt) / 2
    both = torch.stack([even, odd], nd + 1)
    shape = list(x.shape)
    shape[nd] = 2 * n
    return both.reshape(shape).narrow(dim, 0, n_out)


def pyr_up(x: torch.Tensor, out_h: int, out_w: int, store: Callable
           ) -> torch.Tensor:
    return _up_axis(store(_up_axis(x, -1, out_w)), -2, out_h)


def gaussian(x: torch.Tensor, levels: int, store: Callable) -> list:
    pyr = [store(x)]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1], store))
    return pyr


def laplacian(x: torch.Tensor, levels: int, store: Callable) -> list:
    g = gaussian(x, levels, store)
    lap = [store(g[i] - store(pyr_up(g[i + 1], g[i].shape[-2],
                                     g[i].shape[-1], store)))
           for i in range(levels)]
    return lap + [g[levels]]


# --- placement on the ring ---------------------------------------------------
class Layout:
    """The band layout's integers: the panorama's size, the bands' size,
    each band's left corner on the ring, the blend's band count."""

    def __init__(self, pano_w: int, pano_h: int, band_w: int, band_h: int,
                 corners: Sequence[int], num_bands: int):
        self.pano_w, self.pano_h = pano_w, pano_h
        self.band_w, self.band_h = band_w, band_h
        self.corners = list(corners)
        self.num_bands = num_bands
        f = 1 << num_bands
        if pano_w % f or band_w % f:
            raise ValueError("band and panorama widths must divide by "
                             f"2**{num_bands}")

    def columns(self, cam: int, level: int, device) -> torch.Tensor:
        """The ring columns of camera `cam`'s band at `level`."""
        f = 1 << level
        bw, pw = self.band_w // f, self.pano_w // f
        return (torch.arange(bw, device=device) + self.corners[cam] // f) % pw


def place(bands: torch.Tensor, lay: Layout, level: int) -> torch.Tensor:
    """Sum [n, ..., h, bw_l] bands into the ring [..., h, pw_l]."""
    pw = lay.pano_w >> level
    out = bands.new_zeros(tuple(bands.shape[1:-1]) + (pw,))
    for i in range(bands.shape[0]):
        out.index_add_(out.dim() - 1, lay.columns(i, level, bands.device),
                       bands[i])
    return out


def crop(pano: torch.Tensor, lay: Layout, cam: int, level: int
         ) -> torch.Tensor:
    return pano.index_select(pano.dim() - 1,
                             lay.columns(cam, level, pano.device))


def weight_pyramids(weights0: torch.Tensor, lay: Layout):
    """Seam weights f [n, bh, bw] -> (normalised pyramids, valid mask)."""
    w0 = weights0.to(F64)[:, None]
    pyr = gaussian(w0, lay.num_bands, identity)
    norm = []
    for lvl, wl in enumerate(pyr):
        inv = 1.0 / (place(wl, lay, lvl) + WEIGHT_EPS)
        norm.append(torch.stack([wl[i] * crop(inv, lay, i, lvl)
                                 for i in range(wl.shape[0])]))
    valid = (place(w0, lay, 0)[0] > WEIGHT_EPS).to(F64)
    return norm, valid


def blend(bands: torch.Tensor, wpyr: list, valid: torch.Tensor, lay: Layout,
          store: Callable = identity) -> torch.Tensor:
    """Bands f64 [n, 3, bh, bw] -> panorama f64 [3, ph, pw]."""
    lap = laplacian(bands, lay.num_bands, store)
    acc = [store(place(store(lap[l] * store(wpyr[l])), lay, l))
           for l in range(lay.num_bands + 1)]
    out = acc[-1]
    for lvl in range(lay.num_bands - 1, -1, -1):
        out = acc[lvl] + pyr_up(out, acc[lvl].shape[-2], acc[lvl].shape[-1],
                                store)
        if lvl > 0:
            out = store(out)
    return out * valid[None]


def _linear_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR along one axis: source position (i + 0.5)
    * n / n_out - 0.5, taps clamped to the edge."""
    n = x.shape[dim]
    if n == n_out:
        return x
    pos = (torch.arange(n_out, dtype=F64, device=x.device) + 0.5) * (
        n / n_out) - 0.5
    i0 = torch.floor(pos)
    f = pos - i0
    i0 = i0.long()
    a = x.index_select(dim, i0.clamp(0, n - 1))
    b = x.index_select(dim, (i0 + 1).clamp(0, n - 1))
    shape = [1] * x.dim()
    shape[dim % x.dim()] = n_out
    f = f.view(shape)
    return a * (1 - f) + b * f


def output_frame(pano: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Panorama f64 [3, ph, pw] -> u8 [out_h, out_w, 3]."""
    y = _linear_axis(_linear_axis(pano, -1, out_w), -2, out_h)
    return torch.round(y).clamp(0, 255).to(torch.uint8).permute(1, 2, 0)


def stitch(frames: torch.Tensor, maps: torch.Tensor, gains: torch.Tensor,
           wpyr: list, valid: torch.Tensor, lay: Layout, out_h: int,
           out_w: int, store: Callable = identity) -> torch.Tensor:
    """One frame set -> its output frame u8 [out_h, out_w, 3]."""
    bands = warp(frames, maps, gains)
    return output_frame(blend(bands, wpyr, valid, lay, store), out_h, out_w)


# --- the calibration's gains, worked out again ------------------------------
def calibration_rgb(frames: torch.Tensor) -> torch.Tensor:
    """The u8 colour frames the upstream calibrates from, f64 planar
    [n, 3, h, w]: NV12 through cv::cvtColor (rounded to u8), RGB as it
    is."""
    if frames.dim() == 3:
        return torch.round(nv12_to_rgb(frames))
    return frames.permute(0, 3, 1, 2).to(F64)


def seam_canvases(frames: torch.Tensor, seam_megapix: float, fov_deg: float
                  ):
    """Each camera's seam-scale cylindrical warp over the whole ring:
    (u8-valued f64 images [n, 3, ch, cw], bool masks [n, ch, cw]).

    The frames go to seam scale by cv::resize INTER_LINEAR; the fixed
    ring's camera i looks along yaw 2*pi*i/n with ppx = W*s/2 and
    f = ppx / tan(fov/2) (calibration.cpp:28-68 at seam scale); canvas
    pixel (u, v) is the ray at theta = u / f, height v / f on the unit
    cylinder (cv::detail::CylindricalWarper of scale f). Images: INTER_LINEAR,
    BORDER_REFLECT, rounded to u8; masks: remap-NEAREST of a full mask,
    BORDER_CONSTANT."""
    src = calibration_rgb(frames)
    n, _, h, w = src.shape
    s = min(1.0, math.sqrt(seam_megapix * 1e6 / (w * h)))
    sw, sh = int(round(w * s)), int(round(h * s))
    small = torch.round(_linear_axis(_linear_axis(src, -1, sw), -2, sh)
                        ).clamp(0.0, 255.0)
    ppx, ppy = w * s / 2.0, h * s / 2.0
    f = ppx / math.tan(math.radians(fov_deg) / 2.0)
    cw = int(round(2 * math.pi * f))
    top = int(math.ceil(ppy)) + 1
    dev = frames.device
    u = torch.arange(cw, dtype=F64, device=dev)[None, :]
    v = torch.arange(-top, top + 1, dtype=F64, device=dev)[:, None]
    images, masks = [], []
    for i in range(n):
        a = torch.remainder(u / f - 2 * math.pi * i / n + math.pi,
                            2 * math.pi) - math.pi
        front = torch.cos(a) > 0
        c = torch.where(front, torch.cos(a), torch.ones_like(a))
        x = (f * torch.tan(a) + ppx).expand(v.shape[0], cw)
        y = v / c + ppy
        masks.append(front & (x > -0.5) & (x < sw - 0.5) & (y > -0.5)
                     & (y < sh - 0.5))
        xs = x.clamp(-1.0, sw)
        ys = y.clamp(-1.0, sh)
        img = remap_reflect(small[i], xs, ys)
        images.append(torch.round(img).clamp(0.0, 255.0))
    return torch.stack(images), torch.stack(masks)


def remap_reflect(src: torch.Tensor, mx: torch.Tensor, my: torch.Tensor
                  ) -> torch.Tensor:
    """Bilinear remap with BORDER_REFLECT (a tap at -1 reads 0, at w reads
    w - 1): f64 [c, h, w] -> [c, *mx.shape]."""
    c, h, w = src.shape
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx, fy = mx - x0, my - y0
    x0, y0 = x0.long(), y0.long()
    flat = src.reshape(c, h * w)
    out = torch.zeros((c,) + tuple(mx.shape), dtype=F64, device=src.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx = (x0 + dx).clamp(0, w - 1)
            yy = (y0 + dy).clamp(0, h - 1)
            out += flat.index_select(1, (yy * w + xx).reshape(-1)).reshape(
                out.shape) * (wx * wy)
    return out


def ring_gains(frames: torch.Tensor, seam_megapix: float, fov_deg: float
               ) -> torch.Tensor:
    """The calibration's gains f64 [n] from one frame set:
    GainCompensator::feed (exposure_compensate.cpp) over the seam-scale
    warps: N(i, j) overlap pixels and I(i, j) the mean pixel magnitude of
    image i over them, then the damped system with alpha 0.01, beta 100."""
    images, masks = seam_canvases(frames, seam_megapix, fov_deg)
    mag = torch.sqrt((images * images).sum(1))
    n = images.shape[0]
    nmat = torch.zeros(n, n, dtype=F64)
    imat = torch.zeros(n, n, dtype=F64)
    for i in range(n):
        for j in range(i, n):
            inter = masks[i] & masks[j]
            cnt = int(inter.sum())
            nmat[i, j] = nmat[j, i] = max(1, cnt)
            if cnt:
                imat[i, j] = float(mag[i][inter].sum()) / cnt
                imat[j, i] = float(mag[j][inter].sum()) / cnt
    alpha, beta = 0.01, 100.0
    a = torch.zeros(n, n, dtype=F64)
    b = torch.zeros(n, dtype=F64)
    for i in range(n):
        for j in range(n):
            b[i] += beta * nmat[i, j]
            a[i, i] += beta * nmat[i, j]
            if j == i:
                continue
            a[i, i] += 2 * alpha * imat[i, j] ** 2 * nmat[i, j]
            a[i, j] -= 2 * alpha * imat[i, j] * imat[j, i] * nmat[i, j]
    return torch.linalg.solve(a, b)
