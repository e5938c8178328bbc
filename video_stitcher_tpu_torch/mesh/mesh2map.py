"""Mesh -> dense backward maps.

Torch twin of the JAX package's ``mesh/mesh2map.py``. The reference
inflates the solved vertex grid to a full-res forward map
(360_stitcher/resize.cu:9-45) and inverts it by forward-splat averaging
(MeshWarper::convertMeshesToMap, meshwarper.cpp:823-886), which leaves
holes. Here the mesh displacement D(p) = F(p) - p, small and smooth, is
inverted as the fixed point B(q) = q - D(B(q)) by a few Picard iterations
of bilinear sampling: on a coarse grid on the host (coarse_backward_disp),
then upsampled to the band on the device by align-corners matmuls.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from video_stitcher_tpu_torch.ops.remap import remap_planar
from video_stitcher_tpu_torch.ops.resize import device_constant
from video_stitcher_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=64)
def _upsample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners bilinear (vertex j sits at pixel
    j*(n_out-1)/(n_in-1), like custom_resize's u*(cols-1)/tx mapping)."""
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0c), (1.0 - f).astype(np.float32))
    np.add.at(m, (rows, i1c), f.astype(np.float32))
    return m


def _device_upsample_matrix(n_in: int, n_out: int, device: torch.device):
    """_upsample_matrix on `device`, cached (ops/resize.device_constant,
    so a program keeps it)."""
    return device_constant(_upsample_matrix, (n_in, n_out), device)


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32, not TF32 (the JAX code asks for
    precision="highest": TF32 would cost ~0.15 px here)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def upsample_mesh(verts: torch.Tensor, band_h: int, band_w: int
                  ) -> torch.Tensor:
    """verts f32 [..., N, M] -> [..., band_h, band_w], align-corners
    bilinear, as two f32 matmuls."""
    n, m = verts.shape[-2], verts.shape[-1]
    mw = _device_upsample_matrix(m, band_w, verts.device)
    mh = _device_upsample_matrix(n, band_h, verts.device)
    with full_f32_matmul():
        x = torch.matmul(verts.to(torch.float32), mw.T)       # [..., N, bw]
        return torch.matmul(mh, x)                             # [..., bh, bw]


def invert_forward_field(fwd: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """fwd f32 [2, H, W] forward map (x, y destination of each source
    pixel) -> backward map [2, H, W] with F(B(q)) ~= q."""
    h, w = fwd.shape[-2], fwd.shape[-1]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=fwd.device),
        torch.arange(w, dtype=torch.float32, device=fwd.device),
        indexing="ij")
    disp = torch.stack([fwd[0] - gx, fwd[1] - gy])     # D(p) = F(p) - p
    bx, by = gx, gy
    for _ in range(iters):
        d = remap_planar(disp, bx, by, border="replicate")
        bx = gx - d[0]
        by = gy - d[1]
    return torch.stack([bx, by])


def coarse_backward_disp(verts_np: np.ndarray, band_h: int, band_w: int,
                         iters: int = 3, step: int = 8) -> np.ndarray:
    """verts f32 [C, N, M, 2] -> the backward displacement on a step-px
    coarse grid, f32 [C, 2, hc, wc] in full-res pixels (host numpy).

    The N x M mesh's cells span >100 px, so a step-px grid oversamples it
    ~16x; the inverted displacement, equally smooth, upsamples to the
    band with upsample_mesh. The Picard fixed point runs on the host: the
    grid is tiny (~35k points)."""
    c, n, m, _ = verts_np.shape
    v = np.moveaxis(verts_np.astype(np.float32), -1, 1)      # [C, 2, N, M]
    hc = max(n, (band_h - 1 + step - 1) // step + 1)
    wc = max(m, (band_w - 1 + step - 1) // step + 1)
    mh = _upsample_matrix(n, hc)                             # [hc, N]
    mw = _upsample_matrix(m, wc)                             # [wc, M]
    fwd = np.einsum("hn,cznw->czhw", mh,
                    np.einsum("cznm,wm->cznw", v, mw))       # full-res px
    sy = (band_h - 1) / (hc - 1)
    sx = (band_w - 1) / (wc - 1)
    gy, gx = np.mgrid[0:hc, 0:wc].astype(np.float32)
    disp = np.stack([fwd[:, 0] - gx * sx, fwd[:, 1] - gy * sy], axis=1)
    # Picard in coarse-grid units: B(q) = q - D(B(q)), all cameras at once
    ux = np.broadcast_to(gx, (c, hc, wc)).copy()
    uy = np.broadcast_to(gy, (c, hc, wc)).copy()
    dflat = disp.reshape(c, 2, hc * wc)
    for _ in range(iters):
        x0 = np.clip(np.floor(ux).astype(np.int64), 0, wc - 1)
        y0 = np.clip(np.floor(uy).astype(np.int64), 0, hc - 1)
        x1 = np.minimum(x0 + 1, wc - 1)
        y1 = np.minimum(y0 + 1, hc - 1)
        fx = np.clip(ux - x0, 0.0, 1.0).astype(np.float32)[:, None]
        fy = np.clip(uy - y0, 0.0, 1.0).astype(np.float32)[:, None]

        def tap(yy, xx):
            idx = (yy * wc + xx).reshape(c, 1, hc * wc)
            return np.take_along_axis(dflat, idx, 2).reshape(c, 2, hc, wc)

        top = tap(y0, x0)
        top += fx * (tap(y0, x1) - top)
        bot = tap(y1, x0)
        bot += fx * (tap(y1, x1) - bot)
        s = top + fy * (bot - top)
        ux = gx - s[:, 0] / np.float32(sx)
        uy = gy - s[:, 1] / np.float32(sy)
    return np.stack([(gx - ux) * np.float32(sx),
                     (gy - uy) * np.float32(sy)], axis=1)


def upsample_backward_disp(disp_c: torch.Tensor, band_h: int, band_w: int
                           ) -> torch.Tensor:
    """Coarse backward displacement [C, 2, hc, wc] -> dense backward maps
    f32 [C, 2, band_h, band_w] on disp_c's device."""
    bd = upsample_mesh(disp_c, band_h, band_w)
    dev = disp_c.device
    gx = torch.arange(band_w, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(band_h, dtype=torch.float32, device=dev)[:, None]
    return torch.stack([gx - bd[:, 0], gy - bd[:, 1]], dim=1)


def mesh_to_backward_maps(verts: np.ndarray, band_h: int, band_w: int,
                          iters: int = 3, step: int = 8, device=None
                          ) -> torch.Tensor:
    """verts f32 [C, N, M, 2] warped vertex positions -> backward maps f32
    [C, 2, band_h, band_w] on `device` (the card unless the caller asks
    for another; raises on a host without CUDA): the host coarse
    inversion, then the dense upsample."""
    device = resolve_device(device)
    disp_c = coarse_backward_disp(np.asarray(verts), band_h, band_w,
                                  iters=iters, step=step)
    return upsample_backward_disp(torch.as_tensor(disp_c, device=device),
                                  band_h, band_w)
