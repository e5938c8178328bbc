"""The bytes K1 (the per-frame warp with the gains, csrc/remap_gain.cu of
the port) needs for one call, counted from the cell's data: its f32
output once, the backward maps of the active tiles (64 x 16 output
pixels with at least one source tap inside the frame), each source pixel
that some tap reads, once (f32 planar after the NV12 conversion, u8
planar from RGB), and the tile plan (one int32 a tile)."""

from __future__ import annotations

import torch

TILE_H, TILE_W = 16, 64


def taps(maps: torch.Tensor, src_h: int, src_w: int):
    """Per camera: (bool [bh, bw] pixels with a tap inside the source,
    flat indices of the source pixels the taps read)."""
    for m in maps:
        x0 = torch.floor(m[0]).long()
        y0 = torch.floor(m[1]).long()
        reads = torch.zeros_like(x0, dtype=torch.bool)
        idx = []
        for dy in (0, 1):
            for dx in (0, 1):
                xx, yy = x0 + dx, y0 + dy
                ok = (xx >= 0) & (xx < src_w) & (yy >= 0) & (yy < src_h)
                reads |= ok
                idx.append((yy * src_w + xx)[ok])
        yield reads, torch.cat(idx)


def active_tiles(reads: torch.Tensor) -> int:
    bh, bw = reads.shape
    ph, pw = -bh % TILE_H, -bw % TILE_W
    r = torch.nn.functional.pad(reads.float(), (0, pw, 0, ph))
    t = r.reshape((bh + ph) // TILE_H, TILE_H, (bw + pw) // TILE_W, TILE_W)
    return int(t.amax((1, 3)).gt(0).sum())


def n_tiles(bh: int, bw: int) -> int:
    return -(-bh // TILE_H) * -(-bw // TILE_W)


def bytes_needed(ctx) -> int:
    maps = ctx["maps"]
    n, _, bh, bw = maps.shape
    src_h, src_w = ctx["src_hw"]
    elem = 4 if ctx["frame_format"] == "nv12" else 1
    active = src_px = 0
    for reads, idx in taps(maps, src_h, src_w):
        active += active_tiles(reads)
        src_px += int(torch.unique(idx).numel())
    return (n * 3 * bh * bw * 4 + active * TILE_H * TILE_W * 2 * 4
            + src_px * 3 * elem + n * n_tiles(bh, bw) * 4)
