"""The tile plan of the warp kernels K1 and K2.

The port's counterpart of the TPU strip planner
(video_stitcher_tpu/ops/remap_strips.py, ``plan_strips``), which listed
the groups of band pixels that read the source so that the TPU kernel
could skip the rest. Here the band is cut into TILE_H x TILE_W tiles, and
a tile is active when some tap of one of its pixels lies in the source.
The plan orders the tiles: the active ones first, map-major and then
row-major, so one camera's source stays in L2 while its tiles run; then
the empty ones. It is computed from the maps on their device with tensor
reductions whenever the maps change, and is never written to a
checkpoint.

The kernels (``csrc/warp_tiles.cuh``) walk the plan with persistent
blocks: an empty tile gets its zeros written and nothing read; an active
tile's maps come into a shared-memory ring by bulk copy while the
previous tile computes. They read the count of active tiles from the
plan's one-element tensor, not from an argument, so a launch captured in
a CUDA graph (``pipeline/step_graph.py``) walks whichever plan of the same
geometry was last copied into the tensors it reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

TILE_W = 64              # band pixels per tile row: 16 threads x 4 pixels
TILE_H = 16              # tile rows: 256 threads; == csrc/warp_tiles.cuh


class TilePlan(NamedTuple):
    #: int32 [n_maps * tiles_y * tiles_x]: flat tile ids (map, tile row,
    #: tile column), the active tiles first, in that order, then the
    #: empty ones
    order: torch.Tensor
    #: int32 [1] on the order's device: how many of `order` are active
    count: torch.Tensor
    #: (n_maps, tiles_y, tiles_x)
    tiles: Tuple[int, int, int]
    src_h: int
    src_w: int

    @property
    def n_active(self) -> int:
        """count[0] on the host (a device sync on the card)."""
        return int(self.count[0])

    @property
    def active(self) -> torch.Tensor:
        """bool [n_maps, tiles_y, tiles_x]: some tap in the source."""
        flat = torch.zeros(self.order.numel(), dtype=torch.bool,
                           device=self.order.device)
        flat[self.order[:self.n_active].long()] = True
        return flat.reshape(self.tiles)

    def counts(self) -> Dict[str, int]:
        """Tiles per kind."""
        return {"empty": self.order.numel() - self.n_active,
                "active": self.n_active}

    def check(self, n_maps: int, bh: int, bw: int, src_h: int, src_w: int,
              device: torch.device) -> None:
        """Raise unless this plan was made for maps [n_maps, 2, bh, bw]
        on `device` over a src_h x src_w source."""
        want = (n_maps, -(-bh // TILE_H), -(-bw // TILE_W))
        if tuple(self.tiles) != want or (self.src_h, self.src_w) != (
                src_h, src_w):
            raise ValueError(
                f"tile plan {tuple(self.tiles)} over {self.src_h}x"
                f"{self.src_w} does not fit maps [{n_maps}, 2, {bh}, {bw}] "
                f"over {src_h}x{src_w}")
        if self.order.device != device or self.count.device != device:
            raise ValueError(f"tile plan on {self.order.device}, maps on "
                             f"{device}")
        if self.count.shape != (1,) or self.count.dtype != torch.int32:
            raise ValueError(f"tile plan count {self.count.dtype} "
                             f"{tuple(self.count.shape)} is not int32 [1]")


def plan_tiles(x0: torch.Tensor, y0: torch.Tensor, src_h: int,
               src_w: int) -> TilePlan:
    """x0, y0: [n_maps, bh, bw], the top-left tap of each band pixel's 2x2
    bilinear footprint in a src_h x src_w source (taps at x0..x0+1,
    y0..y0+1; a tap outside the source reads nothing). Launches work on
    the maps' device and never waits for it."""
    n, bh, bw = x0.shape
    ty, tx = -(-bh // TILE_H), -(-bw // TILE_W)
    live = (x0 >= -1) & (x0 < src_w) & (y0 >= -1) & (y0 < src_h)
    live = torch.nn.functional.pad(live, (0, tx * TILE_W - bw,
                                          0, ty * TILE_H - bh))
    active = live.reshape(n, ty, TILE_H, tx, TILE_W).any(4).any(2)
    flat = active.reshape(-1)
    # the active ids, then the empty ones, each ascending: a stable sort
    # on the flag, which (unlike a boolean index) needs no device sync
    order = torch.argsort((~flat).to(torch.uint8), stable=True).to(
        torch.int32)
    count = flat.sum(dtype=torch.int32).reshape(1)
    return TilePlan(order=order, count=count, tiles=(n, ty, tx),
                    src_h=src_h, src_w=src_w)


def check_launchable(kernel: str, maps: torch.Tensor, tensors: dict,
                     channels: int, bw: int) -> None:
    """Raise unless the tile kernels take these CUDA tensors: all
    contiguous, the maps 16-byte aligned (their rows are bulk-copied), 3
    channels, a band width that is a multiple of 4 (a thread's 4
    pixels)."""
    for name, t in {"maps": maps, **tensors}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if maps.data_ptr() % 16:
        raise ValueError(f"{kernel} needs 16-byte aligned maps")
    if channels != 3:
        raise ValueError(f"{kernel} takes 3 channels, got {channels}")
    if bw % 4:
        raise ValueError(f"{kernel} needs a band width that is a multiple "
                         f"of 4, got {bw}")
