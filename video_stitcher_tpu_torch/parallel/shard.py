"""Camera sharding: the cameras split over devices, one process driving
them all.

Torch twin of the JAX package's ``parallel/shard.py``, whose
single-controller program shards the camera axis over a ``Mesh`` and sums
each pyramid level's contributions with one ``psum``. Here the mesh is a
list of ``torch.device``: each shard warps its own cameras with K1 over
its own tile plan, builds their Laplacian pyramids, weights them and
places them at their corners, all queued on its device's current stream;
then each level's partial canvases move to the first device and are
added there in shard order, in the blend's storage dtype, and the
pyramid collapses there. That is what the ``psum`` buys: one panorama.

The cameras go to the shards in contiguous blocks of ceil(n / shards),
as in the JAX package. A shard may hold fewer cameras, or none (6 over 4
gives 2, 2, 2, 0): nothing is padded and a shard with no camera launches
nothing, so the JAX package's ``pad_cameras``, its skip flags and its
traced-corner placement (``_dyn_place``) have no counterpart. The corners
stay Python ints, and each shard places its bands with the static
segments of ``blend/multiband.place_bands``.

One reduction path serves the CPU (``[cpu] * k``), one card (``[cuda:0]
* k``) and several cards: ``.to(first device)`` orders itself after the
source stream's work, and on the same device it is the tensor itself.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from video_stitcher_tpu_torch.blend.multiband import (
    collapse_levels, weighted_levels,
)
from video_stitcher_tpu_torch.calib.state import CalibState
from video_stitcher_tpu_torch.ops.remap_strips import (
    plan_remap, remap_strips,
)
from video_stitcher_tpu_torch.ops.resize import resize_planar
from video_stitcher_tpu_torch.ops.warp_tiles import TilePlan


class Shard(NamedTuple):
    """One device's cameras [lo, hi) of the installed state."""
    device: torch.device
    lo: int
    hi: int
    #: the cameras' level-0 band corners, as Python ints
    corners: Tuple[int, ...]
    fused_maps: torch.Tensor            # f32 [hi - lo, 2, bh, bw]
    gains: torch.Tensor                 # f32 [hi - lo]
    weight_pyr: Tuple[torch.Tensor, ...]
    plan: Optional[TilePlan]            # None for a shard with no camera


class ShardedState(NamedTuple):
    shards: Tuple[Shard, ...]
    #: f32 [pano_h, pano_w] on the first shard's device
    valid_mask: torch.Tensor

    @property
    def device(self) -> torch.device:
        """The first shard's device, where the panorama is reduced."""
        return self.shards[0].device


class ShardedFrames(tuple):
    """One frame set split by shard: element k holds shard k's cameras on
    its device (none for a shard with no camera)."""


def camera_blocks(n: int, shards: int) -> List[Tuple[int, int]]:
    """The [lo, hi) camera block of each shard: contiguous blocks of
    ceil(n / shards), the last ones short or empty."""
    per = -(-n // shards)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(shards)]


def device_context(device: torch.device):
    """The device guard under which a shard's work is queued."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_state(state: CalibState, geom,
                devices: Sequence[torch.device]) -> ShardedState:
    """Split the state's camera axis over `devices` (camera_blocks), each
    shard's maps, gains and weight pyramids on its device with the tile
    plan of its maps; the valid mask goes to the first device. On the
    state's own device a shard's tensors are views of the state's."""
    devices = [torch.device(d) for d in devices]
    corners = tuple(int(c) for c in geom.layout.corners)
    shards = []
    for dev, (lo, hi) in zip(devices,
                             camera_blocks(state.fused_maps.shape[0],
                                           len(devices))):
        with device_context(dev):
            maps = state.fused_maps[lo:hi].to(dev).contiguous()
            plan = (plan_remap(maps, geom.warp_src_h, geom.warp_src_w)
                    if hi > lo else None)
            shards.append(Shard(
                device=dev, lo=lo, hi=hi, corners=corners[lo:hi],
                fused_maps=maps, gains=state.gains[lo:hi].to(dev),
                weight_pyr=tuple(w[lo:hi].to(dev).contiguous()
                                 for w in state.weight_pyr),
                plan=plan))
    return ShardedState(shards=tuple(shards),
                        valid_mask=state.valid_mask.to(devices[0]))


def shard_levels(frames: torch.Tensor, shard: Shard, geom
                 ) -> List[torch.Tensor]:
    """One shard's partial panorama levels, on its device: K1 over its
    plan (gain and clamp fused), the Laplacian pyramids in the blend's
    precision, times the weight pyramids in the storage dtype, placed at
    the shard's corners. frames: the shard's cameras, u8 RGB or NV12."""
    from video_stitcher_tpu_torch.pipeline.stitcher import _warp_source
    with device_context(shard.device):
        bands = remap_strips(_warp_source(frames, geom), shard.fused_maps,
                             shard.gains, shard.plan)
        return weighted_levels(bands, shard.weight_pyr, geom.layout,
                               geom.blend_precision, shard.corners)


def reduce_levels(per_shard: Sequence[List[torch.Tensor]],
                  device: torch.device) -> List[torch.Tensor]:
    """Sum the shards' partial levels on `device`, level by level in shard
    order, in their dtype (the JAX package's per-level psum)."""
    out = []
    for parts in zip(*per_shard):
        total = parts[0].to(device, non_blocking=True)
        for p in parts[1:]:
            total = total + p.to(device, non_blocking=True)
        out.append(total)
    return out


def build_sharded_step(geom, devices: Sequence[torch.device],
                       out_size: Optional[Tuple[int, int]] = None):
    """(frames per shard, ShardedState) -> u8 pano [pano_h, pano_w, 3] on
    the first device, or with out_size = (oh, ow) the output frame
    [oh, ow, 3], resized from the f32 panorama as Stitcher.stitch_out
    resizes it (so one shard gives stitch_out's frame bit for bit).
    frames[k] holds shard k's cameras on its device."""
    from video_stitcher_tpu_torch.pipeline.stitcher import _pack_u8_hwc
    devices = [torch.device(d) for d in devices]

    def step(frames: Sequence[torch.Tensor], sharded: ShardedState):
        if [s.device for s in sharded.shards] != devices:
            raise ValueError("the sharded state is not on this step's "
                             "devices")
        if len(frames) != len(sharded.shards):
            raise ValueError(f"{len(frames)} frame blocks for "
                             f"{len(sharded.shards)} shards")
        per_shard = [shard_levels(f, s, geom)
                     for f, s in zip(frames, sharded.shards) if s.hi > s.lo]
        dev0 = sharded.device
        with device_context(dev0):
            pano = collapse_levels(reduce_levels(per_shard, dev0),
                                   geom.blend_precision, sharded.valid_mask)
            if out_size is not None:
                pano = resize_planar(pano, *out_size)
            return _pack_u8_hwc(pano)

    return step
