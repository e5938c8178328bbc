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

``build_sharded_step`` runs the step eagerly, one launch per op; it is
the reference. The Stitcher runs it through ``ShardPrograms``, as the
JAX package jit-compiles its ``shard_map`` step whole: each non-empty
shard's levels are one program on its device (a CUDA graph on the card,
``pipeline/step_graph.py``), on a stream of its own, and the reduction,
the collapse, the resize and the u8 pack are one more on the first
device, whose stream waits for each shard's through events recorded
outside the graphs. A shard on another device hands its levels to the
reduction by a copy into the reduction's buffers, outside its graph.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from video_stitcher_tpu_torch.pipeline.step_graph import (
    ProgramSet, clone_tree, copy_into, on_stream,
)


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


def _reduce_pack(parts, valid_mask: torch.Tensor, geom,
                 out_size: Optional[Tuple[int, int]]):
    """The first device's half of the sharded step: the shards' levels
    reduced, collapsed and masked, resized to `out_size` when given, and
    packed to u8 HWC."""
    from video_stitcher_tpu_torch.pipeline.stitcher import _pack_u8_hwc
    dev0 = valid_mask.device
    pano = collapse_levels(reduce_levels(parts, dev0),
                           geom.blend_precision, valid_mask)
    if out_size is not None:
        pano = resize_planar(pano, *out_size)
    return _pack_u8_hwc(pano)


class ShardPrograms:
    """The sharded step's programs for one geometry and one list of
    devices: per key (pano or output size, each shard's frames' shape and
    dtype), one program per non-empty shard on its device and one
    reduction program on the first. Shard k's programs read one set of
    buffers (its maps, gains, weight pyramids and tile plan), the
    reductions the valid mask's; every install copies a ShardedState of
    the same geometry into them. Called under the stitcher's swap
    lock."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        #: one program set (and stream) per shard, one for the reduction
        self.shard_sets = [ProgramSet(d) for d in self.devices]
        self.reduce_set = ProgramSet(self.devices[0])
        self.geom = None
        self._sharded: Optional[ShardedState] = None
        #: per shard, its Shard with buffer tensors; the valid mask's
        self.buffers: Optional[List[Shard]] = None
        self.valid_mask: Optional[torch.Tensor] = None

    @property
    def captures(self) -> Dict[str, int]:
        """Captures per program name over this object's life."""
        out = {}
        for i, ps in enumerate(self.shard_sets):
            out.update({f"shard {i} on {ps.device}: {k}": v
                        for k, v in ps.captures.items()})
        out.update({f"on {self.reduce_set.device}: {k}": v
                    for k, v in self.reduce_set.captures.items()})
        return out

    def install(self, geom, sharded: ShardedState) -> None:
        """Copy a ShardedState into the buffers (for another geometry,
        drop the programs first), each shard's on its own stream after
        the caller's current stream on its device."""
        if geom != self.geom:
            for ps in self.shard_sets + [self.reduce_set]:
                ps.clear()
            self.buffers = self.valid_mask = None
            self.geom = geom
        self._sharded = sharded
        if self.buffers is None:
            return
        for ps, buf, sh in zip(self.shard_sets, self.buffers,
                               sharded.shards):
            with device_context(sh.device):
                on_stream(ps.stream, lambda b=buf, s=sh: copy_into(
                    _shard_tensors(b), _shard_tensors(s), "shard"),
                    _shard_tensors(sh))
        with device_context(self.devices[0]):
            on_stream(self.reduce_set.stream, lambda: copy_into(
                self.valid_mask, sharded.valid_mask, "valid mask"),
                [sharded.valid_mask])

    def _make_buffers(self) -> None:
        bufs = []
        for ps, sh in zip(self.shard_sets, self._sharded.shards):
            with device_context(sh.device):
                bufs.append(on_stream(ps.stream, lambda s=sh: clone_tree(s),
                                      _shard_tensors(sh)))
        self.buffers = bufs
        with device_context(self.devices[0]):
            self.valid_mask = on_stream(
                self.reduce_set.stream,
                lambda: self._sharded.valid_mask.clone(),
                [self._sharded.valid_mask])

    def run(self, frames: Sequence[torch.Tensor],
            out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The sharded step (build_sharded_step's) on frames[k], shard k's
        cameras, through the programs of its key, built and captured at
        its first use: a copy of the u8 pano (or output frame) on the
        first device, which no later call writes."""
        if self._sharded is None:
            raise RuntimeError("no state installed: calibrate first")
        if len(frames) != len(self.devices):
            raise ValueError(f"{len(frames)} frame blocks for "
                             f"{len(self.devices)} shards")
        if self.buffers is None:
            self._make_buffers()
        geom = self.geom
        ran = []
        for k, (buf, ps) in enumerate(zip(self.buffers, self.shard_sets)):
            if buf.hi == buf.lo:
                continue
            with device_context(buf.device):
                prog = ps.prepare(
                    ("levels",), lambda f, b=buf: shard_levels(f, b, geom),
                    frames[k])
                prog.launch(frames[k])
            ran.append(prog)
        reduce_prog = self._reduction(ran, frames, out_size)
        dev0 = self.devices[0]
        with device_context(dev0):
            out = reduce_prog.launch(
                *[p.output for p in ran],
                after=[p.stream for p in ran if p.stream is not None])
            rs = self.reduce_set.stream
            if rs is None:
                return clone_tree(out)
            with torch.cuda.stream(rs):
                out = out.clone()
            caller = torch.cuda.current_stream(dev0)
            out.record_stream(caller)
            caller.wait_stream(rs)
        # the caller's stream on each other device: a shard's next launch
        # writes levels this reduction read
        for d in {p.device for p in ran} - {self.reduce_set.device}:
            torch.cuda.current_stream(d).wait_stream(rs)
        return out

    def _reduction(self, shard_progs, frames, out_size):
        """The reduction program of the pano or of the output at
        `out_size`, for frames of these shapes and dtypes, over the
        levels of `shard_progs` (each non-empty shard's program, shared by
        the pano and the output): built and captured at its first use,
        after the shard programs have run."""
        geom, valid, dev0 = self.geom, self.valid_mask, self.devices[0]
        step = "pano" if out_size is None else "out {} {}".format(*out_size)
        with device_context(dev0):
            return self.reduce_set.prepare(
                ("reduce", step, "of",
                 str(frames[0].dtype).replace("torch.", "")
                 + str(list(frames[0].shape))),
                lambda *parts: _reduce_pack(parts, valid, geom, out_size),
                *[p.output for p in shard_progs], share=True)


def _shard_tensors(sh: Shard) -> list:
    """A shard's tensors, in a fixed order."""
    return [sh.fused_maps, sh.gains, *sh.weight_pyr,
            *((sh.plan.order, sh.plan.count) if sh.plan is not None
              else ())]
