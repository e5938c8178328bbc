"""The online stitcher: calibrate once, then one warp launch + one batched
pyramid blend per frame set.

Torch twin of the JAX package's ``pipeline/stitcher.py`` (the reference's
per-frame chain upload -> resize -> remap -> gain -> feed -> blend,
360_stitcher/timed.cpp:56-152). Per frame set: the frames go to the device,
K1 (``ops/remap_strips.remap_strips``) warps all cameras through the fused
backward maps with the gain and clamp in its store, the bands are blended
(``blend/multiband.py``) and the result is packed to u8. K1 walks the
maps' tile plan (``ops/warp_tiles.py``), which the stitcher builds with
each state it installs. Under prewarp the frames are first resized to
compose scale (planar f32, which K1 takes as it is). With the CPW mesh on
(``enable_local``, the default) ``calibrate`` ends in the first mesh
solve, and ``recalibrate_mesh`` re-solves it live. The live Runner hands
frame sets over with ``stage_frames`` (pinned host buffers uploaded on a
side CUDA stream) and takes output frames back with ``finalize_out``
(a pinned download). Every entry runs its device work through one
program per key (``pipeline/step_graph.py``: a CUDA graph on the card,
captured at the key's first use and replayed once per call; each install
copies the new state into the programs' buffers), where the JAX package
jit-compiles it: ``stitch``, ``stitch_nv12``, ``stitch_out``,
``stitch_batch``, ``stitch_int16`` and ``output``, and the mesh
re-solve's device stages (``mesh/pipeline.py``), whose programs
``calibrate`` and ``load_calibration`` capture ahead of the first
re-solve. With ``cfg.camera_shards`` > 1 the cameras are sharded over
devices (``parallel/shard.py``): each shard warps and weights its cameras
on its device, one program a shard, and the levels are summed on the
first in one more. ``stitch_int16`` is the reference's integer blend
arithmetic, a parity path.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from video_stitcher_tpu_torch.blend.multiband import (
    blend_bands, blend_bands_int16, blend_feather,
)
from video_stitcher_tpu_torch.calib.calibration import (
    StitchGeometry, calibrate, plan_geometry, prewarp_source, rebuild_aux,
)
from video_stitcher_tpu_torch.calib.state import (
    CalibState, load_state, save_state, state_to,
)
from video_stitcher_tpu_torch.config import StitcherConfig
from video_stitcher_tpu_torch.mesh.pipeline import (
    mesh_pipeline, mesh_weights, prewarm_mesh_programs,
)
from video_stitcher_tpu_torch.ops.color import (
    nv12_to_rgb_planar, nv12_to_rgb_planar_scaled,
)
from video_stitcher_tpu_torch.ops.remap_strips import (
    plan_remap, remap_strips,
)
from video_stitcher_tpu_torch.ops.resize import resize_planar
from video_stitcher_tpu_torch.ops.warp_tiles import TilePlan
from video_stitcher_tpu_torch.parallel.shard import (
    ShardedFrames, ShardedState, ShardPrograms, camera_blocks, shard_state,
)
from video_stitcher_tpu_torch.pipeline.step_graph import StepPrograms
from video_stitcher_tpu_torch.utils import trace
from video_stitcher_tpu_torch.utils.device import resolve_device


def resolve_shard_devices(shards: int, device: torch.device):
    """The devices the cameras are sharded over, `device` first (the
    panorama is reduced there), or None when the stitcher stays
    unsharded. On the card: `device` and the other cards, at most
    `shards` in all; with one card, unsharded. On the CPU: [cpu] *
    shards, the counterpart of the JAX package's virtual host devices."""
    if shards <= 1:
        return None
    if device.type != "cuda":
        return [device] * shards
    others = [torch.device("cuda", i)
              for i in range(torch.cuda.device_count()) if i != device.index]
    devices = [device] + others[:shards - 1]
    return devices if len(devices) > 1 else None


def _prewarped_planar(frames_u8: torch.Tensor, geom: StitchGeometry
                      ) -> torch.Tensor:
    """u8 RGB [N, H, W, 3] or NV12 [N, H*3/2, W] -> planar f32 [N, 3,
    compose_h, compose_w] (prewarp). NV12 takes the fused conversion at
    compose scale (nv12_to_rgb_planar_scaled); RGB is resized after the
    conversion to f32 (timed.cpp:77)."""
    if frames_u8.dim() == 3:
        return nv12_to_rgb_planar_scaled(frames_u8, geom.compose_h,
                                         geom.compose_w).contiguous()
    return prewarp_source(frames_u8.permute(0, 3, 1, 2), geom).contiguous()


def _warp_source(frames_u8: torch.Tensor, geom: StitchGeometry
                 ) -> torch.Tensor:
    """K1's source: u8 RGB [N, H, W, 3] -> planar u8 [N, 3, H, W] (exact),
    NV12 u8 [N, H*3/2, W] -> planar f32 [N, 3, H, W]; under prewarp
    either -> planar f32 at compose size (_prewarped_planar)."""
    if geom.prewarp:
        return _prewarped_planar(frames_u8, geom)
    if frames_u8.dim() == 3:
        return nv12_to_rgb_planar(frames_u8).contiguous()
    return frames_u8.permute(0, 3, 1, 2).contiguous()


def warp_bands(frames_u8: torch.Tensor, state: CalibState,
               geom: StitchGeometry,
               plan: Optional[TilePlan] = None) -> torch.Tensor:
    """Frames -> gain-compensated warped bands f32 [N, 3, bh, bw] through
    one K1 launch, over `plan` (the state's tile plan; built by K1 when
    None). N may be B * n_maps (batched frame sets reuse the maps
    cyclically; the gains are tiled to match). While the tracer records,
    markers on the card (utils/trace.mark) open the step and its warp."""
    trace.mark("step.begin", frames_u8.device)
    src = _warp_source(frames_u8, geom)
    n_maps = state.fused_maps.shape[0]
    gains = state.gains
    if src.shape[0] != n_maps:
        gains = gains.repeat(src.shape[0] // n_maps)
    trace.mark("step.warp", src.device)
    return remap_strips(src, state.fused_maps, gains, plan)


def blend_f32(bands, state: CalibState, geom: StitchGeometry):
    """Warped bands -> blended panorama, planar f32 [3, H, W]."""
    trace.mark("step.blend", bands.device)
    if geom.blend_type == "feather" or geom.num_bands == 0:
        return blend_feather(bands, state.weight_pyr[0][:, 0], geom.layout,
                             state.valid_mask)
    return blend_bands(bands, state.weight_pyr, geom.layout,
                       state.valid_mask, geom.blend_precision)


def _pack_u8_hwc(pano_f32):
    pano = torch.clamp(torch.round(pano_f32), 0.0, 255.0).to(torch.uint8)
    return pano.movedim(-3, -1).contiguous()


def blend_pack(bands, state: CalibState, geom: StitchGeometry):
    """Warped bands -> u8 panorama [pano_h, pano_w, 3]."""
    pano = blend_f32(bands, state, geom)
    trace.mark("step.output", pano.device)
    pano = _pack_u8_hwc(pano)
    trace.mark("step.end", pano.device)
    return pano


def blend_resize_pack(bands, state: CalibState, geom: StitchGeometry,
                      out_h: int, out_w: int):
    """Warped bands -> final output frame u8 [out_h, out_w, 3], resizing
    the f32 panorama (timed.cpp:281) before the single u8 pack."""
    pano = blend_f32(bands, state, geom)
    trace.mark("step.output", pano.device)
    frame = _pack_u8_hwc(resize_planar(pano, out_h, out_w))
    trace.mark("step.end", frame.device)
    return frame


def stitch_pano(frames_u8, state: CalibState, geom: StitchGeometry,
                plan: Optional[TilePlan] = None):
    """Full per-frame stitch -> u8 panorama [pano_h, pano_w, 3]."""
    return blend_pack(warp_bands(frames_u8, state, geom, plan), state, geom)


def stitch_batch_pano(frames_u8, state: CalibState, geom: StitchGeometry,
                      plan: Optional[TilePlan] = None):
    """u8 [B, N, H, W, 3] (or NV12 [B, N, H*3/2, W]) -> u8 panos [B,
    pano_h, pano_w, 3]: ONE warp launch over the B*N cameras (the maps
    reused cyclically), then each set's blend and pack."""
    b, n = frames_u8.shape[0], frames_u8.shape[1]
    bands = warp_bands(frames_u8.reshape((b * n,)
                                         + tuple(frames_u8.shape[2:])),
                       state, geom, plan)
    bands = bands.reshape((b, n) + tuple(bands.shape[1:]))
    return torch.stack([blend_pack(bb, state, geom) for bb in bands])


def stitch_pano_int16(frames_u8, state: CalibState, geom: StitchGeometry,
                      weights0: torch.Tensor,
                      plan: Optional[TilePlan] = None):
    """The quantization-matched 16S parity stitch: the production warp (K1
    on the card) followed by the reference's integer blend arithmetic
    (blend_bands_int16). weights0: the raw seam weights
    (aux["weights0"])."""
    bands = warp_bands(frames_u8, state, geom, plan)
    return _pack_u8_hwc(blend_bands_int16(bands, weights0, geom.layout,
                                          state.valid_mask))


def output_frame(pano_u8, out_h: int, out_w: int):
    """Consumer-side resize to the configured output (timed.cpp:281)."""
    y = resize_planar(pano_u8.movedim(-1, 0).to(torch.float32), out_h, out_w)
    return _pack_u8_hwc(y)


class _PinnedStager:
    """Uploads host frame sets to a card through a ring of pinned host
    buffers, on a side CUDA stream so that an upload overlaps the stitch
    of the frame set before it. A slot is refilled only after its
    previous upload has completed (its event); the ring is shared by the
    threads that stage, under a lock."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device)
        self._slots: list = [None] * slots     # (pinned buffer, event)
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, frames) -> torch.Tensor:
        host = (frames.cpu() if isinstance(frames, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(frames)))
        with self._lock:
            i = self._next
            self._next = (i + 1) % self.slots
            buf = None
            if self._slots[i] is not None:
                buf, done = self._slots[i]
                done.synchronize()
                if buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = None
            if buf is None:
                buf = torch.empty(host.shape, dtype=host.dtype,
                                  pin_memory=True)
            with trace.span("stage.pin"):
                buf.copy_(host)
            with trace.span("stage.h2d"), torch.cuda.stream(self.stream):
                dev = torch.empty(host.shape, dtype=host.dtype,
                                  device=self.device)
                dev.copy_(buf, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            self._slots[i] = (buf, event)
        # read by Stitcher._frames, in each thread that uses the tensor
        dev._staged_event = event
        return dev


class Stitcher:
    """High-level API: calibrate once, stitch per frame.

    >>> st = Stitcher(cfg); st.calibrate(frames); pano = st.stitch(frames)

    Runs on the card unless `device` names another (the tests pass "cpu").
    `(geom, state, aux)`, the state's tile plan and, when the cameras
    are sharded (cfg.camera_shards > 1), the state's shards are installed
    together under a lock, and every online call takes one snapshot of
    them under it, so a swap from another thread never mixes two states,
    or a state and another state's plan or shards, in one call. A mesh
    re-solve (recalibrate_mesh) and every swap_state install the same
    way, so the shards follow every state installed. Unsharded, stitch,
    stitch_nv12 and stitch_out replay the program of their key
    (`programs`), and every install copies the state and its plan into
    the programs' buffers under the same lock.
    """

    def __init__(self, cfg: StitcherConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geom: Optional[StitchGeometry] = None
        self.state: Optional[CalibState] = None
        self.aux: Optional[dict] = None
        self.plan: Optional[TilePlan] = None
        #: the state before the first mesh solve (global warp only)
        self.state_global: Optional[CalibState] = None
        # re-entrant: a step run under it may install (a test's hook)
        self._swap_lock = threading.RLock()
        self._mesh_pipe = None          # mesh/pipeline.MeshPipeline
        #: one pinned ring per shard (index 0 when unsharded)
        self._stagers: dict = {}
        #: the devices of the camera shards, or None (unsharded)
        self._shard_devices = resolve_shard_devices(cfg.camera_shards,
                                                    self.device)
        self._sharded: Optional[ShardedState] = None
        #: the unsharded entries' programs of the installed geometry
        self.programs = StepPrograms(self.device)
        #: the sharded step's programs, when sharded
        self.shard_programs: Optional[ShardPrograms] = None
        #: (a state stitch_int16 was given, on this device, its plan)
        self._int16_state: tuple = (None, None, None)

    # --- calibration -------------------------------------------------
    def calibrate(self, frames: np.ndarray) -> None:
        """Calibrate the rig from one frame set; with cfg.enable_local,
        then solve the CPW mesh from it (calibration.cpp:299-302). Traced
        as a span ``calibrate`` with one child per phase."""
        with trace.span("calibrate"):
            geom, state, aux = calibrate(np.asarray(frames), self.cfg,
                                         device=self.device)
            with trace.span("calibrate.install"):
                self._install(geom, state, aux)
            if self.cfg.enable_local:
                with trace.span("calibrate.prewarm"):
                    self.prewarm_mesh()
                with trace.span("calibrate.mesh"):
                    self.recalibrate_mesh(frames)

    def _install(self, geom: StitchGeometry, state: CalibState,
                 aux: Optional[dict] = None) -> None:
        """Install a state with its tile plan and, when sharded, its
        shards (parallel/shard.shard_state), all built before the lock
        and swapped in together under it, and copied into the programs'
        buffers under it. With `aux`, a new calibration: its state is
        also the global-only state, its seam weights go to the programs'
        buffers, and the mesh machinery of the old one goes. The wait for
        the lock is a span ``lock.wait``."""
        plan = self._plan(geom, state)
        sharded = (None if self._shard_devices is None else
                   shard_state(state, geom, self._shard_devices))
        with trace.span("lock.wait"):
            self._swap_lock.acquire()
        try:
            self.geom, self.state, self.plan = geom, state, plan
            self._sharded = sharded
            self.programs.install(
                geom, state, plan,
                weights0=None if aux is None else aux["weights0"])
            if sharded is not None:
                if (self.shard_programs is None or self.shard_programs.devices
                        != list(self._shard_devices)):
                    self.shard_programs = ShardPrograms(self._shard_devices)
                self.shard_programs.install(geom, sharded)
            if aux is not None:
                self.aux = aux
                self.state_global = state
                self._mesh_pipe = None
                self._int16_state = (None, None, None)
        finally:
            self._swap_lock.release()

    def save_calibration(self, path: str) -> None:
        save_state(path, self._snapshot()[0])

    def load_calibration(self, path: str, frames_shape=None) -> None:
        """Install a checkpoint written by either package's save_state,
        with the aux rebuilt from the geometry (rebuild_aux). The
        geometry follows from the config alone, so `frames_shape` is
        accepted, as the JAX package accepts it, and not read."""
        geom = self.geom or plan_geometry(self.cfg)[0]
        aux = rebuild_aux(self.cfg, geom, self.device)
        # the checkpoint's maps may hold a solved mesh: the closest stand-in
        # for the global-only state
        self._install(geom, self._on_device(
            geom, load_state(path, self.device)), aux)
        if self.cfg.enable_local:
            self.prewarm_mesh()

    def swap_state(self, state: CalibState) -> None:
        """Install a CalibState (moved to this stitcher's device) for the
        same geometry, re-sharding it when sharded; the aux stays."""
        geom = self.geom or plan_geometry(self.cfg)[0]
        self._install(geom, self._on_device(geom, state))

    def _on_device(self, geom: StitchGeometry, state: CalibState
                   ) -> CalibState:
        """The state on this stitcher's device. Maps padded beyond the
        band (TPU strip-plan checkpoints) are cropped."""
        lay = geom.layout
        state = state_to(state, self.device)
        return state._replace(fused_maps=state.fused_maps[
            :, :, :lay.band_h, :lay.band_w].contiguous())

    @staticmethod
    def _plan(geom: StitchGeometry, state: CalibState) -> TilePlan:
        """K1's tile plan of the state's maps over the source K1 samples
        (never checkpointed)."""
        return plan_remap(state.fused_maps, geom.warp_src_h, geom.warp_src_w)

    def _snapshot(self) -> Tuple[CalibState, StitchGeometry, TilePlan]:
        """The installed (state, geom, plan), read together under the
        lock."""
        return self._snapshot_sharded()[:3]

    def _snapshot_sharded(self) -> Tuple[CalibState, StitchGeometry,
                                         TilePlan, Optional[ShardedState]]:
        """The installed (state, geom, plan, shards), read together under
        the lock."""
        with self._swap_lock:
            return self.state, self.geom, self.plan, self._sharded

    # --- online ------------------------------------------------------
    @staticmethod
    def _ready(frames: torch.Tensor) -> torch.Tensor:
        """A staged tensor (stage_frames) made safe for the calling
        thread's current stream on its device: the stream waits for the
        upload's event, and the allocator keeps the tensor's memory until
        that stream's work on it has run. Any other tensor as it is."""
        event = getattr(frames, "_staged_event", None)
        if event is not None:
            stream = torch.cuda.current_stream(frames.device)
            stream.wait_event(event)
            frames.record_stream(stream)
        return frames

    def _frames(self, frames) -> torch.Tensor:
        """The whole frame set on this stitcher's device; a tensor already
        there (a staged one made ready, _ready) is used as it is. A
        sharded staged set (ShardedFrames) is gathered there from its
        shards: the mesh re-solve, stitch_int16 and output read it so."""
        if isinstance(frames, ShardedFrames):
            return torch.cat([self._ready(p).to(self.device)
                              for p in frames])
        if getattr(frames, "_staged_event", None) is not None:
            return self._ready(frames)
        return torch.as_tensor(frames, device=self.device)

    def _shard_frames(self, frames, sharded: ShardedState):
        """Each shard's cameras on its device: the pieces of a sharded
        staged set made ready, or slices of a frame set sent there."""
        if isinstance(frames, ShardedFrames):
            if len(frames) != len(sharded.shards):
                raise ValueError(f"a frame set staged for {len(frames)} "
                                 f"shards, {len(sharded.shards)} installed")
            return [self._ready(p) for p in frames]
        frames = (self._ready(frames) if isinstance(frames, torch.Tensor)
                  else torch.as_tensor(frames))
        return [frames[s.lo:s.hi].to(s.device) for s in sharded.shards]

    def stage_frames(self, frames, slots: int = 3):
        """frames (host numpy or a tensor) -> the frame set on this
        stitcher's device, for stitch* and recalibrate_mesh (the Runner's
        staging path). On the card, host frames go through one of `slots`
        pinned host buffers and upload on a side CUDA stream without
        blocking; every stitcher call that takes the returned tensor first
        waits for the upload on its own thread's stream (_ready). A
        tensor already on this device passes through unchanged; on the
        CPU this is torch.as_tensor. Sharded, each shard's cameras are
        staged so onto its device, through a pinned ring of its own, and
        the pieces come back as one ShardedFrames."""
        devices = self._shard_devices
        if devices is None:
            return self._stage(0, self.device, frames, slots)
        blocks = camera_blocks(len(frames), len(devices))
        return ShardedFrames(
            self._stage(k, dev, frames[lo:hi], slots)
            for k, (dev, (lo, hi)) in enumerate(zip(devices, blocks)))

    def _stage(self, k: int, device: torch.device, frames, slots: int):
        """frames -> `device`, on the card through pinned ring `k`."""
        if isinstance(frames, torch.Tensor) and frames.device == device:
            return frames
        if device.type != "cuda" or len(frames) == 0:
            return torch.as_tensor(frames, device=device)
        stager = self._stagers.get(k)
        if stager is None or stager.slots != slots:
            stager = self._stagers[k] = _PinnedStager(device, slots)
        return stager.upload(frames)

    def _replay(self, frames, out: bool = False) -> torch.Tensor:
        """The unsharded step on `frames` through its program
        (pipeline/step_graph.py): stitch_pano, or with `out`
        blend_resize_pack ∘ warp_bands at the output size, for the
        geometry installed. The frames are made ready on this thread's
        stream first; host frames are copied straight into the program's
        buffer. Spans: ``lock.wait`` (the swap lock), ``replay`` (the
        copy in, the replay and the outputs' copy)."""
        if isinstance(frames, ShardedFrames) or getattr(
                frames, "_staged_event", None) is not None:
            x = self._frames(frames)
        elif isinstance(frames, torch.Tensor):
            x = frames
        else:
            x = torch.as_tensor(np.asarray(frames))
        with trace.span("lock.wait"):
            self._swap_lock.acquire()
        try:
            geom = self.geom
            if geom is None:
                raise RuntimeError("no calibration installed")
            with trace.span("replay"):
                if not out:
                    return self.programs.run(
                        ("stitch_pano",),
                        lambda b, f: stitch_pano(f, b.state, geom, b.plan),
                        x)
                oh, ow = self._out_size(geom)
                return self.programs.run(
                    ("stitch_out", oh, ow),
                    lambda b, f: blend_resize_pack(
                        warp_bands(f, b.state, geom, b.plan), b.state, geom,
                        oh, ow), x)
        finally:
            self._swap_lock.release()

    def stitch(self, frames, device: bool = False):
        """frames u8 [N, H, W, 3] (or NV12 [N, H*3/2, W]) -> u8 pano
        [pano_h, pano_w, 3]. device=True returns the tensor on the device
        (no host transfer), which no later call writes. Unsharded, the
        step is the program of its key (a CUDA graph on the card); sharded,
        the sharded step runs and the pano lies on the first shard's
        device."""
        _, geom, _, sharded = self._snapshot_sharded()
        if sharded is not None:
            pano = self._sharded_replay(frames, sharded)
        else:
            pano = self._replay(frames)
        return pano if device else pano.cpu().numpy()

    def _sharded_replay(self, frames, sharded: ShardedState,
                        out_size=None) -> torch.Tensor:
        """The sharded step on `frames` through its programs
        (parallel/shard.ShardPrograms): build_sharded_step's pano, or its
        output frame at `out_size`, on the first shard's device."""
        blocks = self._shard_frames(frames, sharded)
        with self._swap_lock:
            return self.shard_programs.run(blocks, out_size)

    def stitch_nv12(self, nv12, device: bool = False):
        """Production ingest path: NV12 u8 [N, H*3/2, W] -> u8 pano. The
        conversion to planar RGB runs on the device."""
        return self.stitch(nv12, device)

    def stitch_batch(self, frames, device: bool = False):
        """u8 [B, N, H, W, 3] (or NV12 [B, N, H*3/2, W]) -> u8 panos
        [B, pano_h, pano_w, 3], with ONE warp launch over the B*N cameras
        (the maps are reused cyclically): the program of its key
        (stitch_batch_pano for B and the frames' shape and dtype).
        Sharded, the sharded step's programs replay once per frame set,
        all from one snapshot."""
        _, geom, _, sharded = self._snapshot_sharded()
        if sharded is not None:
            panos = torch.stack([self._sharded_replay(f, sharded)
                                 for f in frames])
            return panos if device else panos.cpu().numpy()
        with self._swap_lock:
            panos = self.programs.run(
                ("stitch_batch",),
                lambda b, f: stitch_batch_pano(f, b.state, geom, b.plan),
                self._frames(frames))
        return panos if device else panos.cpu().numpy()

    def _out_size(self, geom: StitchGeometry):
        """Output frame size under the aspect policy (timed.cpp:254-292)."""
        cfg = self.cfg
        if cfg.keep_aspect_ratio:
            oh = int(cfg.output_width / geom.pano_w * geom.pano_h + 0.5)
            oh = min(oh, cfg.output_height)
        else:
            oh = cfg.output_height
        return oh, cfg.output_width

    def stitch_out(self, frames, device: bool = False):
        """frames -> final output frame, resizing the f32 panorama instead
        of an intermediate u8 one. device=True returns the device tensor
        before black-bar compositing; otherwise equivalent to
        output(stitch(frames)) up to that rounding. Sharded, the sharded
        step resizes its f32 panorama the same way. Unsharded, the step
        (warp + blend + resize + pack) is the program of its key: on the
        card one graph launch."""
        _, geom, _, sharded = self._snapshot_sharded()
        if sharded is not None:
            frame = self._sharded_replay(frames, sharded,
                                         self._out_size(geom))
        else:
            frame = self._replay(frames, out=True)
        return frame if device else self.finalize_out(frame)

    def stitch_int16(self, frames, state: Optional[CalibState] = None,
                     device: bool = False):
        """The 16S-faithful parity stitch (stitch_pano_int16): the
        production warp, K1 on the card, and the reference's exact
        integer blend arithmetic, for a comparison with the reference's
        own 16S output, through the program of its key. `state` defaults
        to the live state (with its plan), read from the programs'
        buffers; any other CalibState (state_global, for the mesh-free
        gold chain) is warped over a tile plan of its own maps, both
        copied into that program's own buffers. Runs on this stitcher's
        device, sharded or not."""
        x = self._frames(frames)
        with self._swap_lock:
            live, geom = self.state, self.geom
            if state is None or state is live:
                pano = self.programs.run(
                    ("stitch_int16",),
                    lambda b, f: stitch_pano_int16(f, b.state, geom,
                                                   b.weights0, b.plan), x)
            else:
                if self._int16_state[0] is not state:
                    dev_state = self._on_device(geom, state)
                    self._int16_state = (state, dev_state,
                                         self._plan(geom, dev_state))
                pano = self.programs.run(
                    ("stitch_int16", "of a state"),
                    lambda b, f, s, p: stitch_pano_int16(f, s, geom,
                                                         b.weights0, p),
                    x, *self._int16_state[1:])
        return pano if device else pano.cpu().numpy()

    def finalize_out(self, frame):
        """Output frame -> host np frame with the black-bar policy applied
        (timed.cpp:285-292). A frame on the card downloads into a pinned
        host buffer of its own (the bars written on the host around it),
        so the array returned never shares memory with a later frame's.
        Spans: ``download.alloc`` (that buffer), ``download.wait``."""
        cfg = self.cfg
        bars = cfg.keep_aspect_ratio and cfg.add_black_bars
        if isinstance(frame, torch.Tensor) and frame.is_cuda:
            h = frame.shape[0]
            rows, y0 = ((cfg.output_height, cfg.output_height // 2 - h // 2)
                        if bars else (h, 0))
            with trace.span("download.alloc"):
                host = torch.empty((rows,) + tuple(frame.shape[1:]),
                                   dtype=frame.dtype, pin_memory=True)
            host[:y0].zero_()
            host[y0 + h:].zero_()
            host[y0:y0 + h].copy_(frame, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(frame.device))
            with trace.span("download.wait"):
                done.synchronize()
            return host.numpy()
        if isinstance(frame, torch.Tensor):
            frame = frame.cpu().numpy()
        if bars:
            canvas = np.zeros((cfg.output_height, cfg.output_width, 3),
                              np.uint8)
            y0 = cfg.output_height // 2 - frame.shape[0] // 2
            canvas[y0:y0 + frame.shape[0]] = frame
            return canvas
        return frame

    def output(self, pano_u8):
        """pano -> final output frame at cfg.output_* with the aspect
        policy (timed.cpp:254-292): output_frame through the program of
        its key (output size, the pano's shape and dtype), which reads no
        state."""
        x = self._frames(pano_u8)
        with self._swap_lock:
            oh, ow = self._out_size(self.geom)
            frame = self.programs.run(
                ("output", oh, ow), lambda b, p: output_frame(p, oh, ow), x)
        return self.finalize_out(frame)

    # --- recalibration (CPW mesh) ---------------------------------------
    def prewarm_mesh(self, frames=None) -> None:
        """Capture the mesh re-solve's programs ahead of its first use
        (mesh/pipeline.prewarm_mesh_programs), keyed by `frames`' shape
        and dtype (by default the u8 RGB frames calibrate takes).
        calibrate and load_calibration run it with cfg.enable_local, and
        the Runner for its own frames, before its threads start."""
        pipe = mesh_pipeline(self)
        with pipe.on_stream():
            x = None if frames is None else self._frames(frames)
            prewarm_mesh_programs(self.cfg, self.geom, pipe, x)
        self._join(pipe)

    def _join(self, pipe) -> None:
        """The caller's current stream waits for the re-solve's."""
        if pipe.stream is not None:
            torch.cuda.current_stream(pipe.device).wait_stream(pipe.stream)

    def recalibrate_mesh(self, frames) -> bool:
        """Re-solve the CPW mesh from fresh frames and install the maps it
        gives, with their tile plan and shards (the reference's
        recalibrateMesh thread body, timed.cpp:414-463). The device
        stages replay the re-solve's programs (mesh/pipeline.py) on its
        own stream, the install included; the caller's stream waits for
        it at the end. A sharded staged set is gathered onto this
        stitcher's device for the solve. Returns True if a mesh was
        installed. Spans: the pipeline's stages (``resolve.*``,
        MeshPipeline.run), ``resolve.compose``, ``resolve.install``."""
        pipe = mesh_pipeline(self)
        with pipe.on_stream():
            disp_c = pipe.run(self._frames(frames))
            if disp_c is not None:
                state, geom, _ = self._snapshot()
                with trace.span("resolve.compose"):
                    new_state = state._replace(
                        fused_maps=pipe.compose(disp_c))
                    if self.cfg.update_masks:
                        weight_pyr, valid = pipe.rebuild(disp_c)
                        new_state = new_state._replace(
                            weight_pyr=weight_pyr, valid_mask=valid)
                with trace.span("resolve.install"):
                    self._install(geom, new_state)
        self._join(pipe)
        return disp_c is not None

    def _rebuild_weights(self, state: CalibState, mesh_maps: torch.Tensor
                         ) -> CalibState:
        """Re-warp the calibration seam weights through the CPW mesh's
        dense backward maps [N, 2, bh, bw] and rebuild the blend weight
        pyramids (MultiBandBlender::update_mask, blenders.cpp:297-315;
        opt-in through cfg.update_masks, as the reference disabled it).
        Eager: recalibrate_mesh runs mesh_weights through a program."""
        weight_pyr, valid = mesh_weights(
            self.aux["weights0"],
            torch.as_tensor(mesh_maps, device=self.device), self.geom.layout)
        return state._replace(weight_pyr=weight_pyr, valid_mask=valid)

    @staticmethod
    def interpolate_states(old: CalibState, new: CalibState, t: float
                           ) -> CalibState:
        """The state between two calibrations at t in [0, 1] (the
        RECALIB_INTERP animation, timed.cpp:452-459 /
        meshwarper.cpp:337-354): `new` with its maps lerped from `old`'s.
        A sample invalid at either end (<= -1) stays -1 for the whole
        animation instead of lerping through the sentinel. Install it
        with swap_state, which builds its tile plan."""
        t = float(min(max(t, 0.0), 1.0))
        a, b = old.fused_maps, new.fused_maps
        mix = torch.where(torch.minimum(a, b) > -1.0, a * (1.0 - t) + b * t,
                          torch.full_like(a, -1.0))
        return new._replace(fused_maps=mix)
