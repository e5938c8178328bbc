"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (nvcc) and prints each one's ptxas
report, calibrates the full-width 6x1920x1080 rig with the default
configuration (StitcherConfig(): the CPW mesh on, so calibrate ends in
the first mesh solve, whose estimation warp runs K1) from a synthetic
scene made from a seed, stitches frame sets through stitch / stitch_nv12
/ stitch_out / stitch_batch, and checks each result against the scene
and against the port's plain versions. Then the local calibration's
numbers (mesh solve, matched seams, mesh displacement, K1 on the
estimation warp), a live re-solve (recalibrate_mesh on perturbed frames,
its tile plan, interpolate_states through K1, one update_masks
re-solve), and K1 held against its plain PyTorch version at the main
path's shapes, also on maps stretched so that one tile's taps span much
of the source; times the path, K1, K1's plain version and the PyTorch
library call that computes K1's function. Then drives the separable warp
(pass_h, kernel K2) at the same rig from the global-only state, holds K2
against its plain version bit for bit and the path against K1, blends
its bands, and times pass_h, K2, K2's plain version and the library call
that computes K2's function. Last, the prewarp path of the JAX package's
BASELINE config 4 (6x3840x2160 -> 7680x3840, keep_aspect_ratio,
add_black_bars, global warp): K1 on the f32 source resized to compose
scale, held against its plain version and timed against its bound, and
stitch_out from RGB and NV12. Then phase "graph", at the default cell
and at config 4: stitch, stitch_nv12 and stitch_out replay one CUDA graph
per key (pipeline/step_graph.py); each replay is held against the eager
module functions at max abs 0 on the installed state, after a swap to
perturbed maps, at three interpolate_states steps, and after the tap
caches were cleared and the freed memory written over; no swap captures
again; the eager and graphed stitch_out times, the CUDA API calls each
call makes (one cudaGraphLaunch and no kernel launch), the card's busy
share, a swap's cost, and each key's capture time and memory pool; then
the Runner from memory in both modes, an eager stand-in against the
graphed stitcher. Every Runner output of every phase is held against
the eager step of its frame set (eager_out). Then phase "programs", at
the default cell: the programs of the JAX package's other jits
(stitch_batch at B = 2 and 4, stitch_int16 on the live state and on
state_global, output, the sharded step on [card] * k for k = 1-4) held
against their eager module functions at max abs 0 through the same
swaps, interpolation steps and cleared caches, with no new capture;
their eager and graphed ms, API calls (one cudaGraphLaunch a call, k' +
1 for the sharded step with k' non-empty shards, no kernel launch),
capture seconds and pools; the mesh re-solve's programs against its
eager stages with the same draws (displacement, installed maps and
weights at max abs 0, both recalib_chunked settings, update_masks on),
one cudaGraphLaunch per unit of a re-solve, and its eager and graphed
seconds. No capture may run on a Runner thread in the Runner phases
that follow. Then phase "runner": the
live Runner (pipeline/runner.py) with the calibrated 6x1080p stitcher:
(a) over the native TCP capture server (framed protocol, 6 loopback
boards streaming NV12 sets) in the threaded and the inline pipeline,
every output equal to stitch_out of the set sent for it; (b) the live re-solve thread with
the interpolation animation until two meshes install; (c) HEVC egress
into a loopback player that counts the pictures; (d) BASELINE config 4
from memory; (e) 20 Runner frames under torch.profiler (utils/trace) for
the card's busy share; and the host<->card copies of one frame set and
one output frame, pinned against pageable. The native I/O libraries
(native/*.cpp) build with g++ beside the kernels' nvcc.
Phase "shard": camera sharding (parallel/shard.py) with the shards on
[card] * k for k = 1-4, the one card standing for k: the sharded step
against stitch and stitch_out (bit-equal with one shard, within 3
otherwise), K1 once per non-empty shard, a Stitcher sharded over two
shards through stage_frames, stitch*, and the live Runner, K1 against
its plain version on one shard's maps, the step's and the reduction's
times and one sharded swap. Phase "int16": stitch_int16 through K1 in
the reference's integer band against the f32 stitch of the same state,
the integer pyramids and blend on the card against the host, its time.
Phase "blend": the blend's kernels (blend/levels.py: down, lap_place and
collapse, csrc/blend_levels.cu) at the rig's shapes in bf16 and f32, each
against its plain version level by level and the whole blend against the
chain of plain pyramid helpers it replaced, at max abs 0; each kernel's
device ms, bound and plain ms; the blend's launches per replay of
stitch_out, and a profiled replay captured with the tracer's markers,
whose blend stage (step.blend to step.output) runs the blend kernels
alone.
Phase "helpers": the JAX package's public helpers that the other phases
do not drive (the f64 host band maps against the card's, the host entry
compose_fused_maps, the Laplacian round trip, the HWC wrappers and the
colour helpers), each on the card against its reference.
Phase "entries": the entry points as a user calls them, with no device
argument: calibrate(frames, cfg) on the card, calibrate(frames, cfg,
mesh_maps=m) against compose_fused_maps, K1 on the meshed maps, and a
save_state -> load_state round trip whose stitch_out equals the saved
state's.
Phase "live": the Runner's fault paths at the default cell (6x1080p NV12
over TCP): (a) a board drops its link mid-frame and reconnects into its
freed slot, another sends a truncated frame the ingest resyncs past,
every output equal to stitch_out of its set and the ingest counters
equal to what was injected; (b) boards flooding a 2-deep capture queue,
its drop counters equal to the frames lost; (c) a player that drops the
egress link, the stream restarting with its height prelude; (d)
tests/test_soak.py's all-features soak (framed ingest, the live re-solve
with its animation and update_masks, HEVC egress), >= 15 of 20 frames, a
re-solve landed, no stall, a decodable stream; (e)
tests/test_egress_rate.py's 4K egress rate (I_PCM, and x265 where it
loads).

Each path runs with the launch counts set to 0 just before it and read
just after.

A kernel's `ms` (and `library_ms`) is its device time alone: the median
over REPS calls of the device time of the kernels one call launches, from
torch.profiler. `call_ms` is the median time between two CUDA events
around one call (the host's checks and launch included); `plain_ms` is
timed that way too. `bound_ms` counts the bytes this run's data needs:
the output, the maps of the active tiles (the kernels read no map of an
empty tile), the source pixels some tap reads, and the tile plan.

Prints the card's name and power limit, one {"kernels": [...]} line, and
as its last line {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import statistics
import struct
import subprocess
import sys
import threading
import time
import traceback
import types

import numpy as np
import torch

SEED = 3               # the JAX package's bench.py scene seed
MIN_PSNR_DB = 40.0     # stitched pano vs the synthetic scene
MAX_ABS_U8 = 3         # BASELINE.md:22, the reference's CUDA-vs-CPU bound
K1_ATOL = 1e-3         # K1 vs its plain version, both f32
REPS = 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM, dense bf16 tensor cores
K1_SOURCE = "video_stitcher_tpu_torch/csrc/remap_gain.cu"
K1_REPLACES = "video_stitcher_tpu/ops/remap_strips.py:543"
PASS_H_ATOL = 1.0      # bf16 pass_h vs the f32 product of the same inputs
                       # (experiments/test_remap_separable.py:49)
SEP_VS_K1_ATOL = 2.0   # the separable warp vs K1, 0-255 scale: the bf16
                       # bound of the TPU warp (ops/remap_strips.py:64-70)
K2_SOURCE = "video_stitcher_tpu_torch/csrc/remap_separable.cu"
K2_REPLACES = "experiments/remap_separable.py:171"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn, reps=REPS):
    """Median host-clock ms of fn() between two device synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps=REPS):
    """Median device ms of fn() between two CUDA events."""
    fn()                                                   # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, reps=REPS):
    """Device time of the kernels one call of fn launches, the kernels
    alone without the host's part of the call: from torch.profiler's
    device entries over reps calls, for each kernel its median entry
    times the entries it has per call, summed. (The profiler has been
    seen to leave out two entries of a window, so the window is not cut
    into calls.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_kernel:
        raise RuntimeError(f"no device entries for {reps} calls")
    total = 0.0
    for name, us in by_kernel.items():
        per_call = max(1, round(len(us) / reps))
        if len(us) != per_call * reps:
            log(f"  (profiler: {len(us)} entries of {name[:40]} for {reps} "
                f"calls, counted {per_call} per call)")
        total += per_call * statistics.median(us)
    return total / 1e3


def device_sum_ms(fn, reps=REPS, launches=None):
    """Device time of all the kernels one call of fn launches: the sum of
    torch.profiler's device entries over reps calls, over reps. For a
    call whose launches of one kernel differ in size (one add per
    pyramid level), where kernel_ms's median entry would stand for the
    middle level only. With `launches` (the kernels one call launches),
    a profile that lost entries is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if launches is None or len(us) == launches * reps:
            break
        log(f"  the profiler saw {len(us)} device entries of "
            f"{launches * reps}; profiled again")
    else:
        raise RuntimeError(f"the profiler saw {len(us)} device entries of "
                           f"{launches * reps}, three times")
    if not us:
        raise RuntimeError(f"no device entries for {reps} calls")
    return sum(us) / reps / 1e3


def needed_source_bytes(x0, y0, h: int, w: int, channels: int,
                        elem_size: int) -> int:
    """Bytes of the source pixels some tap reads: camera m's taps from the
    tap origins x0, y0 [n_maps, bh, bw] (each source read once)."""
    n = x0.shape[0]
    seen = torch.zeros(n * h * w, dtype=torch.bool, device=x0.device)
    cam = torch.arange(n, device=x0.device)[:, None, None]
    x0, y0 = x0.long(), y0.long()
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            seen[((cam * h + y) * w + x)[ok]] = True
    return int(seen.sum()) * channels * elem_size


def tile_bytes(plan, bh: int, bw: int):
    """(band pixels of the active tiles, bytes of the plan)."""
    from video_stitcher_tpu_torch.ops.warp_tiles import TILE_H, TILE_W
    _, ty, tx = plan.tiles
    dev = plan.order.device
    rows = torch.clamp(bh - torch.arange(ty, device=dev) * TILE_H,
                       max=TILE_H)
    cols = torch.clamp(bw - torch.arange(tx, device=dev) * TILE_W,
                       max=TILE_W)
    px = int(((rows[:, None] * cols[None])[None] * plan.active).sum())
    return px, plan.order.numel() * 4


def luma(rgb):
    """BT.601 video-range luma, the plane NV12 carries at full resolution."""
    x = np.asarray(rgb, np.float64)
    return 0.256788 * x[..., 0] + 0.504129 * x[..., 1] \
        + 0.097906 * x[..., 2] + 16.0


def device_profile(fn, reps=5, by_name=False):
    """torch.profiler over reps calls of fn: (share of the wall time the
    card spent in kernels, kernels per call, the top kernels by device
    time), and with `by_name` the kernels per call by full name. The
    profiler's own cost lengthens the wall time, so the share is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    # a warm-up step, whose entries are dropped: the first few device
    # entries after the profiler starts go missing (an H100, 5 a profile)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    # device-side entries only: an operator's entry repeats the device time
    # of the kernels it launched, and the step's annotation on the device
    # spans its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = (busy_us / wall_us, sum(e.count for e in kernels) / reps,
           [(e.key[:60], e.self_device_time_total / reps / 1e3, e.count
             // reps) for e in top])
    if by_name:
        out += ({e.key: e.count / reps for e in kernels},)
    return out


def scene_psnr(pano, scene, valid, of=lambda x: x):
    """psnr of of(pano) vs of(scene) over the valid central rows (the JAX
    package's bench.py rule)."""
    from video_stitcher_tpu_torch.utils.synth import psnr
    gt = np.moveaxis(scene, 0, -1)
    h = pano.shape[0]
    sel = valid[h // 4:3 * h // 4]
    return psnr(of(pano[h // 4:3 * h // 4][sel]),
                of(gt[h // 4:3 * h // 4][sel]))


def max_abs_u8(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} != {b.shape}")
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


FAILED = []


def check(cond: bool, what: str) -> None:
    """Record one check; a failed one fails the run at its end."""
    log(f"  {'ok' if cond else 'FAILED'}: {what}")
    if not cond:
        FAILED.append(what)


def eager_step(st, frames, out: bool = False):
    """The unsharded step on st's installed state through the module
    functions (stitch_pano, or blend_resize_pack of warp_bands at the
    output size), with no program: what a graph replay is held
    against."""
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        blend_resize_pack, stitch_pano, warp_bands)
    state, geom, plan = st._snapshot()
    x = torch.as_tensor(frames, device=st.device)
    if not out:
        return stitch_pano(x, state, geom, plan)
    return blend_resize_pack(warp_bands(x, state, geom, plan), state, geom,
                             *st._out_size(geom))


def eager_out(st, frames) -> np.ndarray:
    """What stitch_out(frames) returns (black bars and all), computed
    eagerly: the expected output of a Runner frame."""
    return st.finalize_out(eager_step(st, frames, out=True))


def program_sets(st) -> dict:
    """Every program set of a stitcher (pipeline/step_graph.ProgramSet):
    its unsharded entries', its sharded step's shards' and reduction's,
    and its mesh re-solve's."""
    sets = {"entries": st.programs}
    if st.shard_programs is not None:
        for i, ps in enumerate(st.shard_programs.shard_sets):
            sets[f"shard {i}"] = ps
        sets["reduction"] = st.shard_programs.reduce_set
    if st._mesh_pipe is not None:
        sets["re-solve"] = st._mesh_pipe.programs
    return sets


def captures(st) -> int:
    """K1 launches the warm-ups of st's captured programs made: a capture
    runs its function once eagerly first, with the K1 launches its graph
    then replays."""
    return sum(p.k1_launches for ps in program_sets(st).values()
               for p in ps.programs.values())


def all_captures(st) -> dict:
    """Captures per program over all of st's program sets."""
    return {f"{name}: {k}": v for name, ps in program_sets(st).items()
            for k, v in ps.captures.items()}


def edited_maps(maps: torch.Tensor, h: int, w: int):
    """The calibrated maps with the cases K1 must get right written in:
    a -1 region, coordinates in (-1, 0), and coordinates just past the
    right and bottom source edges. Returns (maps, the -1 region)."""
    m = maps.clone()
    bh, bw = m.shape[2], m.shape[3]
    dead = (slice(bh // 4, bh // 4 + bh // 16),
            slice(bw // 3, bw // 3 + bw // 16))
    m[:, :, dead[0], dead[1]] = -1.0
    rows, cols = bh // 32, bw // 4

    def ramp(lo, hi):
        return torch.linspace(lo, hi, cols, device=m.device)
    m[:, 0, bh // 2:bh // 2 + rows, :cols] = ramp(-0.999, -0.001)
    m[:, 1, bh // 2 + 2 * rows:bh // 2 + 3 * rows, :cols] = ramp(-0.999,
                                                                 -0.001)
    m[:, 0, bh // 8:bh // 8 + rows, bw // 2:bw // 2 + cols] = ramp(w - 1.5,
                                                                   w + 0.5)
    m[:, 1, bh // 8 + 2 * rows:bh // 8 + 3 * rows,
      bw // 2:bw // 2 + cols] = ramp(h - 1.5, h + 0.5)
    return m.contiguous(), dead


def warp_bound_ms(plan, x0, y0, src, n_out: int, bh: int, bw: int,
                  extra_bytes: int = 0):
    """Least time for a warp kernel's work on this card: the f32 output
    (3 channels) written once, the maps of the active tiles, the source
    pixels some tap reads and the plan each read once, over the memory
    rate; vs ~40 f32 flops a band pixel of an active tile (tap weights,
    4-tap blends, gain, clamp) over the f32 rate."""
    active_px, plan_bytes = tile_bytes(plan, bh, bw)
    nbytes = (n_out * 3 * bh * bw * 4 + active_px * 8 + plan_bytes
              + needed_source_bytes(x0, y0, src.shape[2], src.shape[3], 3,
                                    src.element_size()) + extra_bytes)
    return (*bound_ms(nbytes, 40.0 * active_px, F32_FLOPS), nbytes)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """Least time on this card for work that moves nbytes and does flops
    at peak_flops: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stretched_maps(maps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The maps with a region whose tiles each span a quarter of the
    source's width and half its height: far more than the ~96x28 source
    pixels a calibrated tile reads."""
    m = maps.clone()
    bh = m.shape[2]
    rows = slice(bh // 2 + 64, bh // 2 + 96)
    m[:, 0, rows, 64:320] = torch.linspace(0, w - 1, 256, device=m.device)
    m[:, 1, rows, 64:320] = torch.linspace(0, h - 1, 32,
                                           device=m.device)[:, None]
    return m.contiguous()


def perturbed_maps(maps: np.ndarray) -> np.ndarray:
    """The calibrated maps with a smooth +-2 px x displacement (the kind a
    CPW mesh adds, so Pass V reads off its own band column) and a -1
    corner, as experiments/test_remap_separable.py:22-32 builds them."""
    m = maps.copy()
    n, _, bh, bw = m.shape
    gy = np.arange(bh, dtype=np.float64)[:, None]
    xb = np.arange(bw, dtype=np.float64)[None]
    for i in range(n):
        dx = 2.0 * np.sin(gy / 5.0 + i) * np.cos(xb / 17.0)
        m[i, 0] = np.where(m[i, 0] > -1, m[i, 0] + dx, m[i, 0])
    m[0, :, :bh // 20, :bw // 13] = -1.0
    return m


def k2_phase(st, frames, scene, valid, dev):
    """The separable warp at the main path's rig: plan from the calibrated
    global-only state (its maps have the column structure the separable
    plan is built for), drive pass_h + K2 and blend, check, time. Returns
    (the K2 entry of the kernels line, metrics)."""
    from video_stitcher_tpu_torch.experiments import remap_separable as sep
    from video_stitcher_tpu_torch.ops.remap_strips import plan_remap
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        blend_pack, warp_bands)
    geom, state = st.geom, st.state_global
    k1_plan = plan_remap(state.fused_maps, geom.warp_src_h, geom.warp_src_w)
    log("phase K2 separable warp")
    t0 = time.perf_counter()
    fused = state.fused_maps.cpu().numpy()
    maps_p, gmx_p = sep.pad_maps(fused, sep.global_x_map(fused))
    plan = sep.plan_separable(maps_p, gmx_p, geom.src_h, geom.src_w)
    plan_pert = sep.plan_separable(perturbed_maps(maps_p), gmx_p,
                                   geom.src_h, geom.src_w)
    plan_s = time.perf_counter() - t0
    n, _, bh, bw = fused.shape
    wx = torch.as_tensor(plan.wx, device=dev).to(torch.bfloat16)
    vmaps = torch.as_tensor(plan.vmaps, device=dev)
    vmaps_pert = torch.as_tensor(plan_pert.vmaps, device=dev)
    gains = state.gains[:, None, None, None]
    frames_dev = torch.as_tensor(frames, device=dev)
    src = sep.source_planar(frames_dev, plan.i1_hp)
    i1 = sep.pass_h(src, wx)
    dx = plan_pert.vmaps[:, 0]
    resid = float(np.abs(dx - np.arange(plan.bw_p))[dx > -1].max())
    log(f"  plan {plan_s:.3f} s: I1 {tuple(i1.shape)} {i1.dtype}, vmaps "
        f"{tuple(vmaps.shape)}, perturbed x residual up to {resid:.3f} px")
    check(tuple(i1.shape) == (n, 3, plan.i1_hp, bw + sep.XPAD
                              + sep.LANE_PAD_R)
          and (plan.bh_p, plan.bw_p) == (bh, bw),
          "separable plan at the band's shape, no padding needed")
    hp, wp = i1.shape[2], i1.shape[3]
    tiles = sep.plan_pass_v(vmaps, hp, wp)
    tiles_pert = sep.plan_pass_v(vmaps_pert, hp, wp)
    log(f"  K2 tile plan: {tiles.counts()} (perturbed vmaps "
        f"{tiles_pert.counts()})")

    # the path, counted from 0: pass_h + K2, gain and clamp, blend
    sep.pass_v.launches = 0
    bands = torch.clamp(sep.warp_separable(src, wx, vmaps, tiles)
                        [:, :, :bh, :bw] * gains, 0.0, 255.0)
    pano = blend_pack(bands, state, geom).cpu().numpy()
    k2_launches = sep.pass_v.launches
    check(k2_launches == 1, f"the separable path ran through K2 "
          f"({k2_launches} launch)")
    k1_bands = warp_bands(frames_dev, state, geom, k1_plan)
    d_k1 = float((bands - k1_bands).abs().max())
    check(d_k1 <= SEP_VS_K1_ATOL,
          f"separable warp x gains within {d_k1:.4f} of K1 "
          f"(<= {SEP_VS_K1_ATOL})")
    p_sep = scene_psnr(pano, scene, valid)
    check(p_sep >= MIN_PSNR_DB,
          f"separable path pano psnr {p_sep:.4f} >= {MIN_PSNR_DB}")

    # pass_h against the f32 product of the same bf16 inputs
    gold = torch.bmm(src.float().reshape(n, -1, src.shape[3]),
                     wx.float().transpose(1, 2)).reshape(n, 3, plan.i1_hp, -1)
    d_h = float((i1[..., sep.XPAD:sep.XPAD + plan.bw_p].float() - gold
                 ).abs().max())
    del gold
    check(d_h <= PASS_H_ATOL, f"pass_h within {d_h:.4f} of the f32 "
          f"product (<= {PASS_H_ATOL})")

    # K2 against its plain version, on the real and the perturbed maps
    k2_err = 0.0
    for name, vm, tp in (("calibrated vmaps", vmaps, tiles),
                         ("perturbed vmaps", vmaps_pert, tiles_pert)):
        got = sep.pass_v(i1, vm, tp)
        want = sep.pass_v_plain(i1, vm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k2_err = max(k2_err, err)
        check(got.shape == want.shape and err == 0.0,
              f"K2 {name} {tuple(got.shape)}: max abs {err:.3g}, bit "
              f"for bit")
        dead = (vm[:, 1] == -2.0)[:, None].expand_as(got)
        check(bool(dead.any()) and float(got[dead].abs().max()) == 0.0,
              f"K2 {name}: the {int(dead[:, 0].sum())} invalid pixels "
              f"are exactly 0")
    check(bool((plan_pert.vmaps[0, :, :bh // 20, :bw // 13] == -2).all()),
          "the perturbed maps' -1 corner is marked invalid")

    # times, and the library call computing K2's function: grid_sample
    # (bilinear, zeros, align_corners) on I1 in f32 (f32 weights)
    i1_f32 = i1.float()
    grid = torch.stack([(vmaps[:, 0] + sep.XPAD) * (2.0 / (wp - 1)) - 1.0,
                        vmaps[:, 1] * (2.0 / (hp - 1)) - 1.0],
                       dim=-1).contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            i1_f32, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
    times = {
        "pass_h": event_ms(lambda: sep.pass_h(src, wx)),
        "k2": kernel_ms(lambda: sep.pass_v(i1, vmaps, tiles)),
        "k2_call": event_ms(lambda: sep.pass_v(i1, vmaps, tiles)),
        "k2_plain": event_ms(lambda: sep.pass_v_plain(i1, vmaps)),
        "library": kernel_ms(library),
        "warp_separable": event_ms(lambda: sep.warp_separable(src, wx,
                                                              vmaps, tiles)),
    }
    lib_err = float((library() - sep.pass_v(i1, vmaps, tiles)).abs().max())
    k2_bound, k2_by, k2_bytes = warp_bound_ms(
        tiles, *sep.tap_origins(vmaps, hp, wp), i1, n, bh, bw)
    h_flops = 2.0 * n * 3 * plan.i1_hp * geom.src_w * plan.bw_p
    h_bytes = src.numel() * 2 + wx.numel() * 2 + i1.numel() * 2
    h_bound, h_by = bound_ms(h_bytes, h_flops, BF16_FLOPS)
    log(f"  pass_h {times['pass_h']:.4f} ms, bound {h_bound:.4f} ms by "
        f"{h_by} ({h_flops:.4g} flops, {h_bytes} bytes)")
    log(f"  K2 {times['k2']:.4f} ms on the card alone ({times['k2_call']:.4f}"
        f" ms per call), plain {times['k2_plain']:.4f} ms, library "
        f"{times['library']:.4f} ms on the card alone (max abs vs K2 "
        f"{lib_err:.3g}); bound {k2_bound:.4f} ms by {k2_by} ({k2_bytes} "
        f"bytes); warp_separable {times['warp_separable']:.4f} ms")
    entry = {
        "name": "K2 remap_separable pass_v", "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": times["k2"], "call_ms": times["k2_call"],
        "plain_ms": times["k2_plain"], "bound_ms": k2_bound,
        "bound_by": k2_by, "share": k2_bound / times["k2"],
        "library_ms": times["library"], "tiles": tiles.counts()}
    metrics = {"separable_plan_s": plan_s, "separable_vs_k1_max_abs": d_k1,
               "psnr_separable_db": p_sep, "pass_h_max_abs": d_h,
               "pass_h_ms": times["pass_h"], "pass_h_bound_ms": h_bound,
               "warp_separable_ms": times["warp_separable"],
               "k2_library_max_abs": lib_err}
    return entry, metrics


def mesh_disp_stats(pipe, frames):
    """(median, max) |backward displacement| in px of the mesh the
    pipeline solves from frames, densified to the band."""
    from video_stitcher_tpu_torch.mesh.mesh2map import upsample_backward_disp
    lay = pipe.geom.layout
    disp = pipe.run(frames)
    if disp is None:
        return float("nan"), float("nan")
    maps = upsample_backward_disp(torch.as_tensor(disp, device=pipe.device),
                                  lay.band_h, lay.band_w)
    gx = torch.arange(lay.band_w, device=pipe.device, dtype=torch.float32)
    gy = torch.arange(lay.band_h, device=pipe.device, dtype=torch.float32)
    d = torch.stack([(maps[:, 0] - gx).abs(),
                     (maps[:, 1] - gy[:, None]).abs()])
    return float(d.median()), float(d.max())


def local_phase(st, frames, scene, valid, p_rgb, calib_s, mesh_s, dev):
    """The local calibration: the first mesh solve's numbers, K1 on the
    estimation warp against its plain version, the global-only psnr.
    Returns metrics."""
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips, remap_strips_plain)
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        _warp_source, stitch_pano)
    log("phase local calibration (CPW mesh)")
    state, geom, _ = st._snapshot()
    pipe = st._mesh_pipe
    seams = sum(m is not None and len(m.p1) > 0
                for m in pipe.solver.old_matches)
    frames_dev = torch.as_tensor(frames, device=dev)
    glob_plan = plan_remap(st.state_global.fused_maps, geom.warp_src_h,
                           geom.warp_src_w)
    pano_g = stitch_pano(frames_dev, st.state_global, geom,
                         glob_plan).cpu().numpy()
    p_glob = scene_psnr(pano_g, scene, valid)
    src = _warp_source(frames_dev, geom)
    got = pipe.warp(frames_dev)[0]      # the estimation warp's program
    want = remap_strips_plain(src, pipe.global_maps, pipe.ones)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    d_med, d_max = mesh_disp_stats(pipe, frames)
    log(f"  calibrate {calib_s:.3f} s, of which the first mesh solve "
        f"{mesh_s:.3f} s; seams with matches {seams} of "
        f"{geom.num_images}; mesh |displacement| median {d_med:.4f} px, "
        f"max {d_max:.4f} px")
    log(f"  psnr vs scene: stitch {p_rgb:.4f} dB with the mesh, "
        f"{p_glob:.4f} dB global-only")
    check(seams >= geom.num_images // 2, f"{seams} seams with matches")
    check(d_med < 3.0 and d_max < 25.0, "mesh near identity on the "
          "parallax-free rig (median < 3 px, max < 25 px)")
    check(got.shape == want.shape and err <= K1_ATOL,
          f"K1 estimation warp (gain 1) {tuple(got.shape)}: max abs "
          f"{err:.3g} <= {K1_ATOL}")
    return {"calibrate_s": calib_s, "mesh_solve_s": mesh_s,
            "seams_with_matches": seams, "mesh_disp_median_px": d_med,
            "mesh_disp_max_px": d_max, "psnr_stitch_global_only_db": p_glob,
            "k1_estimation_warp_max_abs": err}


def resolve_phase(st, frames, frames2, dev):
    """The live re-solve: recalibrate_mesh on perturbed frames (timed), the
    plan installed with it, interpolate_states through K1 on the mixed
    maps, one update_masks re-solve. Returns (K1's largest error against
    its plain version here, metrics)."""
    import dataclasses
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips, remap_strips_plain)
    from video_stitcher_tpu_torch.pipeline.stitcher import _warp_source
    log("phase live re-solve")
    times, installed = [], []
    for _ in range(3):
        old = st.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        installed.append(st.recalibrate_mesh(frames2))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    recal_s = statistics.median(times)
    log(f"  recalibrate_mesh {recal_s:.4f} s (median of 3: "
        f"{[round(t, 4) for t in times]}) against recalib_del_ms "
        f"{st.cfg.recalib_del_ms}")
    check(all(installed), "recalibrate_mesh installed a mesh each time")
    state, geom, plan = st._snapshot()
    want = plan_remap(state.fused_maps, geom.warp_src_h, geom.warp_src_w)
    check(plan.n_active == want.n_active
          and torch.equal(plan.order, want.order),
          f"the installed plan is plan_remap of the installed maps "
          f"({plan.counts()})")
    solved = state
    mixed = st.interpolate_states(st.state_global, state, 0.5)
    st.swap_state(mixed)
    state_m, _, plan_m = st._snapshot()
    src = _warp_source(torch.as_tensor(frames, device=dev), geom)
    got = remap_strips(src, state_m.fused_maps, state_m.gains, plan_m)
    want_m = remap_strips_plain(src, state_m.fused_maps, state_m.gains)
    torch.cuda.synchronize()
    err = float((got - want_m).abs().max())
    check(err <= K1_ATOL, f"K1 on interpolate_states(global, mesh, 0.5)'s "
          f"maps: max abs {err:.3g} <= {K1_ATOL} (tiles {plan_m.counts()}:"
          f" samples outside at either end are pinned to -1)")
    st.swap_state(solved)
    pano_fixed = st.stitch(frames)
    cfg = st.cfg
    st.cfg = dataclasses.replace(cfg, update_masks=True)
    try:
        t0 = time.perf_counter()
        ok = st.recalibrate_mesh(frames)
        torch.cuda.synchronize()
        upd_s = time.perf_counter() - t0
    finally:
        st.cfg = cfg
    valid = st.state.valid_mask.cpu().numpy() > 0
    pano = st.stitch(frames)
    zeros = int((pano.max(-1)[valid] == 0).sum())
    dark = int(((pano.astype(np.int32).sum(-1) < 8)
                & (pano_fixed.astype(np.int32).sum(-1) > 60) & valid).sum())
    log(f"  update_masks re-solve {upd_s:.4f} s: {zeros} zero pano pixels "
        f"inside valid_mask, {dark} newly dark")
    check(ok and zeros == 0 and dark == 0,
          "update_masks: no pano pixel at zero inside valid_mask")
    st.swap_state(solved)       # the re-solved mesh, default weights
    return err, {"recalibrate_mesh_s": recal_s,
                 "recalibrate_mesh_s_runs": times,
                 "recalib_del_ms": st.cfg.recalib_del_ms,
                 "interpolate_k1_max_abs": err,
                 "update_masks_recalibrate_s": upd_s}


def prewarp_phase(cfg4, dev, small4):
    """BASELINE config 4 through the prewarp path: calibrate, stitch_out
    from RGB and NV12 (K1 on the f32 source at compose size), black bars,
    K1 against its plain version, its time and bound; and the card
    against the host plain path on a small prewarp rig. Returns (metrics,
    the prewarp entry of K1's line)."""
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.calib.calibration import plan_geometry
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    from video_stitcher_tpu_torch.ops.remap_strips import (
        remap_strips, remap_strips_plain, tap_origins)
    from video_stitcher_tpu_torch.pipeline.stitcher import _warp_source
    from video_stitcher_tpu_torch.utils.synth import make_scene, render_views
    log(f"phase prewarp ({cfg4.num_images}x{cfg4.input_width}x"
        f"{cfg4.input_height} -> {cfg4.output_width}x{cfg4.output_height}, "
        f"keep_aspect_ratio, add_black_bars, enable_local="
        f"{cfg4.enable_local})")
    geom4, _ = plan_geometry(cfg4)
    lay = geom4.layout
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    scene = make_scene(lay.pano_w, lay.pano_h, rng)
    frames = render_views(cfg4, geom4, scene)
    frames_dev = torch.as_tensor(frames, device=dev)
    nv12_dev = rgb_to_nv12(frames_dev)
    nv12 = nv12_dev.cpu().numpy()
    log(f"  synthetic rig {time.perf_counter() - t0:.3f} s: compose "
        f"{geom4.compose_w}x{geom4.compose_h} (scale "
        f"{geom4.compose_scale:.4f}, prewarp {geom4.prewarp}), pano "
        f"{lay.pano_w}x{lay.pano_h}, bands {lay.band_w}x{lay.band_h}")
    check(geom4.prewarp, "BASELINE config 4 takes the prewarp path")
    st = Stitcher(cfg4, device=dev)
    t0 = time.perf_counter()
    st.calibrate(frames)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0

    remap_strips.launches = 0
    out = st.stitch_out(frames)
    out_nv12 = st.stitch_out(nv12)
    pano = st.stitch(frames)
    launches = remap_strips.launches
    check(launches == 3 + captures(st), f"the prewarp path ran through K1 "
          f"({launches} launches in 3 calls and {captures(st)} warm-ups)")
    oh, ow = st._out_size(geom4)
    y0 = cfg4.output_height // 2 - oh // 2
    bars = np.concatenate([out[:y0], out[y0 + oh:]])
    check(out.shape == (cfg4.output_height, cfg4.output_width, 3)
          and bars.size > 0 and int(bars.max()) == 0
          and int(out_nv12[:y0].max()) == 0,
          f"output {out.shape}: frame {oh}x{ow} at row {y0}, black bars "
          f"exactly 0")
    valid = st.state.valid_mask.cpu().numpy() > 0
    p4 = scene_psnr(pano, scene, valid)
    p4_y = scene_psnr(st.stitch(nv12), scene, valid, luma)
    log(f"  calibrate {calib_s:.3f} s; psnr vs scene: stitch {p4:.4f} dB, "
        f"stitch_nv12 luma {p4_y:.4f} dB (not gated: the JAX package "
        f"scores ~34.8 dB on its CPU prewarp rig, tests/"
        f"test_torch_prewarp.py; parity with the host is gated below)")

    state, _, plan = st._snapshot()
    src = _warp_source(frames_dev, geom4)
    src_nv = _warp_source(nv12_dev, geom4)
    check(src.dtype == torch.float32 and tuple(src.shape) == (
        cfg4.num_images, 3, geom4.compose_h, geom4.compose_w),
        f"prewarped source {tuple(src.shape)} {src.dtype}")
    err = 0.0
    for name, s_ in (("RGB", src), ("NV12", src_nv)):
        got = remap_strips(s_, state.fused_maps, state.gains, plan)
        want = remap_strips_plain(s_, state.fused_maps, state.gains)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        check(e <= K1_ATOL, f"K1 on the f32 prewarped {name} source "
              f"{tuple(got.shape)}: max abs {e:.3g} <= {K1_ATOL}")
    fused, gains = state.fused_maps, state.gains
    k1_ms = kernel_ms(lambda: remap_strips(src, fused, gains, plan))
    k1_call = event_ms(lambda: remap_strips(src, fused, gains, plan))
    plain_ms = event_ms(lambda: remap_strips_plain(src, fused, gains))
    hs, ws = src.shape[2], src.shape[3]
    grid = torch.stack([fused[:, 0] * (2.0 / (ws - 1)) - 1.0,
                        fused[:, 1] * (2.0 / (hs - 1)) - 1.0],
                       dim=-1).contiguous()

    def library():
        o = torch.nn.functional.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        return torch.clamp(o * gains[:, None, None, None], 0.0, 255.0)
    lib_ms = kernel_ms(library)
    bound, by, nbytes = warp_bound_ms(
        plan, *tap_origins(fused, hs, ws), src, src.shape[0],
        fused.shape[2], fused.shape[3], extra_bytes=gains.numel() * 4)
    prep_ms = event_ms(lambda: _warp_source(frames_dev, geom4))
    prep_nv_ms = event_ms(lambda: _warp_source(nv12_dev, geom4))
    out_ms = sync_ms(lambda: st.stitch_out(frames_dev, device=True))
    out_nv_ms = sync_ms(lambda: st.stitch_out(nv12_dev, device=True))
    out_host_ms = sync_ms(lambda: st.stitch_out(frames))
    out_nv_host_ms = sync_ms(lambda: st.stitch_out(nv12))
    log(f"  K1 on the f32 prewarped source {k1_ms:.4f} ms on the card "
        f"alone ({k1_call:.4f} ms per call), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms on the card alone; bound {bound:.4f} ms "
        f"by {by} ({nbytes} bytes), share {bound / k1_ms:.4f}; tiles "
        f"{plan.counts()}")
    log(f"  source prep (resize to compose): RGB {prep_ms:.4f} ms, NV12 "
        f"{prep_nv_ms:.4f} ms")
    log(f"  stitch_out per frame: RGB {out_ms:.4f} ms, NV12 "
        f"{out_nv_ms:.4f} ms (frames on the card); RGB {out_host_ms:.4f} "
        f"ms, NV12 {out_nv_host_ms:.4f} ms (host numpy in and out)")

    # the card against the host plain path on a small prewarp rig
    sgeom, _ = plan_geometry(small4)
    srng = np.random.default_rng(5)
    sscene = make_scene(sgeom.layout.pano_w, sgeom.layout.pano_h, srng)
    sframes = render_views(small4, sgeom, sscene)
    snv12 = rgb_to_nv12(torch.as_tensor(sframes)).numpy()
    on_card, on_host = Stitcher(small4, device=dev), Stitcher(small4,
                                                              device="cpu")
    on_card.calibrate(sframes)
    on_host.calibrate(sframes)
    d_small = max(max_abs_u8(on_card.stitch_out(f), on_host.stitch_out(f))
                  for f in (sframes, snv12))
    check(sgeom.prewarp and d_small <= MAX_ABS_U8,
          f"{small4.num_images}x{small4.input_width}x{small4.input_height} "
          f"prewarp rig, stitch_out RGB and NV12: card within {d_small} of "
          f"the host plain path")
    entry = {"ms": k1_ms, "call_ms": k1_call, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "share": bound / k1_ms,
             "library_ms": lib_ms, "max_abs_err": err,
             "launches": launches, "tiles": plan.counts(),
             "source": list(src.shape)}
    metrics = {"prewarp_calibrate_s": calib_s, "prewarp_psnr_stitch_db": p4,
               "prewarp_psnr_stitch_nv12_luma_db": p4_y,
               "prewarp_source_prep_ms": prep_ms,
               "prewarp_source_prep_nv12_ms": prep_nv_ms,
               "prewarp_stitch_out_ms": out_ms,
               "prewarp_stitch_out_nv12_ms": out_nv_ms,
               "prewarp_stitch_out_host_ms": out_host_ms,
               "prewarp_stitch_out_nv12_host_ms": out_nv_host_ms,
               "prewarp_small_rig_max_abs": d_small}
    return metrics, entry, st, nv12, frames


# ---- phase "graph": the per-frame programs ------------------------------

GRAPH_INTERP = (0.25, 0.5, 0.75)   # interpolate_states steps held
GRAPH_FILL_BYTES = 8 << 30         # zeros written over freed memory


def timed_pairs(fns: dict, reps=REPS) -> dict:
    """Host-clock ms of each fn() between two device synchronisations,
    the fns in turn within each of reps rounds: {name: (median, min,
    max)}."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v), max(v))
            for k, v in times.items()}


def api_calls(fn, reps=5) -> dict:
    """The CUDA API calls that launch work (kernels, graphs, copies,
    memsets) per call of fn, by name, from torch.profiler's host entries
    over reps calls."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launch = re.compile(r"^cu(da)?\w*(Launch|Memcpy|Memset)\w*$")
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and launch.match(e.name):
            counts[e.name] = counts.get(e.name, 0) + 1
    return {k: v / reps for k, v in sorted(counts.items())}


def kernel_launches(calls: dict) -> float:
    """Kernel launches per call in api_calls' counts."""
    return sum(v for k, v in calls.items()
               if "Launch" in k and "Graph" not in k)


def clear_tap_caches() -> None:
    """Every cache the step's tap tables come from, emptied: a table no
    program holds is freed."""
    import importlib
    ops = {m: importlib.import_module(f"video_stitcher_tpu_torch.ops.{m}")
           for m in ("color", "pyramid", "resize")}
    from video_stitcher_tpu_torch.ops import pyramid_int
    for fn in (ops["resize"].device_taps, ops["resize"]._interp_matrix,
               ops["resize"].device_constant, pyramid_int._int_taps,
               ops["pyramid"]._down_matrix, ops["pyramid"]._up_matrix,
               ops["color"]._nv12_scaled_mats):
        fn.cache_clear()


def graph_cell(name, st, frames, nv12, dev) -> dict:
    """Phase "graph" at one cell: each key of stitch, stitch_nv12 and
    stitch_out (frames on the card) against the eager module functions,
    max abs 0, on the installed state, after a swap to perturbed maps,
    at each interpolate_states step towards them, and after the tap
    caches were cleared and the freed memory written over; no swap
    captures again. Then the eager and graphed stitch_out times, the
    API calls that launch work per call, the card's busy share, a swap's
    cost, and each key's capture time and pool. Returns metrics."""
    from video_stitcher_tpu_torch.ops.remap_strips import remap_strips
    from video_stitcher_tpu_torch.ops.resize import resize_planar
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        _pack_u8_hwc, blend_f32, warp_bands)
    x_rgb = torch.as_tensor(frames, device=dev)
    x_nv = torch.as_tensor(nv12, device=dev)
    keys = {"stitch RGB": (st.stitch, x_rgb, False),
            "stitch_nv12": (st.stitch_nv12, x_nv, False),
            "stitch_out RGB": (st.stitch_out, x_rgb, True),
            "stitch_out NV12": (st.stitch_out, x_nv, True)}
    held = {}

    def hold(label):
        worst = 0
        for fn, x, out in keys.values():
            got = fn(x, device=True)
            want = eager_step(st, x, out)
            worst = max(worst, int((got.to(torch.int16)
                                    - want.to(torch.int16)).abs().max()))
        held[label] = worst
        check(worst == 0, f"{name}: every key's graph against the eager "
              f"step, {label}: max abs {worst}")

    hold("the installed state")
    caps = dict(st.programs.captures)
    old, plan_old = st.state, st.plan
    new = old._replace(fused_maps=torch.as_tensor(
        perturbed_maps(old.fused_maps.cpu().numpy()), device=dev))
    st.swap_state(new)
    n_old, n_new = plan_old.n_active, st.plan.n_active
    hold(f"perturbed maps ({n_old} -> {n_new} active tiles)")
    for t in GRAPH_INTERP:
        st.swap_state(st.interpolate_states(old, new, t))
        hold(f"interpolate_states t={t} ({st.plan.n_active} active)")
    st.swap_state(old)
    hold("the state swapped back")
    clear_tap_caches()
    torch.cuda.empty_cache()
    fill = min(GRAPH_FILL_BYTES, torch.cuda.mem_get_info(dev)[0] // 2)
    filler = torch.zeros(fill, dtype=torch.uint8, device=dev)
    hold(f"tap caches cleared, {fill} bytes of zeros allocated")
    del filler
    check(st.programs.captures == caps and set(caps.values()) == {1},
          f"{name}: no swap captured again; captures per key {caps}")

    times = {}
    for label, x in (("RGB", x_rgb), ("NV12", x_nv)):
        t = timed_pairs({
            "eager": lambda: eager_step(st, x, True),
            "graph": lambda: st.stitch_out(x, device=True)})
        times[label] = t
        log(f"  {name} stitch_out {label}, frames on the card, ms median "
            f"(min-max) of {REPS} in turns: eager {t['eager'][0]:.4f} "
            f"({t['eager'][1]:.4f}-{t['eager'][2]:.4f}), graph "
            f"{t['graph'][0]:.4f} ({t['graph'][1]:.4f}-"
            f"{t['graph'][2]:.4f})")
    calls = {"eager stitch_out RGB": api_calls(
        lambda: eager_step(st, x_rgb, True))}
    for label, (fn, x, _) in keys.items():
        calls[label] = api_calls(lambda: fn(x, device=True))
    for label, c in calls.items():
        log(f"  {name} API calls per {label} call: {c}")
    graphed = [c for k, c in calls.items() if not k.startswith("eager")]
    check(all(c.get("cudaGraphLaunch") == 1 and kernel_launches(c) == 0
              for c in graphed),
          f"{name}: stitch, stitch_nv12 and stitch_out each make one "
          f"cudaGraphLaunch and no kernel launch per call")
    # the eager step's launches stage by stage: the warp (the source prep
    # and K1), the blend (its kernels, blend/levels.py) and the output
    # (resize and pack), each alone
    prog = next(p for p in st.programs.programs.values()
                if p.key[0][0] == "stitch_out" and p.key[1] == x_rgb.shape)
    state, geom, plan = st._snapshot()
    bands = warp_bands(x_rgb, state, geom, plan)
    pano = blend_f32(bands, state, geom)
    parts = {stage: kernel_launches(api_calls(fn)) for stage, fn in (
        ("warp", lambda: warp_bands(x_rgb, state, geom, plan)),
        ("blend", lambda: blend_f32(bands, state, geom)),
        ("output", lambda: _pack_u8_hwc(resize_planar(
            pano, *st._out_size(geom)))))}
    eager_n = kernel_launches(calls["eager stitch_out RGB"])
    nb = geom.layout.num_bands
    check(eager_n == sum(parts.values()) and parts["warp"] > prog.k1_launches
          == 1 and parts["blend"] == prog.blend_launches == 3 * nb + 1
          and parts["output"] > 0,
          f"{name}: the eager step launches {eager_n} kernels a call, its "
          f"stages' own {parts}: the source prep and K1 "
          f"({prog.k1_launches} a replay), the blend's {3 * nb + 1} "
          f"({prog.blend_launches} a replay), the resize and pack")
    # the profiler loses a graph replay's entries now and then (an H100,
    # 1 profile in 3): such a profile is taken again, at most twice
    want = {"K1": prog.k1_launches, "blend": prog.blend_launches}
    for _ in range(3):
        busy, named = {}, {}
        for label, fn in (("eager", lambda: eager_step(st, x_rgb, True)),
                          ("graph", lambda: st.stitch_out(x_rgb,
                                                          device=True))):
            share, per_call, top, named[label] = device_profile(
                fn, by_name=True)
            busy[label] = {"share": share, "kernels_per_call": per_call}
            log(f"  {name} stitch_out RGB loop under torch.profiler, "
                f"{label}: card busy {share:.4f}, {per_call:.1f} kernels a "
                f"call; top {[(k, round(ms, 4)) for k, ms, _ in top[:3]]}")
        seen = {kind: sum(n for k, n in named["graph"].items() if mark in k)
                for kind, mark in (("K1", "RemapGain"), ("blend", "blend_"))}
        whole = busy["graph"]["kernels_per_call"] >= busy["eager"][
            "kernels_per_call"] and seen == want
        if whole:
            break
        log(f"  {name}: K1 and the blend by name {seen}; profiled again")
    check(whole and all(0 < b["share"] <= 1 for b in busy.values()),
          f"{name}: the profiler sees the replayed graph's kernels: "
          f"{busy['graph']['kernels_per_call']:.1f} a call against the "
          f"eager step's {busy['eager']['kernels_per_call']:.1f}, K1 and "
          f"the blend's by name {seen}, busy shares in (0, 1]")
    swap_ms = sync_ms(lambda: st.swap_state(old), reps=5)
    before = remap_strips.launches
    st.stitch_out(x_rgb, device=True)
    k1_replay = remap_strips.launches - before
    check(k1_replay == 1, f"{name}: a replay counts its captured K1 "
          f"launch ({k1_replay})")
    progs = {p.name: {"capture_s": p.capture_s, "pool_bytes": p.pool_bytes,
                      "replays": p.replays, "k1_launches": p.k1_launches}
             for p in st.programs.programs.values()}
    for k, v in progs.items():
        log(f"  {name} program {k}: capture {v['capture_s']:.4f} s "
            f"(warm-up included), pool {v['pool_bytes']} bytes, "
            f"{v['replays']} replays, K1 {v['k1_launches']} a replay")
    log(f"  {name} swap_state with {len(progs)} programs: {swap_ms:.4f} "
        f"ms (plan + copies into the buffers, between syncs)")
    return {"max_abs": held, "stitch_out_ms": times, "api_calls": calls,
            "busy": busy, "swap_ms": swap_ms, "programs": progs,
            "active_tiles": [n_old, n_new]}


def graph_phase(st, cfg, frames, nv12, st4, frames4, nv12_4, dev):
    """Phase "graph" (graph_cell) at the default cell and at BASELINE
    config 4, then the Runner from memory in both pipeline modes at the
    default cell, eager (a stand-in whose stitch* run the module
    functions) against graphed, every output equal to the eager
    stitch_out of its set. Returns metrics."""
    import os
    import tempfile
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    log("phase graph")
    metrics = {"default": graph_cell("default", st, frames, nv12, dev),
               "config4": graph_cell("config 4", st4, frames4, nv12_4,
                                     dev)}
    eager = Stitcher(cfg, device=dev)
    eager._install(st.geom, st.state, st.aux)
    eager._replay = lambda f, out=False: eager_step(eager, eager._frames(f),
                                                    out)
    rng = np.random.default_rng(SEED + 3)
    sets = [rgb_to_nv12(torch.as_tensor(f, device=dev)).cpu().numpy()
            for f in (frames, np.clip(frames.astype(np.int16) + rng.integers(
                -6, 7, frames.shape), 0, 255).astype(np.uint8))]
    expected = [eager_out(st, s) for s in sets]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for mode in ("threaded", "inline"):
                for label, s in (("eager", eager), ("graph", st)):
                    log(f"  Runner from memory, {mode}, {label}:")
                    _, metrics[f"runner_{mode}_{label}"] = memory_runner(
                        s, cfg, sets, expected, mode)
        finally:
            os.chdir(cwd)
    check(not eager.programs.programs, "the eager stand-in built no program")
    return metrics


# ---- phase "programs" ----------------------------------------------------

PROG_BATCHES = (2, 4)      # stitch_batch sizes held and timed
RESOLVE_REPS = 5           # re-solves timed per side


class EagerPrograms:
    """A ProgramSet stand-in that runs each function eagerly on its
    inputs: a re-solve's device stages with no program (the reference the
    programs are held against)."""
    stream = None

    def prepare(self, step_key, fn, *inputs, share=False):
        return types.SimpleNamespace(output=None)

    def launch(self, step_key, fn, *inputs):
        return fn(*inputs)


def _recording_run(pipe, out: list):
    """pipe.run, recording each displacement it returns."""
    run = pipe.run

    def wrapped(frames):
        disp = run(frames)
        out.append(disp)
        return disp
    pipe.run = wrapped


def captures_ok(fn, dev):
    """(True, "") if fn() can be captured into a CUDA graph on `dev`, else
    (False, the error): the warm-up runs on a side stream first."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        return True, ""
    except Exception as e:               # the answer, not a failure
        torch.cuda.synchronize()
        return False, repr(e)[:200]


def resolve_pair(st, cfg, frames2, dev, label):
    """Two stitchers of st's calibration and one seed: `a` with its
    re-solve's programs captured ahead (prewarm_mesh), `b` with every
    stage eager. One re-solve each: the displacement, the installed maps
    and (update_masks) weights held at max abs 0. Returns metrics."""
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.mesh.pipeline import mesh_pipeline
    a, b = Stitcher(cfg, device=dev), Stitcher(cfg, device=dev)
    for s in (a, b):
        s._install(st.geom, st.state_global, st.aux)
    a.prewarm_mesh()
    mesh_pipeline(b).programs = EagerPrograms()
    disps = {"a": [], "b": []}
    _recording_run(a._mesh_pipe, disps["a"])
    _recording_run(b._mesh_pipe, disps["b"])
    ok = a.recalibrate_mesh(frames2) and b.recalibrate_mesh(frames2)
    torch.cuda.synchronize()
    da, db = disps["a"][0], disps["b"][0]
    d_disp = float(np.abs(da - db).max()) if ok else float("nan")
    d_maps = float((a.state.fused_maps - b.state.fused_maps).abs().max())
    d_w = max(float((x - y).abs().max()) for x, y in zip(
        a.state.weight_pyr + (a.state.valid_mask,),
        b.state.weight_pyr + (b.state.valid_mask,)))
    units = {p.name: p.replays for p in
             a._mesh_pipe.programs.programs.values()}
    check(ok and d_disp == 0 and d_maps == 0 and d_w == 0,
          f"re-solve {label}: programs against the eager stages with the "
          f"same draws: displacement max abs {d_disp}, installed maps "
          f"{d_maps}, weights {d_w}; replays {units}")
    return {"disp_max_abs": d_disp, "maps_max_abs": d_maps,
            "weights_max_abs": d_w, "replays": units}


def programs_phase(st, cfg, frames, frames2, nv12, dev):
    """Phase "programs": the programs of the JAX package's other jits at
    the default cell. stitch_batch (B = 2 and 4 RGB, 2 NV12),
    stitch_int16 (live state and state_global), output and the sharded
    step on [card] * k (k = 1-4, pano and output), each held against its
    eager module function at max abs 0 on the installed state, after a
    swap to perturbed maps, at each interpolate_states step, swapped back
    and after the caches were cleared and memory written over, with no
    new capture; their eager and graphed ms in turns; the API calls per
    call; each key's capture seconds and pool bytes. Then the re-solve:
    its programs against the eager stages with the same draws (both
    recalib_chunked settings, update_masks on), the API calls of one
    re-solve, and its eager and graphed seconds. Returns (K1 launches
    on the phase, metrics)."""
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.mesh.pipeline import mesh_pipeline
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips)
    from video_stitcher_tpu_torch.parallel.shard import build_sharded_step
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        output_frame, stitch_batch_pano, stitch_pano_int16)
    log("phase programs")
    remap_strips.launches = 0
    warm0 = captures(st)
    geom = st.geom
    oh, ow = st._out_size(geom)
    x, x2 = (torch.as_tensor(f, device=dev) for f in (frames, frames2))
    xn = torch.as_tensor(nv12, device=dev)
    pano = st.stitch(x, device=True)
    g = st.state_global
    plan_g = plan_remap(g.fused_maps, geom.warp_src_h, geom.warp_src_w)
    batches = {f"stitch_batch B={b} RGB": torch.stack([x, x2] * (b // 2))
               for b in PROG_BATCHES}
    batches["stitch_batch B=2 NV12"] = torch.stack([xn, xn])
    shards = {}
    for k in SHARD_KS:
        shards[k] = Stitcher(cfg, device=dev)
        shards[k]._shard_devices = [dev] * k
        shards[k].swap_state(st.state)

    def eager_sharded(s, out):
        sh = s._sharded
        return build_sharded_step(geom, [dev] * len(sh.shards),
                                  (oh, ow) if out else None)(
            [x[c.lo:c.hi] for c in sh.shards], sh)

    keys = {}
    for label, fb in batches.items():
        keys[label] = (lambda fb=fb: st.stitch_batch(fb, device=True),
                       lambda fb=fb: stitch_batch_pano(
                           fb, *st._snapshot()))
    keys["stitch_int16 live"] = (
        lambda: st.stitch_int16(x, device=True),
        lambda: stitch_pano_int16(x, st.state, geom, st.aux["weights0"],
                                  st.plan))
    keys["stitch_int16 state_global"] = (
        lambda: st.stitch_int16(x, state=g, device=True),
        lambda: stitch_pano_int16(x, g, geom, st.aux["weights0"], plan_g))
    # output returns the host frame: both sides download theirs
    keys["output"] = (
        lambda: torch.as_tensor(st.output(pano)),
        lambda: torch.as_tensor(st.finalize_out(output_frame(pano, oh,
                                                             ow))))
    for k, s in shards.items():
        for out in (False, True):
            keys[f"sharded k={k} {'stitch_out' if out else 'stitch'}"] = (
                lambda s=s, out=out: (s.stitch_out if out else s.stitch)(
                    x, device=True),
                lambda s=s, out=out: eager_sharded(s, out))
    held = {}

    def hold(label):
        worst = {}
        for name, (graphed, eager) in keys.items():
            got, want = graphed(), eager()
            worst[name] = int((got.to(torch.int16)
                               - want.to(torch.int16)).abs().max())
        held[label] = worst
        check(max(worst.values()) == 0, f"programs: every new key against "
              f"its eager module function, {label}: max abs {worst}")

    everyone = [st] + list(shards.values())
    hold("the installed state")
    caps = {id(s): all_captures(s) for s in everyone}
    old = st.state
    new = old._replace(fused_maps=torch.as_tensor(
        perturbed_maps(old.fused_maps.cpu().numpy()), device=dev))
    for s in everyone:
        s.swap_state(new)
    hold("perturbed maps")
    for t in GRAPH_INTERP:
        mid = st.interpolate_states(old, new, t)
        for s in everyone:
            s.swap_state(mid)
        hold(f"interpolate_states t={t}")
    for s in everyone:
        s.swap_state(old)
    hold("the state swapped back")
    clear_tap_caches()
    torch.cuda.empty_cache()
    fill = min(GRAPH_FILL_BYTES, torch.cuda.mem_get_info(dev)[0] // 2)
    filler = torch.zeros(fill, dtype=torch.uint8, device=dev)
    hold(f"caches cleared, {fill} bytes of zeros allocated")
    del filler
    check(all(all_captures(s) == caps[id(s)] for s in everyone)
          and all(set(c.values()) == {1} for c in caps.values()),
          "programs: no swap captured again, one capture per key")

    # ---- times, API calls, captures and pools
    times, calls = {}, {}
    for name, (graphed, eager) in keys.items():
        times[name] = timed_pairs({"eager": eager, "graph": graphed},
                                  reps=REPS // 2)
        calls[name] = {"graph": api_calls(graphed),
                       "eager": api_calls(eager, reps=2)}
        t, c = times[name], calls[name]
        log(f"  {name}: ms median (min-max) of {REPS // 2} in turns: eager "
            f"{t['eager'][0]:.4f} ({t['eager'][1]:.4f}-{t['eager'][2]:.4f})"
            f", graph {t['graph'][0]:.4f} ({t['graph'][1]:.4f}-"
            f"{t['graph'][2]:.4f}); API calls per call {c['graph']}, "
            f"eager {kernel_launches(c['eager']):.0f} kernel launches")
    for name, c in calls.items():
        want = 1
        if name.startswith("sharded"):
            s = shards[int(name.split("k=")[1].split()[0])]
            want = sum(c_.hi > c_.lo for c_ in s._sharded.shards) + 1
        check(c["graph"].get("cudaGraphLaunch") == want
              and kernel_launches(c["graph"]) == 0,
              f"{name}: {want} cudaGraphLaunch and no kernel launch a call "
              f"({c['graph']})")
    progs = {}
    for s in everyone:
        for set_name, ps in program_sets(s).items():
            if set_name == "re-solve":
                continue
            for p in ps.programs.values():
                key = (f"sharded k={len(s._sharded.shards)} {set_name}: "
                       if s is not st else "") + p.name
                progs[key] = {"capture_s": p.capture_s,
                              "pool_bytes": p.pool_bytes,
                              "replays": p.replays,
                              "k1_launches": p.k1_launches}
    for k, v in progs.items():
        log(f"  program {k}: capture {v['capture_s']:.4f} s (warm-up "
            f"included), pool {v['pool_bytes']} bytes, {v['replays']} "
            f"replays, K1 {v['k1_launches']} a replay")

    # ---- the re-solve
    # why RANSAC's DLT takes cofactor determinants, not an SVD
    dlt = torch.randn(geom.num_images, 256, 8, 9, device=dev)
    svd_ok, svd_err = captures_ok(
        lambda: torch.linalg.svd(dlt, full_matrices=True), dev)
    det_ok, det_err = captures_ok(
        lambda: torch.linalg.det(dlt[..., :8].double()), dev)
    log(f"  capture of torch.linalg.svd on [6, 256, 8, 9]: "
        f"{'ok' if svd_ok else 'refused: ' + svd_err}; of the f64 8x8 "
        f"determinants: {'ok' if det_ok else 'refused: ' + det_err}")
    check(det_ok, "the DLT's f64 determinants can be captured")
    resolve = {}
    for chunked in (True, False):
        rcfg = dataclasses.replace(cfg, recalib_chunked=chunked,
                                   update_masks=True)
        resolve[f"chunked={chunked}"] = resolve_pair(
            st, rcfg, frames2, dev, f"recalib_chunked={chunked}, "
            f"update_masks")
    pipe = mesh_pipeline(st)
    for p in pipe.programs.programs.values():
        log(f"  re-solve program {p.name}: capture {p.capture_s:.4f} s, "
            f"pool {p.pool_bytes} bytes, {p.replays} replays, K1 "
            f"{p.k1_launches} a replay")
    units = 3 + 3 * geom.num_images
    r_calls = api_calls(lambda: st.recalibrate_mesh(frames2), reps=2)
    eager_st = Stitcher(cfg, device=dev)
    eager_st._install(geom, st.state_global, st.aux)
    mesh_pipeline(eager_st).programs = EagerPrograms()
    e_calls = api_calls(lambda: eager_st.recalibrate_mesh(frames2), reps=2)
    log(f"  API calls per re-solve: programs {r_calls}; eager "
        f"{kernel_launches(e_calls):.0f} kernel launches")
    check(r_calls.get("cudaGraphLaunch") == units
          and kernel_launches(r_calls) < kernel_launches(e_calls) / 4,
          f"a re-solve makes one cudaGraphLaunch per unit ({units}: warp, "
          f"salience, detect and match and inliers per camera, compose) "
          f"and {kernel_launches(r_calls):.0f} kernel launches outside "
          f"them (draws, host stages, the install) against "
          f"{kernel_launches(e_calls):.0f} eager")
    r_times = {"eager": [], "graph": []}
    for _ in range(RESOLVE_REPS):
        for side, s in (("eager", eager_st), ("graph", st)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.recalibrate_mesh(frames2)
            torch.cuda.synchronize()
            r_times[side].append(time.perf_counter() - t0)
    r_med = {k: (statistics.median(v), min(v), max(v))
             for k, v in r_times.items()}
    log(f"  recalibrate_mesh s median (min-max) of {RESOLVE_REPS} in "
        f"turns: eager {r_med['eager'][0]:.4f} ({r_med['eager'][1]:.4f}-"
        f"{r_med['eager'][2]:.4f}), graph {r_med['graph'][0]:.4f} "
        f"({r_med['graph'][1]:.4f}-{r_med['graph'][2]:.4f})")
    launches = remap_strips.launches
    warm = captures(st) - warm0
    log(f"  K1 launches in phase programs: {launches} ({warm} warm-ups on "
        f"the default stitcher)")
    metrics = {"max_abs": held, "ms": times, "api_calls": calls,
               "programs": progs, "resolve": resolve,
               "resolve_api_calls": r_calls,
               "svd_captures": svd_ok,
               "resolve_eager_kernel_launches": kernel_launches(e_calls),
               "recalibrate_mesh_s": r_med,
               "resolve_programs": {p.name: {
                   "capture_s": p.capture_s, "pool_bytes": p.pool_bytes}
                   for p in pipe.programs.programs.values()}}
    st.swap_state(old)
    del shards, everyone, eager_st, keys
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, metrics


# ---- the live Runner ------------------------------------------------------

RUNNER_FRAMES = 60     # (a) frames stitched per pipeline mode over TCP
EGRESS_FRAMES = 30     # (c)
RUNNER_4K_FRAMES = 30  # (d)
TRACE_FRAMES = 20      # (e) frames under torch.profiler
RESOLVE_MAX_FRAMES = 3000   # (b) stops after 2 installs; this bounds it
STEADY_SKIP = 10       # first frames left out of the steady-state fps


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CycleSource:
    """In-memory frame source: hands out `sets` in turn until `limit` sets
    were read or `until()` is true."""

    def __init__(self, sets, limit, until=lambda: False):
        self.sets, self.limit, self.until, self.n = sets, limit, until, 0

    def get_frames(self):
        if self.n >= self.limit or self.until():
            return None
        out = self.sets[self.n % len(self.sets)]
        self.n += 1
        return out

    def release(self):
        pass


class CheckSink:
    """Holds the Runner's output i against expected[(i + first) %
    len(expected)], the output of the frame set the source handed out
    for it (a calibrated stitcher's Runner discards its first read,
    the calibration read: first=1). Compares every `every`-th output."""

    def __init__(self, expected, first=1, every=1):
        self.expected, self.first, self.every = expected, first, every
        self.n = self.compared = self.mismatched = self.max_abs = 0

    def write(self, out):
        i = self.n
        self.n += 1
        if i % self.every:
            return
        want = self.expected[(i + self.first) % len(self.expected)]
        self.compared += 1
        if out.shape != want.shape:
            self.mismatched += 1
            self.max_abs = 256
        elif not np.array_equal(out, want):
            self.mismatched += 1
            self.max_abs = max(self.max_abs, max_abs_u8(out, want))

    def release(self):
        pass


def drive_runner(r, st):
    """r.run() with K1's count from 0 and the stitcher's re-solves
    counted. Returns (K1 launches, the launches the Runner's own counts
    give: frames stitched + the calib.jpg pano + the stitch_out and
    stitch the Runner makes on its first set before its threads start +
    one estimation warp per re-solve + one warm-up per capture)."""
    from video_stitcher_tpu_torch.ops.remap_strips import remap_strips
    solves = []
    solve = st.recalibrate_mesh

    def counted(frames):
        solves.append(1)
        return solve(frames)
    st.recalibrate_mesh = counted
    remap_strips.launches = 0
    caps = captures(st)
    try:
        r.run()
    finally:
        del st.recalibrate_mesh
    torch.cuda.synchronize()
    first = 1 if r.consume_device else 2
    return remap_strips.launches, (r.frames_done + 1 + first + len(solves)
                                   + captures(st) - caps)


def runner_numbers(r) -> dict:
    """Steady-state fps from the completion stamps and latency percentiles
    (both with the first STEADY_SKIP frames left out), stage means,
    stalls."""
    ts = r.done_ts
    fps = ((len(ts) - 1 - STEADY_SKIP) / (ts[-1] - ts[STEADY_SKIP])
           if len(ts) > STEADY_SKIP + 1 else float("nan"))
    lat = np.asarray(r.latencies[STEADY_SKIP:]) * 1e3
    return {"frames": r.frames_done, "fps": fps,
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "stage_ms": {k: r.timers.mean_ms(k) for k in r.timers.sums},
            "sync_stalls": r.sync_stalls, "stage_stalls": r.stage_stalls}


def log_runner(name: str, r, nums: dict) -> None:
    def ms(key):
        return "n/a" if nums[key] is None else f"{nums[key]:.3f} ms"
    log(f"  {name}: {nums['frames']} frames, steady {nums['fps']:.3f} fps"
        f", latency p50 {ms('p50_ms')} p99 {ms('p99_ms')}"
        f" (first {STEADY_SKIP} left out of both); stages {r.timers.summary()}; "
        f"stalls sync {r.sync_stalls} stage {r.stage_stalls}")


def has_room(ing, sent: int) -> bool:
    """Whether the capture server has received every one of the `sent`
    frames of each camera and holds at most one of them unread: then one
    more set cannot overflow its bounded drop-oldest queues."""
    lib = ing._native                   # None once the Runner stopped it
    return lib is not None and all(
        s["frames_ok"] >= sent for s in ing.stats()) and max(
        lib.stitchio_queue_size(c) for c in range(ing.n)) <= 1


def tcp_runner(st, cfg, sets, expected, mode):
    """(a): the Runner over the native TCP capture server, framed
    protocol: six loopback boards (one sender thread) stream the NV12 sets
    in turn, each set once the server has room for it (has_room), so the
    ingest drops nothing; every output held against stitch_out of the set
    sent for it."""
    import dataclasses
    from video_stitcher_tpu_torch.io_plane.ingest import pack_frame
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    port = free_port()
    n, rows, w = sets[0].shape
    rcfg = dataclasses.replace(
        cfg, use_stream=True, capture_tcp_port=port, capture_framing=True,
        capture_debug_order=True, capture_img_width=w,
        capture_img_height=rows, pipeline_mode=mode, recalibrate=False)
    sink = CheckSink(expected)
    r = Runner(rcfg, stitcher=st, sink=sink, max_frames=RUNNER_FRAMES,
               collect_latency=True)
    payloads = [[f[cam].tobytes() for cam in range(n)] for f in sets]
    done = threading.Event()
    errors, socks = [], []

    def finished():
        return done.is_set() or r.frames_done >= RUNNER_FRAMES

    def boards():
        try:
            deadline = time.monotonic() + 60
            for cam in range(n):
                while True:
                    try:
                        socks.append(socket.create_connection(
                            ("127.0.0.1", port), timeout=30))
                        break
                    except OSError:
                        if time.monotonic() > deadline:
                            raise
                        time.sleep(0.05)
                # slots follow the accept order: the next board connects
                # once this one is accepted
                while time.monotonic() < deadline:
                    ing = getattr(r, "_ingest", None)
                    lib = ing and ing._native
                    if lib is not None and lib.stitchio_clients() > cam:
                        break
                    time.sleep(0.01 if lib is not None else 0.2)
            for k in range(RUNNER_FRAMES + 8):
                while not (finished() or has_room(r._ingest, k)):
                    time.sleep(1e-3)
                if finished():
                    return
                for cam, sock in enumerate(socks):
                    sock.sendall(pack_frame(payloads[k % len(sets)][cam], k))
        except Exception as e:                   # noqa: BLE001
            if not finished():       # not the Runner closing the server
                errors.append(repr(e))
    board_t = threading.Thread(target=boards, daemon=True)
    board_t.start()
    try:
        launches, want = drive_runner(r, st)
    finally:
        done.set()
        board_t.join(timeout=30)
        for sk in socks:
            sk.close()
    stats = r._ingest.stats()
    nums = runner_numbers(r)
    log_runner(f"TCP, {mode}", r, nums)
    log(f"    ingest: {r._ingest.stats_summary()}, frames_ok "
        f"{[s['frames_ok'] for s in stats]}, drops "
        f"{[s['drops'] for s in stats]}; native server "
        f"{r._ingest._lib is not None}; K1 launches {launches}")
    check(not errors and not board_t.is_alive(),
          f"TCP {mode}: the capture boards streamed without error {errors}")
    check(r.frames_done == RUNNER_FRAMES and sink.compared == RUNNER_FRAMES
          and sink.mismatched == 0,
          f"TCP {mode}: {sink.compared} of {r.frames_done} outputs equal "
          f"stitch_out of the set sent for them (max abs {sink.max_abs})")
    check(r.sync_stalls == 0 and r.stage_stalls == 0,
          f"TCP {mode}: no sync or stage stall")
    check(sum(s["resyncs"] + s["seq_gaps"] for s in stats) == 0,
          f"TCP {mode}: ingest saw no resync and no sequence gap")
    check(r._ingest._lib is not None,
          f"TCP {mode}: the native capture server served")
    check(launches == want, f"TCP {mode}: K1 launched {launches} times, "
          f"frames + calib.jpg + first set + warm-ups = {want}")
    nums.update(k1_launches=launches, ingest_drops=sum(
        s["drops"] for s in stats), max_abs=sink.max_abs)
    return launches, nums


def memory_runner(st, cfg, sets, expected, mode):
    """(a) from memory: the same frame sets and checks as over TCP, with
    no ingest: the Runner's own pace."""
    import dataclasses
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    rcfg = dataclasses.replace(cfg, pipeline_mode=mode, recalibrate=False)
    sink = CheckSink(expected)
    r = Runner(rcfg, stitcher=st, sink=sink,
               source=CycleSource(sets, RUNNER_FRAMES + 1),
               collect_latency=True)
    launches, want = drive_runner(r, st)
    nums = runner_numbers(r)
    log_runner(f"from memory, {mode}", r, nums)
    check(r.frames_done == RUNNER_FRAMES and sink.compared == RUNNER_FRAMES
          and sink.mismatched == 0 and r.sync_stalls == r.stage_stalls == 0,
          f"memory {mode}: {sink.compared} of {r.frames_done} outputs equal "
          f"stitch_out of their set (max abs {sink.max_abs}), no stall")
    check(launches == want, f"memory {mode}: K1 launched {launches} times, "
          f"frames + calib.jpg + first set + warm-ups = {want}")
    nums.update(k1_launches=launches, max_abs=sink.max_abs)
    return launches, nums


def resolve_runner(st, cfg, sets):
    """(b): the live re-solve in the threaded Runner (recalibrate,
    recalib_interp, the default recalib_del_ms) until 2 re-solves have
    installed and animated; then the installed state stitches with no
    zero pixel inside valid_mask."""
    import dataclasses
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    rcfg = dataclasses.replace(cfg, recalibrate=True, recalib_interp=True,
                               pipeline_mode="threaded")
    steps = max(2, rcfg.recalib_del_ms // 60)
    box = []
    source = CycleSource(sets, RESOLVE_MAX_FRAMES, until=lambda: (
        box[0].recalibs_done >= 2 and len(box[0].swap_ms) >= 2 * (steps - 1)))
    r = Runner(rcfg, stitcher=st, source=source, collect_latency=True)
    box.append(r)
    launches, want = drive_runner(r, st)
    nums = runner_numbers(r)
    gaps = np.diff(r.recalib_ts) * 1e3
    log_runner("live re-solve, threaded", r, nums)
    log(f"    recalibs_done {r.recalibs_done}, recalib_ts spacing "
        f"{[round(float(g), 3) for g in gaps]} ms (recalib_del_ms "
        f"{rcfg.recalib_del_ms}); swap_ms over {len(r.swap_ms)} swaps: "
        f"median {statistics.median(r.swap_ms) if r.swap_ms else 0:.4f}, "
        f"max {max(r.swap_ms, default=0):.4f}; K1 launches {launches}")
    check(r.recalibs_done >= 2, f"live re-solve: {r.recalibs_done} meshes "
          f"installed while frames flowed (>= 2)")
    check(r.sync_stalls == 0 and r.stage_stalls == 0 and r.frames_done
          < RESOLVE_MAX_FRAMES, "live re-solve: ended cleanly, no stall")
    check(launches == want, f"live re-solve: K1 launched {launches} times, "
          f"frames + calib.jpg + first set + re-solves + warm-ups = {want}")
    pano = st.stitch(sets[0])
    valid = st.state.valid_mask.cpu().numpy() > 0
    zeros = int((pano.max(-1)[valid] == 0).sum())
    check(zeros == 0, f"live re-solve: {zeros} zero pano pixels inside "
          f"valid_mask after it")
    nums.update(k1_launches=launches, recalibs_done=r.recalibs_done,
                recalib_spacing_ms=gaps.tolist(),
                swap_ms_median=statistics.median(r.swap_ms)
                if r.swap_ms else None,
                swap_ms_max=max(r.swap_ms, default=None))
    return launches, nums


def count_pictures(units) -> int:
    """HEVC pictures in Annex-B units: VCL NAL units (type < 32) whose
    slice starts a picture (first_slice_segment_in_pic_flag)."""
    n = 0
    for u in units:
        i = u.index(b"\x01") + 1            # past the start code
        if len(u) > i + 2 and (u[i] >> 1) & 0x3F < 32 and u[i + 2] & 0x80:
            n += 1
    return n


def egress_runner(st, cfg, sets):
    """(c): PlayerEgress(encoder="hevc") from the threaded Runner into a
    loopback player that counts the pictures it receives."""
    import dataclasses
    from video_stitcher_tpu_torch.io_plane.egress import (
        AnnexBFramer, PlayerEgress)
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    port = free_port()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    got = {"height": None}
    chunks = []             # counted after the run, off the Runner's GIL

    def player():
        conn, _ = srv.accept()
        with conn:
            head = b""
            while len(head) < 4:
                chunk = conn.recv(4 - len(head))
                if not chunk:
                    return
                head += chunk
            got["height"] = struct.unpack("<i", head)[0]
            while True:
                data = conn.recv(1 << 22)
                if not data:
                    break
                chunks.append(data)
    player_t = threading.Thread(target=player, daemon=True)
    player_t.start()
    rcfg = dataclasses.replace(cfg, player_address="127.0.0.1",
                               player_tcp_port=port, send_results=True,
                               recalibrate=False, pipeline_mode="threaded")
    eg = PlayerEgress(rcfg, encoder="hevc")
    send_ms = []
    send = eg.send_frame

    def timed_send(frame):
        t0 = time.perf_counter()
        send(frame)
        send_ms.append((time.perf_counter() - t0) * 1e3)
    eg.send_frame = timed_send
    r = Runner(rcfg, stitcher=st, source=CycleSource(sets, EGRESS_FRAMES + 1),
               egress=eg, collect_latency=True)
    try:
        launches, want = drive_runner(r, st)
    finally:
        player_t.join(timeout=30)
        srv.close()
    framer = AnnexBFramer()
    stream = b"".join(chunks)
    got["bytes"] = len(stream)
    got["pictures"] = count_pictures(framer.push(stream) + [framer.flush()])
    nums = runner_numbers(r)
    enc = eg.selected_encoder
    log_runner(f"egress hevc ({enc}), threaded", r, nums)
    log(f"    player: height {got['height']}, {got['pictures']} pictures, "
        f"{got['bytes']} bytes; send_frame median "
        f"{statistics.median(send_ms):.3f} ms, max {max(send_ms):.3f} ms "
        f"per frame")
    lookahead = enc in ("kvazaar", "ffmpeg")    # the subprocess's lookahead
    check(not player_t.is_alive() and got["height"] is not None
          and (got["pictures"] == r.frames_done if not lookahead
               else 0 < got["pictures"] <= r.frames_done),
          f"egress: the player received {got['pictures']} pictures for "
          f"{r.frames_done} frames (encoder {enc})")
    check(launches == want and r.sync_stalls == 0,
          f"egress: K1 launched {launches} times (= {want}), no stall")
    nums.update(k1_launches=launches, selected_encoder=enc,
                egress_ms_median=statistics.median(send_ms),
                egress_ms_max=max(send_ms), pictures=got["pictures"],
                egress_bytes=got["bytes"])
    return launches, nums


def runner_4k(st4, nv12_4):
    """(d): BASELINE config 4 in the threaded Runner from memory; outputs
    0, 10 and 20 held against stitch_out of the same set."""
    import dataclasses
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    rcfg = dataclasses.replace(st4.cfg, pipeline_mode="threaded",
                               recalibrate=False)
    sink = CheckSink([eager_out(st4, nv12_4)], first=0, every=10)
    r = Runner(rcfg, stitcher=st4, sink=sink,
               source=CycleSource([nv12_4], RUNNER_4K_FRAMES + 1),
               collect_latency=True)
    launches, want = drive_runner(r, st4)
    nums = runner_numbers(r)
    log_runner("4K -> 8K NV12 from memory, threaded", r, nums)
    check(sink.compared == 3 and sink.mismatched == 0,
          f"4K runner: {sink.compared} outputs checked equal to stitch_out "
          f"(max abs {sink.max_abs})")
    check(launches == want and r.sync_stalls == 0 and r.stage_stalls == 0,
          f"4K runner: K1 launched {launches} times (= {want}), no stall")
    nums.update(k1_launches=launches)
    return launches, nums


def trace_busy(path: str) -> dict:
    """Share of a torch.profiler Chrome trace's span in which the card ran
    a kernel (and a copy): the union of their intervals over the span of
    all the trace's events of the profiler (the program's spans, category
    "program", left out; a host without CUDA has only those)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") != "program"]
    if not events:
        return {"kernel_share": 0.0, "copy_share": 0.0, "kernels": 0,
                "span_ms": 0.0}

    def union(spans):
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "kernel"]
    copy = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "gpu_memcpy"]
    return {"kernel_share": union(kern) / (t1 - t0),
            "copy_share": union(copy) / (t1 - t0),
            "kernels": len(kern), "span_ms": (t1 - t0) / 1e3}


def traced_runner(st, cfg, sets, trace_dir):
    """(e): the threaded Runner with cfg.trace_dir: utils/trace records
    TRACE_FRAMES frames under torch.profiler; the card's busy share comes
    from the trace it writes."""
    import dataclasses
    import os
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    rcfg = dataclasses.replace(cfg, trace_dir=trace_dir,
                               trace_frames=TRACE_FRAMES,
                               pipeline_mode="threaded", recalibrate=False)
    r = Runner(rcfg, stitcher=st,
               source=CycleSource(sets, TRACE_FRAMES + 4),
               collect_latency=True)
    launches, want = drive_runner(r, st)
    busy = trace_busy(os.path.join(trace_dir, "trace.json"))
    log(f"  {TRACE_FRAMES} Runner frames under torch.profiler: card busy "
        f"{busy['kernel_share']:.4f} of {busy['span_ms']:.3f} ms in kernels"
        f" ({busy['kernels']} kernels), {busy['copy_share']:.4f} in copies")
    check(busy["kernels"] > 0 and launches == want,
          f"traced runner: the trace holds the card's kernels, K1 launched "
          f"{launches} times (= {want})")
    return launches, busy


def transfer_times(st, host_frames: np.ndarray, out_dev) -> dict:
    """Host<->card copies of one frame set and one output frame, each
    timed alone: the copy between CUDA events from a pinned against a
    pageable host tensor, and the calls the Runner makes (stage_frames,
    finalize_out) against the pageable ones (torch.as_tensor, .cpu())
    between two synchronisations."""
    dev = st.device
    pageable = torch.from_numpy(np.ascontiguousarray(host_frames))
    pinned = torch.empty(pageable.shape, dtype=pageable.dtype,
                         pin_memory=True)
    pinned.copy_(pageable)
    dst = torch.empty(pageable.shape, dtype=pageable.dtype, device=dev)
    out_pinned = torch.empty(out_dev.shape, dtype=out_dev.dtype,
                             pin_memory=True)
    out_pageable = torch.empty(out_dev.shape, dtype=out_dev.dtype)
    return {
        "upload_bytes": pageable.numel(),
        "upload_pinned_ms": event_ms(
            lambda: dst.copy_(pinned, non_blocking=True)),
        "upload_pageable_ms": event_ms(lambda: dst.copy_(pageable)),
        "stage_frames_ms": sync_ms(lambda: st.stage_frames(host_frames)),
        "as_tensor_ms": sync_ms(lambda: torch.as_tensor(host_frames,
                                                        device=dev)),
        "download_bytes": out_dev.numel(),
        "download_pinned_ms": event_ms(
            lambda: out_pinned.copy_(out_dev, non_blocking=True)),
        "download_pageable_ms": event_ms(lambda: out_pageable.copy_(out_dev)),
        "finalize_out_ms": sync_ms(lambda: st.finalize_out(out_dev)),
        "cpu_numpy_ms": sync_ms(lambda: out_dev.cpu().numpy()),
    }


def log_transfers(name: str, t: dict) -> None:
    log(f"  {name} upload {t['upload_bytes']} B: pinned "
        f"{t['upload_pinned_ms']:.4f} ms, pageable "
        f"{t['upload_pageable_ms']:.4f} ms (copy alone, CUDA events); "
        f"stage_frames {t['stage_frames_ms']:.4f} ms, torch.as_tensor "
        f"{t['as_tensor_ms']:.4f} ms (the call)")
    log(f"  {name} download {t['download_bytes']} B: pinned "
        f"{t['download_pinned_ms']:.4f} ms, pageable "
        f"{t['download_pageable_ms']:.4f} ms (copy alone); finalize_out "
        f"{t['finalize_out_ms']:.4f} ms, .cpu().numpy() "
        f"{t['cpu_numpy_ms']:.4f} ms (the call)")


def runner_phase(st, cfg, frames, frames2, st4, nv12_4):
    """The live Runner at the main path's rig, reusing its calibrated
    stitcher: (a) over TCP in both pipeline modes, (b) the live re-solve,
    (c) HEVC egress, (d) BASELINE config 4 from memory, (e) 20 frames
    under torch.profiler; and the host<->card copies alone. Runs in a
    temporary directory (the Runner writes calib.jpg and result.jpg).
    Returns (K1 launches by run, metrics)."""
    import os
    import tempfile
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    log("phase runner")
    dev = st.device
    rng = np.random.default_rng(SEED + 1)
    frames3 = np.clip(frames.astype(np.int16)
                      + rng.integers(-6, 7, frames.shape), 0, 255
                      ).astype(np.uint8)
    sets = [rgb_to_nv12(torch.as_tensor(f, device=dev)).cpu().numpy()
            for f in (frames, frames2, frames3)]
    expected = [eager_out(st, s) for s in sets]
    check(not np.array_equal(expected[0], expected[1]),
          "the sets sent give different outputs")
    launches, metrics = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for mode in ("threaded", "inline"):
                launches[f"TCP {mode}"], metrics[f"tcp_{mode}"] = tcp_runner(
                    st, cfg, sets, expected, mode)
                launches[f"memory {mode}"], metrics[f"memory_{mode}"] = \
                    memory_runner(st, cfg, sets, expected, mode)
            launches["live re-solve"], metrics["resolve"] = resolve_runner(
                st, cfg, sets[:2])
            launches["egress"], metrics["egress"] = egress_runner(st, cfg,
                                                                  sets)
            launches["4K"], metrics["runner_4k"] = runner_4k(st4, nv12_4)
            launches["traced"], metrics["traced"] = traced_runner(
                st, cfg, sets, os.path.join(tmp, "trace"))
        finally:
            os.chdir(cwd)
    out_dev = st.stitch_out(torch.as_tensor(sets[0], device=dev),
                            device=True)
    metrics["transfers_1080p"] = transfer_times(st, sets[0], out_dev)
    log_transfers("1080p NV12 set / 4096x1064 output:",
                  metrics["transfers_1080p"])
    out4 = st4.stitch_out(torch.as_tensor(nv12_4, device=dev), device=True)
    metrics["transfers_4k"] = transfer_times(st4, nv12_4, out4)
    log_transfers("4K NV12 set / 8K output:", metrics["transfers_4k"])
    return launches, metrics


# ---- phase "live": the Runner's fault paths and all features at once ------

LIVE_FRAMES = 60       # (a) frames over TCP through the two ingest faults
LIVE_DROP_AT = 20      # (a) board 1 drops its link mid-frame at this set
LIVE_TRUNC_AT = 40     # (a) board 2 sends a truncated extra frame here
LIVE_TRUNC_BYTES = 100  # (a) cut from that frame's payload
FLOOD_SETS = 48        # (b) sets each board sends flat out
FLOOD_QUEUE = 2        # (b) the capture server's queue depth
LIVE_EGRESS_FRAMES = 30  # (c)
EGRESS_KILL_AFTER = 2  # (c) frames sent before the player drops the link
SOAK_FRAMES = 20       # (d) tests/test_soak.py's frame count
SOAK_MIN_FRAMES = 15   # (d) and its bound
SOAK_RECALIB_MS = 100  # (d) tests/test_soak.py's 1500 ms, cut so that the
                       # re-solves land inside 20 frames at the card's pace
SOAK_GATE_SET = 11     # (d) the boards hold this set (frame 10) until a
SOAK_GATE_S = 25.0     # re-solve has installed (bounded below the Runner's
                       # 3 x 10 s source retries): steady fps and latency
                       # (frames 10-19) are taken with re-solves landing
EGRESS_4K_HW = (2048, 4096)  # (e) tests/test_egress_rate.py:64's frame
EGRESS_4K_FRAMES = 12
PCM_MIN_BYTES_PX = 1.5  # (e) its bounds: a lossless I420 mux, and
PCM_MIN_FPS = 3.0       # the encode + convert + send path's rate
LIVE_WAIT_S = 60.0     # every wait of the phase on a board, player or server


def wait_for(pred, what: str, timeout: float = LIVE_WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(1e-3)


def connect_boards(ing, n: int):
    """One loopback socket per camera, in camera order: each connects once
    the previous one holds its slot (accept order gives the slots)."""
    socks = []
    for cam in range(n):
        socks.append(socket.create_connection(("127.0.0.1", ing.port),
                                              timeout=LIVE_WAIT_S))
        wait_for(lambda: ing._native.stitchio_clients() > cam,
                 f"board {cam} accepted")
    return socks


def live_runner_cfg(cfg, sets, **kw):
    """The Runner's configuration over its own capture server: framed,
    accept-order slots, port 0 (read back from the ingest)."""
    import dataclasses
    n, rows, w = sets[0].shape
    return dataclasses.replace(
        cfg, use_stream=True, capture_tcp_port=0, capture_framing=True,
        capture_debug_order=True, capture_img_width=w,
        capture_img_height=rows, pipeline_mode="threaded",
        recalibrate=False, **kw)


def run_with_boards(r, st, boards):
    """drive_runner(r) with `boards(r, finished)` on a thread of its own
    once the Runner's capture server listens; the board thread ends when
    the run does. Returns (launches, want, board errors, board thread)."""
    done = threading.Event()
    errors = []

    def finished():
        # the Runner sets _stop before it closes its capture server
        return done.is_set() or r._stop.is_set()

    def board_main():
        try:
            if not r.source_ready.wait(LIVE_WAIT_S):
                raise TimeoutError("the capture server never listened")
            boards(r, finished)
        except Exception as e:                   # noqa: BLE001
            if not finished():       # not the Runner closing the server
                errors.append(repr(e))
    board_t = threading.Thread(target=board_main, daemon=True)
    board_t.start()
    try:
        launches, want = drive_runner(r, st)
    finally:
        done.set()
        board_t.join(timeout=LIVE_WAIT_S)
    return launches, want, errors, board_t


def live_faults(st, cfg, sets, expected):
    """(a): over the Runner's capture server (framed, paced by has_room so
    nothing drops), board 1 drops its link halfway through a frame and
    reconnects, taking its freed slot, and resends that frame; board 2
    sends a truncated frame before its full one. Every output equals
    stitch_out of its set, and the counters equal what was injected."""
    from video_stitcher_tpu_torch.io_plane.ingest import (
        HEADER_BYTES, pack_frame)
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    n = sets[0].shape[0]
    sink = CheckSink(expected)
    r = Runner(live_runner_cfg(cfg, sets), stitcher=st, sink=sink,
               max_frames=LIVE_FRAMES, collect_latency=True)
    payloads = [[f[cam].tobytes() for cam in range(n)] for f in sets]
    sent = [0] * n              # whole frames each board sent
    info = {}

    def boards(r, finished):
        ing = r._ingest
        socks = connect_boards(ing, n)
        seq = [0] * n
        try:
            for k in range(LIVE_FRAMES + 8):
                while not (finished() or has_room(ing, k)):
                    time.sleep(1e-3)
                if finished():
                    return
                for cam in range(n):
                    pay = payloads[k % len(sets)][cam]
                    if cam == 1 and k == LIVE_DROP_AT:
                        socks[1].sendall(pack_frame(pay, seq[1])[
                            :HEADER_BYTES + len(pay) // 2])
                        socks[1].close()
                        wait_for(lambda: ing._native.stitchio_clients()
                                 == n - 1, "the dropped link seen")
                        socks[1] = socket.create_connection(
                            ("127.0.0.1", ing.port), timeout=LIVE_WAIT_S)
                        wait_for(lambda: ing._native.stitchio_clients()
                                 == n, "the board reconnected")
                        info["reconnected_at"] = k
                    if cam == 2 and k == LIVE_TRUNC_AT:
                        cut = pay[:len(pay) - LIVE_TRUNC_BYTES]
                        socks[2].sendall(pack_frame(cut, seq[2]))
                        seq[2] += 1
                        info["truncated_bytes"] = HEADER_BYTES + len(cut)
                    socks[cam].sendall(pack_frame(pay, seq[cam]))
                    seq[cam] += 1
                    sent[cam] += 1
        finally:
            for s in socks:
                s.close()
    launches, want, errors, board_t = run_with_boards(r, st, boards)
    stats = r._ingest.stats()
    nums = runner_numbers(r)
    log_runner("ingest faults over TCP, threaded", r, nums)
    log(f"    injected {info}; {r._ingest.stats_summary()}; "
        f"frames_ok {[s['frames_ok'] for s in stats]} of sent {sent}; "
        f"K1 launches {launches}")
    check(not errors and not board_t.is_alive()
          and set(info) == {"reconnected_at", "truncated_bytes"},
          f"live (a): the boards injected both faults {info} {errors}")
    check(r.frames_done == LIVE_FRAMES and sink.compared == LIVE_FRAMES
          and sink.mismatched == 0,
          f"live (a): {sink.compared} of {r.frames_done} outputs equal "
          f"stitch_out of their set across the faults (max abs "
          f"{sink.max_abs})")
    want_rs = [int(c == 2) for c in range(n)]
    check([s["resyncs"] for s in stats] == want_rs
          and [s["seq_gaps"] for s in stats] == want_rs
          and [s["bytes_skipped"] for s in stats]
          == [info.get("truncated_bytes", -1) * x for x in want_rs]
          and [s["drops"] for s in stats] == [0] * n,
          f"live (a): resyncs {[s['resyncs'] for s in stats]}, seq_gaps "
          f"{[s['seq_gaps'] for s in stats]}, bytes_skipped "
          f"{[s['bytes_skipped'] for s in stats]}, drops "
          f"{[s['drops'] for s in stats]} equal the injected")
    check([s["frames_ok"] for s in stats] == sent,
          "live (a): the reconnected board's frames land in its freed slot "
          "(frames_ok per slot = whole frames each board sent)")
    check(r.sync_stalls == 0 and r.stage_stalls == 0 and launches == want,
          f"live (a): no stall; K1 launched {launches} times (= {want})")
    nums.update(k1_launches=launches, injected=info,
                frames_ok=[s["frames_ok"] for s in stats])
    return launches, nums


def live_drops(st, cfg, sets, expected):
    """(b): the boards send FLOOD_SETS copies of one set flat out into a
    capture server FLOOD_QUEUE deep, faster than the Runner consumes; at
    the end each camera's drops equal its frames received less those the
    Runner took and those left queued. Every output equals stitch_out of
    the set."""
    from video_stitcher_tpu_torch.io_plane.ingest import (
        CaptureIngest, pack_frame)
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    n = sets[0].shape[0]
    rcfg = live_runner_cfg(cfg, sets)
    ing = CaptureIngest(rcfg, max_queue=FLOOD_QUEUE)
    ing.start()
    flooded = threading.Event()

    class FloodSource:
        """The Runner's capture source over the shallow server: sets
        until the flood is in and no complete set is left."""
        reads = 0
        queued = pending = None

        def get_frames(self):
            deadline = None
            while True:
                frames = ing.get_frames(timeout=0.2)
                if frames is not None:
                    self.reads += 1
                    return frames
                if flooded.is_set():
                    if all(s["frames_ok"] == FLOOD_SETS
                           for s in ing.stats()):
                        return None      # no complete set is left
                    deadline = deadline or time.monotonic() + LIVE_WAIT_S
                    if time.monotonic() > deadline:
                        return None

        def release(self):
            self.queued = [ing._native.stitchio_queue_size(c)
                           for c in range(n)]
            self.pending = [int(p is not None) for p in ing._pending]
            ing.stop()

    src = FloodSource()
    sink = CheckSink([expected[0]], first=0)
    r = Runner(rcfg, stitcher=st, source=src, sink=sink,
               collect_latency=True)

    def boards(r, finished):
        socks = connect_boards(ing, n)
        try:
            for k in range(FLOOD_SETS):
                for cam, s in enumerate(socks):
                    s.sendall(pack_frame(sets[0][cam].tobytes(), k))
        finally:
            flooded.set()
            for s in socks:
                s.close()
    launches, want, errors, board_t = run_with_boards(r, st, boards)
    stats = ing.stats()
    lost = [FLOOD_SETS - src.reads - src.pending[c] - src.queued[c]
            for c in range(n)]
    drops = [s["drops"] for s in stats]
    nums = runner_numbers(r)
    log_runner(f"flood into a {FLOOD_QUEUE}-deep queue, threaded", r, nums)
    log(f"    {FLOOD_SETS} sets sent per board; Runner read {src.reads}; "
        f"left queued {src.queued}, pending {src.pending}; drops {drops}, "
        f"lost {lost}; K1 launches {launches}")
    check(not errors and not board_t.is_alive(),
          f"live (b): the boards flooded without error {errors}")
    check([s["frames_ok"] for s in stats] == [FLOOD_SETS] * n
          and drops == lost and sum(drops) > 0,
          f"live (b): drops {drops} equal the frames lost {lost} (> 0)")
    check(r.frames_done == src.reads - 1 == sink.compared
          and sink.mismatched == 0 and r.sync_stalls == r.stage_stalls == 0,
          f"live (b): {sink.compared} outputs of {r.frames_done} equal "
          f"stitch_out of the set, no stall")
    check(launches == want,
          f"live (b): K1 launched {launches} times (= {want})")
    nums.update(k1_launches=launches, drops=drops, reads=src.reads)
    return launches, nums


class SessionPlayer:
    """Loopback player: each accepted connection's bytes in a list of its
    own; once kill_after is set, it drops the connection as soon as that
    holds kill_after bytes."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(2)
        self.srv.settimeout(0.1)
        self.port = self.srv.getsockname()[1]
        self.kill_after = None
        self.sessions = []
        self.ended = 0               # sessions whose connection closed
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            chunks = []
            self.sessions.append(chunks)
            got = 0
            conn.settimeout(0.1)
            with conn:
                while not self._stop.is_set():
                    if self.kill_after is not None and got >= self.kill_after:
                        self.kill_after = None
                        break
                    try:
                        data = conn.recv(1 << 22)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                    chunks.append(data)
                    got += len(data)
            self.ended += 1

    def stop(self, sessions: int) -> bool:
        """Once `sessions` connections came and all closed (bounded),
        stop; whether they did and the thread ended."""
        try:
            wait_for(lambda: len(self.sessions) >= sessions
                     and self.ended == len(self.sessions),
                     "the egress closed its connections")
        except TimeoutError:
            pass                      # the caller's check fails instead
        self._stop.set()
        self.thread.join(timeout=LIVE_WAIT_S)
        self.srv.close()
        return not self.thread.is_alive() and len(self.sessions) >= sessions \
            and self.ended == len(self.sessions)

    def session(self, i: int) -> bytes:
        return b"".join(self.sessions[i])


def nal_units(stream: bytes):
    from video_stitcher_tpu_torch.io_plane.egress import AnnexBFramer
    framer = AnnexBFramer()
    return framer.push(stream) + [framer.flush()]


def nal_types(units):
    return [(u[u.index(b"\x01") + 1] >> 1) & 0x3F for u in units]


def stream_decodes(enc: str, stream: bytes, sent) -> str:
    """Whether `stream` (one egress session's HEVC after the height
    prelude) decodes to the frames `sent` to it, by the layer that served:
    I_PCM is lossless and deterministic, so its stream must equal a fresh
    encoder's of those frames (whose output FFmpeg decodes bit-exact,
    tests/test_torch_hevc.py); x265 goes through the in-process decoder;
    a subprocess layer is parsed. Returns "" or what failed."""
    from video_stitcher_tpu_torch.io_plane import hevc_lavc, hevc_pcm
    from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
    if nal_types(nal_units(stream)[:3]) != [32, 33, 34]:
        return "the stream does not open with VPS/SPS/PPS"
    h, w = sent[0].shape[:2]
    if enc == "pcm":
        ref = hevc_pcm.create(w, h)
        want = b"".join(ref.encode(PlayerEgress._to_i420(f).tobytes())
                        for f in sent)
        ref.close()
        return "" if stream == want else "I_PCM stream differs from the " \
            "encoding of the frames sent"
    if enc == "x265" and hevc_lavc.load_native() is not None:
        dec = hevc_lavc.LavcHevcDecoder()
        try:
            pics = dec.decode(stream) + dec.flush()
        finally:
            dec.close()
        ok = 1 <= len(pics) <= len(sent) and all(
            (pw, ph) == (w, h) for _, pw, ph in pics)
        return "" if ok else f"x265 decoded {len(pics)} pictures"
    pics = count_pictures(nal_units(stream))
    return "" if 0 < pics <= len(sent) else f"{pics} pictures parsed"


def live_egress(st, cfg, sets, expected):
    """(c): the Runner streams HEVC to a player that drops the link once
    EGRESS_KILL_AFTER frames went out; the egress reconnects, the new session opens with
    the height prelude and a fresh stream that decodes to the frames sent
    after it, and the Runner runs to its end."""
    import dataclasses
    from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    oh = expected[0].shape[0]
    hh = oh + (oh & 1)
    player = SessionPlayer()
    rcfg = dataclasses.replace(cfg, player_address="127.0.0.1",
                               player_tcp_port=player.port,
                               send_results=True, recalibrate=False,
                               pipeline_mode="threaded")
    eg = PlayerEgress(rcfg, encoder="hevc")
    sent = []                     # (the socket it went out on, frame)
    send = eg.send_frame

    def recording_send(frame):
        send(frame)              # reconnects inside on a dropped link
        sent.append((eg.sock, eg._pad_even(frame)))
        if len(sent) == EGRESS_KILL_AFTER:
            player.kill_after = 0        # the player drops the link now
    eg.send_frame = recording_send
    sink = CheckSink(expected)
    r = Runner(rcfg, stitcher=st, egress=eg, sink=sink,
               source=CycleSource(sets, LIVE_EGRESS_FRAMES + 1),
               collect_latency=True)
    try:
        launches, want = drive_runner(r, st)
    finally:
        stopped = player.stop(2)
    enc = eg.selected_encoder
    sessions = [player.session(i) for i in range(len(player.sessions))]
    heights = [struct.unpack("<i", s[:4])[0] if len(s) >= 4 else None
               for s in sessions]
    after = [f for sock, f in sent if sock is sent[-1][0]]
    err = (stream_decodes(enc, sessions[1][4:], after)
           if len(sessions) == 2 and after else "no second session")
    nums = runner_numbers(r)
    log_runner(f"egress {enc} with a dropped player link, threaded", r, nums)
    log(f"    sessions {len(sessions)}, bytes {[len(s) for s in sessions]},"
        f" height preludes {heights}; {len(after)} frames sent into the "
        f"second; its stream: {err or 'decodes to them'}")
    check(stopped and len(sessions) == 2 and heights == [hh, hh]
          and sent and sent[0][0] is not sent[-1][0],
          f"live (c): the player saw the link drop and one reconnect, each "
          f"session opening with the height {heights} (= {hh})")
    check(not err, f"live (c): the restarted stream ({enc}) is clean: "
          f"{err or 'ok'}")
    check(r.frames_done == LIVE_EGRESS_FRAMES and sink.mismatched == 0
          and r.sync_stalls == r.stage_stalls == 0 and launches == want,
          f"live (c): the Runner lived on, {r.frames_done} frames, outputs "
          f"equal, no stall, K1 {launches} (= {want})")
    nums.update(k1_launches=launches, selected_encoder=enc,
                sessions=[len(s) for s in sessions],
                frames_after_reconnect=len(after))
    return launches, nums


def live_soak(st, cfg, sets):
    """(d): tests/test_soak.py at the default cell: framed TCP NV12 from
    six boards (paced by has_room: the Runner's own rate), the live
    re-solve with its animation and update_masks, and HEVC egress to a
    loopback player, all at once, SOAK_FRAMES frames. The boards hold
    frame 10's set until a re-solve has installed (bounded), so one lands
    however the host's threads share the run's first second."""
    import dataclasses
    from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
    from video_stitcher_tpu_torch.io_plane.ingest import pack_frame
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    n = sets[0].shape[0]
    player = SessionPlayer()
    rcfg = live_runner_cfg(
        cfg, sets, player_address="127.0.0.1", player_tcp_port=player.port,
        send_results=True)
    rcfg = dataclasses.replace(
        rcfg, recalibrate=True, recalib_interp=True,
        recalib_del_ms=SOAK_RECALIB_MS, update_masks=True)
    eg = PlayerEgress(rcfg, encoder="hevc")
    sent = []
    send = eg.send_frame

    def recording_send(frame):
        send(frame)
        sent.append(eg._pad_even(frame))
    eg.send_frame = recording_send
    r = Runner(rcfg, stitcher=st, egress=eg, max_frames=SOAK_FRAMES,
               collect_latency=True)
    payloads = [[f[cam].tobytes() for cam in range(n)] for f in sets]

    gate = {}

    def boards(r, finished):
        ing = r._ingest
        socks = connect_boards(ing, n)
        try:
            k = 0
            while not finished():
                if k == SOAK_GATE_SET and "s" not in gate:
                    t0 = time.perf_counter()
                    wait_for(lambda: finished() or r.recalibs_done >= 1,
                             "a re-solve installed", SOAK_GATE_S)
                    gate["s"] = time.perf_counter() - t0
                if not has_room(ing, k):
                    time.sleep(1e-3)
                    continue
                for cam, s in enumerate(socks):
                    s.sendall(pack_frame(payloads[k % len(sets)][cam], k))
                k += 1
        finally:
            for s in socks:
                s.close()
    masks = st.cfg
    st.cfg = dataclasses.replace(st.cfg, update_masks=True)
    try:
        launches, want, errors, board_t = run_with_boards(r, st, boards)
    finally:
        st.cfg = masks
        stopped = player.stop(1)
    enc = eg.selected_encoder
    data = player.session(0) if player.sessions else b""
    hh = struct.unpack("<i", data[:4])[0] if len(data) >= 4 else None
    err = stream_decodes(enc, data[4:], sent) if sent else "nothing sent"
    nums = runner_numbers(r)
    log_runner(f"all features at once ({enc} egress), threaded", r, nums)
    log(f"    re-solves installed {r.recalibs_done} (recalib_del_ms "
        f"{SOAK_RECALIB_MS}; set {SOAK_GATE_SET} held {gate.get('s', 0):.3f}"
        f" s for the first), swaps {len(r.swap_ms)}; "
        f"{r._ingest.stats_summary()}; egress {len(data)} bytes, height "
        f"{hh}, stream: {err or 'decodes to the frames sent'}; K1 launches "
        f"{launches}")
    check(not errors and not board_t.is_alive() and stopped,
          f"live (d): boards and player ended without error {errors}")
    check(r.frames_done >= SOAK_MIN_FRAMES,
          f"live (d): {r.frames_done} of {SOAK_FRAMES} frames "
          f"(>= {SOAK_MIN_FRAMES})")
    check(r.recalibs_done >= 1, f"live (d): {r.recalibs_done} re-solves "
          f"landed (>= 1)")
    check(r.sync_stalls == 0 and r.stage_stalls == 0,
          f"live (d): stalls sync {r.sync_stalls} stage {r.stage_stalls}")
    check(bool(sent) and hh == sent[0].shape[0] and not err,
          f"live (d): the stream ({enc}) opens with the height {hh} and "
          f"{err or 'decodes to the frames sent'}")
    check(launches == want,
          f"live (d): K1 launched {launches} times (= {want})")
    nums.update(k1_launches=launches, recalibs_done=r.recalibs_done,
                selected_encoder=enc, egress_bytes=len(data))
    return launches, nums


def egress_rate_4k():
    """(e): tests/test_egress_rate.py:64 on the card machine's host:
    EGRESS_4K_FRAMES 4K frames through PlayerEgress("hevc") into a
    loopback drain, with the built-in I_PCM layer pinned, and with x265
    where it loads. I_PCM held to the seed's >= 1.5 B/px and >= 3 fps."""
    import shutil
    from video_stitcher_tpu_torch import StitcherConfig
    from video_stitcher_tpu_torch.io_plane import hevc_lavc
    from video_stitcher_tpu_torch.io_plane.egress import PlayerEgress
    h, w = EGRESS_4K_HW
    base = np.random.default_rng(0).integers(0, 255, (h, w, 3)
                                              ).astype(np.uint8)
    have_x265 = hevc_lavc.create_encoder(64, 64) is not None
    out = {}
    for kind in ("pcm", "x265"):
        if kind == "x265" and not have_x265:
            log("  4K egress x265: not measured (libx265 does not load: no "
                "libavcodec headers on this host)")
            out[kind] = None
            continue
        player = SessionPlayer()
        cfg = StitcherConfig(player_address="127.0.0.1",
                             player_tcp_port=player.port)
        create, which = hevc_lavc.create_encoder, shutil.which
        if kind == "pcm":
            hevc_lavc.create_encoder = lambda *a, **k: None
            shutil.which = lambda name: None
        try:
            eg = PlayerEgress(cfg, encoder="hevc")
            t0 = time.perf_counter()
            for t in range(EGRESS_4K_FRAMES):
                eg.send_frame(np.roll(base, 16 * t, axis=1))
            tail = eg._enc.finish() if eg._enc is not None else b""
            dt = time.perf_counter() - t0
            if tail:
                eg.sock.sendall(tail)
            enc = eg.selected_encoder
            eg.close()
        finally:
            hevc_lavc.create_encoder, shutil.which = create, which
        stopped = player.stop(1)
        nbytes = len(player.session(0)) - 4
        fps = EGRESS_4K_FRAMES / dt
        per_frame = nbytes / EGRESS_4K_FRAMES
        log(f"  4K egress {kind} ({enc}): {fps:.3f} fps, "
            f"{per_frame / 1e6:.4f} MB a frame ({per_frame / (w * h):.4f} "
            f"B/px), {EGRESS_4K_FRAMES} frames of {w}x{h} in {dt:.3f} s")
        check(stopped and enc == kind, f"4K egress: served by {enc} (= "
              f"{kind}), the drain ended")
        if kind == "pcm":
            check(per_frame >= PCM_MIN_BYTES_PX * w * h and
                  fps >= PCM_MIN_FPS,
                  f"4K egress I_PCM: {per_frame / (w * h):.4f} B/px >= "
                  f"{PCM_MIN_BYTES_PX}, {fps:.3f} fps >= {PCM_MIN_FPS}")
        else:
            check(per_frame < 0.15 * 1.5 * w * h,
                  f"4K egress x265: {per_frame:.0f} B a frame, under 0.15 "
                  f"of I_PCM's")
        out[kind] = {"fps": fps, "mb_per_frame": per_frame / 1e6,
                     "bytes_per_px": per_frame / (w * h), "seconds": dt}
    return out


def live_phase(st, cfg, frames, frames2):
    """Phase "live": the Runner's fault paths at the default cell, each
    run with K1's count from 0: (a) ingest faults, (b) queue drops, (c) an
    egress reconnect, (d) every feature at once; and (e) the 4K egress
    rate. Runs in a temporary directory. Returns (K1 launches, metrics)."""
    import os
    import tempfile
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    log("phase live")
    dev = st.device
    rng = np.random.default_rng(SEED + 2)
    frames3 = np.clip(frames.astype(np.int16)
                      + rng.integers(-6, 7, frames.shape), 0, 255
                      ).astype(np.uint8)
    sets = [rgb_to_nv12(torch.as_tensor(f, device=dev)).cpu().numpy()
            for f in (frames, frames2, frames3)]
    expected = [eager_out(st, s) for s in sets]
    launches, metrics = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            launches["ingest faults"], metrics["faults"] = live_faults(
                st, cfg, sets, expected)
            launches["queue drops"], metrics["drops"] = live_drops(
                st, cfg, sets, expected)
            launches["egress reconnect"], metrics["egress_reconnect"] = \
                live_egress(st, cfg, sets, expected)
            launches["soak"], metrics["soak"] = live_soak(st, cfg, sets)
        finally:
            os.chdir(cwd)
    metrics["egress_4k"] = egress_rate_4k()
    return launches, metrics


SHARD_KS = (1, 2, 3, 4)     # phase "shard": shards on [card] * k
SHARD_RUNNER_FRAMES = 30   # the Runner with a 2-shard stitcher
INT16_MIN_DB, INT16_MAX_DB = 35.0, 50.0   # tests/test_reference_int16.py
                       # :83-120: the twin against the f32 blend


def shard_phase(st, cfg, frames, frames2, dev):
    """Camera sharding at the main path's rig: shard_state +
    build_sharded_step with the shards on [card] * k for each k in
    SHARD_KS (one card stands for k cards), the pano
    against st.stitch and the output against st.stitch_out; then a
    Stitcher sharded over [card] * 2 through stage_frames (a pinned ring
    per shard), stitch, stitch_out and the live Runner from memory. K1's
    launches are counted over that drive. Then K1 against its plain
    version on one shard's maps, the step's times, the reduction's device
    time alone (torch.profiler) beside its bound, and one sharded swap
    against an unsharded one. Returns (K1
    launches on the path, K1's error, metrics)."""
    import os
    import tempfile
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    from video_stitcher_tpu_torch.ops.remap_strips import (
        remap_strips, remap_strips_plain)
    from video_stitcher_tpu_torch.parallel.shard import (
        build_sharded_step, reduce_levels, shard_levels, shard_state)
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        _warp_source, resolve_shard_devices)
    log(f"phase shard (k = {list(SHARD_KS)} shards on {dev})")
    geom, state = st.geom, st.state
    oh, ow = st._out_size(geom)
    frames_dev = torch.as_tensor(frames, device=dev)
    ref = st.stitch(frames_dev, device=True).cpu().numpy()
    ref_out = st.stitch_out(frames_dev, device=True).cpu().numpy()
    resolved = resolve_shard_devices(2, st.device)
    cards = torch.cuda.device_count()
    log(f"  Stitcher(camera_shards=2) with {cards} card(s) resolves shard "
        f"devices {resolved}")
    metrics = {"camera_shards_2_resolves": None if resolved is None
               else [str(d) for d in resolved]}
    sharded = {k: shard_state(state, geom, [dev] * k) for k in SHARD_KS}
    rng = np.random.default_rng(SEED + 2)
    sets = [rgb_to_nv12(torch.as_tensor(f, device=dev)).cpu().numpy()
            for f in (frames, frames2, np.clip(frames.astype(np.int16)
                      + rng.integers(-6, 7, frames.shape), 0, 255
                      ).astype(np.uint8))]
    sst = Stitcher(cfg, device=dev)
    sst._shard_devices = [dev] * 2        # two shards on the one card
    sst.swap_state(state)

    # ---- the path: launch counts from 0 just before, read just after
    remap_strips.launches = 0
    per_call, d_pano, d_out = {}, {}, {}
    for k, sh in sharded.items():
        blocks = [frames_dev[s.lo:s.hi] for s in sh.shards]
        before = remap_strips.launches
        pano = build_sharded_step(geom, [dev] * k)(blocks, sh)
        torch.cuda.synchronize()
        per_call[k] = remap_strips.launches - before
        out = build_sharded_step(geom, [dev] * k, (oh, ow))(blocks, sh)
        d_pano[k] = max_abs_u8(pano.cpu().numpy(), ref)
        d_out[k] = max_abs_u8(out.cpu().numpy(), ref_out)
    staged = sst.stage_frames(frames)
    d_sst = max_abs_u8(sst.stitch(staged), ref)
    d_sst_out = max_abs_u8(sst.stitch_out(staged, device=True).cpu().numpy(),
                           ref_out)
    expected = [sst.stitch_out(s) for s in sets]
    path_launches = remap_strips.launches
    warm_sst = captures(sst)          # the shard programs' warm-ups
    rcfg = dataclasses.replace(cfg, pipeline_mode="threaded",
                               recalibrate=False)
    sink = CheckSink(expected)
    r = Runner(rcfg, stitcher=sst, sink=sink,
               source=CycleSource(sets, SHARD_RUNNER_FRAMES + 1),
               collect_latency=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            runner_launches, runner_sets = drive_runner(r, sst)
        finally:
            os.chdir(cwd)
    path_launches += runner_launches
    nums = runner_numbers(r)
    log_runner("Runner from memory, 2 shards, threaded", r, nums)
    log(f"  K1 launches on the shard path {path_launches} (per sharded call "
        f"{per_call}; Runner {runner_launches})")
    for k, sh in sharded.items():
        n_full = sum(s.hi > s.lo for s in sh.shards)
        log(f"  k={k}: cameras per shard {[s.hi - s.lo for s in sh.shards]}"
            f", pano max abs {d_pano[k]}, output max abs {d_out[k]}")
        check(per_call[k] == n_full, f"k={k}: K1 launched {per_call[k]} "
              f"times in one sharded call, once per non-empty shard "
              f"({n_full})")
        bound = 0 if k == 1 else MAX_ABS_U8
        check(d_pano[k] <= bound and d_out[k] <= bound,
              f"k={k}: sharded pano within {d_pano[k]}, output within "
              f"{d_out[k]} of stitch / stitch_out (<= {bound})")
    check(d_sst <= MAX_ABS_U8 and d_sst_out <= MAX_ABS_U8,
          f"Stitcher on 2 shards: staged stitch within {d_sst}, stitch_out "
          f"within {d_sst_out} of the unsharded stitcher")
    check(r.frames_done == SHARD_RUNNER_FRAMES
          and sink.compared == SHARD_RUNNER_FRAMES and sink.mismatched == 0
          and r.sync_stalls == r.stage_stalls == 0,
          f"Runner on 2 shards: {sink.compared} of {r.frames_done} outputs "
          f"equal stitch_out of their set (max abs {sink.max_abs}), no stall")
    check(runner_launches == 2 * runner_sets,
          f"Runner on 2 shards: K1 launched {runner_launches} times, twice "
          f"per stitched set ({runner_sets} sets with calib.jpg and the "
          f"Runner's two calls on its first set)")
    # each sharded step twice (pano, output), then the 2-shard stitcher:
    # stitch, stitch_out and the expected outputs, then the Runner
    want = (2 * sum(per_call.values()) + 2 * (2 + len(sets)) + warm_sst
            + runner_launches)
    check(path_launches == want > 0, f"the shard path ran through K1: "
          f"{path_launches} launches, once per non-empty shard of each "
          f"sharded call and of each capture's warm-up ({want})")

    # ---- K1 against its plain version on one shard's maps; times
    sh = sharded[2]
    s0 = sh.shards[0]
    src = _warp_source(frames_dev[s0.lo:s0.hi], geom)
    got = remap_strips(src, s0.fused_maps, s0.gains, s0.plan)
    want = remap_strips_plain(src, s0.fused_maps, s0.gains)
    torch.cuda.synchronize()
    k1_err = float((got - want).abs().max())
    check(k1_err <= K1_ATOL, f"K1 on shard 0 of 2 {tuple(got.shape)}: max "
          f"abs {k1_err:.3g} <= {K1_ATOL}")
    stitch_out_ms = sync_ms(lambda: st.stitch_out(frames_dev, device=True))
    step_ms, reduce_ms, shard_ms = {}, {}, {}
    for k, sh in sharded.items():
        blocks = [frames_dev[s.lo:s.hi] for s in sh.shards]
        step_out = build_sharded_step(geom, [dev] * k, (oh, ow))
        step_ms[k] = sync_ms(lambda: step_out(blocks, sh))
        parts = [shard_levels(b, s, geom) for b, s in zip(blocks, sh.shards)
                 if s.hi > s.lo]
        # the reduction's device time alone (one shard launches nothing),
        # beside its bound: each add reads two canvases and writes one
        adds = len(parts) - 1
        reduce_ms[k] = (device_sum_ms(lambda: reduce_levels(parts, dev))
                        if adds else 0.0)
        reduce_bytes = adds * 3 * sum(c.numel() * c.element_size()
                                      for c in parts[0])
        shard_ms[k] = sync_ms(lambda: shard_state(state, geom, [dev] * k),
                              reps=5)
        log(f"  k={k}: sharded step (stitch_out) {step_ms[k]:.4f} ms against "
            f"stitch_out {stitch_out_ms:.4f} ms; reduction of the levels "
            f"{reduce_ms[k]:.4f} ms on the card alone ({adds} adds a level,"
            f" bound {reduce_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms for "
            f"{reduce_bytes} bytes); shard_state {shard_ms[k]:.4f} ms")
    ust = Stitcher(cfg, device=dev)
    swap_ms = sync_ms(lambda: ust.swap_state(state), reps=5)
    swap_sharded_ms = sync_ms(lambda: sst.swap_state(state), reps=5)
    log(f"  swap_state {swap_ms:.4f} ms unsharded, {swap_sharded_ms:.4f} ms "
        f"on 2 shards (the state's plan, then each shard's slices and "
        f"plan); copies between two cards not measured (one card here)")
    metrics.update(
        shard_k1_launches=path_launches, shard_k1_per_call=per_call,
        shard_pano_max_abs=d_pano, shard_out_max_abs=d_out,
        shard_stitcher_max_abs=[d_sst, d_sst_out],
        sharded_step_ms=step_ms, stitch_out_ms=stitch_out_ms,
        shard_reduce_ms=reduce_ms, shard_state_ms=shard_ms,
        swap_ms=swap_ms, swap_sharded_ms=swap_sharded_ms,
        shard_k1_max_abs=k1_err,
        shard_runner=dict(nums, max_abs=sink.max_abs,
                          k1_launches=runner_launches))
    return path_launches, k1_err, metrics


def int16_phase(st, frames, scene, valid, dev):
    """The int16 parity twin at the main path's rig: stitch_int16 through
    K1 from the global-only state and from the live one; against the f32
    stitch of the same state, psnr in the JAX twin's band and the
    integer chain biased low (truncation toward zero); the card's
    stitch_int16 against the host plain path on the same state; the
    integer pyramids on the card bit-equal to the host on random int16
    with negatives at the level-0 band shape; blend_bands_int16 on the
    card against the host on the same bands; the time; psnr against the
    scene (not gated).

    The mean |d| < 2 and the share within 3 > 0.85 of
    tests/test_reference_int16.py:83-120 hold on that test's 2-camera
    noise ring (and in tests/test_torch_pyramid_int.py) but not on a
    stitched rig, for the JAX package either: its own stitch_int16 gives
    mean |d| 2.62 and 0.687 within 3 at 6x320x180 on the CPU (the
    truncation bias, mean d +1.75). They are printed here, not gated.
    Returns (K1 launches on the path, metrics)."""
    from video_stitcher_tpu_torch.blend.multiband import blend_bands_int16
    from video_stitcher_tpu_torch.ops.pyramid_int import (
        pyr_down_i16, pyr_up_i16)
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips)
    from video_stitcher_tpu_torch.calib.state import state_to
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        stitch_pano, stitch_pano_int16, warp_bands)
    from video_stitcher_tpu_torch.utils.synth import psnr
    log("phase int16")
    geom, g = st.geom, st.state_global
    lay = geom.layout
    frames_dev = torch.as_tensor(frames, device=dev)
    remap_strips.launches = 0
    warm = captures(st)
    p16 = st.stitch_int16(frames_dev, state=g)
    p16_live = st.stitch_int16(frames_dev)
    torch.cuda.synchronize()
    launches = remap_strips.launches
    warm = captures(st) - warm
    check(launches == 2 + warm, f"K1 launched {launches} times in 2 "
          f"stitch_int16 calls, once each (a replay's counted as its "
          f"launch), and {warm} in the warm-ups before their captures")
    check(p16.shape == (lay.pano_h, lay.pano_w, 3) and p16.dtype == np.uint8
          and p16_live.shape == p16.shape, "stitch_int16 shape and dtype")
    plan_g = plan_remap(g.fused_maps, geom.warp_src_h, geom.warp_src_w)
    pf = stitch_pano(frames_dev, g, geom, plan_g).cpu().numpy()
    d = pf[valid].astype(np.float64) - p16[valid]
    p_twin = psnr(pf[valid], p16[valid])
    mean_abs, within3 = float(np.abs(d).mean()), float((np.abs(d) <= 3)
                                                       .mean())
    bias = float(d.mean())
    log(f"  stitch_int16 (state_global) against the f32 stitch of the same "
        f"state: {p_twin:.4f} dB, mean d {bias:.4f}, mean |d| "
        f"{mean_abs:.4f}, within 3 {within3:.4f}")
    check(INT16_MIN_DB < p_twin < INT16_MAX_DB and bias > 0,
          f"the twin sits in the reference's integer band ({INT16_MIN_DB}-"
          f"{INT16_MAX_DB} dB), biased low by its truncation")
    host = stitch_pano_int16(torch.as_tensor(frames), state_to(g, "cpu"),
                             geom, st.aux["weights0"].cpu()).numpy()
    d_host = max_abs_u8(p16, host)
    check(d_host <= MAX_ABS_U8, f"stitch_int16 on the card within {d_host} "
          f"of the host plain path on the same state (<= {MAX_ABS_U8})")
    p_scene = scene_psnr(p16, scene, valid)
    log(f"  stitch_int16 psnr vs scene {p_scene:.4f} dB (not gated)")

    rng = np.random.default_rng(SEED)
    n = geom.num_images
    x = rng.integers(-3000, 3000, (n, 3, lay.band_h, lay.band_w)
                     ).astype(np.int16)
    xs = rng.integers(-8000, 8000, (n, 3, lay.band_h // 2, lay.band_w // 2)
                      ).astype(np.int16)
    down_eq = torch.equal(pyr_down_i16(torch.as_tensor(x, device=dev)).cpu(),
                          pyr_down_i16(torch.as_tensor(x)))
    up_eq = torch.equal(
        pyr_up_i16(torch.as_tensor(xs, device=dev), lay.band_h,
                   lay.band_w).cpu(),
        pyr_up_i16(torch.as_tensor(xs), lay.band_h, lay.band_w))
    check(down_eq and up_eq, f"pyr_down_i16 {x.shape} and pyr_up_i16 "
          f"{xs.shape} on the card bit-equal to the host")
    bands = warp_bands(frames_dev, g, geom, plan_g)
    w0 = st.aux["weights0"]
    on_card = blend_bands_int16(bands, w0, lay, g.valid_mask).cpu()
    on_host = blend_bands_int16(bands.cpu(), w0.cpu(), lay,
                                g.valid_mask.cpu())
    d_blend = float((on_card - on_host).abs().max())
    check(d_blend <= 1, f"blend_bands_int16 on the card within {d_blend} "
          f"of the host on the same bands (<= 1)")
    int16_ms = sync_ms(lambda: st.stitch_int16(frames_dev, device=True),
                       reps=5)
    int16_global_ms = sync_ms(lambda: st.stitch_int16(frames_dev, state=g,
                                                      device=True), reps=5)
    log(f"  stitch_int16 {int16_ms:.4f} ms (live state), "
        f"{int16_global_ms:.4f} ms (state_global, its plan built per call)")
    return launches, {
        "int16_k1_launches": launches, "int16_vs_f32_db": p_twin,
        "int16_vs_f32_mean_abs": mean_abs, "int16_vs_f32_within3": within3,
        "int16_vs_f32_mean": bias, "int16_card_vs_host_max_abs": d_host,
        "int16_psnr_scene_db": p_scene, "int16_pyr_bit_equal": down_eq
        and up_eq, "int16_blend_card_vs_host_max_abs": d_blend,
        "stitch_int16_ms": int16_ms,
        "stitch_int16_global_ms": int16_global_ms}


BLEND_SOURCE = "video_stitcher_tpu_torch/csrc/blend_levels.cu"
BLEND_REPLACES = ("none: the JAX package leaves the blend to XLA's fusion "
                  "of blend/multiband.py and ops/pyramid.py")


def blend_chain(bands, weight_pyr, lay, precision, valid):
    """The blend as the port ran it before its kernels: the plain pyramid
    helpers (laplacian_pyramid, the product with the weights, place_bands,
    the collapse through pyr_up), one launch per tap, product and sum."""
    from video_stitcher_tpu_torch.blend.multiband import place_bands
    from video_stitcher_tpu_torch.ops.pyramid import (
        laplacian_pyramid, pyr_up, storage_dtype)
    dt = storage_dtype(precision)
    lap = laplacian_pyramid(bands, lay.num_bands, precision)
    acc = [place_bands(lap[lvl] * weight_pyr[lvl].to(dt), lay, lvl)
           for lvl in range(lay.num_bands + 1)]
    out = acc[-1]
    for lvl in range(lay.num_bands - 1, -1, -1):
        out = acc[lvl].to(torch.float32) + pyr_up(
            out, acc[lvl].shape[-2], acc[lvl].shape[-1], precision,
            out_dtype=torch.float32)
        if precision == "bf16" and lvl > 0:
            out = out.to(dt)
    return acc, out.to(torch.float32) * valid[None]


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| (inf for tensors of another shape or dtype)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    return float((a.float() - b.float()).abs().max())


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors given (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def blend_stage_kernels(st, frames, dev):
    """The device kernels of one profiled replay of stitch_out between its
    step.blend and step.output markers, in order: the programs of a new
    stitcher on st's state, captured with the tracer on so that they hold
    the step's markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.utils import trace
    x = torch.as_tensor(frames, device=dev)
    trace.enable()
    try:
        traced = Stitcher(st.cfg, device=dev)
        traced._install(st.geom, st.state)
        traced.stitch_out(x, device=True)              # the capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced.stitch_out(x, device=True)
            torch.cuda.synchronize()
        names = trace.mark_names()
    finally:
        trace.disable()
        trace.clear()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = {}
    for i, e in enumerate(events):
        m = trace.MARK_KERNEL.search(e.name)
        if m:
            marks.setdefault(names.get(int(m.group(1))), i)
    lo, hi = marks.get("step.blend"), marks.get("step.output")
    if lo is None or hi is None or hi < lo:
        return None
    return [e.name for e in events[lo + 1:hi]]


def blend_phase(st, frames, dev):
    """Phase "blend": the blend's kernels (blend/levels.py,
    csrc/blend_levels.cu) at the rig's shapes in bf16 and f32. Each kernel
    against its plain version level by level on the same inputs, and the
    blend through the kernels against the chain the port ran before them,
    all at max abs 0; each kernel's device ms (all its levels of one
    frame) against its bound and its plain version's ms; the blend's
    launches per replay of stitch_out, and the kernels of a profiled,
    marked replay between step.blend and step.output: the blend's alone.
    Returns (kernel entries, metrics)."""
    from video_stitcher_tpu_torch.blend import levels
    from video_stitcher_tpu_torch.blend.multiband import (
        collapse_levels, weighted_levels)
    from video_stitcher_tpu_torch.pipeline.stitcher import warp_bands
    log("phase blend")
    lay, nb = st.geom.layout, st.geom.layout.num_bands
    bands = warp_bands(torch.as_tensor(frames, device=dev), st.state,
                       st.geom, st.plan)
    wp, valid = st.state.weight_pyr, st.state.valid_mask
    log(f"  bands {tuple(bands.shape)}, panorama [3, {lay.band_h}, "
        f"{lay.pano_w}], {nb} bands, corners {lay.corners}")
    entries = {name: {"name": f"blend {name}", "route": "cuda",
                      "source": BLEND_SOURCE, "replaces": BLEND_REPLACES,
                      "max_abs_err": 0.0, "by_precision": {}}
               for name in ("down", "lap_place", "collapse")}
    metrics = {}
    for precision in ("bf16", "highest"):
        gauss = [bands]
        for _ in range(nb):
            gauss.append(levels.down_plain(gauss[-1], precision))
        lap_args = [(gauss[lvl], gauss[lvl + 1] if lvl < nb else None,
                     wp[lvl], lay, lvl, None, precision)
                    for lvl in range(nb + 1)]
        acc = [levels.lap_place_plain(*a) for a in lap_args]
        outs = [acc[-1]]
        for lvl in range(nb - 1, -1, -1):
            outs.insert(0, levels.collapse_plain(acc[lvl], outs[0], precision,
                                                 lvl == 0, valid))
        col_args = [(acc[lvl], outs[lvl + 1], precision, lvl == 0, valid)
                    for lvl in range(nb)]
        err = {
            "down": max(max_abs(levels.down(g, precision), n) for g, n in
                        zip(gauss[:-1], gauss[1:])),
            "lap_place": max(max_abs(levels.lap_place(*a), p)
                             for a, p in zip(lap_args, acc)),
            "collapse": max(max_abs(levels.collapse(*a), p)
                            for a, p in zip(col_args, outs))}
        acc_k = weighted_levels(bands, wp, lay, precision)
        pano_k = collapse_levels(acc_k, precision, valid)
        acc_c, pano_c = blend_chain(bands, wp, lay, precision, valid)
        d_levels = max(max_abs(a, c) for a, c in zip(acc_k, acc_c))
        d_pano = max_abs(pano_k, pano_c)
        torch.cuda.synchronize()
        for name, e in err.items():
            check(e == 0.0, f"blend {name} ({precision}) equals its plain "
                  f"version at every level: max abs {e}")
        check(d_levels == 0.0 and d_pano == 0.0,
              f"the blend through the kernels ({precision}) equals the "
              f"plain chain: levels max abs {d_levels}, panorama {d_pano}")
        byts = {
            "down": sum(tensor_bytes(g, n)
                        for g, n in zip(gauss[:-1], gauss[1:])),
            "lap_place": sum(tensor_bytes(a[0], a[1], a[2], p)
                             for a, p in zip(lap_args, acc)),
            "collapse": sum(tensor_bytes(a[0], a[1], a[4] if a[3] else None,
                                         o) for a, o in zip(col_args, outs))}
        runs = {
            "down": (lambda: [levels.down(g, precision) for g in gauss[:-1]],
                     lambda: [levels.down_plain(g, precision)
                              for g in gauss[:-1]]),
            "lap_place": (lambda: [levels.lap_place(*a) for a in lap_args],
                          lambda: [levels.lap_place_plain(*a)
                                   for a in lap_args]),
            "collapse": (lambda: [levels.collapse(*a) for a in col_args],
                         lambda: [levels.collapse_plain(*a)
                                  for a in col_args])}
        for name, (kernel, plain) in runs.items():
            launches = len(kernel())
            ms = device_sum_ms(kernel, launches=launches)
            bound = bound_ms(byts[name], 0.0, F32_FLOPS)[0]
            row = {"ms": ms, "call_ms": event_ms(kernel),
                   "plain_ms": event_ms(plain), "bound_ms": bound,
                   "bound_by": "bytes", "bytes": byts[name],
                   "share": bound / ms, "max_abs_err": err[name],
                   "launches_per_frame": launches}
            entries[name]["by_precision"][precision] = row
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                               err[name])
            log(f"  {name} ({precision}): {ms:.4f} ms on the card alone "
                f"({row['call_ms']:.4f} ms per frame's calls, "
                f"{row['launches_per_frame']} launches), bound "
                f"{bound:.4f} ms ({byts[name]} bytes), share "
                f"{row['share']:.3f}; plain {row['plain_ms']:.4f} ms")
        blend = lambda: collapse_levels(  # noqa: E731
            weighted_levels(bands, wp, lay, precision), precision, valid)
        metrics[precision] = {
            "blend_ms": device_sum_ms(blend, launches=3 * nb + 1),
            "blend_call_ms": event_ms(blend),
            "chain_ms": event_ms(lambda: blend_chain(bands, wp, lay,
                                                     precision, valid)),
            "bound_ms": bound_ms(sum(byts.values()), 0.0, F32_FLOPS)[0]}
        log(f"  the blend ({precision}): {metrics[precision]['blend_ms']:.4f}"
            f" ms on the card alone, bound "
            f"{metrics[precision]['bound_ms']:.4f} ms; the chain it "
            f"replaced {metrics[precision]['chain_ms']:.4f} ms")
    step = [p for p in st.programs.programs.values()
            if p.key[0][0] == "stitch_out"]
    per_replay = [p.blend_launches for p in step]
    log(f"  blend launches per replay of stitch_out: {per_replay}")
    check(bool(step) and all(n == 3 * nb + 1 for n in per_replay),
          f"every stitch_out program replays the blend's {3 * nb + 1} "
          f"kernel launches")
    stage = blend_stage_kernels(st, frames, dev)
    log(f"  a marked replay's kernels from step.blend to step.output: "
        f"{stage}")
    check(stage is not None and len(stage) == 3 * nb + 1 and all(
        "blend_" in k and "index" not in k for k in stage),
        "the blend stage of a replay runs the blend kernels alone (no "
        "index_select, multiply or add)")
    metrics.update(stitch_out_blend_launches=per_replay,
                   blend_stage_kernels=stage)
    return list(entries.values()), metrics


MAP_HOST_PX = 0.01     # card band maps vs the f64 host build
                       # (tests/test_geometry.py:110-130)
FUSED_ATOL_PX = 1e-3   # compose_fused_maps vs compose_fused_maps_device
PYR_ROUNDTRIP_ATOL = 1e-2   # tests/test_ops_gold.py:113-118
HELPER_ATOL = 1e-3     # a helper on the card vs the same call on the CPU


def helpers_phase(st, frames, nv12, pano_f32, dev):
    """The JAX package's public helpers on the card at the main path's
    rig: the f32 band maps against the f64 host build (identical -1
    sentinels, < MAP_HOST_PX elsewhere); the host entry
    compose_fused_maps on the card against compose_fused_maps_device,
    with no mesh (also against the calibrated state_global's maps, which
    K1 warps with) and with a perturbed mesh map; the Laplacian round
    trip collapse_laplacian(laplacian_pyramid(pano, levels)) on the f32
    pano; and the HWC wrappers (remap, resize, resize_scale) and colour
    helpers on one 1080p frame against the same call on CPU tensors.
    Launches no kernel. Returns metrics."""
    from video_stitcher_tpu_torch.calib.calibration import (
        compose_fused_maps, compose_fused_maps_device)
    from video_stitcher_tpu_torch.geometry.cylindrical import (
        band_backward_maps, band_backward_maps_device)
    from video_stitcher_tpu_torch.ops import color, remap, resize
    from video_stitcher_tpu_torch.ops.pyramid import (
        collapse_laplacian, laplacian_pyramid)
    from video_stitcher_tpu_torch.ops.resize import resize_scale
    log("phase helpers")
    geom, lay = st.geom, st.geom.layout
    cams = st.aux["cams_map"]
    t0 = time.perf_counter()
    host = band_backward_maps(lay, cams)
    host_s = time.perf_counter() - t0
    card = band_backward_maps_device(lay, cams, dev).cpu().numpy()
    card_ms = sync_ms(lambda: band_backward_maps_device(lay, cams, dev),
                      reps=5)
    hs = (host[:, 0] == -1) & (host[:, 1] == -1)
    cs = (card[:, 0] == -1) & (card[:, 1] == -1)
    d_maps = float(np.abs(host - card)[np.broadcast_to(
        ~hs[:, None], host.shape)].max())
    log(f"  band_backward_maps {host.shape}: host f64 {host_s:.3f} s, "
        f"card f32 {card_ms:.4f} ms")
    check(bool((hs == cs).all()) and d_maps < MAP_HOST_PX,
          f"band maps on the card: sentinels identical ({int(hs.sum())} "
          f"px), max abs {d_maps:.3g} < {MAP_HOST_PX} px elsewhere")

    band_maps = st.aux["band_maps"]
    bm = band_maps.cpu().numpy()
    n, _, bh, bw = bm.shape
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    mesh = perturbed_maps(np.broadcast_to(np.stack([gx, gy])[None],
                                          (n, 2, bh, bw)))
    fused_err = {}
    for name, mm in (("no mesh", None), ("perturbed mesh", mesh)):
        got = compose_fused_maps(geom, bm, mm, device=dev)
        want = compose_fused_maps_device(
            band_maps, None if mm is None else torch.as_tensor(
                mm, device=dev), geom).cpu().numpy()
        fused_err[name] = float(np.abs(got - want).max())
        check(got.shape == want.shape and got.dtype == np.float32
              and fused_err[name] <= FUSED_ATOL_PX,
              f"compose_fused_maps on the card, {name}: max abs "
              f"{fused_err[name]:.3g} <= {FUSED_ATOL_PX} px of "
              f"compose_fused_maps_device")
        if mm is None:
            d_state = float(np.abs(
                got - st.state_global.fused_maps.cpu().numpy()).max())
            check(d_state <= FUSED_ATOL_PX, f"... and max abs {d_state:.3g}"
                  f" of the calibrated state_global's maps")

    levels = geom.num_bands
    rec = collapse_laplacian(laplacian_pyramid(pano_f32, levels))
    d_pyr = float((rec - pano_f32).abs().max())
    pyr_ms = sync_ms(lambda: collapse_laplacian(
        laplacian_pyramid(pano_f32, levels)), reps=5)
    check(d_pyr <= PYR_ROUNDTRIP_ATOL,
          f"collapse_laplacian(laplacian_pyramid(pano, {levels})) "
          f"{tuple(pano_f32.shape)}: max abs {d_pyr:.3g} <= "
          f"{PYR_ROUNDTRIP_ATOL}; {pyr_ms:.4f} ms")

    frame = torch.as_tensor(frames[0])
    maps0 = st.state.fused_maps[0].cpu()
    oh, ow = frame.shape[0] // 2, frame.shape[1] // 2
    calls = {
        "remap": lambda f, m, nv: remap(f, m[0], m[1]),
        "resize": lambda f, m, nv: resize(f, oh, ow),
        "resize_scale 0.82": lambda f, m, nv: resize_scale(f, 0.82),
        "rgb_to_gray": lambda f, m, nv: color.rgb_to_gray(f),
        "bgr_to_gray": lambda f, m, nv: color.bgr_to_gray(f),
        "swap_rb": lambda f, m, nv: color.swap_rb(f),
        "nv12_to_bgr": lambda f, m, nv: color.nv12_to_bgr(nv),
    }
    nv0 = torch.as_tensor(nv12[0])
    wrapper_err = {}
    for name, fn in calls.items():
        on_card = fn(frame.to(dev), maps0.to(dev), nv0.to(dev)).cpu()
        on_host = fn(frame, maps0, nv0)
        wrapper_err[name] = float((on_card.float() - on_host.float())
                                  .abs().max())
        check(on_card.shape == on_host.shape
              and on_card.dtype == on_host.dtype
              and wrapper_err[name] <= HELPER_ATOL,
              f"{name} {tuple(on_card.shape)} on the card: max abs "
              f"{wrapper_err[name]:.3g} <= {HELPER_ATOL} of the CPU call")
    return {"band_maps_host_s": host_s, "band_maps_card_ms": card_ms,
            "band_maps_card_vs_host_max_px": d_maps,
            "compose_fused_maps_max_px": fused_err,
            "pyramid_roundtrip_max_abs": d_pyr, "pyramid_roundtrip_ms": pyr_ms,
            "wrappers_card_vs_cpu_max_abs": wrapper_err}


ENTRY_MESH_SD_PX = 2.5     # the mesh vertices' displacement, px


def entries_phase(cfg, frames, dev):
    """The entry points as a user calls them, with no device argument
    anywhere (the card is their default): calibrate(frames, cfg) leaves
    every state and aux tensor on the card; calibrate(frames, cfg,
    mesh_maps=m), m a smooth non-identity mesh from mesh_to_backward_maps,
    gives the fused maps compose_fused_maps(geom, band_maps, m) gives (max
    abs 0); save_state -> load_state lands on the card, and stitch_out
    from it (a Stitcher that loads the file, load_calibration with
    frames_shape) equals stitch_out from the state it was saved from (max
    abs 0). K1 runs on the meshed maps over their tile plan within K1_ATOL
    of its plain version. Returns (K1 launches on the path, K1's max abs
    error, metrics)."""
    import os
    import tempfile
    from video_stitcher_tpu_torch import Stitcher
    from video_stitcher_tpu_torch.calib.calibration import (
        calibrate, compose_fused_maps)
    from video_stitcher_tpu_torch.calib.state import load_state, save_state
    from video_stitcher_tpu_torch.mesh.mesh2map import mesh_to_backward_maps
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips, remap_strips_plain)
    log("phase entries")

    def on_card(tensors):
        return all(t.device.type == "cuda" for t in tensors)

    def state_tensors(state):
        return [state.fused_maps, state.gains, *state.weight_pyr,
                state.valid_mask]

    geom, state, aux = calibrate(frames, cfg)
    check(on_card(state_tensors(state) + [
        aux["band_maps"], aux["weights0"], aux["overlap_masks"]]),
        "calibrate(frames, cfg): every state and aux tensor on the card")
    lay = geom.layout
    rng = np.random.default_rng(SEED)
    n, m_ = cfg.mesh_height, cfg.mesh_width
    verts = np.stack(np.meshgrid(np.linspace(0, lay.band_w - 1, m_),
                                 np.linspace(0, lay.band_h - 1, n)), -1)
    verts = (verts[None] + rng.normal(0, ENTRY_MESH_SD_PX,
                                      (cfg.num_images, n, m_, 2))
             ).astype(np.float32)
    mesh = mesh_to_backward_maps(verts, lay.band_h, lay.band_w)
    gy, gx = torch.meshgrid(torch.arange(lay.band_h, device=mesh.device),
                            torch.arange(lay.band_w, device=mesh.device),
                            indexing="ij")
    mesh_px = float(torch.stack([mesh[:, 0] - gx, mesh[:, 1] - gy]).abs()
                    .max())
    check(mesh.device.type == "cuda" and mesh_px > 1.0,
          f"mesh_to_backward_maps on the card: max |mesh - identity| "
          f"{mesh_px:.3f} px")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geom_m, meshed, aux_m = calibrate(frames, cfg, mesh_maps=mesh)
    torch.cuda.synchronize()
    calib_mesh_s = time.perf_counter() - t0
    want = compose_fused_maps(geom_m, aux_m["band_maps"].cpu().numpy(),
                              mesh.cpu().numpy())
    d_fused = float(np.abs(meshed.fused_maps.cpu().numpy() - want).max())
    check(on_card(state_tensors(meshed)) and d_fused == 0.0,
          f"calibrate(frames, cfg, mesh_maps=m) {calib_mesh_s:.3f} s: fused "
          f"maps max abs {d_fused:.3g} from compose_fused_maps(geom, "
          f"band_maps, m)")

    src = torch.as_tensor(frames).to(meshed.fused_maps.device).permute(
        0, 3, 1, 2).contiguous()
    plan = plan_remap(meshed.fused_maps, geom.src_h, geom.src_w)
    got = remap_strips(src, meshed.fused_maps, meshed.gains, plan)
    k1_err = float((got - remap_strips_plain(src, meshed.fused_maps,
                                             meshed.gains)).abs().max())
    check(k1_err <= K1_ATOL, f"K1 on the meshed maps {tuple(got.shape)} "
          f"(tiles {plan.counts()}): max abs {k1_err:.3g} <= {K1_ATOL}")
    k1_ms = kernel_ms(lambda: remap_strips(src, meshed.fused_maps,
                                           meshed.gains, plan))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "meshed.npz")
        t0 = time.perf_counter()
        save_state(path, meshed)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        loaded = load_state(path)
        check(on_card(state_tensors(loaded)),
              f"save_state ({nbytes} bytes, {save_s:.3f} s) -> "
              f"load_state: every tensor on the card")
        saved = Stitcher(cfg)
        saved.swap_state(meshed)
        from_file = Stitcher(cfg)
        from_file.load_calibration(path, frames_shape=frames.shape)
    remap_strips.launches = 0
    warm = captures(saved) + captures(from_file)   # the re-solve's prewarm
    out_saved = saved.stitch_out(frames)
    out_loaded = from_file.stitch_out(frames)
    launches = remap_strips.launches
    d_out = max_abs_u8(out_saved, out_loaded)
    check(launches == 2 + captures(saved) + captures(from_file) - warm
          and from_file.device.type == "cuda" and d_out == 0,
          f"stitch_out from the loaded checkpoint: max abs {d_out} from "
          f"the state it was saved from, K1 launches {launches}")
    log(f"  K1 on the entries path: {launches} launches, {k1_ms:.4f} ms on "
        f"the card alone (meshed maps, source {tuple(src.shape)})")
    return launches, k1_err, {
        "calibrate_mesh_maps_s": calib_mesh_s, "mesh_max_px": mesh_px,
        "fused_vs_compose_max_abs": d_fused, "k1_meshed_ms": k1_ms,
        "k1_meshed_max_abs": k1_err, "k1_meshed_tiles": plan.counts(),
        "checkpoint_bytes": nbytes, "save_state_s": save_s,
        "stitch_out_loaded_max_abs": d_out}


def baseline_config4():
    """The JAX package's BASELINE config 4 (bench.py::p_4k): 6-camera 4K
    in, 8K out, keep_aspect_ratio + add_black_bars, global warp."""
    from video_stitcher_tpu_torch import StitcherConfig
    return StitcherConfig(input_width=3840, input_height=2160,
                          output_width=7680, output_height=3840,
                          keep_aspect_ratio=True, add_black_bars=True,
                          enable_local=False)


def small_prewarp_rig():
    """tests/test_torch_prewarp.py's rig: 4x640x360 at compose scale 0.35."""
    from video_stitcher_tpu_torch import StitcherConfig
    return StitcherConfig(num_images=4, input_width=640, input_height=360,
                          compose_megapix=0.04, enable_local=False,
                          output_width=960, output_height=400,
                          keep_aspect_ratio=True, add_black_bars=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from video_stitcher_tpu_torch import StitcherConfig
    return run(StitcherConfig(), torch.device("cuda"), baseline_config4(),
               small_prewarp_rig())


def run(cfg, dev, cfg4, small4) -> int:
    from video_stitcher_tpu_torch import Stitcher, StitcherConfig, _build
    from video_stitcher_tpu_torch.blend import levels
    from video_stitcher_tpu_torch.blend.multiband import blend_bands
    from video_stitcher_tpu_torch.calib.calibration import plan_geometry
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    from video_stitcher_tpu_torch.ops.remap_strips import (
        plan_remap, remap_strips, remap_strips_plain, tap_origins)
    from video_stitcher_tpu_torch.ops.resize import resize_planar
    from video_stitcher_tpu_torch.pipeline.stitcher import (
        _pack_u8_hwc, blend_f32, warp_bands)
    from video_stitcher_tpu_torch.utils.synth import make_scene, render_views

    card = card_line()
    kind = torch.cuda.get_device_name(0)

    def blend_snap():
        """The blend kernels' launches so far: down, lap_place, collapse."""
        return [k.launches for k in levels.KERNELS]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    log("phase build")
    from concurrent.futures import ThreadPoolExecutor
    from video_stitcher_tpu_torch.io_plane import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:      # g++ beside nvcc
        native_job = pool.submit(native.build)
        built = _build.build()
        native_built = native_job.result()
    log(f"  build seconds {time.perf_counter() - t0:.3f} per kernel "
        f"{json.dumps(built)}")
    for name, b in native_built.items():
        log(f"  native {name}: " + (f"{b.seconds:.3f} s" if b.error is None
                                    else "not built: " + b.error.strip()
                                    .splitlines()[0][:200]))
    check(all(native_built[n].error is None for n in (
        "libstitchio.so", "libhevcpcm.so", "libhevcintra.so")),
        "the native I/O libraries build (libhevclavc needs libavcodec's "
        "headers; without them the egress takes the next encoder)")
    for name in _build.KERNELS:
        log(f"  ptxas, csrc/{name}.cu:\n    "
            + _build.ptxas_report(name).replace("\n", "\n    "))

    # ---- main path at full width -------------------------------------
    log(f"phase main path ({cfg.num_images}x{cfg.input_width}x"
        f"{cfg.input_height}, enable_local={cfg.enable_local})")
    geom, _ = plan_geometry(cfg)
    lay = geom.layout
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    scene = make_scene(lay.pano_w, lay.pano_h, rng)
    frames = render_views(cfg, geom, scene)
    frames2 = np.clip(frames.astype(np.int16)
                      + rng.integers(-12, 13, frames.shape), 0, 255
                      ).astype(np.uint8)
    nv12 = rgb_to_nv12(torch.from_numpy(frames)).numpy()
    log(f"  synthetic rig {time.perf_counter() - t0:.3f} s: frames "
        f"{frames.shape}, pano {lay.pano_w}x{lay.pano_h}, bands "
        f"{lay.band_w}x{lay.band_h}, levels {lay.num_bands}")

    st = Stitcher(cfg, device=dev)
    mesh_s = []
    solve = st.recalibrate_mesh

    def timed_solve(f):
        t = time.perf_counter()
        out = solve(f)
        torch.cuda.synchronize()
        mesh_s.append(time.perf_counter() - t)
        return out
    st.recalibrate_mesh = timed_solve      # calibrate's first mesh solve
    remap_strips.launches = 0
    for k in levels.KERNELS:
        k.launches = 0
    counts, blend_counts = [], []

    def counted(fn, *args, **kw):
        before, caps = remap_strips.launches, captures(st)
        blend_before = [(k.launches, k.captured) for k in levels.KERNELS]
        out = fn(*args, **kw)
        counts.append(remap_strips.launches - before
                      - (captures(st) - caps))
        # a capture's warm-up launches what the capture records
        blend_counts.append([k.launches - n - (k.captured - c) for k, (n, c)
                             in zip(levels.KERNELS, blend_before)])
        return out

    t0 = time.perf_counter()
    st.calibrate(frames)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del st.recalibrate_mesh
    calib_launches = remap_strips.launches
    blend_calib = blend_snap()
    log(f"  calibrate {calib_s:.3f} s (first mesh solve "
        f"{sum(mesh_s):.3f} s), K1 launches {calib_launches}")
    check(len(mesh_s) == int(cfg.enable_local) and calib_launches == len(
        mesh_s) + captures(st), "calibrate solved the mesh once, its "
        "estimation warp through K1 (and the warm-up before its capture)")
    calib_caps = captures(st)
    panos = [counted(st.stitch, f) for f in (frames, frames2, frames)]
    panos_nv12 = [counted(st.stitch_nv12, nv12) for _ in range(2)]
    outs = [counted(st.stitch_out, f) for f in (frames, frames2)]
    batch = counted(st.stitch_batch, np.stack([frames, frames2]))
    main_launches = remap_strips.launches
    main_caps = captures(st) - calib_caps
    log(f"  K1 launches on the main path: {main_launches} (calibrate "
        f"{calib_launches}, per stitch* call {counts} besides the "
        f"{main_caps} warm-ups before the captures of "
        f"{sorted(st.programs.captures)})")
    check(all(c == 1 for c in counts),
          "K1 launched exactly once per stitch* call (a replay's K1 "
          "counted as its launch), plus once per capture's warm-up")
    check(main_launches == len(counts) + main_caps + calib_launches > 0,
          "the main path ran through K1")
    # down and collapse once a level below the top, lap_place once a level,
    # per frame set (stitch_batch's two sets last)
    nb = lay.num_bands
    want = [[sets * nb, sets * (nb + 1), sets * nb]
            for sets in [1] * (len(blend_counts) - 1) + [2]]
    blend_at = [("stitch*", blend_snap())]
    log(f"  blend launches (down, lap_place, collapse) on the main path: "
        f"{blend_at[0][1]} (calibrate {blend_calib}, per stitch* call "
        f"{blend_counts} besides the warm-ups before the captures)")
    check(blend_counts == want, f"the blend's kernels launched {nb}, "
          f"{nb + 1} and {nb} times a frame set in every stitch* call (a "
          f"replay's counted as its launches)")

    # ---- what came out ------------------------------------------------
    log("phase results")
    valid = st.state.valid_mask.cpu().numpy() > 0
    p_rgb = scene_psnr(panos[0], scene, valid)
    p_nv12 = scene_psnr(panos_nv12[0], scene, valid)
    p_nv12_y = scene_psnr(panos_nv12[0], scene, valid, luma)
    log(f"  psnr vs scene: stitch {p_rgb:.4f} dB; stitch_nv12 "
        f"{p_nv12:.4f} dB RGB (4:2:0 chroma), {p_nv12_y:.4f} dB luma")
    check(panos[0].shape == (lay.pano_h, lay.pano_w, 3)
          and panos[0].dtype == np.uint8, "pano shape and dtype")
    check(p_rgb >= MIN_PSNR_DB, f"stitch psnr {p_rgb:.2f} >= {MIN_PSNR_DB}")
    check(p_nv12_y >= MIN_PSNR_DB,
          f"stitch_nv12 luma psnr {p_nv12_y:.2f} >= {MIN_PSNR_DB}")
    check(np.array_equal(panos[0], panos[2]), "stitch is deterministic")
    two_step = st.output(panos[0])
    d_out = max_abs_u8(outs[0], two_step)
    check(outs[0].shape == st.output(panos[1]).shape and d_out <= MAX_ABS_U8,
          f"stitch_out {outs[0].shape} within {d_out} of output(stitch)")
    d_batch = max(max_abs_u8(batch[0], panos[0]),
                  max_abs_u8(batch[1], panos[1]))
    check(d_batch == 0, "stitch_batch equals per-frame stitch")
    local_metrics = local_phase(st, frames, scene, valid, p_rgb, calib_s,
                                sum(mesh_s), dev)
    resolve_err, resolve_metrics = resolve_phase(st, frames, frames2, dev)

    bands = warp_bands(torch.as_tensor(frames, device=dev), st.state, geom,
                       st.plan)
    b32 = blend_bands(bands, st.state.weight_pyr, lay, st.state.valid_mask,
                      "highest").cpu().numpy()
    b16 = blend_bands(bands, st.state.weight_pyr, lay, st.state.valid_mask,
                      "bf16").cpu().numpy()
    from video_stitcher_tpu_torch.utils.synth import psnr
    p16 = psnr(b16[:, valid], b32[:, valid])
    d16 = max_abs_u8(np.clip(np.round(b16), 0, 255),
                     np.clip(np.round(b32), 0, 255))
    # measured, not gated: the default bf16 storage is the JAX package's
    # own choice, and the port's bf16 blend equals it bit for bit on the
    # CPU (tests/test_torch_blend.py)
    log(f"  bf16 blend storage vs f32 chain: {p16:.4f} dB, u8 max abs "
        f"{d16}")

    # small rig: the card against the port's plain versions on the host
    small = StitcherConfig(num_images=6, input_width=320, input_height=180,
                           enable_local=False)
    sgeom, _ = plan_geometry(small)
    srng = np.random.default_rng(7)
    sscene = make_scene(sgeom.layout.pano_w, sgeom.layout.pano_h, srng)
    sframes = render_views(small, sgeom, sscene)
    on_card, on_host = Stitcher(small, device=dev), Stitcher(small,
                                                             device="cpu")
    on_card.calibrate(sframes)
    on_host.calibrate(sframes)
    d_small = max_abs_u8(on_card.stitch(sframes), on_host.stitch(sframes))
    check(d_small <= MAX_ABS_U8,
          f"6x320x180 pano: card within {d_small} of the host plain path")

    # ---- K1 against its plain version at the main path's shapes --------
    log("phase K1 vs plain")
    maps, dead = edited_maps(st.state.fused_maps, geom.src_h, geom.src_w)
    k1_err = resolve_metrics["interpolate_k1_max_abs"]
    src_u8 = torch.as_tensor(frames, device=dev).permute(0, 3, 1, 2
                                                         ).contiguous()
    from video_stitcher_tpu_torch.ops.color import nv12_to_rgb_planar
    src_f32 = nv12_to_rgb_planar(torch.as_tensor(nv12, device=dev)
                                 ).contiguous()
    gains = st.state.gains
    src_b = torch.cat([src_u8, torch.as_tensor(
        frames2, device=dev).permute(0, 3, 1, 2)]).contiguous()
    gains_b = gains.repeat(2)
    stretched = stretched_maps(maps, geom.src_h, geom.src_w)
    plans = {"edited": plan_remap(maps, geom.src_h, geom.src_w),
             "stretched": plan_remap(stretched, geom.src_h, geom.src_w)}
    log(f"  K1 tile plans: calibrated {st.plan.counts()}, edited "
        f"{plans['edited'].counts()}, stretched "
        f"{plans['stretched'].counts()}")
    for name, s, m, g, p in (
            ("u8 source", src_u8, maps, gains, plans["edited"]),
            ("f32 source", src_f32, maps, gains, plans["edited"]),
            ("calibrated maps", src_u8, st.state.fused_maps, gains, st.plan),
            ("batched N=12 n_maps=6", src_b, maps, gains_b,
             plans["edited"]),
            ("stretched maps", src_u8, stretched, gains,
             plans["stretched"]),
            ("stretched maps, plan built by K1", src_u8, stretched, gains,
             None)):
        got = remap_strips(s, m, g, p)
        want = remap_strips_plain(s, m, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k1_err = max(k1_err, err)
        check(got.shape == want.shape and err <= K1_ATOL,
              f"K1 {name} {tuple(got.shape)}: max abs {err:.3g} "
              f"<= {K1_ATOL}")
    zeros = remap_strips(src_u8, maps, gains, plans["edited"])[
        :, :, dead[0], dead[1]]
    check(float(zeros.abs().max()) == 0.0, "K1 -1 region is exactly 0")

    # ---- times -----------------------------------------------------------
    log(f"phase times (median of {REPS})")
    fused = st.state.fused_maps
    frames_dev = torch.as_tensor(frames, device=dev)
    stitch_out_ms = sync_ms(lambda: st.stitch_out(frames_dev, device=True))
    stitch_out_host_ms = sync_ms(lambda: st.stitch_out(frames))
    k1_ms = kernel_ms(lambda: remap_strips(src_u8, fused, gains, st.plan))
    k1_call_ms = event_ms(lambda: remap_strips(src_u8, fused, gains,
                                               st.plan))
    plain_ms = event_ms(lambda: remap_strips_plain(src_u8, fused, gains),
                        reps=REPS)
    # the library call computing K1's function: grid_sample (bilinear,
    # zero padding, align_corners so -1..size-1 spans the pixel centres)
    src_lib = src_u8.float()
    bw, bh = fused.shape[3], fused.shape[2]
    grid = torch.stack([fused[:, 0] * (2.0 / (geom.src_w - 1)) - 1.0,
                        fused[:, 1] * (2.0 / (geom.src_h - 1)) - 1.0],
                       dim=-1).contiguous()

    def library():
        out = torch.nn.functional.grid_sample(
            src_lib, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        return torch.clamp(out * gains[:, None, None, None], 0.0, 255.0)
    lib_ms = kernel_ms(library)
    lib_err = float((library() - remap_strips(src_u8, fused, gains, st.plan)
                     ).abs().max())
    k1_bound, k1_by, nbytes = warp_bound_ms(
        st.plan, *tap_origins(fused, geom.src_h, geom.src_w), src_u8,
        src_u8.shape[0], bh, bw, extra_bytes=gains.numel() * 4)
    # where stitch_out's time goes, stage by stage (frames on the card)
    oh, ow = st._out_size(geom)
    pano_f32 = blend_f32(bands, st.state, geom)
    stages = {
        "warp (permute + K1)": event_ms(
            lambda: warp_bands(frames_dev, st.state, geom, st.plan)),
        "blend (pyramids + placement)": event_ms(
            lambda: blend_f32(bands, st.state, geom)),
        "resize + u8 pack": event_ms(
            lambda: _pack_u8_hwc(resize_planar(pano_f32, oh, ow))),
    }
    for name, ms in stages.items():
        log(f"  stage {name}: {ms:.4f} ms")
    busy, kernels_per_frame, top = device_profile(
        lambda: st.stitch_out(frames_dev, device=True))
    if busy > 0:
        log(f"  stitch_out under torch.profiler: card busy {busy:.4f} of "
            f"the wall time, {kernels_per_frame:.1f} kernels per frame")
    else:
        log("  stitch_out under torch.profiler: no device time seen, "
            "busy share not measured")
    for key, ms, count in top:
        log(f"    {ms:.4f} ms/frame in {count} x {key}")
    log(f"  stitch_out per frame {stitch_out_ms:.4f} ms (frames on the "
        f"card), {stitch_out_host_ms:.4f} ms (host numpy in and out)")
    log(f"  K1 {k1_ms:.4f} ms on the card alone ({k1_call_ms:.4f} ms per "
        f"call), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms on the "
        f"card alone (max abs vs K1 {lib_err:.3g}); bound {k1_bound:.4f} "
        f"ms by {k1_by} ({nbytes} bytes); calibrate {calib_s:.3f} s")
    blend_at.append(("results and times", blend_snap()))
    blend_entries, blend_metrics = blend_phase(st, frames, dev)
    blend_at.append(("blend", blend_snap()))
    helper_metrics = helpers_phase(st, frames, nv12, pano_f32, dev)
    entry_launches, entry_k1_err, entry_metrics = entries_phase(cfg, frames,
                                                                dev)
    blend_at.append(("entries", blend_snap()))
    shard_launches, shard_k1_err, shard_metrics = shard_phase(
        st, cfg, frames, frames2, dev)
    blend_at.append(("shard", blend_snap()))
    int16_launches, int16_metrics = int16_phase(st, frames, scene, valid,
                                                dev)
    k2_entry, k2_metrics = k2_phase(st, frames, scene, valid, dev)
    blend_at.append(("int16 and K2", blend_snap()))
    pw_metrics, pw_entry, st4, nv12_4, frames4 = prewarp_phase(cfg4, dev,
                                                               small4)
    blend_at.append(("prewarp", blend_snap()))
    graph_metrics = graph_phase(st, cfg, frames, nv12, st4, frames4, nv12_4,
                                dev)
    del frames4
    blend_at.append(("graph", blend_snap()))
    prog_launches, prog_metrics = programs_phase(st, cfg, frames, frames2,
                                                 nv12, dev)
    blend_at.append(("programs", blend_snap()))
    # every capture from here on: the thread it ran on
    from video_stitcher_tpu_torch.pipeline.step_graph import Program
    capture, threads_seen = Program.capture, []

    def watched(self, *inputs):
        threads_seen.append((threading.current_thread().name, self.name))
        return capture(self, *inputs)
    Program.capture = watched
    try:
        runner_launches, runner_metrics = runner_phase(
            st, cfg, frames, frames2, st4, nv12_4)
        blend_at.append(("runner", blend_snap()))
        live_launches, live_metrics = live_phase(st, cfg, frames, frames2)
        blend_at.append(("live", blend_snap()))
    finally:
        Program.capture = capture
    off_main = [t for t in threads_seen if t[0] != "MainThread"]
    log(f"  captures in the Runner phases: {len(threads_seen)}, "
        f"{threads_seen[:8]}")
    check(not off_main, f"no capture ran on a Runner thread (the re-solve "
          f"thread's included): {off_main}")
    for name, s in (("default", st), ("config 4", st4)):
        caps = all_captures(s)
        log(f"  {name} captures per key after the Runner phases: {caps}")
        check(set(caps.values()) == {1}, f"{name}: each key captured once "
              f"through every Runner phase, swaps and re-solves included")
    log(json.dumps({"metrics": {
        "card": card, "calibrate_s": calib_s,
        "stitch_out_ms": stitch_out_ms,
        "stitch_out_host_ms": stitch_out_host_ms,
        "psnr_stitch_db": p_rgb, "psnr_stitch_nv12_db": p_nv12,
        "psnr_stitch_nv12_luma_db": p_nv12_y,
        "bf16_vs_f32_blend_db": p16, "bf16_vs_f32_blend_u8_max_abs": d16,
        "stage_ms": stages, "stitch_out_card_busy_share": busy,
        "stitch_out_kernels_per_frame": kernels_per_frame,
        "build_s": built, "k1_launches_calibrate": calib_launches,
        **local_metrics, **resolve_metrics, **k2_metrics, **pw_metrics,
        "runner": runner_metrics, "shard": shard_metrics,
        "int16": int16_metrics, "helpers": helper_metrics,
        "entries": entry_metrics, "live": live_metrics,
        "graph": graph_metrics, "programs": prog_metrics,
        "blend": blend_metrics}}))
    for i, entry in enumerate(blend_entries):
        entry["launches"] = blend_at[0][1][i]
        entry["launches_by_path"] = {
            "calibrate": blend_calib[i],
            "stitch*": sum(c[i] for c in blend_counts),
            **{name: at[i] - prev[i] for (_, prev), (name, at)
               in zip(blend_at, blend_at[1:])}}

    log(json.dumps({"kernels": [{
        "name": "K1 remap_gain", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": main_launches,
        "max_abs_err": max(k1_err, local_metrics[
            "k1_estimation_warp_max_abs"], pw_entry["max_abs_err"],
            shard_k1_err, entry_k1_err),
        "ms": k1_ms, "call_ms": k1_call_ms,
        "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
        "share": k1_bound / k1_ms, "library_ms": lib_ms,
        "tiles": st.plan.counts(),
        "launches_by_path": {"calibrate (mesh estimation warp)":
                             calib_launches, "stitch*": len(counts),
                             "prewarp": pw_entry["launches"],
                             "runner": runner_launches,
                             "shard": shard_launches,
                             "int16": int16_launches,
                             "entries": entry_launches,
                             "live": live_launches,
                             "programs": prog_launches},
        "prewarp_f32_source": pw_entry},
        k2_entry, *blend_entries]}))
    log(card)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} checks failed: {FAILED}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                      # report the phase that failed
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
