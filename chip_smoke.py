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
stitch_out from RGB and NV12.

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

import json
import statistics
import subprocess
import sys
import time
import traceback

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


def device_profile(fn, reps=5):
    """torch.profiler over reps calls of fn: (share of the wall time the
    card spent in kernels, kernels per call, the top kernels by device
    time). The profiler's own cost lengthens the wall time, so the share
    is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    # device-side entries only: an operator's entry repeats the device time
    # of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (busy_us / wall_us, sum(e.count for e in kernels) / reps,
            [(e.key[:60], e.self_device_time_total / reps / 1e3, e.count
              // reps) for e in top])


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
    got = pipe.warp(frames_dev)
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
    check(launches == 3, f"the prewarp path ran through K1 ({launches} "
          f"launches in 3 calls)")
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
    return metrics, entry


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
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    log("phase build")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  build seconds {time.perf_counter() - t0:.3f} per kernel "
        f"{json.dumps(built)}")
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
    counts = []

    def counted(fn, *args, **kw):
        before = remap_strips.launches
        out = fn(*args, **kw)
        counts.append(remap_strips.launches - before)
        return out

    t0 = time.perf_counter()
    st.calibrate(frames)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del st.recalibrate_mesh
    calib_launches = remap_strips.launches
    log(f"  calibrate {calib_s:.3f} s (first mesh solve "
        f"{sum(mesh_s):.3f} s), K1 launches {calib_launches}")
    check(len(mesh_s) == int(cfg.enable_local) and calib_launches == len(
        mesh_s), "calibrate solved the mesh once, its estimation warp "
        "through K1")
    panos = [counted(st.stitch, f) for f in (frames, frames2, frames)]
    panos_nv12 = [counted(st.stitch_nv12, nv12) for _ in range(2)]
    outs = [counted(st.stitch_out, f) for f in (frames, frames2)]
    batch = counted(st.stitch_batch, np.stack([frames, frames2]))
    main_launches = remap_strips.launches
    log(f"  K1 launches on the main path: {main_launches} (calibrate "
        f"{calib_launches}, per stitch* call {counts})")
    check(all(c == 1 for c in counts),
          "K1 launched exactly once per stitch* call")
    check(main_launches == len(counts) + calib_launches > 0,
          "the main path ran through K1")

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
    k2_entry, k2_metrics = k2_phase(st, frames, scene, valid, dev)
    pw_metrics, pw_entry = prewarp_phase(cfg4, dev, small4)
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
        **local_metrics, **resolve_metrics, **k2_metrics, **pw_metrics}}))

    log(json.dumps({"kernels": [{
        "name": "K1 remap_gain", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": main_launches,
        "max_abs_err": max(k1_err, local_metrics[
            "k1_estimation_warp_max_abs"], pw_entry["max_abs_err"]),
        "ms": k1_ms, "call_ms": k1_call_ms,
        "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
        "share": k1_bound / k1_ms, "library_ms": lib_ms,
        "tiles": st.plan.counts(),
        "launches_by_path": {"calibrate (mesh estimation warp)":
                             calib_launches, "stitch*": len(counts),
                             "prewarp": pw_entry["launches"]},
        "prewarp_f32_source": pw_entry},
        k2_entry]}))
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
