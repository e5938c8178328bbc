"""The comparison that decides ``correct``.

Each number is held to a limit of its cell's file
(``stitchbench/workloads/<cell>.json``, ``limits``):

* ``frame_rms``: for a sample of the window's output frames drawn from
  the seed, the root mean square difference (u8 levels) between the frame
  the Runner delivered and the plain reference's frame
  (``stitchbench/reference.py``) of the same frame set, computed through
  the backward maps of the very state the program's step read for that
  frame, and the calibration's gains and seam weights; the worst frame.
  A sampled frame that never came reads infinity.
* ``mesh_px``: for every CPW mesh in use (the first solve of calibrate
  and each one a re-solve installed), the mean distance in panorama
  pixels, over the overlaps of neighbouring cameras, between the scene
  points the two cameras' backward maps bring to the same panorama pixel,
  from the scene's own geometry (``stitchbench/scene.py``); the worst
  mesh's.
* ``mesh_left``: that worst distance as a share of the same distance
  under the calibration's global-only maps (the misalignment the planted
  displacement makes). A mesh solve that did nothing leaves 1.
* ``gain_err``: the calibration's gains against the reference's own gain
  solve over the same frame set (``reference.ring_gains``).
* ``seam_err``: the calibration's seam weights against what the
  symmetric ring fixes (``seam_err`` below).
* ``frames_missing``: frame sets handed out in the window whose output
  never came (limit 0).

The seam placement, within those properties, is a choice of the
calibration and is followed, not worked out again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from stitchbench import reference as ref
from stitchbench.scene import Rig, truth_theta_h


def frame_rms(got, want: torch.Tensor) -> float:
    """RMS difference of two u8 frames [h, w, 3] (inf when the shapes
    differ)."""
    got = torch.as_tensor(got)
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = got.to(want.device, torch.float64) - want.to(torch.float64)
    return float(torch.sqrt(torch.mean(d * d)))


def out_size(cfg: dict, lay: ref.Layout) -> Tuple[int, int]:
    """The output frame's size (360_stitcher/timed.cpp:254-292): the
    configured width, and the panorama's aspect with keep_aspect_ratio."""
    w = cfg["output_width"]
    if cfg["keep_aspect_ratio"]:
        h = min(int(w / lay.pano_w * lay.pano_h + 0.5), cfg["output_height"])
    else:
        h = cfg["output_height"]
    return h, w


def mesh_px(maps: torch.Tensor, rig: Rig, lay: ref.Layout,
            step: int = 4) -> float:
    """Mean misalignment (panorama px) between neighbouring cameras over
    their overlaps, for backward maps f32 [n, 2, bh, bw]."""
    pw = lay.pano_w
    scale = pw / (2 * math.pi)
    dev = maps.device
    rows = torch.arange(0, lay.band_h, step, device=dev)
    total, count = 0.0, 0
    for i in range(rig.n):
        j = (i - 1) % rig.n
        ci = lay.columns(i, 0, dev)[::step]
        xj = (ci - lay.corners[j]) % pw
        inside = xj < lay.band_w
        xi = torch.arange(0, lay.band_w, step, device=dev)[inside]
        xj = xj[inside]
        if xi.numel() == 0:
            continue
        mi = maps[i][:, rows][:, :, xi].to(torch.float64)
        mj = maps[j][:, rows][:, :, xj].to(torch.float64)

        def ok(m):
            return ((m[0] >= 0) & (m[0] <= rig.w - 1) & (m[1] >= 0)
                    & (m[1] <= rig.h - 1))
        valid = ok(mi) & ok(mj)
        if not bool(valid.any()):
            continue
        ti, hi = truth_theta_h(rig, i, mi[0][valid], mi[1][valid])
        tj, hj = truth_theta_h(rig, j, mj[0][valid], mj[1][valid])
        dt = torch.remainder(ti - tj + math.pi, 2 * math.pi) - math.pi
        d = scale * torch.hypot(dt, hi - hj)
        total += float(d.sum())
        count += int(d.numel())
    return total / count if count else math.inf


def gain_err(gains: torch.Tensor, ref_gains: torch.Tensor) -> float:
    """The largest relative gap between the calibration's gains and the
    reference's own (``reference.ring_gains``)."""
    g = gains.double().cpu()
    return float((g / ref_gains.cpu() - 1).abs().max())


def seam_err(weights0: torch.Tensor, maps: torch.Tensor, rig: Rig,
             lay: ref.Layout) -> float:
    """How far the seam weights f [n, bh, bw] are from splitting the
    panorama the ring covers (each pixel some camera's backward map
    `maps` brings inside its frame) into one share a camera: the largest
    of the share of covered pixels with no weight (the weights' sum under
    0.5), the share owned by two cameras or more (weight over 0.5 each),
    and the largest relative gap of a camera's share from the mean (the
    ring is symmetric, so a Voronoi seam gives each camera the same)."""
    w = weights0.to(torch.float64)
    m = maps.to(torch.float64)
    inside = ((m[:, 0] >= 0) & (m[:, 0] <= rig.w - 1) & (m[:, 1] >= 0)
              & (m[:, 1] <= rig.h - 1)).to(torch.float64)
    covered = ref.place(inside[:, None], lay, 0)[0] > 0
    total = ref.place(w[:, None], lay, 0)[0]
    owners = ref.place((w > 0.5).to(torch.float64)[:, None], lay, 0)[0]
    n_cov = float(covered.sum())
    gap = float((covered & (total < 0.5)).sum()) / n_cov
    double = float((covered & (owners >= 2)).sum()) / n_cov
    inv = torch.where(total > 0, 1.0 / total.clamp(min=1e-12),
                      torch.zeros_like(total))
    share = torch.stack([(w[i] * ref.crop(inv, lay, i, 0)).sum()
                         for i in range(w.shape[0])])
    balance = float((share / share.mean() - 1).abs().max())
    return max(gap, double, balance)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[list]]:
    """(correct, [[name, number, limit], ...]): each number at or under
    its limit (a missing number fails)."""
    checks = [[k, numbers.get(k, math.inf), limits[k]] for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
