"""CPW mesh recalibration: frames -> features -> matches -> solve ->
coarse backward displacement.

Torch twin of the JAX package's ``mesh/pipeline.py``, the body of the
reference's recalibrateMesh thread (360_stitcher/timed.cpp:414-463 +
MeshWarper::createMesh, meshwarper.cpp:48-335). The frames are warped
through the global maps by K1 (``ops/remap_strips.py``, gain 1: the mesh
is estimated on ungained, globally warped bands, meshwarper.cpp:64-73)
over a tile plan built once; ORB, matching, RANSAC and the salience run
on the stitcher's device; the rig filters, the CPW solve and the coarse
inversion run on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from video_stitcher_tpu_torch.features import ransac
from video_stitcher_tpu_torch.features.match import knn_ratio_match
from video_stitcher_tpu_torch.features.orb import (
    Keypoints, detect_and_describe,
)
from video_stitcher_tpu_torch.mesh.cpw import (
    CamMatches, CPWSolver, TemporalMatches,
)
from video_stitcher_tpu_torch.mesh.mesh2map import (
    full_f32_matmul, coarse_backward_disp,
)
from video_stitcher_tpu_torch.ops.color import rgb_to_gray_planar
from video_stitcher_tpu_torch.ops.remap_strips import (
    plan_remap, remap_strips,
)

Y_DIFF_MAX = 40.0          # meshwarper.cpp:935
X_DIST_SLACK = 300.0       # meshwarper.cpp:938


def band_targets(layout) -> List[float]:
    """Per-camera expected x-distance p1.x - p2.x against dst = (cam-1) mod
    C: the exact band corner difference, wrapped to the nearest period
    (in place of theta*f*scale, meshwarper.cpp:616-628,686)."""
    c = len(layout.corners)
    out = []
    for idx in range(c):
        dst = (idx - 1) % c
        t = layout.corners[dst] - layout.corners[idx]
        if layout.wrap:
            t = (t + layout.pano_w / 2) % layout.pano_w - layout.pano_w / 2
        out.append(float(t))
    return out


def _salience_all(bands: torch.Tensor, qn: int, qm: int) -> torch.Tensor:
    """Per-quad, per-half-triangle salience of the camera batch, f32
    [C, qn, qm, 4] = sqrt(||per-channel variance||_2 + 0.5) (meanStdDev
    over the triangle, meshwarper.cpp:543-564); the masked triangle sums
    as two f32 matmuls."""
    c, ch3, h, w = bands.shape
    ch = h // qn
    cw = w // qm
    img = bands[:, :, :qn * ch, :qm * cw].reshape(c, ch3, qn, ch, qm, cw)
    yy, xx = np.mgrid[0:ch, 0:cw]
    fy = (yy + 0.5) / ch
    fx = (xx + 0.5) / cw
    masks_np = np.stack([
        fy <= fx, fy >= fx,
        fy <= 1 - fx, fy >= 1 - fx,
    ]).astype(np.float32)                          # [4, ch, cw]
    dev = bands.device
    cnt = torch.as_tensor(masks_np.sum(axis=(1, 2)), device=dev)     # [4]
    # pre-centre by the cell mean so that s2 - mean^2 cancels among small
    # numbers
    xc = img - img.mean(dim=(3, 5), keepdim=True)
    y = xc.permute(0, 1, 2, 4, 3, 5).reshape(c * ch3 * qn * qm, ch * cw)
    m2 = torch.as_tensor(masks_np.reshape(4, ch * cw).T.copy(), device=dev)
    with full_f32_matmul():
        s1 = (y @ m2).reshape(c, ch3, qn, qm, 4)
        s2 = ((y * y) @ m2).reshape(c, ch3, qn, qm, 4)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    return torch.sqrt(torch.sqrt((var ** 2).sum(1)) + 0.5)


def _match_ransac(xy1, xy2, d1, d2, v1, v2, ratio, generator):
    """Match set 1 against set 2 and RANSAC the matches (one pair, or a
    batch of pairs on a leading axis). Returns (p1, p2, valid, inliers,
    distance)."""
    m = knn_ratio_match(d1, d2, v1, v2, ratio)
    p1 = xy1
    p2 = torch.gather(xy2, -2, m.train.long()[..., None].expand(
        m.train.shape + (2,)))
    _, inl, _ = ransac.ransac_homography(p1, p2, m.valid, generator)
    return p1, p2, m.valid, inl, m.distance


class MeshPipeline:
    """The feature machinery and the CPW solver state across
    recalibrations, on the global maps' device. The estimation warp runs
    K1 over the global maps' tile plan, built once (the global maps never
    change); RANSAC draws from a generator seeded with rng_seed."""

    def __init__(self, geom, global_fused_maps: torch.Tensor,
                 overlap_masks: torch.Tensor, cfg, rng_seed: int = 0):
        lay = geom.layout
        self.geom = geom
        self.cfg = cfg
        self.device = global_fused_maps.device
        self.global_maps = global_fused_maps.contiguous()
        self.plan = plan_remap(self.global_maps, geom.warp_src_h,
                               geom.warp_src_w)
        self.ones = torch.ones(geom.num_images, dtype=torch.float32,
                               device=self.device)
        self.overlap_masks = torch.as_tensor(
            overlap_masks, dtype=torch.float32, device=self.device)
        self.solver = CPWSolver(
            num_images=geom.num_images, mesh_w=cfg.mesh_width,
            mesh_h=cfg.mesh_height, band_w=lay.band_w, band_h=lay.band_h,
            targets=band_targets(lay), alphas=cfg.alphas,
            global_dist=cfg.global_dist, recalib_thresh=cfg.recalib_thresh_px,
            shrink_px=cfg.mesh_shrink_px)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        # previous solve's keypoints, for the temporal term (alphas[3] > 0)
        self._prev_kps = None

    def _detect(self, gray, masks):
        cfg = self.cfg
        return detect_and_describe(gray, masks,
                                   max_keypoints=cfg.orb_num_features,
                                   num_levels=cfg.orb_num_levels,
                                   scale_factor=cfg.orb_scale_factor)

    def warp(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames -> globally warped bands f32 [C, 3, bh, bw], no gain,
        through K1."""
        from video_stitcher_tpu_torch.pipeline.stitcher import _warp_source
        src = _warp_source(frames, self.geom)
        return remap_strips(src, self.global_maps, self.ones, self.plan)

    def run(self, frames):
        """frames u8 [C, H, W, 3] or NV12 [C, H*3/2, W] (numpy or a tensor)
        -> coarse backward displacement f32 [C, 2, hc, wc] (host numpy,
        full-res pixels), or None when no seam has usable matches."""
        geom, cfg = self.geom, self.cfg
        c = geom.num_images
        frames = torch.as_tensor(frames, device=self.device)[:c]
        bands = self.warp(frames)
        gray = rgb_to_gray_planar(bands, axis=1)
        nonblack = (bands.amax(dim=1) > 0).to(torch.float32)
        masks = self.overlap_masks * nonblack
        qn, qm = self.solver.N - 1, self.solver.M - 1

        if cfg.recalib_chunked:
            # one camera, then one seam, at a time: in eager PyTorch each
            # op is its own launch, so a live stitch loop's launches
            # interleave between them with no gate
            kp_list = [self._detect(gray[i], masks[i]) for i in range(c)]
            kps = (Keypoints(*map(torch.stack, zip(*kp_list)))
                   if cfg.alphas[3] > 0.0 else None)
            sal = _salience_all(bands, qn, qm)
            pend = []
            for idx in range(c):
                a, d = kp_list[idx], kp_list[(idx - 1) % c]
                pend.append(_match_ransac(a.xy, d.xy, a.desc, d.desc,
                                          a.valid, d.valid, cfg.lowe_ratio,
                                          self.generator))
            host = [[t.cpu().numpy() for t in p] for p in pend]
            p1b, p2b, okb, inlb, distb = (list(x) for x in zip(*host))
        else:
            kps = self._detect(gray, masks)
            sal = _salience_all(bands, qn, qm)
            # every ring pair (idx vs idx-1 mod C) at once
            pend = _match_ransac(
                kps.xy, torch.roll(kps.xy, 1, 0), kps.desc,
                torch.roll(kps.desc, 1, 0), kps.valid,
                torch.roll(kps.valid, 1, 0), cfg.lowe_ratio, self.generator)
            p1b, p2b, okb, inlb, distb = (t.cpu().numpy() for t in pend)
        salience = sal.cpu().numpy()

        matches: List[Optional[CamMatches]] = []
        for idx in range(c):
            dst = (idx - 1) % c
            if dst == c - 1 and not cfg.wrap_around:
                matches.append(None)
                continue
            p1, p2, ok, inl, dist = (p1b[idx], p2b[idx], okb[idx],
                                     inlb[idx], distb[idx])
            ok = np.asarray(ok, bool)
            if ok.sum() >= 8:
                ok = ok & np.asarray(inl, bool)
            # rig sanity filters (meshwarper.cpp:930-941)
            target = self.solver.targets[idx]
            ydiff = np.abs(p1[:, 1] - p2[:, 1])
            xdev = np.abs(target - (p1[:, 0] - p2[:, 0]))
            ok = ok & (ydiff <= Y_DIFF_MAX) & (xdev <= X_DIST_SLACK)
            if ok.sum() == 0:
                matches.append(None)
                continue
            sel = np.where(ok)[0]
            # consensus trim on the (x, y) deviation from the rig target:
            # keep the largest mutually consistent cluster (RANSAC only
            # gates seams with >= 8 matches)
            xdev_s = (p1[sel, 0] - p2[sel, 0]) - target
            ydev_s = p1[sel, 1] - p2[sel, 1]
            tol = max(15.0, 0.02 * self.solver.bw)
            dd = (np.abs(xdev_s[:, None] - xdev_s[None, :])
                  + np.abs(ydev_s[:, None] - ydev_s[None, :]))
            support = (dd <= tol).sum(1)
            if support.max() < 2:
                # a lone match corroborates nothing
                matches.append(None)
                continue
            sel = sel[dd[np.argmax(support)] <= tol]
            order = np.argsort(dist[sel])[:cfg.max_features_per_image]
            sel = sel[order]
            matches.append(CamMatches(p1=p1[sel], p2=p2[sel], dst=dst))

        if all(m is None for m in matches):
            return None

        # temporal same-camera matches against the previous solve's
        # keypoints (featurefinder.cpp:110-170); off unless alphas[3] > 0
        temporal: List[Optional[TemporalMatches]] = [None] * c
        if cfg.alphas[3] > 0.0:
            cur = {"desc": kps.desc, "valid": kps.valid,
                   "xy": kps.xy.cpu().numpy()}
            if self._prev_kps is not None:
                pk = self._prev_kps
                for idx in range(c):
                    m = knn_ratio_match(cur["desc"][idx], pk["desc"][idx],
                                        cur["valid"][idx], pk["valid"][idx],
                                        cfg.lowe_ratio)
                    ok = m.valid.cpu().numpy()
                    if ok.sum() == 0:
                        continue
                    pt = cur["xy"][idx][m.query.cpu().numpy()[ok]]
                    pp = pk["xy"][idx][m.train.cpu().numpy()[ok]]
                    # tracked points must barely move between frames
                    near = np.hypot(*(pt - pp).T) <= Y_DIFF_MAX
                    if near.sum():
                        temporal[idx] = TemporalMatches(pt=pt[near],
                                                        pp=pp[near])
            self._prev_kps = cur

        verts = self.solver.solve(matches, temporal=temporal,
                                  salience=salience)
        if cfg.visualize_matches or cfg.visualize_mesh:
            self._dump_viz(bands, matches, verts)
        return coarse_backward_disp(verts, geom.layout.band_h,
                                    geom.layout.band_w)

    def _dump_viz(self, bands, matches, verts):
        """Write match / mesh debug images for this recalibration under
        cfg.viz_dir (VISUALIZE_MATCHES / VISUALIZE_WARPED toggles,
        defs.h:62-64 / meshwarper.cpp:159-171,788-807). Debug-only:
        downloads the bands."""
        import os
        from video_stitcher_tpu_torch.utils import viz
        cfg = self.cfg
        os.makedirs(cfg.viz_dir, exist_ok=True)
        self._viz_seq = getattr(self, "_viz_seq", -1) + 1
        imgs = bands.cpu().numpy()                # [C, 3, bh, bw]
        for i, m in enumerate(matches):
            if cfg.visualize_matches and m is not None:
                pairs = np.stack([np.arange(len(m.p1))] * 2, axis=1)
                img = viz.draw_matches(imgs[i], m.p1, imgs[m.dst], m.p2,
                                       pairs)
                viz.save(os.path.join(
                    cfg.viz_dir,
                    f"matches_{self._viz_seq:03d}_{i}to{m.dst}.png"), img)
            if cfg.visualize_mesh:
                img = viz.draw_mesh(imgs[i], verts[i])
                viz.save(os.path.join(
                    cfg.viz_dir, f"mesh_{self._viz_seq:03d}_{i}.png"), img)


def solve_mesh_maps(frames, stitcher):
    """Stitcher.recalibrate_mesh's entry: builds the stitcher's
    MeshPipeline on first use (over the global maps of its aux), then
    runs it."""
    if stitcher._mesh_pipe is None:
        from video_stitcher_tpu_torch.calib.calibration import \
            compose_fused_maps_device
        geom = stitcher.geom
        global_maps = compose_fused_maps_device(stitcher.aux["band_maps"],
                                                None, geom)
        stitcher._mesh_pipe = MeshPipeline(
            geom, global_maps, stitcher.aux["overlap_masks"], stitcher.cfg)
    return stitcher._mesh_pipe.run(frames)
