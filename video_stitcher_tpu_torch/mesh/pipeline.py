"""CPW mesh recalibration: frames -> features -> matches -> solve ->
coarse backward displacement.

Torch twin of the JAX package's ``mesh/pipeline.py``, the body of the
reference's recalibrateMesh thread (360_stitcher/timed.cpp:414-463 +
MeshWarper::createMesh, meshwarper.cpp:48-335). The frames are warped
through the global maps by K1 (``ops/remap_strips.py``, gain 1: the mesh
is estimated on ungained, globally warped bands, meshwarper.cpp:64-73)
over a tile plan built once; ORB, matching, RANSAC and the salience run
on the stitcher's device, as programs (``pipeline/step_graph.py``) where
the JAX package jit-compiles them, captured ahead of the first re-solve
by ``prewarm_mesh_programs``; the rig filters, the CPW solve and the
coarse inversion run on the host.

Traced (``utils/trace``), a re-solve's host stages are spans
``resolve.warp`` (the estimation warp and the salience), ``resolve.detect``,
``resolve.match``, ``resolve.ransac`` (the draw and the inliers),
``resolve.fetch`` (the wait for the pinned downloads), ``resolve.filter``
(the rig filters and the consensus trim) and ``resolve.solve`` (the CPW
solve and the coarse inversion); each program replay is bracketed by
markers on the re-solve's stream (``resolve.<step>``, ``resolve.end``).
"""

from __future__ import annotations

import contextlib
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
from video_stitcher_tpu_torch.blend.multiband import build_weight_pyramids
from video_stitcher_tpu_torch.mesh.mesh2map import (
    full_f32_matmul, coarse_backward_disp, upsample_backward_disp,
)
from video_stitcher_tpu_torch.ops.color import rgb_to_gray_planar
from video_stitcher_tpu_torch.ops.remap import remap_planar
from video_stitcher_tpu_torch.ops.resize import device_constant
from video_stitcher_tpu_torch.pipeline.step_graph import (
    ProgramSet, clone_tree,
)
from video_stitcher_tpu_torch.ops.remap_strips import (
    plan_remap, remap_strips,
)
from video_stitcher_tpu_torch.utils import trace

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


def _triangle_masks(ch: int, cw: int):
    """The four half-triangles of a ch x cw cell: (masks f32 [ch*cw, 4],
    pixel counts f32 [4])."""
    yy, xx = np.mgrid[0:ch, 0:cw]
    fy = (yy + 0.5) / ch
    fx = (xx + 0.5) / cw
    masks_np = np.stack([
        fy <= fx, fy >= fx,
        fy <= 1 - fx, fy >= 1 - fx,
    ]).astype(np.float32)                          # [4, ch, cw]
    return (np.ascontiguousarray(masks_np.reshape(4, ch * cw).T),
            masks_np.sum(axis=(1, 2)))


def _salience_all(bands: torch.Tensor, qn: int, qm: int) -> torch.Tensor:
    """Per-quad, per-half-triangle salience of the camera batch, f32
    [C, qn, qm, 4] = sqrt(||per-channel variance||_2 + 0.5) (meanStdDev
    over the triangle, meshwarper.cpp:543-564); the masked triangle sums
    as two f32 matmuls against device constants."""
    c, ch3, h, w = bands.shape
    ch = h // qn
    cw = w // qm
    img = bands[:, :, :qn * ch, :qm * cw].reshape(c, ch3, qn, ch, qm, cw)
    m2, cnt = device_constant(_triangle_masks, (ch, cw), bands.device)
    # pre-centre by the cell mean so that s2 - mean^2 cancels among small
    # numbers
    xc = img - img.mean(dim=(3, 5), keepdim=True)
    y = xc.permute(0, 1, 2, 4, 3, 5).reshape(c * ch3 * qn * qm, ch * cw)
    with full_f32_matmul():
        s1 = (y @ m2).reshape(c, ch3, qn, qm, 4)
        s2 = ((y * y) @ m2).reshape(c, ch3, qn, qm, 4)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    return torch.sqrt(torch.sqrt((var ** 2).sum(1)) + 0.5)


NUM_HYP = 256             # RANSAC hypotheses a seam (ransac_homography's)


def _match(xy1, xy2, d1, d2, v1, v2, ratio):
    """Match set 1 against set 2 (one pair, or a batch of pairs on a
    leading axis) -> (p1, p2, valid, distance): each query point and its
    match's point."""
    m = knn_ratio_match(d1, d2, v1, v2, ratio)
    p2 = torch.gather(xy2, -2, m.train.long()[..., None].expand(
        m.train.shape + (2,)))
    return xy1, p2, m.valid, m.distance


def _match_ring(xy, desc, valid, ratio):
    """Every ring pair at once, camera idx against idx - 1 mod C."""
    return _match(xy, torch.roll(xy, 1, 0), desc, torch.roll(desc, 1, 0),
                  valid, torch.roll(valid, 1, 0), ratio)


def _inliers(p1, p2, valid, hyp):
    """RANSAC's inlier mask of the matches after its draw `hyp`."""
    return ransac.ransac_from_draws(p1, p2, valid, hyp)[1]


def _warp_stage(frames, global_maps, ones, plan, overlap_masks, geom):
    """frames -> (bands f32 [C, 3, bh, bw] through K1 with gain 1, gray
    [C, bh, bw], the detection masks: the overlap masks where a band is
    not black)."""
    from video_stitcher_tpu_torch.pipeline.stitcher import _warp_source
    bands = remap_strips(_warp_source(frames, geom), global_maps, ones,
                         plan)
    gray = rgb_to_gray_planar(bands, axis=1)
    nonblack = (bands.amax(dim=1) > 0).to(torch.float32)
    return bands, gray, overlap_masks * nonblack


def mesh_weights(weights0: torch.Tensor, mesh_maps: torch.Tensor, layout):
    """The calibration seam weights re-warped through the CPW mesh's dense
    backward maps [N, 2, bh, bw] -> (weight pyramids, valid mask), as
    build_weight_pyramids gives them (MultiBandBlender::update_mask,
    blenders.cpp:297-315)."""
    warped = torch.stack([
        remap_planar(w[None], m[0], m[1], border="constant")[0]
        for w, m in zip(weights0, mesh_maps)])
    weight_pyr, valid = build_weight_pyramids(warped, layout)
    return tuple(w.contiguous() for w in weight_pyr), valid


class _Downloads:
    """Pinned host buffers by name, reused by every re-solve: each copy
    goes on the current stream and is read after `wait`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs: dict = {}
        self.pending: list = []

    def get(self, name: str, t: torch.Tensor):
        if self.device.type != "cuda":
            self.pending.append((name, t.clone()))
            return
        buf = self.bufs.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self.bufs[name] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
        buf.copy_(t, non_blocking=True)
        self.pending.append((name, buf))

    def wait(self) -> dict:
        """{name: numpy copy} of every copy since the last wait, read
        after an event recorded on the current stream (no other stream is
        waited for)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        out = {name: t.numpy().copy() for name, t in self.pending}
        self.pending = []
        return out


class MeshPipeline:
    """The feature machinery and the CPW solver state across
    recalibrations, on the global maps' device. The estimation warp runs
    K1 over the global maps' tile plan, built once (the global maps never
    change); RANSAC draws from a generator seeded with rng_seed.

    The device stages run as programs (``pipeline/step_graph.py``), where
    the JAX package jit-compiles them: the estimation warp with gray and
    the masks; detection, one program per camera under
    ``cfg.recalib_chunked`` (launched once a camera) or all cameras at
    once; the salience; the match of one seam (chunked, once a seam) or
    of every ring pair, then after RANSAC's draw its inliers; and, with
    ``krinv`` and ``weights0`` given (the stitcher's), the fused maps of
    a solved displacement (``compose``) and under ``cfg.update_masks``
    the re-warped weights (``rebuild``). Each is a CUDA graph on the
    card, on the pipeline's own stream (``stream``), captured by
    ``prepare`` (prewarm_mesh_programs) or at its first use. The draw
    runs between the match and the inliers, outside both graphs, through
    ``ransac.sample_hypotheses`` looked up at each call: a program's
    warm-up draws nothing. The downloads are copies into pinned buffers,
    read through one event; the rig filters, the CPW solve and the
    coarse inversion run on the host."""

    def __init__(self, geom, global_fused_maps: torch.Tensor,
                 overlap_masks: torch.Tensor, cfg, rng_seed: int = 0,
                 krinv: Optional[torch.Tensor] = None,
                 weights0: Optional[torch.Tensor] = None):
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
        self.krinv = krinv
        self.weights0 = weights0
        self.solver = CPWSolver(
            num_images=geom.num_images, mesh_w=cfg.mesh_width,
            mesh_h=cfg.mesh_height, band_w=lay.band_w, band_h=lay.band_h,
            targets=band_targets(lay), alphas=cfg.alphas,
            global_dist=cfg.global_dist, recalib_thresh=cfg.recalib_thresh_px,
            shrink_px=cfg.mesh_shrink_px)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self.programs = ProgramSet(self.device, mark="resolve")
        #: the re-solve's stream (None on the CPU)
        self.stream = self.programs.stream
        self._downloads = _Downloads(self.device)
        # the chunked detection's keypoints, stacked by camera
        self._kps: Optional[Keypoints] = None
        # previous solve's keypoints, for the temporal term (alphas[3] > 0)
        self._prev_kps = None

    def on_stream(self):
        """A context that queues work on the re-solve's device and stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _detect(self, gray, masks):
        cfg = self.cfg
        return detect_and_describe(gray, masks,
                                   max_keypoints=cfg.orb_num_features,
                                   num_levels=cfg.orb_num_levels,
                                   scale_factor=cfg.orb_scale_factor)

    def _warp(self, frames):
        return _warp_stage(frames, self.global_maps, self.ones, self.plan,
                           self.overlap_masks, self.geom)

    def _salience(self, bands):
        return _salience_all(bands, self.solver.N - 1, self.solver.M - 1)

    def _match_one(self, xy1, xy2, d1, d2, v1, v2):
        return _match(xy1, xy2, d1, d2, v1, v2, self.cfg.lowe_ratio)

    def _match_all(self, xy, desc, valid):
        return _match_ring(xy, desc, valid, self.cfg.lowe_ratio)

    def _compose(self, disp):
        from video_stitcher_tpu_torch.calib.calibration import \
            compose_fused_maps_from_disp
        return compose_fused_maps_from_disp(self.krinv, disp, self.geom)

    def _rebuild(self, disp):
        lay = self.geom.layout
        return mesh_weights(self.weights0, upsample_backward_disp(
            disp, lay.band_h, lay.band_w), lay)

    def disp_shape(self):
        """The coarse displacement's shape, [C, 2, hc, wc]
        (coarse_backward_disp at its 8 px step)."""
        lay, step = self.geom.layout, 8
        return (self.geom.num_images, 2,
                max(self.solver.N, (lay.band_h - 1 + step - 1) // step + 1),
                max(self.solver.M, (lay.band_w - 1 + step - 1) // step + 1))

    def prepare(self, frames: torch.Tensor, rebuild: bool = False) -> None:
        """Build and capture every program of a re-solve of `frames`' shape
        and dtype (compose, when the pipeline has its inputs, and with
        `rebuild` the re-warped weights'), each on zeros of its inputs'
        shapes: nothing is drawn."""
        cfg, c, ps = self.cfg, self.geom.num_images, self.programs
        lay, k = self.geom.layout, cfg.orb_num_features

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        with self.on_stream():
            frames = torch.as_tensor(frames, device=self.device)[:c]
            ps.prepare(("warp",), self._warp, frames)
            ps.prepare(("salience",), self._salience,
                       zeros(c, 3, lay.band_h, lay.band_w))
            n = () if cfg.recalib_chunked else (c,)
            gray = zeros(*n, lay.band_h, lay.band_w)
            xy, ok = zeros(*n, k, 2), zeros(*n, k, dtype=torch.bool)
            desc = zeros(*n, k, 8, dtype=torch.int32)
            hyp = zeros(*n, NUM_HYP, 4, dtype=torch.int64)
            if cfg.recalib_chunked:
                ps.prepare(("detect",), self._detect, gray, gray)
                ps.prepare(("match",), self._match_one, xy, xy, desc, desc,
                           ok, ok)
                ps.prepare(("inliers",), _inliers, xy, xy, ok, hyp)
            else:
                ps.prepare(("detect all",), self._detect, gray, gray)
                ps.prepare(("match all",), self._match_all, xy, desc, ok)
                ps.prepare(("inliers all",), _inliers, xy, xy, ok, hyp)
            disp = zeros(*self.disp_shape())
            if self.krinv is not None:
                ps.prepare(("compose",), self._compose, disp)
            if rebuild and self.weights0 is not None:
                ps.prepare(("rebuild",), self._rebuild, disp)

    def warp(self, frames: torch.Tensor):
        """Frames on the pipeline's device -> (globally warped bands f32
        [C, 3, bh, bw] through K1 with no gain, gray [C, bh, bw], the
        detection masks), through the estimation warp's program: its
        outputs, which the next re-solve writes over."""
        with self.on_stream():
            return self.programs.launch(("warp",), self._warp, frames)

    def compose(self, disp_c) -> torch.Tensor:
        """The fused maps of a coarse displacement (host or device) through
        its program: a tensor of their own on the re-solve's stream."""
        with self.on_stream():
            return self.programs.launch(
                ("compose",), self._compose,
                torch.as_tensor(disp_c, device=self.device)).clone()

    def rebuild(self, disp_c):
        """(weight pyramids, valid mask) of a coarse displacement under
        cfg.update_masks, through its program: tensors of their own."""
        with self.on_stream():
            return clone_tree(self.programs.launch(
                ("rebuild",), self._rebuild,
                torch.as_tensor(disp_c, device=self.device)))

    def _stacked(self, kp: Keypoints) -> Keypoints:
        """The chunked detection's per-camera keypoints stacked by camera,
        a buffer of the pipeline's."""
        c = self.geom.num_images
        if self._kps is None:
            self._kps = Keypoints(*(torch.empty((c,) + tuple(t.shape),
                                                dtype=t.dtype,
                                                device=t.device)
                                    for t in kp))
        return self._kps

    def run(self, frames):
        """frames u8 [C, H, W, 3] or NV12 [C, H*3/2, W] (numpy or a tensor)
        -> coarse backward displacement f32 [C, 2, hc, wc] (host numpy,
        full-res pixels), or None when no seam has usable matches. The
        device stages are queued on the re-solve's stream."""
        with self.on_stream():
            return self._run(frames)

    def _run(self, frames):
        geom, cfg, ps = self.geom, self.cfg, self.programs
        c = geom.num_images
        frames = torch.as_tensor(frames, device=self.device)[:c]
        with trace.span("resolve.warp"):
            bands, gray, masks = self.warp(frames)
            sal = ps.launch(("salience",), self._salience, bands)
        fetch = self._downloads
        fetch.get("salience", sal)
        fields = ("p1", "p2", "ok", "inl", "dist")
        if cfg.recalib_chunked:
            # one camera, then one seam, at a time: one graph launch each,
            # so a live stitch loop's replays run between them
            with trace.span("resolve.detect"):
                for i in range(c):
                    kp = ps.launch(("detect",), self._detect, gray[i],
                                   masks[i])
                    kps = self._stacked(kp)
                    for dst, src in zip(kps, kp):
                        dst[i].copy_(src, non_blocking=True)
            for idx in range(c):
                a, d = idx, (idx - 1) % c
                with trace.span("resolve.match"):
                    p1, p2, ok, dist = ps.launch(
                        ("match",), self._match_one, kps.xy[a], kps.xy[d],
                        kps.desc[a], kps.desc[d], kps.valid[a],
                        kps.valid[d])
                with trace.span("resolve.ransac"):
                    hyp = ransac.sample_hypotheses(ok[None], NUM_HYP,
                                                   self.generator)[0]
                    inl = ps.launch(("inliers",), _inliers, p1, p2, ok, hyp)
                for name, t in zip(fields, (p1, p2, ok, inl, dist)):
                    fetch.get(f"{name}{idx}", t)
            if cfg.alphas[3] > 0.0:
                kps = Keypoints(*(t.clone() for t in kps))
            with trace.span("resolve.fetch"):
                host = fetch.wait()
            p1b, p2b, okb, inlb, distb = (
                [host[f"{name}{idx}"] for idx in range(c)]
                for name in fields)
        else:
            with trace.span("resolve.detect"):
                kps = ps.launch(("detect all",), self._detect, gray, masks)
            # every ring pair (idx vs idx-1 mod C) at once
            with trace.span("resolve.match"):
                p1, p2, ok, dist = ps.launch(("match all",),
                                             self._match_all, kps.xy,
                                             kps.desc, kps.valid)
            with trace.span("resolve.ransac"):
                hyp = ransac.sample_hypotheses(ok, NUM_HYP, self.generator)
                inl = ps.launch(("inliers all",), _inliers, p1, p2, ok, hyp)
            for name, t in zip(fields, (p1, p2, ok, inl, dist)):
                fetch.get(name, t)
            if cfg.alphas[3] > 0.0:
                kps = Keypoints(*(t.clone() for t in kps))
            with trace.span("resolve.fetch"):
                host = fetch.wait()
            p1b, p2b, okb, inlb, distb = (host[name] for name in fields)
        salience = host["salience"]
        with trace.span("resolve.filter"):
            matches, temporal = self._filter(p1b, p2b, okb, inlb, distb, kps)
        if matches is None:
            return None
        with trace.span("resolve.solve"):
            verts = self.solver.solve(matches, temporal=temporal,
                                      salience=salience)
            disp = coarse_backward_disp(verts, geom.layout.band_h,
                                        geom.layout.band_w)
        if cfg.visualize_matches or cfg.visualize_mesh:
            self._dump_viz(bands, matches, verts)
        return disp

    def _filter(self, p1b, p2b, okb, inlb, distb, kps):
        """The seams' matches after the rig filters and the consensus trim
        (meshwarper.cpp:930-941), and the temporal matches: (matches,
        temporal), or (None, None) when no seam has usable matches."""
        cfg, c = self.cfg, self.geom.num_images
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
            return None, None

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
        return matches, temporal

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


def mesh_pipeline(stitcher) -> MeshPipeline:
    """The stitcher's MeshPipeline, built on first use over the global maps
    of its aux, with its camera matrices (krinv) and seam weights for the
    compose and rebuild programs. Built on the re-solve's stream."""
    if stitcher._mesh_pipe is None:
        from video_stitcher_tpu_torch.calib.calibration import (
            compose_fused_maps_device, krinv_device)
        geom, aux = stitcher.geom, stitcher.aux
        global_maps = compose_fused_maps_device(aux["band_maps"], None, geom)
        stitcher._mesh_pipe = MeshPipeline(
            geom, global_maps, aux["overlap_masks"], stitcher.cfg,
            krinv=krinv_device(aux["cams_map"], stitcher.device),
            weights0=aux["weights0"])
    return stitcher._mesh_pipe


def prewarm_mesh_programs(cfg, geom, pipe: MeshPipeline,
                          frames=None) -> None:
    """Capture the re-solve's programs (MeshPipeline.prepare) ahead of the
    first re-solve, as the JAX package compiles its program set at
    calibration: on the card, every capture synchronises the device, so
    the stitcher runs this before a live Runner's threads start. `frames`
    (or their shape and dtype) key the estimation warp; by default u8 RGB
    frames of the geometry's source size, which calibrate takes. With
    cfg.update_masks the re-warped weights' program too. The pipeline
    must be the one of `geom`."""
    if pipe.geom != geom:
        raise ValueError("the mesh pipeline was built for another "
                         "geometry")
    if frames is None:
        frames = torch.zeros((geom.num_images, geom.src_h, geom.src_w, 3),
                             dtype=torch.uint8, device=pipe.device)
    pipe.prepare(frames, rebuild=cfg.update_masks)


def solve_mesh_maps(frames, stitcher):
    """Stitcher.recalibrate_mesh's entry: builds the stitcher's
    MeshPipeline on first use (mesh_pipeline), then runs it."""
    return mesh_pipeline(stitcher).run(frames)
