"""Content-preserving-warp (CPW) mesh least squares.

The port's own copy of the JAX package's ``mesh/cpw.py``, which uses only
numpy and scipy; tests/test_torch_mesh.py holds it to the original.

Re-implements MeshWarper's energy (360_stitcher/meshwarper.cpp:48-786),
after Liu et al. CVPR'14, over the unknown vector of 2*M*N*num_cams mesh
vertex coordinates:

* local alignment (meshwarper.cpp:596-709): for every matched feature pair
  between ring neighbors, the bilinearly-interpolated x positions must
  differ by the inter-camera panorama offset (y difference -> 0);
* global alignment (meshwarper.cpp:389-418): vertices farther than
  GLOBAL_DIST from every feature are anchored to their rest position;
* smoothness (meshwarper.cpp:421-593): each of the 8 triangles around a
  vertex must deform by a similarity transform, weighted by local color
  variance salience.

Deviations (documented):
* The reference's target x-distance is theta*f*scale with hardcoded
  theta=4.25/-0.25 for cameras 3/4 (meshwarper.cpp:620-627) — artifacts of
  OpenCV's atan2 branch-cut split of the yaw=pi camera. Our uniform band
  layout has no split, so the target is the *exact* band corner difference.
* The reference accidentally sums the x and y smoothness residuals into one
  duplicated equation (meshwarper.cpp:568-587 inserts identical rows at
  row and row+1); we keep the standard separate x/y residuals
  V1 = V2 + u*(V3-V2) + v*R90(V3-V2).
* Solved with dense normal equations (1200 unknowns) instead of Eigen
  LeastSquaresConjugateGradient — same minimizer.

Host-side (runs at ~1 Hz in the recalibration job); NumPy + scipy.sparse.

Performance: the system build is fully vectorized (no per-row Python
loops). The smoothness and global row STRUCTURE is constant for a given
mesh/band geometry — only the per-solve salience weights and the
near-feature tau mask change — so __init__ precomputes the sparse
pattern + unweighted coefficients once, and solve() just rescales and
concatenates arrays. This matters beyond speed: the recalibration thread
shares one host core with the live stitch loop, and numpy/LAPACK release
the GIL where Python row loops (the round-3 implementation; measured
0.15-0.3 s per solve, all GIL-holding) starved the stitch thread and
were starved by it (VERDICT r3: Rewarp 1.5-29.6 s under load vs 0.49 s
isolated).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import sparse

# the 8 triangles around a vertex (offsets of V1, V3 relative to the vertex
# V2=(0,0)), in the reference's t=0..7 order (meshwarper.cpp:446-489)
_TRIANGLES = [
    ((-1, 0), (-1, -1)), ((0, -1), (-1, -1)),
    ((0, -1), (1, -1)), ((1, 0), (1, -1)),
    ((-1, 0), (-1, 1)), ((0, 1), (-1, 1)),
    ((0, 1), (1, 1)), ((1, 0), (1, 1)),
]


@dataclass
class CamMatches:
    """Selected matches of camera src against dst=(src-1) mod C (band coords)."""
    p1: np.ndarray          # [K, 2] points in src band
    p2: np.ndarray          # [K, 2] points in dst band
    dst: int


@dataclass
class TemporalMatches:
    """Matches of camera cam at frame t against the same camera at t-1
    (meshwarper.cpp calcTemporalLocalTerm inputs, matched by
    featurefinder::matchFeaturesTemporal)."""
    pt: np.ndarray          # [K, 2] points in current band
    pp: np.ndarray          # [K, 2] same points in the previous frame's band


class CPWSolver:
    def __init__(self, num_images: int, mesh_w: int, mesh_h: int,
                 band_w: int, band_h: int, targets: Sequence[float],
                 alphas=(1.0, 0.01, 0.00005, 0.0), global_dist: float = 30.0,
                 recalib_thresh: float = 15.0, shrink_px: float = 0.75):
        self.C = num_images
        self.M = mesh_w
        self.N = mesh_h
        self.bw = band_w
        self.bh = band_h
        self.targets = list(targets)    # per-src-camera x target vs dst cam
        self.alphas = alphas
        self.global_dist = global_dist
        self.recalib_thresh = recalib_thresh
        self.shrink_px = shrink_px
        # feature-stability state (meshwarper.cpp:208-276)
        self.prev_avg = np.zeros(num_images * 2)
        self.old_matches: List[Optional[CamMatches]] = [None] * num_images
        # previous solved mesh, for the temporal term (meshwarper.cpp:711-786)
        self.prev_verts: Optional[np.ndarray] = None
        # constant-structure templates (see module docstring: only weights
        # change per solve)
        self._smooth_tpl = self._build_smooth_template()
        gx = self.rest_x(np.arange(self.M))      # [M]
        gy = self.rest_y(np.arange(self.N))      # [N]
        cols_x = np.array([[self._col(0, i, j, 0) for j in range(self.M)]
                           for i in range(self.N)])
        # global rows interleaved (x, y) per vertex, cam-0 columns
        self._global_cols = np.stack([cols_x, cols_x + 1],
                                     axis=-1).reshape(-1)      # [2*N*M]
        self._global_g = np.stack([np.broadcast_to(gx, (self.N, self.M)),
                                   np.broadcast_to(gy[:, None],
                                                   (self.N, self.M))],
                                  axis=-1).reshape(-1)         # [2*N*M]

    # --- rest grid ---------------------------------------------------
    def rest_x(self, j):
        return np.asarray(j, np.float64) * (self.bw - 1) / (self.M - 1)

    def rest_y(self, i):
        return np.asarray(i, np.float64) * (self.bh - 1) / (self.N - 1)

    def _col(self, cam, i, j, d):
        return 2 * (j + i * self.M + cam * self.M * self.N) + d

    # --- term builders (vectorized; each returns (cols[R,E], vals[R,E],
    # b[R]) blocks for the assembly in solve) ---------------------------
    def _bilin_grid(self, x: np.ndarray, y: np.ndarray):
        """Vectorized cell lookup: points [K] -> (l, t, u, v) arrays with
        the reference's cell convention (meshwarper.cpp:612-615: cell size
        bw/(M-1), index clamped to the last interior cell)."""
        n_, m_ = self.N, self.M
        t = np.minimum((y * (n_ - 1) / self.bh).astype(np.int64), n_ - 2)
        l = np.minimum((x * (m_ - 1) / self.bw).astype(np.int64), m_ - 2)
        cw = self.bw / (m_ - 1)
        ch = self.bh / (n_ - 1)
        return l, t, x / cw - l, y / ch - t

    def _bilin_block(self, cam, x, y, d, weight):
        """[K] points -> (cols [K,4], vals [K,4]) interpolating coordinate
        d at each point, scaled by weight ([K] or scalar)."""
        l, t, u, v = self._bilin_grid(x, y)
        c00 = self._col(cam, t, l, d)
        cols = np.stack([c00, c00 + 2, c00 + 2 * self.M,
                         c00 + 2 * self.M + 2], axis=1)
        w = np.broadcast_to(np.asarray(weight, np.float64), x.shape)
        vals = np.stack([(1 - u) * (1 - v), u * (1 - v),
                         (1 - u) * v, u * v], axis=1) * w[:, None]
        return cols, vals

    def _local_block(self, cam: int, m: CamMatches, a: float):
        """Local alignment (meshwarper.cpp:596-709): 2 rows per in-band
        match (x and y residuals), 8 entries each (4 src + 4 dst)."""
        x1, y1 = m.p1[:, 0].astype(np.float64), m.p1[:, 1].astype(np.float64)
        x2, y2 = m.p2[:, 0].astype(np.float64), m.p2[:, 1].astype(np.float64)
        ok = ((x1 >= 0) & (x1 < self.bw) & (y1 >= 0) & (y1 < self.bh)
              & (x2 >= 0) & (x2 < self.bw) & (y2 >= 0) & (y2 < self.bh))
        x1, y1, x2, y2 = x1[ok], y1[ok], x2[ok], y2[ok]
        k = len(x1)
        if k == 0:
            return None
        c1, v1 = self._bilin_block(cam, x1, y1, 0, a)
        c2, v2 = self._bilin_block(m.dst, x2, y2, 0, -a)
        cols0 = np.concatenate([c1, c2], axis=1)          # [K, 8] (d=0)
        vals = np.concatenate([v1, v2], axis=1)           # same for d=1
        cols = np.concatenate([cols0, cols0 + 1], axis=0)  # x rows, y rows
        vals = np.concatenate([vals, vals], axis=0)
        b = np.concatenate([np.full(k, self.targets[cam] * a), np.zeros(k)])
        return cols, vals, b

    def _global_block(self, cam: int, pts: np.ndarray, a: float):
        """Global alignment (meshwarper.cpp:389-418): identity anchor with
        tau=0 within global_dist of any feature. Structure precomputed;
        only tau changes per solve."""
        n_, m_ = self.N, self.M
        if len(pts):
            gx = self.rest_x(np.arange(m_))
            gy = self.rest_y(np.arange(n_))
            dx = gx[None, :, None] - pts[None, None, :, 0]
            dy = gy[:, None, None] - pts[None, None, :, 1]
            near = np.any(np.hypot(dx, dy) < self.global_dist, axis=-1)
            tau = (~near).astype(np.float64)
        else:
            tau = np.ones((n_, m_))
        t2 = np.repeat(tau.reshape(-1), 2)                 # (x, y) per vertex
        cols = (self._global_cols + self._col(cam, 0, 0, 0))[:, None]
        return cols, (a * t2)[:, None], a * t2 * self._global_g

    def _salience(self, band_img: np.ndarray) -> np.ndarray:
        """Per-quad, per-half-triangle salience [N-1, M-1, 4]:
        sqrt(||per-channel variance||_2 + 0.5) (meanStdDev over the triangle,
        meshwarper.cpp:543-564)."""
        c, h, w = band_img.shape
        qn, qm = self.N - 1, self.M - 1
        ch = h // qn
        cw = w // qm
        img = band_img[:, :qn * ch, :qm * cw].reshape(c, qn, ch, qm, cw)
        yy, xx = np.mgrid[0:ch, 0:cw]
        fy = (yy + 0.5) / ch
        fx = (xx + 0.5) / cw
        # 4 half-quads: diag tl-br upper/lower, diag tr-bl upper/lower
        masks = np.stack([
            fy <= fx, fy >= fx,            # cut along tl->br
            fy <= 1 - fx, fy >= 1 - fx,    # cut along tr->bl
        ]).astype(np.float64)              # [4, ch, cw]
        cnt = masks.sum(axis=(1, 2))       # [4]
        s1 = np.einsum("cyhxw,thw->cyxt", img, masks)
        s2 = np.einsum("cyhxw,thw->cyxt", img.astype(np.float64) ** 2, masks)
        mean = s1 / cnt
        var = np.maximum(s2 / cnt - mean ** 2, 0.0)      # [c, qn, qm, 4]
        return np.sqrt(np.sqrt((var ** 2).sum(axis=0)) + 0.5)

    def _build_smooth_template(self):
        """Smoothness structure (meshwarper.cpp:421-593) for cam 0, built
        ONCE: the (cols, unweighted coeffs) of both residual rows per
        valid (vertex, triangle), plus the flat index into the per-quad
        salience grid that scales each row. Per solve, per cam:
        data = coeffs * (a * sal.flat[sal_idx]); cols += cam offset.
        ~1600 rows of pure-Python loop here — runs once, not per solve."""
        n_, m_ = self.N, self.M
        cw = (self.bw - 1) / (m_ - 1)
        ch = (self.bh - 1) / (n_ - 1)
        cols_list, vals_list, sal_idx = [], [], []
        for i in range(n_):
            for j in range(m_):
                for t, (o1, o3) in enumerate(_TRIANGLES):
                    p1 = (j + o1[0], i + o1[1])
                    p3 = (j + o3[0], i + o3[1])
                    if not (0 <= p1[0] < m_ and 0 <= p1[1] < n_
                            and 0 <= p3[0] < m_ and 0 <= p3[1] < n_):
                        continue
                    v1 = np.array([p1[0] * cw, p1[1] * ch])
                    v2 = np.array([j * cw, i * ch])
                    v3 = np.array([p3[0] * cw, p3[1] * ch])
                    # local-frame coords of V1 in the (V3-V2, R90(V3-V2))
                    # basis with R90(x,y)=(y,-x); exact-zero residual at the
                    # rest grid by construction
                    ex, ey = v3[0] - v2[0], v3[1] - v2[1]
                    dx_, dy_ = v1[0] - v2[0], v1[1] - v2[1]
                    l2 = ex * ex + ey * ey
                    u = (dx_ * ex + dy_ * ey) / l2
                    v = (dx_ * ey - dy_ * ex) / l2
                    # salience lookup: quad containing the triangle
                    qj = min(j, p1[0], p3[0])
                    qi = min(i, p1[1], p3[1])
                    qj = min(max(qj, 0), m_ - 2)
                    qi = min(max(qi, 0), n_ - 2)
                    diag_tlbr = (p3[0] - j) * (p3[1] - i) > 0
                    half = 0 if t in (1, 2, 4, 7) else 1
                    k4 = (0 if diag_tlbr else 2) + half
                    flat = (qi * (m_ - 1) + qj) * 4 + k4
                    c1x = self._col(0, p1[1], p1[0], 0)
                    c1y = self._col(0, p1[1], p1[0], 1)
                    c2x = self._col(0, i, j, 0)
                    c2y = self._col(0, i, j, 1)
                    c3x = self._col(0, p3[1], p3[0], 0)
                    c3y = self._col(0, p3[1], p3[0], 1)
                    # x residual: V1x - V2x - u(V3x-V2x) - v(V3y-V2y)
                    cols_list.append([c1x, c2x, c2y, c3x, c3y])
                    vals_list.append([1.0, u - 1, v, -u, -v])
                    sal_idx.append(flat)
                    # y residual: V1y - V2y - u(V3y-V2y) + v(V3x-V2x)
                    cols_list.append([c1y, c2y, c2x, c3x, c3y])
                    vals_list.append([1.0, u - 1, -v, v, -u])
                    sal_idx.append(flat)
        return (np.asarray(cols_list, np.int64),
                np.asarray(vals_list, np.float64),
                np.asarray(sal_idx, np.int64))

    def _smooth_block(self, cam: int, sal: np.ndarray, a: float):
        """Per-cam smoothness rows from the precomputed template."""
        cols, vals, sal_idx = self._smooth_tpl
        w = a * np.asarray(sal, np.float64).reshape(-1)[sal_idx]
        off = self._col(cam, 0, 0, 0)
        return (cols + off, vals * w[:, None],
                np.zeros(len(sal_idx)))

    def _eval_mesh(self, verts: np.ndarray, cam: int, x: np.ndarray,
                   y: np.ndarray):
        """Bilinearly interpolate solved vertex positions at band points
        [K] -> [K, 2] (x, y)."""
        l, t, u, v = self._bilin_grid(np.asarray(x, np.float64),
                                      np.asarray(y, np.float64))
        u, v = u[:, None], v[:, None]
        return (verts[cam, t, l] * (1 - u) * (1 - v)
                + verts[cam, t, l + 1] * u * (1 - v)
                + verts[cam, t + 1, l] * (1 - u) * v
                + verts[cam, t + 1, l + 1] * u * v).astype(np.float64)

    def _temporal_block(self, cam: int, tm: "TemporalMatches",
                        prev_verts: np.ndarray, a: float):
        """Temporal local alignment (meshwarper.cpp:711-786): the current
        mesh must move each tracked feature to where the *previous* solved
        mesh put its match — damping frame-to-frame mesh jitter."""
        xt = tm.pt[:, 0].astype(np.float64)
        yt = tm.pt[:, 1].astype(np.float64)
        xp = tm.pp[:, 0].astype(np.float64)
        yp = tm.pp[:, 1].astype(np.float64)
        ok = ((xt >= 0) & (xt < self.bw) & (yt >= 0) & (yt < self.bh)
              & (xp >= 0) & (xp < self.bw) & (yp >= 0) & (yp < self.bh))
        xt, yt, xp, yp = xt[ok], yt[ok], xp[ok], yp[ok]
        if len(xt) == 0:
            return None
        target = self._eval_mesh(prev_verts, cam, xp, yp)      # [K, 2]
        cols0, vals = self._bilin_block(cam, xt, yt, 0, a)
        cols = np.concatenate([cols0, cols0 + 1], axis=0)
        return (cols, np.concatenate([vals, vals], axis=0),
                a * np.concatenate([target[:, 0], target[:, 1]]))

    # --- stability reuse (meshwarper.cpp:208-276) ----------------------
    def _stability_filter(self, matches: List[Optional[CamMatches]]):
        c = self.C
        fp_avg = np.zeros(c * 2)
        fp_cnt = np.zeros(c * 2)
        for idx in range(c):
            m = matches[idx]
            if m is None or len(m.p1) == 0:
                continue
            fp_avg[idx * 2] = m.p1[:, 0].sum()
            fp_cnt[idx * 2] = len(m.p1)
            fp_avg[m.dst * 2 + 1] = m.p2[:, 0].sum()
            fp_cnt[m.dst * 2 + 1] = len(m.p2)
        fp_avg = np.where(fp_cnt > 0, fp_avg / np.maximum(fp_cnt, 1), 0.0)

        use_old = np.zeros(c, bool)
        if any(m is not None for m in self.old_matches):
            for idx in range(c):
                idx2 = (idx - 1) % c
                avg = abs(fp_avg[idx * 2] - fp_avg[idx2 * 2 + 1])
                avg_prev = abs(self.prev_avg[idx * 2] - self.prev_avg[idx2 * 2 + 1])
                found = fp_avg[idx * 2] != 0 and fp_avg[idx2 * 2 + 1] != 0
                found_prev = (self.prev_avg[idx * 2] != 0
                              and self.prev_avg[idx2 * 2 + 1] != 0)
                if (abs(avg - avg_prev) < self.recalib_thresh) or \
                        (not found and found_prev):
                    use_old[idx] = True
        return fp_avg, use_old

    # --- main solve ----------------------------------------------------
    def solve(self, matches: List[Optional[CamMatches]],
              band_imgs: Optional[np.ndarray] = None,
              temporal: Optional[List[Optional["TemporalMatches"]]] = None,
              salience: Optional[np.ndarray] = None,
              ) -> np.ndarray:
        """matches[idx]: CamMatches for (src=idx, dst=idx-1 mod C) or None.
        band_imgs: f32 [C, 3, bh, bw] (for salience), OR pass precomputed
        salience [C, N-1, M-1, 4] (mesh/pipeline computes it on device so
        the full band tensor never crosses to the host).
        temporal[idx]: optional same-camera frame-(t-1) matches; only used
        when alphas[3] > 0 and a previous solve exists (defs.h ALPHAS[3]=0
        keeps this off by default, like the reference).
        Returns warped vertex positions f32 [C, N, M, 2] (x, y)."""
        if band_imgs is None and salience is None:
            raise ValueError("solve() needs band_imgs or salience")
        a_local = math.sqrt(self.alphas[0])
        a_global = math.sqrt(self.alphas[1])
        a_smooth = math.sqrt(self.alphas[2])
        a_temporal = math.sqrt(self.alphas[3]) if len(self.alphas) > 3 else 0.0

        fp_avg, use_old = self._stability_filter(matches)

        # the matches each pair actually contributes this solve
        eff = [self.old_matches[i] if (use_old[i] and
                                       self.old_matches[i] is not None)
               else matches[i] for i in range(self.C)]

        blocks: list = []           # (cols [R,E], vals [R,E], b [R])
        for cam in range(self.C):
            m = eff[cam]
            if m is not None and len(m.p1):
                blk = self._local_block(cam, m, a_local)
                if blk is not None:
                    blocks.append(blk)
            # global-anchor exemption points: this pair's p1 (the
            # reference's selected_points, meshwarper.cpp:185-193) PLUS
            # the neighboring pair's p2 landing in THIS camera's band —
            # deviation: the local term pulls camera dst at p2
            # (meshwarper.cpp:596-709 both-endpoint rows), so anchoring
            # those same vertices to rest fought the pull whenever one
            # side of a seam contributed all the matches.
            pts_parts = []
            if m is not None and len(m.p1):
                pts_parts.append(m.p1)
            m_next = eff[(cam + 1) % self.C]
            if (m_next is not None and len(m_next.p1)
                    and m_next.dst == cam):
                pts_parts.append(m_next.p2)
            pts = (np.concatenate(pts_parts)
                   if pts_parts else np.zeros((0, 2)))
            blocks.append(self._global_block(cam, pts, a_global))
            sal = (salience[cam] if salience is not None
                   else self._salience(band_imgs[cam]))
            blocks.append(self._smooth_block(cam, sal, a_smooth))
            if (a_temporal > 0.0 and temporal is not None
                    and temporal[cam] is not None
                    and self.prev_verts is not None
                    and len(temporal[cam].pt)):
                blk = self._temporal_block(cam, temporal[cam],
                                           self.prev_verts, a_temporal)
                if blk is not None:
                    blocks.append(blk)

        # update stability state (meshwarper.cpp:313-334). Deviation:
        # the reference refreshes the NEIGHBOR pair's retained state
        # unconditionally whenever pair idx refreshes (its own "//TODO:
        # don't skip matched features" marks the spot) — clobbering a
        # stable pair's validated matches with this frame's set that
        # the recalib_thresh test just said to ignore. Here a pair's
        # state only refreshes when ITS stability test says so.
        for idx in range(self.C):
            idx2 = (idx - 1) % self.C
            if use_old[idx] and self.old_matches[idx] is not None:
                continue
            self.old_matches[idx] = matches[idx]
            self.prev_avg[idx * 2] = fp_avg[idx * 2]
            self.prev_avg[idx * 2 + 1] = fp_avg[idx * 2 + 1]
            if not (use_old[idx2] and self.old_matches[idx2] is not None):
                self.old_matches[idx2] = matches[idx2]
                self.prev_avg[idx2 * 2] = fp_avg[idx2 * 2]
                self.prev_avg[idx2 * 2 + 1] = fp_avg[idx2 * 2 + 1]

        # assembly: pure array concatenation (row order is irrelevant to
        # the normal equations), then GIL-releasing scipy/LAPACK
        nun = 2 * self.M * self.N * self.C
        row_off = 0
        di, ri, ci, bl = [], [], [], []
        for cols, vals, b in blocks:
            r, e = cols.shape
            ri.append(np.repeat(np.arange(row_off, row_off + r), e))
            ci.append(cols.reshape(-1))
            di.append(vals.reshape(-1))
            bl.append(b)
            row_off += r
        a = sparse.coo_matrix(
            (np.concatenate(di), (np.concatenate(ri), np.concatenate(ci))),
            shape=(row_off, nun)).tocsr()
        bvec = np.concatenate(bl)
        ata = (a.T @ a).toarray()
        ata.flat[::nun + 1] += 1e-9
        atb = a.T @ bvec
        x = np.linalg.solve(ata, atb)

        # unknown layout is (cam, i, j, d) row-major (see _col)
        verts = x.reshape(self.C, self.N, self.M, 2).astype(np.float32)

        # soft-shrink vertex displacements toward the rest grid: feature
        # localization is ~0.2-0.5 px even with sub-pixel refinement, and a
        # sub-pixel mesh warp of sharp texture costs ~2-3 dB PSNR while
        # correcting nothing; real parallax displacements (>~2 px) pass
        # through nearly untouched (no reference equivalent — the reference
        # simply ships the jitter)
        if self.shrink_px > 0.0:
            g = np.zeros_like(verts)
            g[..., 0] = self.rest_x(np.arange(self.M))[None, None, :]
            g[..., 1] = self.rest_y(np.arange(self.N))[None, :, None]
            disp = verts - g
            mag = np.hypot(disp[..., 0], disp[..., 1])
            scale = np.maximum(0.0, 1.0 - self.shrink_px / np.maximum(mag, 1e-9))
            verts = (g + disp * scale[..., None]).astype(np.float32)

        self.prev_verts = verts
        return verts
