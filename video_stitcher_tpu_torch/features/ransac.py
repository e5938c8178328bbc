"""Batched RANSAC homography, used as an inlier filter.

Torch twin of the JAX package's ``features/ransac.py`` (the reference's
cv::findHomography(..., RANSAC), 360_stitcher/featurefinder.cpp:87; only
the inlier mask feeds the CPW solver). S hypotheses are scored at once:
4 correspondences each, the 8x9 DLT by batched SVD, reprojection inliers
counted, the first best kept.

The random draw is split from the rest: ``sample_hypotheses`` draws the
indices from a ``torch.Generator`` (the JAX package draws them with
``jax.random.categorical`` on threefry keys), and everything after it
(``ransac_from_draws``) is a function of the drawn indices, so a test can
feed both packages the same draws and a CUDA graph can take them as an
input. Nothing after the draw waits for the device: each hypothesis's
homography is the null vector of its 8x9 DLT system by cofactors (its
nine 8x8 minors, f64 determinants), not by an SVD, whose convergence
check reads the device. Degenerate input (fewer than 8 valid matches, or
none) gives a finite but meaningless result, which the caller discards.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

REPROJ_THRESH = 3.0      # OpenCV findHomography default


def sample_hypotheses(valid: torch.Tensor, num_hyp: int,
                      generator: torch.Generator) -> torch.Tensor:
    """valid bool [..., K] -> int64 [..., num_hyp, 4]: four indices per
    hypothesis, drawn with replacement with probability proportional to
    valid + 1e-6 (biased to valid points)."""
    probs = valid.to(torch.float32) + 1e-6
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, num_hyp * 4, replacement=True,
                            generator=generator)
    return idx.reshape(valid.shape[:-1] + (num_hyp, 4))


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization over the valid points of pts [B, K, 2] ->
    (normalized pts, T [B, 3, 3])."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(-1), min=1.0)                       # [B]
    mean = (pts * w[..., None]).sum(-2) / n[..., None]        # [B, 2]
    d = torch.sqrt(((pts - mean[:, None]) ** 2).sum(-1)) * w
    scale = math.sqrt(2.0) / torch.clamp(d.sum(-1) / n, min=1e-6)
    t = torch.zeros(pts.shape[0], 3, 3, dtype=torch.float32,
                    device=pts.device)
    t[:, 0, 0] = scale
    t[:, 1, 1] = scale
    t[:, 0, 2] = -scale * mean[:, 0]
    t[:, 1, 2] = -scale * mean[:, 1]
    t[:, 2, 2] = 1.0
    return (pts - mean[:, None]) * scale[:, None, None], t


def _dlt4(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """p1, p2 [..., 4, 2] -> H [..., 3, 3] of unit norm, the null vector of
    the 8x9 DLT system: h_j = (-1)^j det(A without column j), the
    generalised cross product of its rows, in f64 (its sign may differ
    from the JAX package's SVD; H is scale-free). A system of rank < 8
    gives 0."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    a = torch.cat([r1, r2], dim=-2).to(torch.float64)        # [..., 8, 9]
    minors = torch.stack([torch.cat([a[..., :j], a[..., j + 1:]], -1)
                          for j in range(9)], -3)             # [..., 9, 8, 8]
    sign = torch.ones(9, dtype=torch.float64, device=a.device)
    sign[1::2] = -1.0
    h = torch.linalg.det(minors) * sign
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                        min=1e-300)
    return h.to(torch.float32).reshape(a.shape[:-2] + (3, 3))


def _project(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """h [..., 3, 3], pts [..., K, 2] -> projected [..., K, 2]."""
    px, py = pts[..., 0], pts[..., 1]

    def row(i):
        return (h[..., i, 0, None] * px + h[..., i, 1, None] * py
                + h[..., i, 2, None])
    x, y, w = row(0), row(1), row(2)
    w = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    return torch.stack([x / w, y / w], -1)


def ransac_homography(p1: torch.Tensor, p2: torch.Tensor,
                      valid: torch.Tensor, generator: torch.Generator,
                      num_hyp: int = 256, thresh: float = REPROJ_THRESH
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """p1, p2 f32 [K, 2] or [B, K, 2] correspondences; valid bool [K] or
    [B, K]. Returns (H [.., 3, 3], inlier mask bool [.., K], inlier count
    [..]) of the first hypothesis with the most inliers."""
    single = p1.dim() == 2
    v = valid[None] if single else valid
    idx = sample_hypotheses(v, num_hyp, generator)            # [B, S, 4]
    return ransac_from_draws(p1, p2, valid, idx[0] if single else idx,
                             thresh)


def ransac_from_draws(p1: torch.Tensor, p2: torch.Tensor,
                      valid: torch.Tensor, idx: torch.Tensor,
                      thresh: float = REPROJ_THRESH
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ransac_homography after its draw: idx int64 [S, 4] or [B, S, 4],
    the hypotheses' match indices (sample_hypotheses). Launches work on
    the device and never waits for it."""
    single = p1.dim() == 2
    if single:
        p1, p2, valid, idx = p1[None], p2[None], valid[None], idx[None]
    b = p1.shape[0]
    p1n, t1 = _normalize(p1, valid)
    p2n, t2 = _normalize(p2, valid)

    rows = torch.arange(b, device=p1.device)[:, None, None]
    hyp_ok = valid[rows, idx].all(-1)
    same = torch.zeros_like(hyp_ok)
    for i in range(4):
        for j in range(i + 1, 4):
            same = same | (idx[..., i] == idx[..., j])
    hyp_ok = hyp_ok & ~same

    hs = _dlt4(p1n[rows, idx], p2n[rows, idx])                # [B, S, 3, 3]
    hyp_ok = hyp_ok & (hs.abs().amax((-2, -1)) > 0)           # rank 8
    proj = _project(hs, p1n[:, None])                         # [B, S, K, 2]
    err2 = ((proj - p2n[:, None]) ** 2).sum(-1)
    # the threshold in pixels, in normalized coordinates (isotropic)
    s2 = t2[:, 0, 0]
    inl = (err2 < ((thresh * s2) ** 2)[:, None, None]) & valid[:, None, :]
    counts = torch.where(hyp_ok, inl.sum(-1), torch.full_like(
        inl.sum(-1), -1))
    best = torch.argmax(counts, dim=-1)                       # [B]
    rb = torch.arange(b, device=p1.device)
    # solve_ex: no error check, which would read the device
    h_best = torch.linalg.solve_ex(t2, hs[rb, best] @ t1).result
    out = (h_best, inl[rb, best], counts[rb, best])
    if single:
        out = tuple(o[0] for o in out)
    return out
