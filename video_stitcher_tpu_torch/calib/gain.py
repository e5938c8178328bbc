"""Pairwise gain compensation.

Re-implements GainCompensator::feed
(sources/modules/stitching/src/exposure_compensate.cpp:70-150): for every
image pair, count overlap pixels N(i,j) and mean pixel magnitude I(i,j) over
the mask intersection, then solve the damped linear system (alpha=0.01,
beta=100) for per-image scalar gains. Operates on full panorama-width
canvases (periodic), so ring-wrap overlaps need no special casing.

This is a calibration-time op on ~0.01 MP images; plain NumPy.
"""

from __future__ import annotations

import numpy as np


def solve_gains(images: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """images: f32 [N, H, W, 3] seam-scale warped canvases;
    masks: [N, H, W] (nonzero = valid). Returns f64 gains [N]."""
    n = images.shape[0]
    mag = np.sqrt(np.sum(images.astype(np.float64) ** 2, axis=-1))  # [N,H,W]
    valid = masks > 0

    nmat = np.zeros((n, n), np.int64)
    imat = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(i, n):
            inter = valid[i] & valid[j]
            cnt = int(inter.sum())
            nmat[i, j] = nmat[j, i] = max(1, cnt)
            if cnt:
                imat[i, j] = mag[i][inter].mean()
                imat[j, i] = mag[j][inter].mean()

    alpha, beta = 0.01, 100.0
    a = np.zeros((n, n), np.float64)
    b = np.zeros(n, np.float64)
    for i in range(n):
        for j in range(n):
            b[i] += beta * nmat[i, j]
            a[i, i] += beta * nmat[i, j]
            if j == i:
                continue
            a[i, i] += 2 * alpha * imat[i, j] ** 2 * nmat[i, j]
            a[i, j] -= 2 * alpha * imat[i, j] * imat[j, i] * nmat[i, j]
    return np.linalg.solve(a, b)
