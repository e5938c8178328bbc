"""Voronoi seam finding on panorama canvases.

Re-implements VoronoiSeamFinder::findInPair
(sources/modules/stitching/src/seam_finders.cpp:111-162): for each
overlapping pair, pixels uniquely owned by each mask seed an L1 distance
transform; contested pixels go to the nearer owner (ties to the second
image, as `dist1 < dist2` implies). We run it on full panorama-width
canvases — the pairwise ROI bookkeeping of the reference collapses to plain
array ops, and ring wraparound is handled by a periodic horizontal tiling.

Calibration-time op on ~0.01 MP masks; NumPy + scipy.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _l1_distance_to(mask_nonzero: np.ndarray, periodic_x: bool) -> np.ndarray:
    """L1 (taxicab) distance from each pixel to the nearest True pixel."""
    if not mask_nonzero.any():
        return np.full(mask_nonzero.shape, np.float64(1e12))
    src = mask_nonzero
    if periodic_x:
        src = np.concatenate([src, src, src], axis=1)
    d = ndimage.distance_transform_cdt(~src, metric="taxicab").astype(np.float64)
    if periodic_x:
        w = mask_nonzero.shape[1]
        d = d[:, w:2 * w]
    return d


def find_seams(masks: np.ndarray, periodic_x: bool = True) -> np.ndarray:
    """masks: u8 [N, H, W] canvases (255 = owned). Returns seam-carved masks.

    Pair order matches PairwiseSeamFinder::run (all i<j); non-overlapping
    pairs are no-ops exactly as in the reference.
    """
    out = masks.copy()
    n = out.shape[0]
    for i in range(n):
        for j in range(i + 1, n):
            collision = (out[i] > 0) & (out[j] > 0)
            if not collision.any():
                continue
            unique1 = (out[i] > 0) & ~collision
            unique2 = (out[j] > 0) & ~collision
            d1 = _l1_distance_to(unique1, periodic_x)
            d2 = _l1_distance_to(unique2, periodic_x)
            first_wins = d1 < d2
            # seam_finders.cpp:152-160: where first wins zero mask2, else mask1
            out[j][collision & first_wins] = 0
            out[i][collision & ~first_wins] = 0
    return out
