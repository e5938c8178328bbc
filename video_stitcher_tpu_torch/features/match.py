"""Brute-force Hamming kNN matching with Lowe's ratio test.

Torch twin of the JAX package's ``features/match.py`` (the reference's
BruteForce-Hamming knnMatch(k=2) + ratio test,
360_stitcher/featurefinder.cpp:50-68). Descriptors are int32 [..., K, 8]
(the bits of the JAX package's uint32 words). PyTorch has no popcount, so
each descriptor's bits become +-1 and the distance matrix is one matmul:
agreements minus disagreements, exact in f32 (integers up to 256).

Hamming distances are small integers, so ties are the rule. The two
nearest train descriptors are taken by the unique integer key
dist * K2 + index, i.e. lowest index first on ties, as ``lax.top_k`` orders
them in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = 1 << 30                 # distance of an invalid row or column


class Matches(NamedTuple):
    query: torch.Tensor     # i32 [..., K] index into set 1
    train: torch.Tensor     # i32 [..., K] index into set 2
    distance: torch.Tensor  # f32 [..., K]
    valid: torch.Tensor     # bool [..., K]


def _signs(d: torch.Tensor) -> torch.Tensor:
    """int32 words [..., K, W] -> f32 [..., K, 32 W]: +1 per set bit, -1
    per clear one."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    bits = (d[..., None] >> shifts) & 1
    return bits.flatten(-2).to(torch.float32) * 2.0 - 1.0


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor, valid1=None,
                   valid2=None) -> torch.Tensor:
    """d1 [..., K1, W], d2 [..., K2, W] int32 -> i32 [..., K1, K2] Hamming
    distances; invalid rows and columns get INVALID."""
    agree = torch.matmul(_signs(d1), _signs(d2).transpose(-1, -2))
    dist = ((32 * d1.shape[-1] - agree) * 0.5).round().to(torch.int32)
    big = torch.full_like(dist, INVALID)
    if valid1 is not None:
        dist = torch.where(valid1[..., :, None], dist, big)
    if valid2 is not None:
        dist = torch.where(valid2[..., None, :], dist, big)
    return dist


def knn_ratio_match(d1, d2, valid1=None, valid2=None,
                    ratio: float = 0.7) -> Matches:
    """knn(k=2) + ratio test: one candidate match per query, flagged
    invalid where the ratio test fails or either neighbour is not a real
    descriptor."""
    dist = hamming_matrix(d1, d2, valid1, valid2)
    k2 = dist.shape[-1]
    index = torch.arange(k2, dtype=torch.int64, device=dist.device)
    key = dist.to(torch.int64) * k2 + index
    top2 = torch.topk(key, 2, dim=-1, largest=False, sorted=True).values
    idx2 = top2 % k2
    d2f = torch.div(top2, k2, rounding_mode="floor").to(torch.float32)
    best, second = d2f[..., 0], d2f[..., 1]
    ok = best < ratio * second
    if valid1 is not None:
        ok = ok & valid1
    # both neighbours must be real descriptors: with the second one the
    # invalid sentinel the ratio test would pass for every query
    lim = float(1 << 29)
    ok = ok & (best < lim) & (second < lim)
    k1 = d1.shape[-2]
    query = torch.arange(k1, dtype=torch.int32, device=dist.device)
    return Matches(query=query.expand(ok.shape),
                   train=idx2[..., 0].to(torch.int32),
                   distance=best, valid=ok)
