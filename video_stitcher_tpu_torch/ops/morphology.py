"""3x3 dilation of the seam masks.

Torch twin of the JAX package's ``ops/morphology.py``: the reference's
cuda::createMorphologyFilter(MORPH_DILATE, 3x3, 1 iteration), which
inflates the seam masks before the compose-scale AND when the CPW mesh is
on (360_stitcher/calibration.cpp:209,232: "without dilation local warping
will cause black borders between seams").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> same shape: the max over each pixel's 8-neighbourhood
    and itself (replicated border)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x.reshape((-1, 1, h, w)), (1, 1, 1, 1), mode="replicate")
    out = x.reshape((-1, 1, h, w))
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, xp[..., dy:dy + h, dx:dx + w])
    return out.reshape(lead + (h, w))
