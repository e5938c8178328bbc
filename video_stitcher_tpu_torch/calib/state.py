"""Calibration state: every tensor the per-frame stitch reads.

Torch twin of the JAX package's ``calib/state.py``. The checkpoint is the
same ``.npz`` format, so either package loads the other's; the TPU
strip-plan fields that older JAX checkpoints carry are ignored (the CUDA
warp reads ``fused_maps`` directly).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from video_stitcher_tpu_torch.utils.device import resolve_device


class CalibState(NamedTuple):
    #: f32 [N, 2, bandH, bandW] — fused backward maps (warp-source px per
    #: band output px): compose-resize ∘ global warp [∘ CPW mesh].
    fused_maps: torch.Tensor
    #: f32 [N] — per-camera gains (exposure_compensate.cpp:125-150).
    gains: torch.Tensor
    #: tuple of f32 [N, 1, h_l, w_l] — pre-normalized weight pyramids.
    weight_pyr: Tuple[torch.Tensor, ...]
    #: f32 [pano_h, pano_w] — 1 where any camera contributes.
    valid_mask: torch.Tensor


def state_to(state: CalibState, device) -> CalibState:
    """The state's tensors as contiguous f32 on `device`."""
    def put(x):
        if isinstance(x, np.ndarray):        # copy: numpy views may be
            x = torch.from_numpy(np.array(x, np.float32))   # read-only
        return x.to(device=device, dtype=torch.float32).contiguous()
    return CalibState(fused_maps=put(state.fused_maps),
                      gains=put(state.gains),
                      weight_pyr=tuple(put(w) for w in state.weight_pyr),
                      valid_mask=put(state.valid_mask))


def save_state(path: str, state: CalibState, extra: dict | None = None
               ) -> None:
    def host(x):
        return x.detach().cpu().numpy()
    data = {
        "fused_maps": host(state.fused_maps),
        "gains": host(state.gains),
        "valid_mask": host(state.valid_mask),
        "n_levels": np.int64(len(state.weight_pyr)),
    }
    for i, w in enumerate(state.weight_pyr):
        data[f"weight_pyr_{i}"] = host(w)
    if extra:
        for k, v in extra.items():
            data["extra_" + k] = v
    np.savez_compressed(path, **data)


def load_state(path: str, device=None) -> CalibState:
    """A checkpoint written by either package's save_state -> CalibState
    on `device` (the card unless the caller asks for another; raises on
    a host without CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        n = int(z["n_levels"])
        return state_to(CalibState(
            fused_maps=z["fused_maps"], gains=z["gains"],
            weight_pyr=tuple(z[f"weight_pyr_{i}"] for i in range(n)),
            valid_mask=z["valid_mask"]), device)
