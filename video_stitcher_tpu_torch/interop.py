"""Hand a calibration across from the JAX package.

The JAX ``CalibState``'s arrays, as numpy (``np.asarray`` of each field),
become the port's ``CalibState`` on a device, so both packages stitch from
one state. A ``.npz`` checkpoint goes across through
``Stitcher.load_calibration`` instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from video_stitcher_tpu_torch.calib.state import CalibState, state_to


def state_from_numpy(fused_maps: np.ndarray, gains: np.ndarray,
                     weight_pyr: Sequence[np.ndarray],
                     valid_mask: np.ndarray, device="cpu") -> CalibState:
    """fused_maps f32 [N, 2, bh, bw], gains [N], weight_pyr f32
    [N, 1, h_l, w_l] per level, valid_mask [pano_h, pano_w] -> CalibState
    on `device`."""
    return state_to(CalibState(fused_maps=np.asarray(fused_maps),
                               gains=np.asarray(gains),
                               weight_pyr=tuple(np.asarray(w)
                                                for w in weight_pyr),
                               valid_mask=np.asarray(valid_mask)), device)
