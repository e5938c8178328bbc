"""Hand a calibration, and the mesh pipeline's intermediate values, across
from the JAX package.

The JAX ``CalibState``'s arrays, as numpy (``np.asarray`` of each field),
become the port's ``CalibState`` on a device, so both packages stitch from
one state. A ``.npz`` checkpoint goes across through
``Stitcher.load_calibration`` instead. Keypoints, matches and a CPW
solver's matches go across the same way, so that both packages can be fed
the same intermediate values. Like every entry of the port, each lands on
the card unless the caller names another device (the tests pass "cpu").
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from video_stitcher_tpu_torch.calib.state import CalibState, state_to
from video_stitcher_tpu_torch.features.match import Matches
from video_stitcher_tpu_torch.features.orb import Keypoints
from video_stitcher_tpu_torch.mesh.cpw import CamMatches
from video_stitcher_tpu_torch.utils.device import resolve_device


def state_from_numpy(fused_maps: np.ndarray, gains: np.ndarray,
                     weight_pyr: Sequence[np.ndarray],
                     valid_mask: np.ndarray, device=None) -> CalibState:
    """fused_maps f32 [N, 2, bh, bw], gains [N], weight_pyr f32
    [N, 1, h_l, w_l] per level, valid_mask [pano_h, pano_w] -> CalibState
    on `device`."""
    return state_to(CalibState(fused_maps=np.asarray(fused_maps),
                               gains=np.asarray(gains),
                               weight_pyr=tuple(np.asarray(w)
                                                for w in weight_pyr),
                               valid_mask=np.asarray(valid_mask)),
                    resolve_device(device))


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype), device=device)


def keypoints_from_numpy(xy, response, angle, valid, desc, device=None
                         ) -> Keypoints:
    """The JAX package's ``Keypoints`` fields as numpy -> the port's
    ``features/orb.Keypoints`` on `device`; the uint32 descriptor words
    keep their bits as int32."""
    device = resolve_device(device)
    return Keypoints(xy=_tensor(xy, np.float32, device),
                     response=_tensor(response, np.float32, device),
                     angle=_tensor(angle, np.float32, device),
                     valid=_tensor(valid, bool, device),
                     desc=_tensor(np.array(desc, np.uint32).view(np.int32),
                                  np.int32, device))


def matches_from_numpy(query, train, distance, valid, device=None
                       ) -> Matches:
    """The JAX package's ``Matches`` fields as numpy -> the port's
    ``features/match.Matches`` on `device`."""
    device = resolve_device(device)
    return Matches(query=_tensor(query, np.int32, device),
                   train=_tensor(train, np.int32, device),
                   distance=_tensor(distance, np.float32, device),
                   valid=_tensor(valid, bool, device))


def cam_matches_from_numpy(old_matches) -> List[Optional[CamMatches]]:
    """A CPW solver's ``old_matches`` (per camera: an object with p1, p2,
    dst, or None) -> the port's ``mesh/cpw.CamMatches`` list."""
    return [None if m is None else
            CamMatches(p1=np.array(m.p1, np.float32),
                       p2=np.array(m.p2, np.float32), dst=int(m.dst))
            for m in old_matches]
