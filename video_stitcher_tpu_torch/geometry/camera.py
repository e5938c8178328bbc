"""Fixed-rig camera model.

Mirrors calibrateCameras (360_stitcher/calibration.cpp:28-68): N cameras on a
ring, camera i rotated by yaw_i = 2*pi*i/N about the y axis, focal length from
a 90-degree horizontal FoV (f = (W/2) / tan(fov/2)), principal point at the
image center — all expressed at "work" scale like the reference, then
re-scaled for seam / compose resolutions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List

import numpy as np


@dataclass(frozen=True)
class CameraParams:
    focal: float
    ppx: float
    ppy: float
    yaw: float          # rotation about y axis (radians)
    aspect: float = 1.0

    @property
    def K(self) -> np.ndarray:
        return np.array([
            [self.focal, 0.0, self.ppx],
            [0.0, self.focal * self.aspect, self.ppy],
            [0.0, 0.0, 1.0],
        ], dtype=np.float64)

    @property
    def R(self) -> np.ndarray:
        """Ry(yaw): camera-to-world rotation (calibration.cpp:42-45)."""
        c, s = math.cos(self.yaw), math.sin(self.yaw)
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                        dtype=np.float64)

    def scaled(self, factor: float) -> "CameraParams":
        """Re-express intrinsics at another resolution scale
        (calibration.cpp:171-173 updates focal/ppx/ppy by compose_work_aspect)."""
        return replace(self, focal=self.focal * factor,
                       ppx=self.ppx * factor, ppy=self.ppy * factor)


def fixed_rig_cameras(num_images: int, width: int, height: int,
                      work_scale: float, fov_deg: float = 90.0,
                      yaws=None) -> List[CameraParams]:
    """Reference rig: ppx = W*work_scale/2, f = ppx / tan(fov/2)
    (calibration.cpp:31-32,55-63)."""
    ppx = width * work_scale / 2.0
    ppy = height * work_scale / 2.0
    focal = ppx / math.tan(math.radians(fov_deg) / 2.0)
    if yaws is None:
        yaws = [2.0 * math.pi * i / num_images for i in range(num_images)]
    elif len(yaws) != num_images:
        # a silent mismatch only surfaced later as a far-away shape
        # error (frames are asserted against cfg.num_images)
        raise ValueError(f"{len(yaws)} yaws for {num_images} cameras")
    return [CameraParams(focal=focal, ppx=ppx, ppy=ppy, yaw=float(y))
            for y in yaws]
