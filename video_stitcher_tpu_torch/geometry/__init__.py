from video_stitcher_tpu_torch.geometry.camera import (
    CameraParams, fixed_rig_cameras,
)
from video_stitcher_tpu_torch.geometry.cylindrical import (
    cylindrical_backward_map, cylindrical_forward, detect_v_range, BandLayout,
    plan_band_layout,
)

__all__ = [
    "CameraParams", "fixed_rig_cameras",
    "cylindrical_backward_map", "cylindrical_forward", "detect_v_range",
    "BandLayout", "plan_band_layout",
]
