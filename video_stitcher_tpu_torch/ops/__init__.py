from video_stitcher_tpu_torch.ops.remap import remap, remap_planar
from video_stitcher_tpu_torch.ops.resize import resize, resize_planar
from video_stitcher_tpu_torch.ops.pyramid import (
    pyr_down, pyr_up, gaussian_pyramid, laplacian_pyramid,
)
from video_stitcher_tpu_torch.ops import color
from video_stitcher_tpu_torch.ops.morphology import dilate3x3

__all__ = [
    "remap", "remap_planar", "resize", "resize_planar",
    "pyr_down", "pyr_up", "gaussian_pyramid", "laplacian_pyramid",
    "color", "dilate3x3",
]
