"""PyTorch/CUDA port of the 360 live video stitcher.

A second package beside the JAX one (``video_stitcher_tpu``), which stays
the reference it is tested against; this package imports nothing of it.
Plain tensor code is PyTorch; each TPU kernel of the JAX package has a
CUDA kernel written for Hopper in ``csrc/`` (the per-frame warp
``remap_gain.cu``, the separable warp's vertical pass
``remap_separable.cu``), built with nvcc at first use.
"""

from video_stitcher_tpu_torch.config import StitcherConfig

__version__ = "0.1.0"

__all__ = ["StitcherConfig", "Stitcher", "__version__"]


def __getattr__(name):
    # lazy: keeps `import video_stitcher_tpu_torch` light
    if name == "Stitcher":
        from video_stitcher_tpu_torch.pipeline.stitcher import Stitcher
        return Stitcher
    raise AttributeError(name)
