"""The device the port computes on, for every entry point that takes one
(``Stitcher``, ``calibrate``, ``rebuild_aux``, ``compose_fused_maps``,
``load_state``, ``mesh_to_backward_maps`` and the ``interop.py``
carry-across functions): the card unless the caller names another."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port computes on: the card unless the caller asks
    for another (the tests pass "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; "
                               "pass device='cpu' to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the index the card's tensors report, so that a tensor already
        # on this device compares equal to it
        device = torch.device("cuda", torch.cuda.current_device())
    return device
