"""Faults planted in the program, each a way its timed path or its
calibration could go wrong, to show that the comparison catches it
(``stitchbench/control.py`` on the card, ``stitchbench/tests`` on the
CPU). Each is planted before the Stitcher is made, since its programs
capture what they call.

* ``mesh_noop``: a mesh solve that does nothing (installs no mesh);
* ``half_cameras``: half of the cameras' warped bands left out of the
  blend;
* ``stale_state``: the step reads the calibration's global-only maps
  while the stitcher has installed a mesh;
* ``frame_altered``: the output frame altered where it is produced (its
  top quarter halved);
* ``gain_none``: a gain solve that returns all ones;
* ``seam_none``: no seam carved: each camera keeps all it covers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

NAMES = ("mesh_noop", "half_cameras", "stale_state", "frame_altered",
         "gain_none", "seam_none")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted ("" for none), restored on
    exit."""
    import video_stitcher_tpu_torch.calib.calibration as cal
    import video_stitcher_tpu_torch.pipeline.stitcher as sm
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "mesh_noop":
        patch(sm.Stitcher, "recalibrate_mesh", lambda self, frames: False)
    elif name == "half_cameras":
        warp = sm.warp_bands

        def half(frames, state, geom, plan=None):
            bands = warp(frames, state, geom, plan)
            keep = torch.zeros(bands.shape[0], 1, 1, 1, device=bands.device)
            keep[: bands.shape[0] // 2] = 1
            return bands * keep
        patch(sm, "warp_bands", half)
    elif name == "stale_state":
        install = sm.Stitcher._install

        def keep_global(self, geom, state, aux=None):
            install(self, geom, state, aux)
            if aux is None and self.state_global is not None:
                if self.programs.buffers is not None:
                    self.programs.buffers.copy_from(state=self.state_global)
                self.programs._values["state"] = self.state_global
        patch(sm.Stitcher, "_install", keep_global)
    elif name == "frame_altered":
        pack = sm.blend_resize_pack

        def altered(*a, **kw):
            out = pack(*a, **kw).clone()
            out[: out.shape[0] // 4] //= 2
            return out
        patch(sm, "blend_resize_pack", altered)
    elif name == "gain_none":
        patch(cal, "solve_gains",
              lambda images, masks: np.ones(images.shape[0]))
    elif name == "seam_none":
        patch(cal, "_seam_masks", lambda masks, cfg, geom: masks.copy())
    elif name:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
