"""A dry run of camera sharding on the host: the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``, with the shards on
``[cpu] * n`` in place of its virtual host devices.

    python -m video_stitcher_tpu_torch.parallel.dryrun 4

Calibrates a 6x160x90 rig with the CPW mesh (``enable_local``) and
``camera_shards=n``, stitches sharded, re-solves the mesh (which
re-shards the new state) and stitches again, runs the sharded
``stitch_out``, and holds the panorama against a single-device stitcher
driven the same way, within 3 (the reference's own blend bound,
test_blenders.cuda.cpp:95). Its production-shape phase (6x1920x1080,
sharded) runs on the card, in chip_smoke.py's phase "shard".
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

MAX_ABS = 3


def scene_frames(cfg) -> np.ndarray:
    """The rig's views of a synthetic scene (seed 3): the CPW feature
    pipeline needs texture it can match, not noise."""
    from video_stitcher_tpu_torch.calib.calibration import plan_geometry
    from video_stitcher_tpu_torch.utils.synth import make_scene, render_views
    geom, _ = plan_geometry(cfg)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h,
                       np.random.default_rng(3))
    return render_views(cfg, geom, scene)


def dryrun_multichip(n_devices: int) -> dict:
    """Drive the sharded Stitcher on [cpu] * n_devices and check it
    (raises on a failed check). Returns what it measured."""
    from video_stitcher_tpu_torch import Stitcher, StitcherConfig
    cfg = StitcherConfig(num_images=6, input_width=160, input_height=90,
                         enable_local=True, recalibrate=False,
                         camera_shards=n_devices)
    frames = scene_frames(cfg)
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)                     # calibrate, with the mesh
    shards = st._sharded.shards
    if len(shards) != n_devices:
        raise AssertionError(f"{len(shards)} shards for {n_devices}")
    pano = st.stitch(frames, device=True)
    if tuple(pano.shape) != (st.geom.pano_h, st.geom.pano_w, 3):
        raise AssertionError(f"pano {tuple(pano.shape)}")
    # a live re-solve installs a new state, which is sharded again
    before = st._sharded
    if not st.recalibrate_mesh(frames):
        raise AssertionError("the re-solve installed no mesh")
    if st._sharded is before:
        raise AssertionError("the re-solved state was not sharded")
    pano2 = st.stitch(frames)
    out = st.stitch_out(frames, device=True)

    ref_st = Stitcher(dataclasses.replace(cfg, camera_shards=1),
                      device="cpu")
    ref_st.calibrate(frames)
    ref_st.recalibrate_mesh(frames)
    diff = int(np.abs(pano2.astype(np.int32)
                      - ref_st.stitch(frames).astype(np.int32)).max())
    diff_out = int(np.abs(out.numpy().astype(np.int32) - ref_st.stitch_out(
        frames, device=True).numpy().astype(np.int32)).max())
    if max(diff, diff_out) > MAX_ABS:
        raise AssertionError(f"sharded against single-device: pano max abs "
                             f"{diff}, output {diff_out} > {MAX_ABS}")
    return {"shards": [s.hi - s.lo for s in shards], "pano": tuple(
        pano2.shape), "out": tuple(out.shape), "max_abs": diff,
        "max_abs_out": diff_out}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(f"dryrun_multichip({n}): OK {dryrun_multichip(n)}")
