"""The entry points' contracts against the JAX package's, on the 6x320x180
ring of tests/test_torch_calibration.py (scene seed 7, gains 0.85-1.15):

- ``calibrate(frames, cfg, mesh_maps=m)`` composes a caller's CPW mesh
  into the fused maps as the JAX ``calibrate(..., mesh_maps=m)`` does.
  `m` is a non-identity mesh that both packages'
  ``mesh_to_backward_maps`` build from the same perturbed vertices. The
  JAX side runs op by op (``jax.disable_jit``, ROADMAP Queue 3). Bounds:
  the calibration parity of tests/test_torch_calibration.py (fused maps
  within 1e-3 px) and 3/255 for the stitch (BASELINE.md:22);
- ``Stitcher.load_calibration(path, frames_shape=...)`` takes the JAX
  package's second parameter and installs a JAX checkpoint of that meshed
  state;
- ``use_pallas_remap``, which chose between two TPU lowerings of what K1
  computes, changes nothing in the port: False stitches bit-equal to True.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.calib.calibration import calibrate as j_calibrate
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.calib.state import save_state as j_save_state
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.mesh import mesh2map as jm2m
from video_stitcher_tpu.pipeline.stitcher import stitch_pano as j_stitch_pano
from video_stitcher_tpu.utils.synth import make_scene, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.calib.calibration import (
    calibrate, compose_fused_maps_device,
)
from video_stitcher_tpu_torch.mesh import mesh2map as tm2m
from video_stitcher_tpu_torch.pipeline.stitcher import stitch_pano

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mesh import _verts   # grid vertices moved by N(0, 2.5 px)

RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False, recalibrate=False)
MAPS_ATOL = 1e-3       # px, tests/test_torch_calibration.py
MAX_ABS = 3            # u8 panoramas, BASELINE.md:22


def _diff(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)
                      ).max())


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    jcfg = JConfig(**RING)
    jgeom, _ = j_plan(jcfg)
    lay = jgeom.layout
    scene = make_scene(lay.pano_w, lay.pano_h, np.random.default_rng(7))
    frames = render_views(jcfg, jgeom, scene,
                          gains=np.linspace(0.85, 1.15, 6))
    verts = _verts(np.random.default_rng(5), c=6, n=jcfg.mesh_height,
                   m=jcfg.mesh_width, bh=lay.band_h, bw=lay.band_w)
    jmesh = np.asarray(jm2m.mesh_to_backward_maps(
        jnp.asarray(verts), lay.band_h, lay.band_w))
    tmesh = tm2m.mesh_to_backward_maps(verts, lay.band_h, lay.band_w,
                                       device="cpu")
    with jax.disable_jit():
        _, jstate, _ = j_calibrate(frames, jcfg, mesh_maps=jmesh)
    geom, state, aux = calibrate(frames, StitcherConfig(**RING),
                                 mesh_maps=tmesh, device="cpu")
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_meshed.npz")
    j_save_state(ckpt, jstate)
    return dict(frames=frames, jgeom=jgeom, jstate=jstate, jmesh=jmesh,
                tmesh=tmesh, geom=geom, state=state, aux=aux, ckpt=ckpt,
                jpano=np.asarray(j_stitch_pano(jnp.asarray(frames), jstate,
                                               jgeom)))


def test_the_mesh_is_not_identity(rig):
    lay = rig["geom"].layout
    gy, gx = np.mgrid[0:lay.band_h, 0:lay.band_w]
    m = rig["tmesh"].numpy()
    d = np.abs(np.stack([m[:, 0] - gx, m[:, 1] - gy], 1))
    assert np.median(d) > 0.5 and d.max() < 15
    np.testing.assert_allclose(m, rig["jmesh"], atol=1e-4)


def test_calibrate_with_mesh_maps_matches_jax(rig):
    port = rig["state"].fused_maps.numpy()
    ref = np.asarray(rig["jstate"].fused_maps)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=MAPS_ATOL, rtol=0)
    assert np.abs(port - rig["aux"]["band_maps"].numpy()).max() > 1.0


def test_calibrate_with_mesh_maps_composes_like_the_helper(rig):
    """The fused maps are compose_fused_maps_device of the band maps and
    the mesh, bit for bit, whether the mesh comes as numpy or a tensor."""
    want = compose_fused_maps_device(rig["aux"]["band_maps"], rig["tmesh"],
                                     rig["geom"])
    assert torch.equal(rig["state"].fused_maps, want)
    _, from_numpy, _ = calibrate(rig["frames"], StitcherConfig(**RING),
                                 rig["tmesh"].numpy(), device="cpu")
    assert torch.equal(from_numpy.fused_maps, want)


def test_calibrate_with_mesh_maps_stitches_like_jax(rig):
    pano = stitch_pano(torch.as_tensor(rig["frames"]), rig["state"],
                       rig["geom"]).numpy()
    assert _diff(pano, rig["jpano"]) <= MAX_ABS


def test_load_calibration_takes_frames_shape(rig):
    st = Stitcher(StitcherConfig(**RING), device="cpu")
    st.load_calibration(rig["ckpt"], frames_shape=rig["frames"].shape)
    np.testing.assert_array_equal(st.state.fused_maps.numpy(),
                                  np.asarray(rig["jstate"].fused_maps))
    assert _diff(st.stitch(rig["frames"]), rig["jpano"]) <= MAX_ABS
    other = Stitcher(StitcherConfig(**RING), device="cpu")
    other.load_calibration(rig["ckpt"])
    assert np.array_equal(other.stitch(rig["frames"]),
                          st.stitch(rig["frames"]))


def test_use_pallas_remap_changes_nothing(rig):
    frames = rig["frames"]
    panos = []
    for flag in (True, False):
        st = Stitcher(StitcherConfig(**RING, use_pallas_remap=flag),
                      device="cpu")
        st.calibrate(frames)
        panos.append((st.stitch(frames), st.stitch_out(frames)))
    for a, b in zip(*panos):
        np.testing.assert_array_equal(a, b)
