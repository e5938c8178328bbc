"""The CPW mesh's numeric modules against the JAX package's: the own copy
of the CPW solver, the mesh -> map inversion and upsampling, the
gather-free compose of the fused maps, and the salience.

Tolerances: the solver's vertices within 1e-5 px (the same numpy/scipy
code on the same inputs); coarse_backward_disp exactly (the same host
numpy); the f32 upsampling matmuls, the forward-field inversion and the
salience within 1e-4 (relative for the salience); the fused maps of
compose_fused_maps_from_disp within 1e-3 px (tests/test_mesh.py:98's
rig and displacement).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from video_stitcher_tpu.calib import calibration as jcal
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.mesh import cpw as jcpw
from video_stitcher_tpu.mesh import mesh2map as jm2m
from video_stitcher_tpu.mesh import pipeline as jpipe
from video_stitcher_tpu_torch import StitcherConfig
from video_stitcher_tpu_torch.calib import calibration as tcal
from video_stitcher_tpu_torch.interop import cam_matches_from_numpy
from video_stitcher_tpu_torch.mesh import cpw as tcpw
from video_stitcher_tpu_torch.mesh import mesh2map as tm2m
from video_stitcher_tpu_torch.mesh import pipeline as tpipe

VERT_ATOL = 1e-5
F32_ATOL = 1e-4
MAP_ATOL = 1e-3


def _matches(cpw, rng, c, bw, bh, targets, k=40):
    out = []
    for i in range(c):
        if i == c - 1:
            out.append(None)
            continue
        p1 = np.stack([rng.uniform(10, 60, k), rng.uniform(10, bh - 10, k)],
                      -1)
        p2 = np.stack([p1[:, 0] - targets[i] + rng.normal(0, 3, k),
                       p1[:, 1] + rng.normal(0, 1, k)], -1)
        out.append(cpw.CamMatches(p1=p1.astype(np.float32),
                                  p2=p2.astype(np.float32), dst=(i - 1) % c))
    return out


@pytest.mark.parametrize("alphas", [(1.0, 0.01, 0.00005, 0.0),
                                    (1.0, 0.01, 0.00005, 0.5)])
def test_cpw_solver_copy_matches_original(alphas):
    c, bw, bh = 3, 120, 100
    targets = [-60.0, -60.0, -60.0]
    kw = dict(num_images=c, mesh_w=6, mesh_h=6, band_w=bw, band_h=bh,
              targets=targets, alphas=alphas)
    js, ts = jcpw.CPWSolver(**kw), tcpw.CPWSolver(**kw)
    rng = np.random.default_rng(1)
    sal = rng.random((c, 5, 5, 4)).astype(np.float32) + 0.5
    for step in range(3):     # the second and third solves reuse matches
        jm = _matches(jcpw, rng, c, bw, bh, targets)
        tmatch = cam_matches_from_numpy(jm)
        temporal = [None] * c
        if alphas[3] > 0:
            pt = rng.uniform(20, 90, (12, 2)).astype(np.float32)
            temporal = [jcpw.TemporalMatches(pt=pt, pp=pt + 0.5)] + \
                [None] * (c - 1)
        tt = [None if t is None else tcpw.TemporalMatches(pt=t.pt, pp=t.pp)
              for t in temporal]
        vj = js.solve(jm, temporal=temporal, salience=sal)
        vt = ts.solve(tmatch, temporal=tt, salience=sal)
        np.testing.assert_allclose(vt, vj, atol=VERT_ATOL,
                                   err_msg=f"solve {step}")


def _verts(rng, c=2, n=6, m=6, bh=160, bw=224, sd=2.5):
    base_x = np.linspace(0, bw - 1, m)
    base_y = np.linspace(0, bh - 1, n)
    vx = base_x[None, None, :] + rng.normal(0, sd, (c, n, m))
    vy = base_y[None, :, None] + rng.normal(0, sd, (c, n, m))
    return np.stack([vx, vy], axis=-1).astype(np.float32)


def test_coarse_backward_disp_exact():
    v = _verts(np.random.default_rng(7))
    np.testing.assert_array_equal(tm2m.coarse_backward_disp(v, 160, 224),
                                  jm2m.coarse_backward_disp(v, 160, 224))


def test_upsample_mesh_and_backward_disp_match_jax():
    rng = np.random.default_rng(8)
    v = rng.normal(0, 3, (2, 2, 21, 29)).astype(np.float32)
    np.testing.assert_allclose(
        tm2m.upsample_mesh(torch.as_tensor(v), 160, 224).numpy(),
        np.asarray(jm2m.upsample_mesh(jnp.asarray(v), 160, 224)),
        atol=F32_ATOL)
    np.testing.assert_allclose(
        tm2m.upsample_backward_disp(torch.as_tensor(v), 160, 224).numpy(),
        np.asarray(jm2m.upsample_backward_disp(jnp.asarray(v), 160, 224)),
        atol=F32_ATOL)
    verts = _verts(rng)
    np.testing.assert_allclose(
        tm2m.mesh_to_backward_maps(verts, 160, 224, device="cpu").numpy(),
        np.asarray(jm2m.mesh_to_backward_maps(jnp.asarray(verts), 160, 224)),
        atol=F32_ATOL)


def test_invert_forward_field_matches_jax():
    h, w = 64, 96
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    fwd = np.stack([gx + 3.0 * np.sin(gy / 17.0),
                    gy + 2.0 * np.cos(gx / 23.0)]).astype(np.float32)
    np.testing.assert_allclose(
        tm2m.invert_forward_field(torch.as_tensor(fwd), 4).numpy(),
        np.asarray(jm2m.invert_forward_field(jnp.asarray(fwd), 4)),
        atol=F32_ATOL)


def test_compose_fused_maps_from_disp_matches_jax():
    kw = dict(num_images=4, input_width=320, input_height=180)
    jgeom, jcams = jcal.plan_geometry(JConfig(**kw))
    geom, cams = tcal.plan_geometry(StitcherConfig(**kw))
    lay = geom.layout
    step = 8
    hc = max(10, (lay.band_h - 1 + step - 1) // step + 1)
    wc = max(10, (lay.band_w - 1 + step - 1) // step + 1)
    disp = np.random.default_rng(3).normal(0, 2.0, (4, 2, hc, wc)) \
        .astype(np.float32)
    want = np.asarray(jcal.compose_fused_maps_from_disp(
        jcal.krinv_device(jcams), jnp.asarray(disp), geom=jgeom))
    got = tcal.compose_fused_maps_from_disp(
        tcal.krinv_device(cams, "cpu"), torch.as_tensor(disp), geom)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=MAP_ATOL)


def test_salience_matches_jax():
    rng = np.random.default_rng(6)
    bands = (rng.random((3, 3, 90, 110)) * 255).astype(np.float32)
    want = np.asarray(jpipe._salience_all(jnp.asarray(bands), 9, 9))
    got = tpipe._salience_all(torch.as_tensor(bands), 9, 9).numpy()
    assert got.shape == want.shape == (3, 9, 9, 4)
    np.testing.assert_allclose(got, want, rtol=F32_ATOL)


def test_band_targets_and_filters_match_jax():
    geom, _ = tcal.plan_geometry(StitcherConfig(num_images=6))
    assert tpipe.band_targets(geom.layout) == jpipe.band_targets(
        jcal.plan_geometry(JConfig(num_images=6))[0].layout)
    assert (tpipe.Y_DIFF_MAX, tpipe.X_DIST_SLACK) == (jpipe.Y_DIFF_MAX,
                                                      jpipe.X_DIST_SLACK)
