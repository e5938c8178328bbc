"""The CPW mesh path end to end: the port's ``Stitcher`` with the default
``enable_local=True`` against the JAX package's, on the 6x320x180 ring at
scene seed 11 of tests/test_mesh_e2e.py.

- With the JAX package's RANSAC draws fed to the port (its
  ``sample_hypotheses`` replaced by the threefry draws the JAX
  ``MeshPipeline`` makes from ``PRNGKey(0)``), both packages select the
  same matches (>= 95% of each seam's within 1e-3 px; measured 99-100%),
  the coarse mesh displacement
  agrees within 0.05 px and the fused maps within 0.1 px, and the
  panoramas within 3/255 (BASELINE.md:22).
- The JAX reference for weights and panoramas is its calibration run op
  by op (``jax.disable_jit``, as tests/test_torch_calibration.py runs
  it), with the JAX ``Stitcher``'s mesh maps put in: compiled, XLA
  re-rounds the seam-canvas row and a band row on an exact canvas
  integer samples the neighbouring (dilated) mask row, which moves a few
  pixels of one pano row by up to ~100.
- With the port's own generator, the mesh is near identity (median |d| <
  3 px, max < 25 px) and the psnr against the scene stays within 3 dB of
  the global path: tests/test_mesh_e2e.py's own bounds.
- ``recalibrate_mesh`` installs a state and its tile plan together;
  ``interpolate_states`` equals the JAX package's at t = 0, 0.5 and 1
  (1e-5); ``update_masks`` reproduces the pyramids through an identity
  mesh (1e-5, tests/test_update_masks.py); a JAX ``enable_local``
  checkpoint loads with dilated seams (1e-6) and stitches within 3/255.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

import video_stitcher_tpu.mesh.pipeline as jpipeline
from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import calibrate as j_calibrate
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.pipeline.stitcher import stitch_pano as j_stitch_pano
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.features import ransac
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.mesh import pipeline as tpipeline
from video_stitcher_tpu_torch.mesh.mesh2map import upsample_backward_disp
from video_stitcher_tpu_torch.ops.remap_strips import plan_remap

CFG = dict(num_images=6, input_width=320, input_height=180,
           enable_local=True, recalibrate=True)
MAX_ABS = 3            # u8 panoramas, BASELINE.md:22
DISP_ATOL = 0.05       # coarse displacement, px, with the same draws
KP_ATOL = 1e-3         # matched points, px: the compiled JAX detect fuses
                       # the sub-pixel fit's arithmetic differently
MATCH_RECALL = 0.95    # of each seam's JAX matches, found in the port's:
                       # the compiled JAX warp rounds the bands up to 0.013
                       # away, which flips a descriptor bit in ~1 keypoint
                       # of 500 and can swap a tie at the 100-match cap
PYR_ATOL = 1e-5        # tests/test_update_masks.py's identity bound


def _diff(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)
                      ).max())


def _scene_psnr(pano, scene, valid):
    h = pano.shape[0]
    gt = np.moveaxis(scene, 0, -1)
    sel = valid[h // 4:3 * h // 4]
    return psnr(pano[h // 4:3 * h // 4][sel], gt[h // 4:3 * h // 4][sel])


class JaxDraws:
    """The RANSAC draws of the JAX MeshPipeline (key schedule of its
    ``_next_key`` from PRNGKey(0), one key per seam), in the order the
    port's pipeline asks for them."""

    def __init__(self, c):
        self.c = c
        self.key = jax.random.PRNGKey(0)
        self.keys = None
        self.calls = 0

    def _one(self, valid, num_hyp):
        if self.calls % self.c == 0:
            self.key, sub = jax.random.split(self.key)
            self.keys = jax.random.split(sub, self.c)
        key = self.keys[self.calls % self.c]
        self.calls += 1
        probs = jnp.asarray(valid.cpu().numpy()).astype(jnp.float32) + 1e-6
        idx = jax.random.categorical(
            key, jnp.log(probs)[None, :].repeat(num_hyp * 4, 0))
        return torch.as_tensor(np.array(idx).reshape(num_hyp, 4),
                               dtype=torch.int64)

    def __call__(self, valid, num_hyp, generator):
        """valid [B, K] (B seams, in ring order) -> [B, num_hyp, 4]."""
        return torch.stack([self._one(v, num_hyp) for v in valid])


def _recording(cls, out):
    run = cls.run

    def wrapped(self, frames):
        disp = run(self, frames)
        out.append(disp)
        return disp
    return wrapped


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    jcfg = JConfig(**CFG)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng, smooth=4)
    frames = render_views(jcfg, geom, scene)
    jdisp, tdisp = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline.MeshPipeline, "run",
                   _recording(jpipeline.MeshPipeline, jdisp))
        jst = JStitcher(jcfg)
        jst.calibrate(frames)
        mp.setattr(tpipeline.MeshPipeline, "run",
                   _recording(tpipeline.MeshPipeline, tdisp))
        mp.setattr(ransac, "sample_hypotheses", JaxDraws(6))
        fed = Stitcher(StitcherConfig(**CFG), device="cpu")
        fed.calibrate(frames)
    own = Stitcher(StitcherConfig(**CFG), device="cpu")
    own.calibrate(frames)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_local.npz")
    jst.save_calibration(ckpt)
    with jax.disable_jit():
        _, jglobal, jaux = j_calibrate(frames, jcfg)
    jmesh = jglobal._replace(fused_maps=jst.state.fused_maps)
    return dict(geom=geom, scene=scene, frames=frames, jst=jst, fed=fed,
                own=own, jdisp=jdisp[0], tdisp=tdisp[0], ckpt=ckpt,
                jglobal=jglobal, jaux=jaux, jmesh=jmesh)


def _jax_pano(rig, state):
    return np.asarray(j_stitch_pano(jnp.asarray(rig["frames"]), state,
                                    rig["jst"].geom))


def test_default_config_runs_the_mesh():
    assert StitcherConfig().enable_local
    assert Stitcher(StitcherConfig(**CFG), device="cpu").cfg.enable_local


def test_same_draws_same_matches(rig):
    jm = rig["jst"]._mesh_pipe.solver.old_matches
    tm = rig["fed"]._mesh_pipe.solver.old_matches
    assert sum(m is not None for m in tm) >= 3
    for a, b in zip(jm, tm):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dst == b.dst and a.p1.shape == b.p1.shape
            d = (np.abs(a.p1[:, None] - b.p1[None]).max(-1)
                 + np.abs(a.p2[:, None] - b.p2[None]).max(-1))
            assert (d.min(1) <= 2 * KP_ATOL).mean() >= MATCH_RECALL


def test_same_draws_same_mesh(rig):
    assert rig["tdisp"].shape == rig["jdisp"].shape
    np.testing.assert_allclose(rig["tdisp"], rig["jdisp"], atol=DISP_ATOL)
    fused_j = np.asarray(rig["jst"].state.fused_maps)
    fused_t = rig["fed"].state.fused_maps.numpy()
    ok = (fused_j > -1) & (fused_t > -1)
    assert np.abs(fused_t - fused_j)[ok].max() < 0.1


def test_same_draws_same_pano(rig):
    assert _diff(rig["fed"].stitch(rig["frames"]),
                 _jax_pano(rig, rig["jmesh"])) <= MAX_ABS


def test_own_generator_mesh_near_identity(rig):
    st, geom = rig["own"], rig["geom"]
    lay = geom.layout
    disp = st._mesh_pipe.run(rig["frames"])
    assert disp is not None
    maps = upsample_backward_disp(torch.as_tensor(disp), lay.band_h,
                                  lay.band_w).numpy()
    gy, gx = np.mgrid[0:lay.band_h, 0:lay.band_w]
    d = np.abs(np.stack([maps[:, 0] - gx, maps[:, 1] - gy]))
    assert np.median(d[0]) < 3.0 and np.median(d[1]) < 3.0
    assert d.max() < 25.0


def test_own_generator_psnr_near_global(rig):
    st, frames = rig["own"], rig["frames"]
    pano = st.stitch(frames)
    glob = Stitcher(StitcherConfig(**{**CFG, "enable_local": False}),
                    device="cpu")
    glob.calibrate(frames)
    valid = glob.state.valid_mask.numpy() > 0
    p_g = _scene_psnr(glob.stitch(frames), rig["scene"], valid)
    p_m = _scene_psnr(pano, rig["scene"], valid)
    assert p_m > p_g - 3.0, (p_g, p_m)


def test_recalibrate_installs_state_and_plan(rig):
    st = rig["own"]
    old_state, old_plan = st.state, st.plan
    assert st.recalibrate_mesh(rig["frames"])
    state, geom, plan = st._snapshot()
    assert state is not old_state and plan is not old_plan
    want = plan_remap(state.fused_maps, geom.warp_src_h, geom.warp_src_w)
    assert plan.n_active == want.n_active
    assert torch.equal(plan.order, want.order)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0])
def test_interpolate_states_matches_jax(rig, t):
    jst, st = rig["jst"], rig["own"]
    old_np = np.array(jst.state_global.fused_maps)
    new_np = np.array(jst.state.fused_maps)
    jmix = np.asarray(jst.interpolate_states(
        jst.state_global, jst.state, t).fused_maps)
    old = st.state_global._replace(fused_maps=torch.as_tensor(old_np))
    new = st.state._replace(fused_maps=torch.as_tensor(new_np))
    mix = st.interpolate_states(old, new, t)
    np.testing.assert_allclose(mix.fused_maps.numpy(), jmix, atol=1e-5)
    st.swap_state(mix)
    state, geom, plan = st._snapshot()
    want = plan_remap(state.fused_maps, geom.warp_src_h, geom.warp_src_w)
    assert torch.equal(plan.order, want.order)


def test_update_masks_identity_parity(rig):
    st = rig["own"]
    lay = st.geom.layout
    yy, xx = np.mgrid[0:lay.band_h, 0:lay.band_w].astype(np.float32)
    ident = np.broadcast_to(np.stack([xx, yy]),
                            (6, 2, lay.band_h, lay.band_w)).copy()
    new = st._rebuild_weights(st.state_global, torch.as_tensor(ident))
    for lvl, (orig, got, want) in enumerate(zip(
            st.state_global.weight_pyr, new.weight_pyr,
            rig["jglobal"].weight_pyr)):
        np.testing.assert_allclose(got.numpy(), orig.numpy(),
                                   atol=PYR_ATOL, err_msg=f"level {lvl}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PYR_ATOL, err_msg=f"level {lvl}")
    np.testing.assert_allclose(new.valid_mask.numpy(),
                               np.asarray(rig["jglobal"].valid_mask),
                               atol=1e-6)


def test_update_masks_recalibration(rig):
    cfg = StitcherConfig(**{**CFG, "update_masks": True})
    st = Stitcher(cfg, device="cpu")
    st.calibrate(rig["frames"])
    valid = st.state.valid_mask.numpy() > 0
    pano = st.stitch(rig["frames"])
    assert (pano.sum(-1)[valid] > 0).all()


def test_load_jax_local_checkpoint(rig):
    jst = rig["jst"]
    st = Stitcher(StitcherConfig(**CFG), device="cpu")
    st.load_calibration(rig["ckpt"])
    np.testing.assert_allclose(st.aux["seam_masks"],
                               np.asarray(jst.aux["seam_masks"]), atol=1e-6)
    np.testing.assert_allclose(st.aux["weights0"].numpy(),
                               np.asarray(rig["jaux"]["weights0"]),
                               atol=1e-6)
    frames = rig["frames"]
    assert _diff(st.stitch(frames), jst.stitch(frames)) <= MAX_ABS
    assert st.recalibrate_mesh(frames)


def test_state_handed_as_arrays(rig):
    jst = rig["jst"]
    st = Stitcher(StitcherConfig(**CFG), device="cpu")
    st.load_calibration(rig["ckpt"])
    st.swap_state(state_from_numpy(
        np.asarray(jst.state.fused_maps), np.asarray(jst.state.gains),
        [np.asarray(w) for w in jst.state.weight_pyr],
        np.asarray(jst.state.valid_mask), device="cpu"))
    assert _diff(st.stitch(rig["frames"]), jst.stitch(rig["frames"])) \
        <= MAX_ABS


def _pipelines(rig, **cfg_kw):
    """A JAX and a port MeshPipeline over the same global state."""
    jst, st = rig["jst"], rig["fed"]
    jcfg = JConfig(**{**CFG, **cfg_kw})
    jpipe = jpipeline.MeshPipeline(jst.geom, jst.state_global.fused_maps,
                                   jst.aux["overlap_masks"], jcfg)
    tpipe_ = tpipeline.MeshPipeline(
        st.geom, st.state_global.fused_maps, st.aux["overlap_masks"],
        StitcherConfig(**{**CFG, **cfg_kw}))
    return jpipe, tpipe_


def test_batched_branch_equals_chunked(rig, monkeypatch):
    """recalib_chunked=False (all cameras, then all seams, at once) gives
    the chunked branch's mesh, with the same draws."""
    monkeypatch.setattr(ransac, "sample_hypotheses", JaxDraws(6))
    _, chunked = _pipelines(rig)
    want = chunked.run(rig["frames"])
    monkeypatch.setattr(ransac, "sample_hypotheses", JaxDraws(6))
    _, batched = _pipelines(rig, recalib_chunked=False)
    got = batched.run(rig["frames"])
    np.testing.assert_allclose(got, want, atol=1e-6)
    for a, b in zip(chunked.solver.old_matches, batched.solver.old_matches):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.p1, a.p1, atol=1e-6)


def test_temporal_term_matches_jax(rig, monkeypatch):
    """alphas[3] > 0: the second solve adds temporal matches against the
    first solve's keypoints; its mesh agrees with the JAX package's within
    DISP_ATOL, with the same draws."""
    alphas = (1.0, 0.01, 0.00005, 0.5)
    monkeypatch.setattr(ransac, "sample_hypotheses", JaxDraws(6))
    jpipe, tpipe_ = _pipelines(rig, alphas=alphas)
    frames2 = np.roll(rig["frames"], 1, axis=2)
    for f in (rig["frames"], frames2):
        want = jpipe.run(f)
        got = tpipe_.run(f)
    assert tpipe_._prev_kps is not None
    np.testing.assert_allclose(got, want, atol=DISP_ATOL)


def test_resolve_and_swap_never_split_state_and_plan(rig):
    """Re-solves and swaps on one thread while another takes snapshots:
    every snapshot's plan is the plan of that snapshot's maps."""
    import sys
    import threading
    st = Stitcher(StitcherConfig(**CFG), device="cpu")
    st.load_calibration(rig["ckpt"])
    seen, bad, done = [0], [], threading.Event()

    def reader():
        while not done.is_set() or seen[0] == 0:
            state, geom, plan = st._snapshot()
            want = plan_remap(state.fused_maps, geom.warp_src_h,
                              geom.warp_src_w)
            if not torch.equal(plan.order, want.order):
                bad.append(seen[0])
            seen[0] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=reader)
    try:
        t.start()
        for i in range(3):
            prev = st.state
            assert st.recalibrate_mesh(np.roll(rig["frames"], i, axis=2))
            st.swap_state(st.interpolate_states(prev, st.state, 0.5))
    finally:
        done.set()
        t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert seen[0] > 0 and not bad, (seen[0], bad)
