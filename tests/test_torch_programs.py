"""The programs of the JAX package's other jits (``pipeline/step_graph.py``
machinery): the sharded step (``parallel/shard.ShardPrograms``),
``stitch_batch``, ``stitch_int16``, ``output`` and the mesh re-solve's
device stages (``mesh/pipeline.MeshPipeline``). On the CPU a program's
launch runs its function eagerly on its buffers, which is what these
tests drive (the captures run in chip_smoke.py's phase "programs").

On the 6x320x180 ring of tests/test_torch_step_graph.py (the JAX
package's calibration handed across):
- each program equals its eager module function bit for bit: the
  sharded step on [cpu] * k for k = 1-4 (pano and output), stitch_batch
  at B = 2 from RGB and NV12, stitch_int16 on the live state and on
  state_global, output;
- and the JAX package within the repo's bounds: 3 for the sharded pano
  and 4 for its output (tests/test_torch_parallel.py), 3 for
  stitch_batch and output (BASELINE.md:22), stitch_int16 within 3 with
  99% of pixels equal (tests/test_torch_pyramid_int.py);
- after a swap to perturbed maps, at each interpolate_states step and
  after a calibrate with the same geometry (new seam weights), each
  program equals a fresh stitcher with that state, with no new program.

On the CPW mesh ring of tests/test_torch_mesh_e2e.py (seed 11): each
re-solve stage through its program equals the eager stage bit for bit
under both recalib_chunked settings with update_masks on; the
displacement agrees with the JAX package's within 0.05 px with its
draws fed across (that file's bound); a prewarmed re-solve and an eager
one from one seed install the same maps; prewarm captures each unit once
and draws nothing.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

import video_stitcher_tpu.mesh.pipeline as jpipeline
from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.ops.color import rgb_to_nv12
from video_stitcher_tpu.parallel import shard as jshard
from video_stitcher_tpu.utils.synth import make_scene, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.features import ransac
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.mesh import pipeline as tpipeline
from video_stitcher_tpu_torch.parallel.shard import build_sharded_step
from video_stitcher_tpu_torch.pipeline.stitcher import (
    output_frame, stitch_batch_pano, stitch_pano_int16,
)

CPU = torch.device("cpu")
MAX_ABS = 3            # u8, BASELINE.md:22
SHARDED_OUT_VS_JAX = 3 + 1     # tests/test_torch_parallel.py
DISP_ATOL = 0.05       # tests/test_torch_mesh_e2e.py, with the same draws
RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False, recalibrate=False)
MESH = dict(num_images=6, input_width=320, input_height=180,
            enable_local=True, recalibrate=True)


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def ring():
    jcfg = JConfig(**RING)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    frames2 = np.clip(frames.astype(np.int32)
                      + rng.integers(-20, 20, frames.shape), 0, 255
                      ).astype(np.uint8)
    jst = JStitcher(jcfg)
    jst.calibrate(frames)
    state = state_from_numpy(
        np.asarray(jst.state.fused_maps), np.asarray(jst.state.gains),
        [np.asarray(w) for w in jst.state.weight_pyr],
        np.asarray(jst.state.valid_mask), device="cpu")
    cfg = StitcherConfig(**RING)
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)
    # the JAX calibration's seam weights too (stitch_int16 reads them)
    aux = dict(st.aux, weights0=torch.tensor(
        np.asarray(jst.aux["weights0"]), dtype=torch.float32))
    st._install(st.geom, state, aux)
    return dict(cfg=cfg, jst=jst, st=st, state=state, frames=frames,
                frames2=frames2)


def _sharded(cfg, state, k):
    """A stitcher sharded over [cpu] * k (k = 1 included), `state`
    installed."""
    st = Stitcher(cfg, device="cpu")
    st._shard_devices = [CPU] * k
    st.swap_state(state)
    assert st.shard_programs.devices == [CPU] * k
    return st


def _eager_sharded(st, frames, out):
    sharded = st._sharded
    f = torch.as_tensor(frames)
    step = build_sharded_step(st.geom, st._shard_devices,
                              st._out_size(st.geom) if out else None)
    return step([f[s.lo:s.hi] for s in sharded.shards], sharded)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_programs_equal_the_eager_step(ring, k):
    st = _sharded(ring["cfg"], ring["state"], k)
    for frames in (ring["frames"], ring["frames2"]):
        pano = st.stitch(frames, device=True)
        out = st.stitch_out(frames, device=True)
        assert torch.equal(pano, _eager_sharded(st, frames, False))
        assert torch.equal(out, _eager_sharded(st, frames, True))
    sp = st.shard_programs
    n_full = sum(s.hi > s.lo for s in st._sharded.shards)
    # one levels program per non-empty shard, shared by pano and output;
    # one reduction each
    assert sum(len(ps.programs) for ps in sp.shard_sets) == n_full
    assert len(sp.reduce_set.programs) == 2
    assert set(sp.captures.values()) == {1}
    if k == 1:        # one shard is the unsharded step
        ref = Stitcher(ring["cfg"], device="cpu")
        ref.swap_state(ring["state"])
        assert torch.equal(pano, ref.stitch(ring["frames2"], device=True))


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_programs_match_jax(ring, k):
    """The JAX shard_map program on k virtual devices against the port's
    programs on [cpu] * k, from one state: pano and output."""
    jst, frames = ring["jst"], ring["frames"]
    st = _sharded(ring["cfg"], ring["state"], k)
    mesh = Mesh(np.array(jax.devices()[:k]), ("cam",))
    jstate, corners, total = jshard.shard_state(jst.state, jst.geom, mesh)
    jframes = jax.device_put(jshard.pad_cameras(frames, total),
                             NamedSharding(mesh, P("cam")))
    out_size = st._out_size(st.geom)
    want = np.asarray(jshard.build_sharded_step(jst.geom, mesh)(
        jframes, jstate, corners))
    want_out = np.asarray(jshard.build_sharded_step(
        jst.geom, mesh, out_size=out_size)(jframes, jstate, corners))
    assert _diff(st.stitch(frames), want) <= MAX_ABS
    assert _diff(st.stitch_out(frames, device=True).numpy(),
                 want_out) <= SHARDED_OUT_VS_JAX


@pytest.mark.parametrize("fmt", ["rgb", "nv12"])
def test_stitch_batch_program(ring, fmt):
    st, jst = ring["st"], ring["jst"]
    batch = np.stack([ring["frames"], ring["frames2"]])
    if fmt == "nv12":
        batch = np.stack([np.stack([np.asarray(rgb_to_nv12(f)) for f in s])
                          for s in batch])
    got = st.stitch_batch(batch, device=True)
    state, geom, plan = st._snapshot()
    assert torch.equal(got, stitch_batch_pano(torch.as_tensor(batch), state,
                                              geom, plan))
    key = (("stitch_batch",), batch.shape, torch.uint8)
    assert key in st.programs.programs
    assert _diff(got.numpy(), jst.stitch_batch(batch)) <= MAX_ABS
    for i in range(2):
        assert torch.equal(got[i], st.stitch(batch[i], device=True))


def test_stitch_int16_program_on_the_live_state(ring):
    st, jst, frames = ring["st"], ring["jst"], ring["frames"]
    state, geom, plan = st._snapshot()
    got = st.stitch_int16(frames, device=True)
    want = stitch_pano_int16(torch.as_tensor(frames), state, geom,
                             st.aux["weights0"], plan)
    assert torch.equal(got, want)
    assert (("stitch_int16",), frames.shape, torch.uint8) in \
        st.programs.programs
    jpano = np.asarray(jst.stitch_int16(frames))
    valid = st.state.valid_mask.numpy() > 0
    d = np.abs(got.numpy().astype(np.int32) - jpano.astype(np.int32))[valid]
    assert d.max() <= MAX_ABS and (d == 0).mean() >= 0.99


def test_stitch_int16_program_on_state_global(mesh):
    """Another state than the live one (the global-only state beside the
    solved mesh) goes into the program's own buffers with its plan; the
    live programs' buffers keep the live state."""
    st, frames = mesh["st"], mesh["frames"]
    state, geom = st.state_global, st.geom
    assert not torch.equal(state.fused_maps, st.state.fused_maps)
    live = st.stitch_int16(frames, device=True)
    got = st.stitch_int16(frames, state=state, device=True)
    want = stitch_pano_int16(torch.as_tensor(frames), state, geom,
                             st.aux["weights0"], st._plan(geom, state))
    assert torch.equal(got, want) and not torch.equal(got, live)
    key = (("stitch_int16", "of a state"), frames.shape, torch.uint8)
    assert key in st.programs.programs
    assert torch.equal(st.programs.buffers.state.fused_maps,
                       st.state.fused_maps)
    assert torch.equal(st.stitch_int16(frames, device=True), live)


def test_output_program(ring):
    st, jst = ring["st"], ring["jst"]
    pano = st.stitch(ring["frames"])
    got = st.output(pano)
    oh, ow = st._out_size(st.geom)
    want = output_frame(torch.as_tensor(pano), oh, ow).numpy()
    np.testing.assert_array_equal(got, want)
    prog = st.programs.programs[(("output", oh, ow), pano.shape,
                                 torch.uint8)]
    assert prog.replays == 1
    assert _diff(got, np.asarray(jst.output(pano))) <= MAX_ABS


def _perturbed(state):
    m = state.fused_maps.clone()
    valid = m > -1.0
    m = torch.where(valid, m + torch.tensor([2.5, -1.5])[None, :, None,
                                                         None], m)
    m[:, :, :, : m.shape[3] // 3] = -1.0
    return state._replace(fused_maps=m.contiguous(),
                          gains=state.gains * 0.9)


def _entries(st, frames, frames2):
    batch = np.stack([frames, frames2])
    return {"stitch_batch": st.stitch_batch(batch, device=True),
            "stitch_int16": st.stitch_int16(frames, device=True),
            "output": torch.as_tensor(st.output(st.stitch(frames2)))}


def test_programs_follow_every_install(ring):
    """Swaps to perturbed maps, each interpolate_states step and a
    calibrate of the same geometry are copies into the programs'
    buffers: each equals a fresh stitcher with that state, unsharded
    and on two shards, with no new program."""
    cfg, frames, frames2 = ring["cfg"], ring["frames"], ring["frames2"]
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)
    sh = _sharded(cfg, st.state, 2)
    sh.aux = st.aux
    old = st.state
    new = _perturbed(old)
    _entries(st, frames, frames2)
    sh.stitch(frames), sh.stitch_out(frames)
    caps = dict(st.programs.captures)
    shard_caps = dict(sh.shard_programs.captures)
    steps = [new] + [Stitcher.interpolate_states(old, new, t)
                     for t in (0.25, 0.5, 0.75)] + [old]
    for state in steps:
        st.swap_state(state)
        sh.swap_state(state)
        fresh = Stitcher(cfg, device="cpu")
        fresh._install(st.geom, state, st.aux)
        for name, got in _entries(st, frames, frames2).items():
            assert torch.equal(got, _entries(fresh, frames, frames2)[name])
        fresh_sh = _sharded(cfg, state, 2)
        assert torch.equal(sh.stitch(frames2, device=True),
                           fresh_sh.stitch(frames2, device=True))
        assert torch.equal(sh.stitch_out(frames2, device=True),
                           fresh_sh.stitch_out(frames2, device=True))
    # a calibration of the same geometry with a finer seam canvas: new
    # seam weights, copied into the buffers the int16 program reads
    w_old = st.aux["weights0"]
    st.cfg = dataclasses.replace(cfg, seam_megapix=0.02)
    geom = st.geom
    st.calibrate(frames)
    assert st.geom == geom and not torch.equal(st.aux["weights0"], w_old)
    assert torch.equal(st.programs.buffers.weights0, st.aux["weights0"])
    fresh = Stitcher(st.cfg, device="cpu")
    fresh.calibrate(frames)
    for name, got in _entries(st, frames, frames2).items():
        assert torch.equal(got, _entries(fresh, frames, frames2)[name]), name
    assert st.programs.captures == caps
    assert sh.shard_programs.captures == shard_caps


# ---- the mesh re-solve ----------------------------------------------------

class EagerPrograms:
    """A ProgramSet stand-in that runs each function eagerly on its
    inputs: the re-solve's stages with no program."""
    stream = None

    def prepare(self, step_key, fn, *inputs, share=False):
        return types.SimpleNamespace(output=None)

    def launch(self, step_key, fn, *inputs):
        return fn(*inputs)


class JaxDraws:
    """The JAX MeshPipeline's RANSAC draws from PRNGKey(0)
    (tests/test_torch_mesh_e2e.py), for valid [B, K]."""

    def __init__(self, c):
        self.c, self.calls = c, 0
        self.key, self.keys = jax.random.PRNGKey(0), None

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
        return torch.stack([self._one(v, num_hyp) for v in valid])


@pytest.fixture(scope="module")
def mesh():
    jcfg = JConfig(**MESH)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(11)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng, smooth=4)
    frames = render_views(jcfg, geom, scene)
    frames2 = np.roll(frames, 2, axis=2)
    st = Stitcher(StitcherConfig(**MESH), device="cpu")
    st.calibrate(frames)
    return dict(st=st, frames=frames, frames2=frames2)


def _pipe(st, eager=False, **cfg_kw):
    """A fresh MeshPipeline of the stitcher's calibration (seed 0)."""
    cfg = dataclasses.replace(st.cfg, **cfg_kw)
    saved, st._mesh_pipe = st._mesh_pipe, None
    saved_cfg, st.cfg = st.cfg, cfg
    try:
        pipe = tpipeline.mesh_pipeline(st)
    finally:
        st._mesh_pipe, st.cfg = saved, saved_cfg
    if eager:
        pipe.programs = EagerPrograms()
    return pipe


@pytest.mark.parametrize("chunked", [True, False])
def test_resolve_programs_equal_the_eager_stages(mesh, chunked):
    st, frames = mesh["st"], mesh["frames2"]
    progs = _pipe(st, recalib_chunked=chunked, update_masks=True)
    eager = _pipe(st, eager=True, recalib_chunked=chunked, update_masks=True)
    tpipeline.prewarm_mesh_programs(progs.cfg, progs.geom, progs)
    units = ["warp", "salience", "compose", "rebuild"] + (
        ["detect", "match", "inliers"] if chunked else
        ["detect all", "match all", "inliers all"])
    assert sorted(k[0][0] for k in progs.programs.programs) == sorted(units)
    for _ in range(2):
        got, want = progs.run(frames), eager.run(frames)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(progs.compose(got), eager.compose(want))
        for a, b in zip(progs.rebuild(got)[0], eager.rebuild(want)[0]):
            assert torch.equal(a, b)
        assert torch.equal(progs.rebuild(got)[1], eager.rebuild(want)[1])
    # one launch a camera and a seam chunked, one a unit otherwise
    replays = {k[0][0]: p.replays for k, p in progs.programs.programs.items()}
    each = 6 if chunked else 1
    assert replays["warp"] == replays["salience"] == 2
    assert replays["detect" if chunked else "detect all"] == 2 * each
    assert replays["match" if chunked else "match all"] == 2 * each
    assert replays["inliers" if chunked else "inliers all"] == 2 * each
    assert set(progs.programs.captures.values()) == {1}


def test_resolve_matches_jax_with_its_draws(mesh, monkeypatch):
    st, frames = mesh["st"], mesh["frames2"]
    aux = st.aux
    jpipe = jpipeline.MeshPipeline(
        j_plan(JConfig(**MESH))[0], st.state_global.fused_maps.numpy(),
        aux["overlap_masks"].numpy(), JConfig(**MESH))
    want = jpipe.run(frames)
    monkeypatch.setattr(ransac, "sample_hypotheses", JaxDraws(6))
    pipe = _pipe(st)
    tpipeline.prewarm_mesh_programs(pipe.cfg, pipe.geom, pipe)
    got = pipe.run(frames)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=DISP_ATOL)


def test_a_prewarmed_resolve_installs_what_an_eager_one_does(mesh):
    """Two stitchers from one calibration and one seed: the one whose
    re-solve programs were captured (and warmed up) ahead installs the
    maps of the one that runs every stage eagerly; no program is built
    again."""
    st, frames = mesh["st"], mesh["frames2"]
    a, b = (Stitcher(st.cfg, device="cpu") for _ in range(2))
    for s in (a, b):
        s._install(st.geom, st.state_global, st.aux)
    a.prewarm_mesh()
    caps = dict(a._mesh_pipe.programs.captures)
    tpipeline.mesh_pipeline(b).programs = EagerPrograms()
    for _ in range(2):
        assert a.recalibrate_mesh(frames) and b.recalibrate_mesh(frames)
        assert torch.equal(a.state.fused_maps, b.state.fused_maps)
    assert a._mesh_pipe.programs.captures == caps
    assert set(caps.values()) == {1}


def test_calibrate_and_load_prewarm_the_resolve(mesh, tmp_path):
    st = mesh["st"]
    keys = {k[0][0] for k in st._mesh_pipe.programs.programs}
    assert keys == {"warp", "salience", "detect", "match", "inliers",
                    "compose"}
    path = str(tmp_path / "calib.npz")
    st.save_calibration(path)
    loaded = Stitcher(st.cfg, device="cpu")
    loaded.load_calibration(path)
    assert {k[0][0] for k in loaded._mesh_pipe.programs.programs} == keys
    from video_stitcher_tpu_torch.calib.calibration import plan_geometry
    other = plan_geometry(dataclasses.replace(st.cfg,
                                              compose_megapix=0.03))[0]
    with pytest.raises(ValueError, match="another geometry"):
        tpipeline.prewarm_mesh_programs(st.cfg, other, loaded._mesh_pipe)
    # update_masks, set on the stitcher after calibration: prewarm adds
    # the re-warped weights' program
    loaded.cfg = dataclasses.replace(st.cfg, update_masks=True)
    loaded.prewarm_mesh()
    assert {k[0][0] for k in loaded._mesh_pipe.programs.programs} == \
        keys | {"rebuild"}
