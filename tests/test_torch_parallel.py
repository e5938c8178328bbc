"""Camera sharding in the port (``parallel/shard.py``, the Stitcher's
sharded paths, ``parallel/dryrun.py``) on ``[cpu] * k``, the counterpart
of the JAX package's virtual host devices (tests/conftest.py).

- shard_state: contiguous camera blocks of ceil(n / k), shards with no
  camera, each shard's tensors and tile plan;
- the sharded step against the single-device stitch on the 6x96x54 rig
  of tests/test_parallel.py: bit-equal with one shard, within 1 (that
  test's bound) with 2, 3, 4 and 8;
- against the JAX package's build_sharded_step on its 8-device virtual
  mesh, the JAX state carried across (interop.py): the pano within 3,
  the output frame (out_size) within 4;
- Stitcher(camera_shards=4, device="cpu") through calibrate (with the
  CPW mesh), stage_frames, stitch*, swap_state, recalibrate_mesh,
  load_calibration and stitch_int16; the dry run; and the live Runner
  from memory with camera_shards=2, every output equal to stitch_out of
  its frame set.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.parallel import shard as jshard
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.ops.remap_strips import plan_remap
from video_stitcher_tpu_torch.parallel.dryrun import (
    dryrun_multichip, scene_frames,
)
from video_stitcher_tpu_torch.parallel.shard import (
    ShardedFrames, build_sharded_step, camera_blocks, shard_state,
)
from video_stitcher_tpu_torch.pipeline import stitcher as stitcher_mod
from video_stitcher_tpu_torch.pipeline.runner import Runner

CPU = torch.device("cpu")
SMALL = dict(num_images=6, input_width=96, input_height=54,
             enable_local=False, recalibrate=False)
LOCAL = dict(num_images=6, input_width=160, input_height=90,
             enable_local=True, recalibrate=False, output_width=320,
             output_height=160)


def _diff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def small():
    """tests/test_parallel.py's rig, calibrated by the JAX package; the
    port stitches from the same state, handed across as arrays."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (6, 54, 96, 3)).astype(np.uint8)
    jst = JStitcher(JConfig(**SMALL))
    jst.calibrate(frames)
    st = Stitcher(StitcherConfig(**SMALL), device="cpu")
    st.swap_state(state_from_numpy(
        np.asarray(jst.state.fused_maps), np.asarray(jst.state.gains),
        [np.asarray(w) for w in jst.state.weight_pyr],
        np.asarray(jst.state.valid_mask), device="cpu"))
    return st, jst, frames


@pytest.fixture(scope="module")
def local():
    """The dry run's 6x160x90 rig with the CPW mesh: one sharded and one
    single-device stitcher, each calibrated."""
    cfg = StitcherConfig(**LOCAL)
    frames = scene_frames(cfg)
    frames2 = np.clip(frames.astype(np.int16) + np.random.default_rng(5)
                      .integers(-12, 13, frames.shape), 0, 255
                      ).astype(np.uint8)
    one = Stitcher(cfg, device="cpu")
    one.calibrate(frames)
    four = Stitcher(dataclasses.replace(cfg, camera_shards=4), device="cpu")
    four.calibrate(frames)
    return one, four, frames, frames2


def test_camera_blocks():
    assert camera_blocks(6, 1) == [(0, 6)]
    assert camera_blocks(6, 2) == [(0, 3), (3, 6)]
    assert camera_blocks(6, 4) == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert camera_blocks(6, 8) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5),
                                   (5, 6), (6, 6), (6, 6)]
    assert camera_blocks(5, 3) == [(0, 2), (2, 4), (4, 5)]


@pytest.mark.parametrize("k", [4, 8])
def test_shard_state_blocks_plans_and_empty_shards(small, k):
    st = small[0]
    state, geom = st.state, st.geom
    sh = shard_state(state, geom, [CPU] * k)
    assert len(sh.shards) == k and sh.device == CPU
    np.testing.assert_array_equal(sh.valid_mask.numpy(),
                                  state.valid_mask.numpy())
    for s, (lo, hi) in zip(sh.shards, camera_blocks(6, k)):
        assert (s.lo, s.hi, s.device) == (lo, hi, CPU)
        assert s.corners == tuple(geom.layout.corners[lo:hi])
        assert all(type(c) is int for c in s.corners)
        assert torch.equal(s.fused_maps, state.fused_maps[lo:hi])
        assert torch.equal(s.gains, state.gains[lo:hi])
        assert len(s.weight_pyr) == len(state.weight_pyr)
        for w, full in zip(s.weight_pyr, state.weight_pyr):
            assert torch.equal(w, full[lo:hi])
        if hi == lo:
            assert s.plan is None and s.fused_maps.shape[0] == 0
            continue
        want = plan_remap(state.fused_maps[lo:hi], geom.warp_src_h,
                          geom.warp_src_w)
        assert torch.equal(s.plan.order, want.order)
        assert s.plan.n_active == want.n_active > 0
        assert s.plan.tiles[0] == hi - lo
    assert sum(s.plan is None for s in sh.shards) == {4: 1, 8: 2}[k]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_sharded_step_matches_single_device(small, k):
    st, _, frames = small
    sh = shard_state(st.state, st.geom, [CPU] * k)
    f = torch.as_tensor(frames)
    blocks = [f[s.lo:s.hi] for s in sh.shards]
    pano = build_sharded_step(st.geom, [CPU] * k)(blocks, sh).numpy()
    oh, ow = st._out_size(st.geom)
    out = build_sharded_step(st.geom, [CPU] * k, (oh, ow))(blocks,
                                                          sh).numpy()
    ref, ref_out = st.stitch(frames), st.stitch_out(frames, device=True)
    if k == 1:
        np.testing.assert_array_equal(pano, ref)
        np.testing.assert_array_equal(out, ref_out.numpy())
    assert _diff(pano, ref) <= 1 and _diff(out, ref_out) <= 1


def test_sharded_step_checks_its_inputs(small):
    st, _, frames = small
    sh = shard_state(st.state, st.geom, [CPU] * 2)
    step = build_sharded_step(st.geom, [CPU] * 3)
    with pytest.raises(ValueError, match="devices"):
        step([torch.as_tensor(frames)] * 2, sh)
    with pytest.raises(ValueError, match="frame blocks"):
        build_sharded_step(st.geom, [CPU] * 2)([torch.as_tensor(frames)],
                                               sh)


@pytest.mark.parametrize("k", [2, 8])
def test_sharded_step_matches_jax(small, k):
    """The JAX shard_map program on k virtual devices and the port's step
    on [cpu] * k, from one state."""
    st, jst, frames = small
    mesh = Mesh(np.array(jax.devices()[:k]), ("cam",))
    jstate, corners, total = jshard.shard_state(jst.state, jst.geom, mesh)
    jframes = jax.device_put(jshard.pad_cameras(frames, total),
                             NamedSharding(mesh, P("cam")))
    want = np.asarray(jshard.build_sharded_step(jst.geom, mesh)(
        jframes, jstate, corners))
    sh = shard_state(st.state, st.geom, [CPU] * k)
    f = torch.as_tensor(frames)
    got = build_sharded_step(st.geom, [CPU] * k)(
        [f[s.lo:s.hi] for s in sh.shards], sh).numpy()
    assert _diff(got, want) <= 3


#: the sharded bound (3, test_sharded_step_matches_jax) plus the 1 that
#: resizing the f32 pano, not the u8 one as the JAX step does, can add
SHARDED_OUT_VS_JAX = 3 + 1


@pytest.mark.parametrize("k", [2, 8])
def test_sharded_output_matches_jax(small, k):
    """The output frame of both sharded steps built with out_size: the
    port resizes the f32 pano (so one shard equals stitch_out bit for
    bit), the JAX step the u8 pano."""
    st, jst, frames = small
    out_size = st._out_size(st.geom)
    assert out_size == jst._out_size()
    mesh = Mesh(np.array(jax.devices()[:k]), ("cam",))
    jstate, corners, total = jshard.shard_state(jst.state, jst.geom, mesh)
    jframes = jax.device_put(jshard.pad_cameras(frames, total),
                             NamedSharding(mesh, P("cam")))
    want = np.asarray(jshard.build_sharded_step(
        jst.geom, mesh, out_size=out_size)(jframes, jstate, corners))
    sh = shard_state(st.state, st.geom, [CPU] * k)
    f = torch.as_tensor(frames)
    got = build_sharded_step(st.geom, [CPU] * k, out_size)(
        [f[s.lo:s.hi] for s in sh.shards], sh).numpy()
    assert got.shape == want.shape == out_size + (3,)
    assert _diff(got, want) <= SHARDED_OUT_VS_JAX


def test_resolve_shard_devices(monkeypatch):
    resolve = stitcher_mod.resolve_shard_devices
    assert resolve(1, CPU) is None
    assert resolve(3, CPU) == [CPU] * 3
    cuda = [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve(4, cuda[0]) is None          # one card: unsharded
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert resolve(2, cuda[0]) == cuda[:2]
    assert resolve(8, cuda[0]) == cuda
    assert resolve(2, cuda[1]) == [cuda[1], cuda[0]]


def test_sharded_stitcher_stitches_like_the_single_device_one(local):
    one, four, frames, frames2 = local
    assert [(s.lo, s.hi) for s in four._sharded.shards] == \
        camera_blocks(6, 4)
    staged = four.stage_frames(frames)
    assert isinstance(staged, ShardedFrames)
    assert [p.shape[0] for p in staged] == [2, 2, 2, 0]
    np.testing.assert_array_equal(four._frames(staged).numpy(), frames)
    for f in (frames, staged, torch.as_tensor(frames)):
        assert _diff(four.stitch(f), one.stitch(frames)) <= 1
        assert _diff(four.stitch_out(f), one.stitch_out(frames)) <= 1
    batch = four.stitch_batch(np.stack([frames, frames2]))
    assert _diff(batch[0], four.stitch(frames)) == 0
    assert _diff(batch[1], four.stitch(frames2)) == 0
    assert _diff(four.stitch_nv12(one_nv12(frames)),
                 one.stitch_nv12(one_nv12(frames))) <= 1
    # stitch_int16 runs on the stitcher's device, sharded or not
    np.testing.assert_array_equal(four.stitch_int16(staged),
                                  one.stitch_int16(frames))
    np.testing.assert_array_equal(
        four.stitch_int16(frames, state=four.state_global),
        one.stitch_int16(frames, state=one.state_global))


def one_nv12(frames):
    from video_stitcher_tpu_torch.ops.color import rgb_to_nv12
    return rgb_to_nv12(torch.as_tensor(frames)).numpy()


def test_sharded_stitcher_reshards_every_installed_state(local, tmp_path):
    """swap_state (each animation step), recalibrate_mesh and
    load_calibration each install new shards with the state."""
    one, four, frames, frames2 = local
    four = Stitcher(four.cfg, device="cpu")
    four.calibrate(frames)
    old, old_shards = four.state, four._sharded
    assert four.recalibrate_mesh(four.stage_frames(frames2))
    assert four._sharded is not old_shards
    assert torch.equal(four._sharded.shards[1].fused_maps,
                       four.state.fused_maps[2:4])
    new = four.state
    mix = four.interpolate_states(old, new, 0.5)
    four.swap_state(mix)
    assert torch.equal(four._sharded.shards[2].fused_maps,
                       mix.fused_maps[4:6])
    ref = Stitcher(one.cfg, device="cpu")
    ref.calibrate(frames)
    ref.swap_state(mix)
    assert _diff(four.stitch(frames2), ref.stitch(frames2)) <= 1
    ckpt = str(tmp_path / "calib.npz")
    ref.save_calibration(ckpt)
    before = four._sharded
    four.load_calibration(ckpt)
    assert four._sharded is not before and four.state_global is four.state
    assert _diff(four.stitch(frames), ref.stitch(frames)) <= 1


def test_camera_shards_resolve_and_shard_in_the_stitcher(local):
    one, four, _, _ = local
    assert one._shard_devices is None and one._sharded is None
    assert four._shard_devices == [CPU] * 4
    assert len(four._sharded.shards) == 4
    # an unsharded set is sliced per shard; a staged set is used as it is
    pieces = four._shard_frames(np.zeros((6, 90, 160, 3), np.uint8),
                                four._sharded)
    assert [p.shape[0] for p in pieces] == [2, 2, 2, 0]
    with pytest.raises(ValueError, match="staged for 2 shards"):
        four._shard_frames(ShardedFrames(pieces[:2]), four._sharded)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    got = dryrun_multichip(n)
    assert len(got["shards"]) == n and sum(got["shards"]) == 6
    assert got["max_abs"] <= 3 and got["max_abs_out"] <= 3


class _Cycle:
    def __init__(self, sets, limit):
        self.sets, self.limit, self.n = sets, limit, 0

    def get_frames(self):
        if self.n >= self.limit:
            return None
        out = self.sets[self.n % len(self.sets)]
        self.n += 1
        return out

    def release(self):
        pass


class _Sink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        self.frames.append(out)

    def release(self):
        pass


@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_runner_with_camera_shards(local, mode, tmp_path, monkeypatch):
    """The live Runner from memory with camera_shards=2: staged sets are
    per-shard pieces, and every output equals stitch_out of its set."""
    monkeypatch.chdir(tmp_path)            # the Runner writes calib.jpg
    one, _, frames, frames2 = local
    cfg = dataclasses.replace(one.cfg, camera_shards=2, pipeline_mode=mode,
                              sync_timeout_ms=10000.0)
    st = Stitcher(cfg, device="cpu")
    st.swap_state(one.state)
    st.aux = one.aux
    assert len(st._sharded.shards) == 2
    sets = [frames, frames2]
    want = [st.stitch_out(s) for s in sets]
    sink = _Sink()
    r = Runner(cfg, source=_Cycle(sets, 6), sink=sink, max_frames=5,
               stitcher=st)
    r.run()
    assert r.frames_done == 5 and len(sink.frames) == 5
    assert r.sync_stalls == r.stage_stalls == 0
    assert isinstance(r._latest_frames, ShardedFrames)
    for i, out in enumerate(sink.frames):
        # the first read is the calibration read, which a calibrated
        # stitcher's Runner discards
        assert _diff(out, want[(i + 1) % 2]) == 0
    assert st.recalibrate_mesh(r._latest_frames)
