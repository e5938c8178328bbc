"""The per-frame programs (``pipeline/step_graph.py``): one program per
key (the step, the frames' shape and dtype, the geometry), as the JAX
package jit-compiles its step. On the card a program replays a CUDA
graph; on the CPU its replay runs the same step eagerly on the same
buffers, which is what these tests drive (the capture itself runs in
chip_smoke.py's phase "graph").

On the 6x320x180 ring (the JAX package's calibration handed across) and
the 4x640x360 prewarp rig of tests/test_torch_prewarp.py: each key's
replay equals the module functions bit for bit, and the JAX package's
stitch within 3/255 (BASELINE.md:22), RGB on the ring >= 40 dB against
the scene; an output is not written by the next call; a swap (maps
perturbed so that the active tile count changes, every step of an
interpolation) is a copy into the buffers, not a new program, and gives
what a fresh stitcher with that state gives; keys alternated on one
stitcher give what separate stitchers give; a calibration with a new
geometry builds new programs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)

from video_stitcher_tpu import Stitcher as JStitcher
from video_stitcher_tpu.calib.calibration import plan_geometry as j_plan
from video_stitcher_tpu.config import StitcherConfig as JConfig
from video_stitcher_tpu.ops.color import rgb_to_nv12
from video_stitcher_tpu.utils.synth import make_scene, psnr, render_views
from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.interop import state_from_numpy
from video_stitcher_tpu_torch.ops.remap_strips import plan_remap
from video_stitcher_tpu_torch.pipeline.stitcher import (
    blend_resize_pack, stitch_pano, warp_bands,
)

MAX_ABS = 3            # u8, BASELINE.md:22
MIN_PSNR = 40.0        # RGB pano against the scene (bench.py's bound)
RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False, recalibrate=False)
PREWARP = dict(num_images=4, input_width=640, input_height=360,
               compose_megapix=0.04, enable_local=False, recalibrate=False,
               output_width=960, output_height=400, keep_aspect_ratio=True,
               add_black_bars=True)
ENTRIES = ["stitch", "stitch_nv12", "stitch_out"]


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _scene_psnr(pano, scene, valid):
    gt = np.moveaxis(scene, 0, -1)
    h = pano.shape[0]
    sel = valid[h // 4:3 * h // 4]
    return psnr(pano[h // 4:3 * h // 4][sel], gt[h // 4:3 * h // 4][sel])


def _rig(kw, seed, jax_op_by_op):
    jcfg = JConfig(**kw)
    geom, _ = j_plan(jcfg)
    rng = np.random.default_rng(seed)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(jcfg, geom, scene)
    frames2 = np.clip(frames.astype(np.int32)
                      + rng.integers(-20, 20, frames.shape), 0, 255
                      ).astype(np.uint8)
    nv12 = np.stack([np.asarray(rgb_to_nv12(f)) for f in frames])
    jst = JStitcher(jcfg)
    cfg = StitcherConfig(**kw)
    if jax_op_by_op:                 # as tests/test_torch_prewarp.py
        with jax.disable_jit():
            jst.calibrate(frames)
        st = Stitcher(cfg, device="cpu")
        st.calibrate(frames)
        state = st.state
    else:                            # as tests/test_torch_stitch_e2e.py
        jst.calibrate(frames)
        state = state_from_numpy(
            np.asarray(jst.state.fused_maps), np.asarray(jst.state.gains),
            [np.asarray(w) for w in jst.state.weight_pyr],
            np.asarray(jst.state.valid_mask), device="cpu")
    return dict(cfg=cfg, jst=jst, state=state, frames=frames,
                frames2=frames2, nv12=nv12, scene=scene)


@pytest.fixture(scope="module")
def ring():
    return _rig(RING, 7, jax_op_by_op=False)


@pytest.fixture(scope="module")
def prewarp():
    return _rig(PREWARP, 5, jax_op_by_op=True)


def _stitcher(rig, state=None):
    st = Stitcher(rig["cfg"], device="cpu")
    st.swap_state(rig["state"] if state is None else state)
    return st


def _module_step(st, entry, frames):
    """What the module functions give for `entry` on the installed
    state, with no program."""
    state, geom, plan = st._snapshot()
    x = torch.as_tensor(frames)
    if entry == "stitch_out":
        return blend_resize_pack(warp_bands(x, state, geom, plan), state,
                                 geom, *st._out_size(geom))
    return stitch_pano(x, state, geom, plan)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("rig_name", ["ring", "prewarp"])
def test_replay_equals_the_module_functions_and_jax(rig_name, entry,
                                                    request):
    rig = request.getfixturevalue(rig_name)
    st, jst = _stitcher(rig), rig["jst"]
    frames = rig["nv12"] if entry == "stitch_nv12" else rig["frames"]
    got = getattr(st, entry)(frames, device=True)
    assert torch.equal(got, _module_step(st, entry, frames))
    (key, prog), = st.programs.programs.items()
    step = ("stitch_out",) + st._out_size(st.geom) if entry == \
        "stitch_out" else ("stitch_pano",)
    assert key == (step, frames.shape, torch.uint8) and prog.replays == 1
    assert st.programs.captures == {prog.name: 1}
    host = getattr(st, entry)(frames)
    assert _diff(host, getattr(jst, entry)(frames)) <= MAX_ABS
    if rig_name == "ring" and entry == "stitch":
        valid = st.state.valid_mask.numpy() > 0
        assert _scene_psnr(host, rig["scene"], valid) >= MIN_PSNR
    assert prog.replays == 2 and len(st.programs.programs) == 1


@pytest.mark.parametrize("entry", ENTRIES)
def test_an_output_is_not_written_by_the_next_call(ring, entry):
    st = _stitcher(ring)
    sets = ((ring["nv12"], np.stack([np.asarray(rgb_to_nv12(f))
                                     for f in ring["frames2"]]))
            if entry == "stitch_nv12" else (ring["frames"],
                                            ring["frames2"]))
    first = getattr(st, entry)(sets[0], device=True)
    held = first.clone()
    second = getattr(st, entry)(sets[1], device=True)
    prog, = st.programs.programs.values()
    assert first.data_ptr() not in (second.data_ptr(),
                                    prog.output.data_ptr())
    assert torch.equal(first, held) and not torch.equal(first, second)
    assert torch.equal(second, _module_step(st, entry, sets[1]))


def _perturbed(state):
    """Maps shifted by a few pixels with a third of each band marked
    invalid: K1's tile plan has another count of active tiles."""
    m = state.fused_maps.clone()
    valid = m > -1.0
    m = torch.where(valid, m + torch.tensor([2.5, -1.5])[None, :, None,
                                                         None], m)
    m[:, :, :, : m.shape[3] // 3] = -1.0
    return state._replace(fused_maps=m.contiguous())


@pytest.mark.parametrize("entry", ["stitch", "stitch_out"])
def test_swaps_are_copies_into_the_buffers(ring, entry):
    st = _stitcher(ring)
    old = st.state
    getattr(st, entry)(ring["frames"], device=True)
    captures = dict(st.programs.captures)
    prog, = st.programs.programs.values()
    new = _perturbed(old)
    plans = [plan_remap(s.fused_maps, st.geom.warp_src_h,
                        st.geom.warp_src_w) for s in (old, new)]
    assert plans[1].n_active != plans[0].n_active
    steps = [new] + [Stitcher.interpolate_states(old, new, t)
                     for t in (0.25, 0.5, 0.75, 1.0)] + [old]
    for state in steps:
        st.swap_state(state)
        got = getattr(st, entry)(ring["frames"], device=True)
        fresh = _stitcher(ring, state)
        assert torch.equal(got, getattr(fresh, entry)(ring["frames"],
                                                      device=True))
        assert torch.equal(st.programs.buffers.plan.count, st.plan.count)
        assert torch.equal(st.programs.buffers.state.fused_maps,
                           st.state.fused_maps)
    assert st.programs.programs == {prog.key: prog}
    assert st.programs.captures == captures
    assert prog.replays == 1 + len(steps)


def test_a_state_of_another_geometry_is_refused(ring):
    st = _stitcher(ring)
    st.stitch(ring["frames"], device=True)
    bad = ring["state"]._replace(gains=ring["state"].gains[:3])
    with pytest.raises(ValueError, match="buffers"):
        st.programs.install(st.geom, bad, st.plan)


def test_alternating_keys_equal_separate_stitchers(ring):
    st = _stitcher(ring)
    nv12_2 = np.stack([np.asarray(rgb_to_nv12(f)) for f in ring["frames2"]])
    calls = [("stitch", ring["frames"]), ("stitch_out", ring["nv12"]),
             ("stitch_nv12", nv12_2), ("stitch_out", ring["frames2"]),
             ("stitch", ring["frames2"]), ("stitch_out", nv12_2),
             ("stitch_nv12", ring["nv12"]), ("stitch_out", ring["frames"])]
    alone = {}
    for entry, frames in calls:
        got = getattr(st, entry)(frames, device=True)
        key = (entry == "stitch_out", frames.ndim)
        if key not in alone:
            alone[key] = _stitcher(ring)
        want = getattr(alone[key], entry)(frames, device=True)
        assert torch.equal(got, want), entry
    # stitch and stitch_nv12 share the step; RGB and NV12 are two keys
    assert len(st.programs.programs) == 4
    assert set(st.programs.captures.values()) == {1}
    assert sorted(p.replays for p in st.programs.programs.values()) == [
        2, 2, 2, 2]


def test_a_new_geometry_builds_new_programs(ring):
    cfg2 = dataclasses.replace(ring["cfg"], compose_megapix=0.03)
    st = Stitcher(ring["cfg"], device="cpu")
    st.calibrate(ring["frames"])
    st.stitch_out(ring["frames"], device=True)
    geom1 = st.geom
    prog1, = st.programs.programs.values()
    st.calibrate(ring["frames"])          # the same geometry: kept
    assert st.geom == geom1
    assert st.programs.programs == {prog1.key: prog1}
    st.cfg = cfg2
    st.calibrate(ring["frames"])          # a new geometry: dropped
    assert st.geom != geom1 and st.programs.programs == {}
    got = st.stitch_out(ring["frames"], device=True)
    prog2, = st.programs.programs.values()
    assert prog2 is not prog1 and prog2.buffers is not prog1.buffers
    assert sum(st.programs.captures.values()) == 2
    fresh = Stitcher(cfg2, device="cpu")
    fresh.calibrate(ring["frames"])
    assert torch.equal(got, fresh.stitch_out(ring["frames"], device=True))


def test_no_collection_holds_the_collector_off_while_graphs_capture():
    """While any capture is under way the cyclic collector is off (a
    collection could destroy an unreachable program's graph inside the
    capture); after the last one it is as it was before the first."""
    import gc
    import threading
    from video_stitcher_tpu_torch.pipeline.step_graph import no_collection
    was = gc.isenabled()
    try:
        gc.enable()
        inside, outside = threading.Event(), threading.Event()

        def other():
            with no_collection():
                inside.set()
                outside.wait(10)
        t = threading.Thread(target=other)
        with no_collection():
            assert not gc.isenabled()
            t.start()
            assert inside.wait(10)
        assert not gc.isenabled()          # the other capture is open
        outside.set()
        t.join(10)
        assert not t.is_alive() and gc.isenabled()
        gc.disable()                       # off before: off after
        with no_collection(), no_collection():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
