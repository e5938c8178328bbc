"""A whole run of a cell on the CPU at a small size (the look for a card
skipped): a sound run comes out correct; the control and each fault the
cells can have come out not correct, through the same judge."""

import time

import pytest
import torch

from stitchbench import faults, harness
import video_stitcher_tpu_torch.pipeline.stitcher as stitcher_mod

SMALL = dict(input_width=320, input_height=180, output_width=640,
             output_height=320)
TRAFFIC = dict(ring_sets=3, warmup_frames=2, expect_fps=4, sample_frames=3,
               rate_hz=4)
SEED = 2**31 + 977


def run(cell="r1080-nv12-dev-flat", **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 2.0, False, torch.device("cpu"),
                            time.perf_counter(), cfg_override=SMALL,
                            traffic_override=TRAFFIC, **kw)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)       # the Runner may write result.jpg


@pytest.mark.parametrize("cell", ["r1080-nv12-dev-flat",
                                  "r1080-rgb-dev-flat",
                                  "r1080-nv12-host-live60"])
def test_sound_run_is_correct_and_the_control_is_not(cell):
    r = run(cell, control=True)
    assert r["correct"], r["checks"]
    assert r["info"]["frames_compared"] >= 1
    ok, checks = r["info"]["control"]
    assert not ok, checks
    assert dict((k, v) for k, v, _ in checks)["frame_rms"] > dict(
        (k, lim) for k, _, lim in checks)["frame_rms"]


@pytest.mark.parametrize("fault,number", [
    ("mesh_noop", "mesh_left"),
    ("frame_altered", "frame_rms"),
    ("half_cameras", "frame_rms"),
    ("stale_state", "frame_rms"),
    ("gain_none", "gain_err"),
    ("seam_none", "seam_err"),
])
def test_planted_fault_is_not_correct(fault, number):
    with faults.planted(fault):
        r = run()
    assert not r["correct"]
    checks = {k: (v, lim) for k, v, lim in r["checks"]}
    assert checks[number][0] > checks[number][1], r["checks"]
    if fault == "mesh_noop":
        assert checks["mesh_left"][0] == 1.0


def test_faults_are_restored():
    before = (stitcher_mod.warp_bands, stitcher_mod.Stitcher._install)
    with faults.planted("half_cameras"):
        assert stitcher_mod.warp_bands is not before[0]
    with faults.planted("stale_state"):
        pass
    assert (stitcher_mod.warp_bands, stitcher_mod.Stitcher._install) == before
