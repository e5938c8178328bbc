"""The harness finds every piece by name, and nothing in the folder is
left that no cell uses."""

import json
from pathlib import Path

import pytest

from stitchbench import harness

HERE = harness.HERE
BENCH = harness.load_benchmark()


def test_benchmark_names_each_file():
    for c in BENCH["configs"]:
        assert Path(HERE.parent / c["file"]).is_file()
        assert c["file"] == f"stitchbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        wl = harness.load_json("workloads", w["name"])
        assert wl["config"] == w["config"]
        assert wl["traffic"] == w["traffic"]
        harness.load_json("configs", wl["config"])
        harness.load_json("traffic", wl["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_nothing_unused():
    used = {("configs", c["name"]) for c in BENCH["configs"]}
    used |= {("traffic", w["traffic"]) for w in BENCH["workloads"]}
    used |= {("workloads", w["name"]) for w in BENCH["workloads"]}
    used |= {("metrics", m["name"])
             for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for kind in ("configs", "traffic", "workloads", "metrics"):
        for f in (HERE / kind).iterdir():
            if f.suffix in (".json", ".py"):
                assert (kind, f.name[:-len(f.suffix)]) in used, f


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_its_metrics(cell):
    e2e = harness.cell_metrics(BENCH, cell, trace=False)
    layer = harness.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in BENCH["per_layer"]:
        if m["name"] in layer:
            assert m["moves"] in e2e


def test_configs_hold_every_setting_once():
    from video_stitcher_tpu_torch.config import StitcherConfig
    import dataclasses
    for c in BENCH["configs"]:
        with open(HERE.parent / c["file"]) as f:
            text = f.read()
        cfg = json.loads(text)
        for field in dataclasses.fields(StitcherConfig):
            assert field.name in cfg
            assert text.count(f'"{field.name}"') == 1
        assert harness.stitcher_config(cfg).pipeline_mode == "threaded"
