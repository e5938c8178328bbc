"""One run of one cell: set-up, the measured window, the comparison.

Everything that belongs to a configuration, a traffic mix, a cell or a
metric is found by name under ``stitchbench/``:

* ``configs/<config>.json``: the StitcherConfig fields as they are run,
  and the frame format the rig delivers;
* ``traffic/<traffic>.json``: the generator's parameters
  (``stitchbench/traffic.py``);
* ``workloads/<cell>.json``: the cell's configuration, traffic and
  comparison limits;
* ``metrics/<metric>.py``: ``read(ctx)`` -> the metric, or None when the
  run has nothing to read for it;
* ``roofline/<name>.py``: ``bytes_needed(ctx)`` of a kernel or a step.

The program is the port (``video_stitcher_tpu_torch``): its Runner drives
the window, with the benchmark's source and sink and a Stitcher that
set-up calibrated (``Stitcher.calibrate``) on the cell's first frame set.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from stitchbench import judge
from stitchbench import reference as ref
from stitchbench import trace as tracing
from stitchbench.scene import make_ring
from stitchbench.traffic import Sink, Source, draw_sample

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "video_stitcher_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """stitchbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"stitchbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Optional[Path] = None) -> dict:
    with open((root or HERE.parent) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The names of the metrics a run of `cell` reports: its end-to-end
    metrics, or with a trace its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or (
                "workloads" not in m and m["moves"] in moved)]


def stitcher_config(cfg: dict):
    from video_stitcher_tpu_torch.config import StitcherConfig
    names = {f.name for f in dataclasses.fields(StitcherConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in names}
    return StitcherConfig(**kw)


def calibration_frames(frames, device: torch.device) -> np.ndarray:
    """A frame set as Stitcher.calibrate takes it: u8 RGB on the host;
    NV12 through the port's own conversion, cut to u8 as the Runner
    does when it calibrates from NV12 itself."""
    from video_stitcher_tpu_torch.ops.color import nv12_to_rgb
    t = torch.as_tensor(frames, device=device)
    if t.dim() == 3:
        t = nv12_to_rgb(t).to(torch.uint8)
    return t.cpu().numpy()


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not load:
    JAX, its relatives, and the JAX package the port was made from."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _layout(geom) -> ref.Layout:
    lay = geom.layout
    return ref.Layout(lay.pano_w, lay.pano_h, lay.band_w, lay.band_h,
                      lay.corners, lay.num_bands)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             bench: Optional[dict] = None, cfg_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             control: bool = False) -> dict:
    """One run of `cell`; returns the result line's object (with the
    checks under ``checks``). `cfg_override` and `traffic_override` let
    the CPU tests run the same path at a small size; `control` also
    judges the control (stitchbench/control.py) on the run's own frames
    and states, under ``info["control"]``."""
    from video_stitcher_tpu_torch.pipeline.runner import Runner
    from video_stitcher_tpu_torch.pipeline.stitcher import Stitcher
    from stitchbench.probe import Probe

    bench = bench if bench is not None else load_benchmark()
    wl = load_json("workloads", cell)
    cfg = dict(load_json("configs", wl["config"]))
    cfg.update(cfg_override or {})
    traffic = dict(load_json("traffic", wl["traffic"]))
    traffic.update(traffic_override or {})
    scfg = stitcher_config(cfg)

    # --- set-up: the scene, the frames, the stitcher ---------------------
    rig, ring = make_ring(cfg, traffic, seed, device)
    if traffic["frames_on"] == "host":
        ring = [np.ascontiguousarray(r.cpu().numpy()) for r in ring]
    st = Stitcher(scfg, device=device)
    probe = Probe(st)
    source = Source(ring, traffic, seconds)
    sample = draw_sample(traffic, seconds, seed, source.first)
    sink = Sink(sample)
    runner = Runner(scfg, source=source, sink=sink, stitcher=st,
                    consume_device=traffic["output_to"] == "device")
    st.calibrate(calibration_frames(ring[0], device))

    window = None
    if trace:
        if device.type == "cuda":
            tracing.prepare(device)
        probe.traced = True
        length = min(traffic["trace_seconds"], seconds / 2)
        window = tracing.Window(source, seconds - length, length)
        window.start()

    # --- the window ---------------------------------------------------------
    runner.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = int(torch.cuda.max_memory_allocated(device))
    else:
        memory_peak = 0
    events = None
    if window is not None:
        window.join(timeout=60.0)
        events = tracing.collect(window, probe.spans)
    if source.t0 is None:
        raise RuntimeError("the window never opened")
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)

    # --- what the metrics read -------------------------------------------
    t0, t1 = source.t0, source.t1
    seqs = list(source.window_seqs())
    done = sink.done
    lat = sorted((done[s] - source.due[s]) * 1e3 if s in done else math.inf
                 for s in seqs)
    geom = st.geom
    lay = _layout(geom)
    latest = probe.states[probe.gen]
    ctx = {
        "seconds": seconds,
        "setup_s": t0 - t_start,
        "completed_in_window": sum(1 for t in done.values() if t0 <= t <= t1),
        "latencies_ms": lat,
        "calibrate_s": sum(e - s for s, e in probe.calibrate_spans),
        "resolve_ms": [(e - s) * 1e3 for s, e in probe.resolve_spans
                       if t0 <= s and e <= t1],
        "frame_format": cfg["frame_format"],
        "maps": latest.fused_maps,
        "src_hw": (geom.warp_src_h, geom.warp_src_w),
        "peak_bytes_per_s": peak_bandwidth(device),
        "trace": None,
    }
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    breakdown = None
    if events is not None:
        w0, w1 = tracing.bounds(events)
        red = tracing.reduce(events, w0, w1)
        red["frames"] = sum(1 for t in done.values()
                            if window.t0 <= t <= window.t1)
        ctx["trace"] = red
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}

    metrics = {}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name in cell_metrics(bench, cell, trace):
        value = load_module("metrics", name).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    # --- the comparison, with the program's state freed ------------------
    keep = {g: probe.states[g].fused_maps for g in
            {probe.gen_of[s] for s in seqs if s in probe.gen_of}
            | set(g for g in probe.states if g >= 2)}
    calib = probe.states[1]
    gains, weights0 = calib.gains, st.aux["weights0"]
    global_maps = calib.fused_maps
    gen_of = dict(probe.gen_of)
    kept = sink.kept
    del runner, st, probe, latest, calib, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sampled = [s for s in seqs if s in sample]
    numbers, info = compare(cfg, rig, ring, lay, keep, global_maps, gains,
                            weights0, gen_of, kept, sampled, device)
    numbers["frames_missing"] = sum(1 for s in seqs if s not in done)
    correct, checks = judge.verdict(numbers, wl["limits"])
    out = {"correct": correct, "attempted": len(seqs),
           "failed": sum(1 for s in seqs if s not in done),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        cnum, _ = compare(cfg, rig, ring, lay, keep, global_maps, gains,
                          weights0, gen_of, kept, sampled, device,
                          control=True)
        cnum["frames_missing"] = numbers["frames_missing"]
        info["control"] = judge.verdict(cnum, wl["limits"])
    out["info"] = info
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the benchmark's process: "
                         + ", ".join(names))
        self.names = names


def peak_bandwidth(device: torch.device) -> Optional[float]:
    """The card's published memory bandwidth (roofline/peaks.json), by
    its name; None off the card."""
    if device.type != "cuda":
        return None
    with open(HERE / "roofline" / "peaks.json") as f:
        peaks = json.load(f)
    name = torch.cuda.get_device_name(device)
    for kind, p in peaks.items():
        if kind in name:
            return p["hbm_bytes_per_s"]
    return None


def compare(cfg, rig, ring, lay, maps_by_gen, global_maps, gains, weights0,
            gen_of, kept, sampled, device, control=False):
    """(numbers, info) of the comparison (stitchbench/judge.py). With
    `control`, the reference computed in the lower precision takes the
    program's place as the frames judged."""
    out_h, out_w = judge.out_size(cfg, lay)
    wpyr, valid = ref.weight_pyramids(weights0.to(device), lay)
    rms = []
    for s in sampled:
        if s not in gen_of or (not control and s not in kept):
            rms.append(math.inf)
            continue
        frames = torch.as_tensor(ring[s % len(ring)]).to(device)
        maps = maps_by_gen[gen_of[s]].to(device)
        args = (frames, maps, gains.to(device), wpyr, valid, lay, out_h,
                out_w)
        want = ref.stitch(*args)
        got = ref.stitch(*args, store=ref.fp8_store) if control else kept[s]
        rms.append(judge.frame_rms(got, want))
    planted = judge.mesh_px(global_maps, rig, lay)
    meshes = {g: judge.mesh_px(m, rig, lay) for g, m in maps_by_gen.items()}
    worst = max(meshes.values()) if meshes else math.inf
    ref_gains = ref.ring_gains(torch.as_tensor(ring[0]).to(device),
                               cfg["seam_megapix"], cfg["fov_deg"])
    numbers = {"frame_rms": max(rms) if rms else math.inf,
               "mesh_px": worst,
               "mesh_left": worst / planted,
               "gain_err": judge.gain_err(gains, ref_gains),
               "seam_err": judge.seam_err(weights0.to(device),
                                          global_maps.to(device), rig, lay)}
    info = {"frames_compared": len(rms), "meshes_compared": len(meshes),
            "mesh_px_global": planted}
    return numbers, info
