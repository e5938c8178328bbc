"""What the benchmark's process loads, checked in a fresh interpreter by
whole top-level module names."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    tops = top_level_after(
        "import stitchbench.run, stitchbench.harness, stitchbench.control\n"
        "import stitchbench.probe\n"
        "from video_stitcher_tpu_torch.pipeline.runner import Runner\n"
        "from video_stitcher_tpu_torch.pipeline.stitcher import Stitcher\n")
    assert not tops & {"jax", "jaxlib", "flax", "video_stitcher_tpu"}
    assert "video_stitcher_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = top_level_after(
        "import stitchbench.reference, stitchbench.judge, stitchbench.scene\n")
    assert not tops & {"video_stitcher_tpu_torch", "video_stitcher_tpu",
                       "jax"}
