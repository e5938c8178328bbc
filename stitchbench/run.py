"""The benchmark's command: one run of one cell on this machine's card.

    python3 stitchbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the repository's root. Prints the result as one JSON line, the last
of standard output, and the numbers the comparison held to their limits
as the last lines of standard error. Exits 2 without a result when the
machine lacks the cards the cell asks for, and 3 when the process loaded
JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from stitchbench import harness
    bench = harness.load_benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    import torch
    chips = cells[a.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), torch.device("cuda", 0),
                                  T_START, bench=bench)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    print(card_line(), file=sys.stderr)
    print(json.dumps(finite(result["info"])), file=sys.stderr)
    for name, value, limit in result["checks"]:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    # a tail that falls on a frame that never came reads Infinity (and
    # the run is not correct: frames_missing)
    print(json.dumps({k: v if k == "metrics" else finite(v)
                      for k, v in result.items()}))
    return 0


def finite(x):
    """x with each non-finite float as None (strict JSON)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


if __name__ == "__main__":
    sys.exit(main())
