"""The readings the comparison's limits are set from (not run by the
benchmark's own runs).

    python3 stitchbench/control.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--fault <name>[,<name>...]]

For each fault ("" for none) and each seed, one run of the cell as
run.py makes it, in one process; each prints one JSON line with the
program's numbers and, judged by the same limits, the control's: the
plain reference computed with its pyramid stored in float8 e4m3 (the
step below the bfloat16 blend storage the configuration states), put in
the program's place on the run's own frame sets and states. The faults
are planted in the program (``stitchbench/faults.py``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default="",
                   help="comma-separated faults of stitchbench/faults.py")
    a = p.parse_args(argv)
    import torch
    from stitchbench import faults, harness
    from stitchbench.run import finite
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    for fault in a.fault.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            try:
                with faults.planted(fault):
                    r = harness.run_cell(a.workload, seed, a.seconds, False,
                                         torch.device("cuda", 0), t0,
                                         bench=bench, control=True)
            except Exception as e:  # noqa: BLE001 — a crash is a failed run
                print(json.dumps({"workload": a.workload, "seed": seed,
                                  "fault": fault, "correct": False,
                                  "error": repr(e)}), flush=True)
                torch.cuda.empty_cache()
                continue
            ok, checks = r["info"].pop("control")
            print(json.dumps(finite({
                "workload": a.workload, "seed": seed, "fault": fault,
                "correct": r["correct"], "checks": r["checks"],
                "control_correct": ok, "control_checks": checks,
                "info": r["info"], "metrics": r["metrics"]})), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
