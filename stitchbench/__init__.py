"""The benchmark of video_stitcher_tpu_torch on one NVIDIA H100: run
``python3 stitchbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root (BENCHMARK.json names the
cells)."""
