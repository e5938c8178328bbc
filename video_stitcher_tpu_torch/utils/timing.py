"""Per-stage timers + FPS meter.

The reference hand-rolls this with times[5] checkpoints and a 30-frame FPS
print (360_stitcher/timed.cpp:43-44,61-119,372-381)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional


class StageTimers:
    def __init__(self, stages: List[str]):
        self.sums: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # pre-seed so summary() keeps the declared order and a stage
        # that never ran shows as 0.0ms instead of silently missing
        for s in stages:
            self.sums[s] += 0.0
            self.counts[s] += 0

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def add(self, stage: str, seconds: float) -> None:
        """Count one run of `stage` that took `seconds` (a span's time:
        the Runner's stages are utils/trace spans, ``span(into=)``)."""
        self.sums[stage] += seconds
        self.counts[stage] += 1

    def mean_ms(self, stage: str) -> float:
        c = self.counts[stage]
        return self.sums[stage] / c * 1e3 if c else 0.0

    def summary(self) -> str:
        return " ".join(f"{k}={self.mean_ms(k):.1f}ms" for k in self.sums)

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()


class FpsMeter:
    """Prints-worthy FPS every `period` frames (timed.cpp:372-381)."""

    def __init__(self, period: int = 30):
        self.period = period
        self.count = 0
        self.t0 = time.perf_counter()

    def tick(self) -> Optional[float]:
        self.count += 1
        if self.count >= self.period:
            t1 = time.perf_counter()
            fps = self.count / (t1 - self.t0)
            self.count = 0
            self.t0 = t1
            return fps
        return None
