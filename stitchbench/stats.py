"""Order statistics over all of a window's samples."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest sample
    with at least a share q of the samples at or below it. A failed
    sample is infinite and sits above every other, so a rank that falls
    on one reads infinity."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
