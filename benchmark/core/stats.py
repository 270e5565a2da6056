"""Order statistics of a run's samples."""

from __future__ import annotations

import math


def percentile(samples, p: float):
    """Nearest rank: the smallest sample with at least p % of them at or
    below it; None for no samples."""
    s = sorted(samples)
    if not s:
        return None
    return s[max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))]
