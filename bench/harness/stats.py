"""Order statistics the metrics share."""
from __future__ import annotations

import statistics
from typing import Iterable, Optional


def nearest_rank(xs: Iterable[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (``runtime.frontdoor._percentile``'s rule:
    the ceil(q * n / 100)-th smallest), or None for no samples."""
    s = sorted(xs)
    if not s:
        return None
    rank = -(-int(q) * len(s) // 100)
    return s[max(0, min(len(s), rank) - 1)]


def median(xs: Iterable[float]) -> Optional[float]:
    s = list(xs)
    return statistics.median(s) if s else None
