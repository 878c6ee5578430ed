"""Shared arithmetic of the per-layer readers: the records of requests
that started in the window, and percentiles of their stages."""
from __future__ import annotations

from typing import List, Optional

from kvb.window import quantile


def started(run) -> List:
    """Records due in the window whose start-of-life ran (every start is
    cold: the cells run PD)."""
    return [r for r in run.window.due_in_window() if r.breakdown]


def stage_ms(run, stage: str, q: float) -> Optional[float]:
    vals = [r.breakdown[stage] for r in started(run) if stage in r.breakdown]
    return quantile(vals, q) * 1e3 if vals else None
