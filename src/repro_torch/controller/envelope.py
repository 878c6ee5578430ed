"""Theorem 6.2: the piecewise-optimal policy as a lower envelope of lines.

Each profile p is the line T̃_p(x) = 1/s_p + x/cr_p in x = 1/B.  Minimizing
over profiles = taking the lower envelope; the optimal profile is piecewise
constant in x with breakpoints where adjacent lines intersect.  Offline we
build the envelope per (workload, quality-bucket); online an O(log m) lookup
returns the optimal profile plus its envelope neighbours (the bandit's tiny
candidate set).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
from repro_torch.controller.latency_model import normalized_latency


@dataclass(frozen=True)
class Line:
    intercept: float  # 1/s_p
    slope: float      # 1/cr_p
    profile: Profile

    def at(self, x: float) -> float:
        return self.intercept + self.slope * x


@dataclass
class LowerEnvelope:
    """Sorted segments: x in [breaks[i], breaks[i+1]) -> lines[i]."""

    lines: List[Line] = field(default_factory=list)
    breaks: List[float] = field(default_factory=list)  # len(lines)-1 interior

    def optimal(self, inv_bandwidth: float) -> Profile:
        i = bisect.bisect_right(self.breaks, inv_bandwidth)
        return self.lines[i].profile

    def optimal_index(self, inv_bandwidth: float) -> int:
        return bisect.bisect_right(self.breaks, inv_bandwidth)

    def candidates(self, inv_bandwidth: float, n_neighbors: int = 1
                   ) -> List[Profile]:
        """Model-optimal profile + envelope neighbours (Sec. 6.2)."""
        i = self.optimal_index(inv_bandwidth)
        lo = max(i - n_neighbors, 0)
        hi = min(i + n_neighbors + 1, len(self.lines))
        return [l.profile for l in self.lines[lo:hi]]


def line_of(p: Profile) -> Line:
    s_term = 0.0 if p.s_eff == float("inf") else 1.0 / p.s_eff
    return Line(intercept=s_term, slope=1.0 / p.cr, profile=p)


def build_envelope(profiles: Sequence[Profile],
                   include_identity: bool = True) -> LowerEnvelope:
    """Classic lower-envelope construction over lines (convex duality).

    Sort by slope descending (x→0 favours small intercept; x→∞ favours
    small slope) and run the incremental hull check."""
    lines = [line_of(p) for p in profiles]
    if include_identity:
        lines.append(line_of(IDENTITY_PROFILE))
    # dedupe: keep lowest intercept per slope
    by_slope: Dict[float, Line] = {}
    for l in lines:
        cur = by_slope.get(l.slope)
        if cur is None or l.intercept < cur.intercept:
            by_slope[l.slope] = l
    lines = sorted(by_slope.values(), key=lambda l: (-l.slope, l.intercept))

    # prune lines dominated at x=0 with steeper slope AND higher intercept
    hull: List[Line] = []
    breaks: List[float] = []

    def intersect(a: Line, b: Line) -> float:
        return (b.intercept - a.intercept) / (a.slope - b.slope)

    for l in lines:
        while hull:
            top = hull[-1]
            if l.intercept <= top.intercept:
                # l is never worse than top anywhere (slope smaller too)
                hull.pop()
                if breaks:
                    breaks.pop()
                continue
            x = intersect(top, l)
            if breaks and x <= breaks[-1]:
                hull.pop()
                breaks.pop()
                continue
            breaks.append(x)
            break
        hull.append(l)
    return LowerEnvelope(lines=hull, breaks=breaks)


def brute_force_optimal(profiles: Sequence[Profile], inv_bandwidth: float,
                        include_identity: bool = True) -> Profile:
    """O(n) argmin for property-testing the envelope."""
    cands = list(profiles) + ([IDENTITY_PROFILE] if include_identity else [])
    return min(cands, key=lambda p: normalized_latency(p, inv_bandwidth))
