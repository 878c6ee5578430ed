"""The 3D Pareto frontier over (Accuracy ↑, CR ↑, Latency ↓) — Sec. 5.2.3.

The frontier is the static runtime lookup table the Service-Aware Online
Controller selects from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import Profile


@dataclass(frozen=True)
class ParetoPoint:
    acc: float   # higher better
    cr: float    # higher better
    lat: float   # lower better (s per byte at reference bandwidth)
    profile: Profile


def profile_latency(p: Profile, ref_bandwidth: float) -> float:
    """Per-byte KV latency of a profile at a reference bandwidth:
    1/s_p + 1/(B·cr_p)  (Eq. 6 with V factored out)."""
    s_term = 0.0 if p.s_eff == float("inf") else 1.0 / p.s_eff
    return s_term + 1.0 / (ref_bandwidth * p.cr)


def dominates(a: ParetoPoint, b: ParetoPoint) -> bool:
    ge = (a.acc >= b.acc) and (a.cr >= b.cr) and (a.lat <= b.lat)
    strict = (a.acc > b.acc) or (a.cr > b.cr) or (a.lat < b.lat)
    return ge and strict


def pareto_frontier(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """O(n^2) non-dominated filter (n is a few hundred)."""
    out: List[ParetoPoint] = []
    for i, p in enumerate(points):
        if not any(dominates(q, p) for j, q in enumerate(points) if j != i):
            out.append(p)
    return out


def frontier_from_profiles(
    profiles: Sequence[Profile], workload: str, ref_bandwidth: float = 1e9
) -> List[ParetoPoint]:
    pts = [
        ParetoPoint(acc=p.q(workload), cr=p.cr,
                    lat=profile_latency(p, ref_bandwidth), profile=p)
        for p in profiles
    ]
    return pareto_frontier(pts)
