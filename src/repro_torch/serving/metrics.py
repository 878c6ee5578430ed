"""Latency-distribution metrics shared by every serving backend.

Means hide exactly what SLO serving is about: the tail.  This module
computes the p50/p95/p99 TTFT and JCT quantiles plus per-SLO-class
violation rates from any population of finished requests — the
real-execution :class:`~repro.serving.engine.ServingRuntime`, the
multi-worker :class:`~repro.serving.cluster.ClusterRuntime`, and the
event-driven :class:`~repro.serving.simulator.Simulator` all feed their
completions through :func:`latency_summary` so their ``summary()``
outputs are directly comparable.

Requests are duck-typed: anything with ``ttft``, ``jct``, ``slo_class``,
``t_slo`` and ``slo_violated`` attributes works (both
:class:`~repro.serving.request.Request` and the runtime's
``ServedRequest`` qualify).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

PERCENTILES = (50, 95, 99)


def percentile_row(values: Sequence[float], prefix: str
                   ) -> Dict[str, float]:
    """``{prefix_p50: ..., prefix_p95: ..., prefix_p99: ...}`` (empty when
    there are no values — absent keys beat fabricated zeros)."""
    vals = np.asarray(list(values), dtype=float)
    if vals.size == 0:
        return {}
    return {f"{prefix}_p{p}": float(np.percentile(vals, p))
            for p in PERCENTILES}


def violation_rates(requests: Iterable,
                    classes: Iterable[str] = ()) -> Dict[str, float]:
    """Per-SLO-class violation rates over requests that carry an SLO
    (``t_slo > 0``); ``slo_violation_rate`` is the all-class aggregate.

    ``classes`` forces a rate key for each named class even when no
    completed request of that class carried an SLO — reported as 0.0
    violations rather than silently dropped (a class that was entirely
    shed or starved still shows up in the summary)."""
    with_slo: Dict[str, list] = {cls: [] for cls in classes}
    for r in requests:
        if getattr(r, "t_slo", 0.0) > 0:
            with_slo.setdefault(r.slo_class, []).append(bool(r.slo_violated))
    out: Dict[str, float] = {}
    all_flags = [f for flags in with_slo.values() for f in flags]
    if all_flags:
        out["slo_violation_rate"] = float(np.mean(all_flags))
    for cls, flags in sorted(with_slo.items()):
        out[f"slo_violation_rate_{cls}"] = \
            float(np.mean(flags)) if flags else 0.0
    return out


def route_counts(requests: Iterable) -> Dict[str, float]:
    """``{route_<name>_completed: n}`` over requests that carry a
    placement route — one shared implementation for the cluster runtime
    and the topology-driven simulator."""
    by_route: Dict[str, int] = {}
    for r in requests:
        route = getattr(r, "route", "")
        if route:
            by_route[route] = by_route.get(route, 0) + 1
    return {f"route_{name}_completed": float(n)
            for name, n in sorted(by_route.items())}


def class_latency_blocks(requests: Sequence,
                         classes: Iterable[str] = ()) -> Dict[str, object]:
    """Per-SLO-class tail blocks: completed count plus TTFT/JCT
    p50/p95/p99 for every class observed among ``requests`` or named in
    ``classes``.  Edge cases are explicit, never NaN:

    * 0 completed in a class -> ``completed_<cls>`` is 0.0 and every
      percentile key is present with value ``None`` (the class is
      reported, not dropped);
    * 1 completed -> all three percentiles equal that request's latency.
    """
    by_cls: Dict[str, list] = {}
    for r in requests:
        by_cls.setdefault(getattr(r, "slo_class", "standard"), []).append(r)
    out: Dict[str, object] = {}
    for cls in sorted(set(classes) | set(by_cls)):
        rs = by_cls.get(cls, [])
        out[f"completed_{cls}"] = float(len(rs))
        if rs:
            out.update(percentile_row([r.ttft for r in rs], f"ttft_{cls}"))
            out.update(percentile_row([r.jct for r in rs], f"jct_{cls}"))
        else:
            for p in PERCENTILES:
                out[f"ttft_{cls}_p{p}"] = None
                out[f"jct_{cls}_p{p}"] = None
    return out


def speculation_stats(requests: Iterable,
                      classes: Iterable[str] = ()) -> Dict[str, float]:
    """Speculative-decode acceptance block (DESIGN.md §15), duck-typed on
    ``verify_steps`` / ``spec_committed`` / ``drafts_offered`` /
    ``drafts_accepted`` (requests without them — e.g. simulator records —
    contribute nothing).  Emitted only when at least one request actually
    took a verify step, so non-speculative summaries are unchanged:

    * ``spec_tokens_per_step``       — committed tokens per verify step,
      aggregated over all verify steps (the decode-throughput multiplier);
    * ``spec_tokens_per_step_<cls>`` — the same per SLO class;
    * ``spec_accept_rate``           — accepted / offered drafts.
    """
    steps = committed = offered = accepted = 0
    by_cls: Dict[str, list] = {cls: [0, 0] for cls in classes}
    for r in requests:
        vs = int(getattr(r, "verify_steps", 0) or 0)
        if vs <= 0:
            continue
        sc = int(getattr(r, "spec_committed", 0) or 0)
        steps += vs
        committed += sc
        offered += int(getattr(r, "drafts_offered", 0) or 0)
        accepted += int(getattr(r, "drafts_accepted", 0) or 0)
        cls = by_cls.setdefault(getattr(r, "slo_class", "standard"), [0, 0])
        cls[0] += vs
        cls[1] += sc
    if steps == 0:
        return {}
    out = {"spec_tokens_per_step": committed / steps}
    if offered > 0:
        out["spec_accept_rate"] = accepted / offered
    for cls, (vs, sc) in sorted(by_cls.items()):
        out[f"spec_tokens_per_step_{cls}"] = sc / vs if vs else None
    return out


def latency_summary(requests: Sequence,
                    classes: Optional[Iterable[str]] = None
                    ) -> Dict[str, float]:
    """The shared distribution block: TTFT/JCT p50/p95/p99 plus per-class
    violation rates.  Pass ``classes`` (the SLO classes the run was
    *supposed* to serve) to additionally emit per-class tail blocks with
    explicit zero/None reporting for empty classes — see
    :func:`class_latency_blocks`.  Runs with speculative decoding also
    get the acceptance block of :func:`speculation_stats`."""
    out: Dict[str, float] = {}
    out.update(percentile_row([r.ttft for r in requests], "ttft"))
    out.update(percentile_row([r.jct for r in requests], "jct"))
    out.update(violation_rates(requests, classes or ()))
    if classes is not None:
        out.update(class_latency_blocks(requests, classes))
    out.update(speculation_stats(requests, classes or ()))
    return out
