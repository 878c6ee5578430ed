"""Scenario archetypes: what each request *is*, beyond when it arrives.

Four production archetypes, each mapped onto the ``data.synthetic``
workload families (their prompt generators and context scales are reused,
so a trace event can always be materialized into a real prompt for the
real-execution runtime):

* ``chat`` — interactive conversations behind a small set of HOT shared
  system prompts: high prefix-sharing probability over few groups
  (Zipf-skewed), short-to-medium contexts, tight TTFT SLO.
* ``rag`` — long-context retrieval-augmented generation: heavy-tailed
  contexts (lognormal), little sharing (every retrieval set differs),
  looser TTFT SLO, standard class.
* ``agentic`` — multi-turn tool-using sessions: each arrival spawns a
  session of several turns sharing ONE prefix group whose context GROWS
  turn over turn (the KV written by turn *i* covers a prefix of turn
  *i+1* — growing KV reuse), JCT SLO.
* ``classify`` — prefill-only one-token classification (FUTURE.md #5
  shape): out_tokens == 1, short contexts, high sharing on the classifier
  prompt, batch class.

Each archetype is declarative (:class:`ScenarioSpec`); generation is a
pure function of ``(spec, arrival times, rng)`` so traces are
seed-deterministic end to end.  :func:`build_trace` composes per-tenant
archetype + arrival-process pairs into one superposed trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import WORKLOADS
from repro_torch.workloads.arrivals import make_arrivals
from repro_torch.workloads.trace import Trace, TraceEvent

Rng = np.random.Generator


def _mix_scale(mix: Dict[str, float]) -> float:
    """Weighted mean ctx scale of a workload mix (tokens ~ bytes for the
    byte tokenizer) — ties archetype context medians to the synthetic
    workload families they draw prompts from."""
    tot = sum(mix.values())
    return sum(WORKLOADS[w].ctx_scale * p for w, p in mix.items()) / tot


@dataclass(frozen=True)
class ScenarioSpec:
    """Declarative archetype: lengths, sharing, turns, SLO contract."""

    name: str
    workload_mix: Dict[str, float]
    ctx_median: int               # lognormal median prompt tokens
    ctx_sigma: float = 0.4        # lognormal sigma
    ctx_min: int = 64
    ctx_max: int = 65536
    out_median: int = 32          # lognormal median decode tokens
    out_sigma: float = 0.5
    out_min: int = 1
    slo_class: str = "standard"
    slo_metric: str = "ttft"
    t_slo: float = 0.0
    q_min: float = 0.97
    # Prefix sharing: with probability share_p a request reuses one of
    # hot_groups Zipf-skewed shared groups; otherwise it opens its own.
    hot_groups: int = 0
    share_p: float = 0.0
    zipf_a: float = 1.3
    # Multi-turn sessions (agentic): mean turns per session (geometric),
    # think-time between turns, and context carried forward per turn
    # (prev ctx + prev output + fresh user tokens).
    turns_mean: float = 1.0
    turn_gap_s: float = 4.0
    turn_user_tokens: int = 96


def _lognormal_ints(rng: Rng, n: int, median: float, sigma: float,
                    lo: int, hi: int) -> np.ndarray:
    vals = rng.lognormal(math.log(median), sigma, size=n)
    return np.clip(vals, lo, hi).astype(np.int64)


def _zipf_groups(rng: Rng, n: int, k: int, a: float) -> np.ndarray:
    """n draws over k hot groups with Zipf(a) popularity."""
    w = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** a
    w /= w.sum()
    return rng.choice(k, size=n, p=w)


def generate_events(spec: ScenarioSpec, tenant: str, times: np.ndarray,
                    rng: Rng, group_start: int = 0
                    ) -> Tuple[List[TraceEvent], int]:
    """Expand arrival times into trace events for one (tenant, archetype)
    stream.  Returns ``(events, next_free_group)``; rids are dense in
    event-time order, local to this stream (``Trace.merge`` renumbers).
    All draws are vectorized up front so million-event streams build in
    seconds; sessions (``turns_mean > 1``) expand each arrival into its
    turns."""
    n = len(times)
    if n == 0:
        return [], group_start
    names = sorted(spec.workload_mix)
    probs = np.asarray([spec.workload_mix[w] for w in names], dtype=float)
    probs /= probs.sum()
    widx = rng.choice(len(names), size=n, p=probs)
    ctx = _lognormal_ints(rng, n, spec.ctx_median, spec.ctx_sigma,
                          spec.ctx_min, spec.ctx_max)
    out = _lognormal_ints(rng, n, spec.out_median, spec.out_sigma,
                          spec.out_min, 1 << 20)
    share = (rng.random(n) < spec.share_p) if spec.hot_groups > 0 \
        else np.zeros(n, dtype=bool)
    hot = _zipf_groups(rng, n, max(spec.hot_groups, 1), spec.zipf_a) \
        if spec.hot_groups > 0 else np.zeros(n, dtype=np.int64)
    multi_turn = spec.turns_mean > 1.0
    turns = (1 + rng.geometric(1.0 / spec.turns_mean, size=n)
             if multi_turn else np.ones(n, dtype=np.int64))

    rows: List[Tuple] = []       # (t, workload, ctx, out, group)
    next_group = group_start + spec.hot_groups
    for i in range(n):
        w = names[widx[i]]
        if share[i]:
            g = group_start + int(hot[i])
        else:
            g = next_group
            next_group += 1
        t = float(times[i])
        c, o = int(ctx[i]), int(out[i])
        rows.append((t, w, c, o, g))
        if multi_turn:
            # Session turns share the group; context grows by the prior
            # turn's output plus fresh user tokens, so each turn's pool
            # entry covers a strict prefix of the next turn's prompt.
            for _ in range(int(turns[i]) - 1):
                t = t + float(rng.exponential(spec.turn_gap_s))
                c = min(c + o + spec.turn_user_tokens, spec.ctx_max)
                o = int(_lognormal_ints(rng, 1, spec.out_median,
                                        spec.out_sigma, spec.out_min,
                                        1 << 20)[0])
                rows.append((t, w, c, o, g))
    rows.sort(key=lambda r: r[0])
    events = [TraceEvent(rid=i, t=r[0], tenant=tenant, scenario=spec.name,
                         workload=r[1], ctx_tokens=r[2], out_tokens=r[3],
                         prefix_group=r[4], slo_class=spec.slo_class,
                         slo_metric=spec.slo_metric, t_slo=spec.t_slo,
                         q_min=spec.q_min)
              for i, r in enumerate(rows)]
    return events, next_group


# ---------------------------------------------------------------------------
# The four archetypes (context medians anchored to the synthetic
# families' ctx scales via _mix_scale).
# ---------------------------------------------------------------------------
_CHAT_MIX = {"qalike": 0.5, "summlike": 0.3, "codelike": 0.2}
_RAG_MIX = {"qalike": 0.6, "summlike": 0.4}
_AGENTIC_MIX = {"codelike": 0.5, "mathlike": 0.5}
_CLASSIFY_MIX = {"mathlike": 0.5, "qalike": 0.5}

ARCHETYPES: Dict[str, ScenarioSpec] = {
    "chat": ScenarioSpec(
        name="chat", workload_mix=_CHAT_MIX,
        ctx_median=int(2 * _mix_scale(_CHAT_MIX)), ctx_sigma=0.5,
        out_median=48, slo_class="interactive", slo_metric="ttft",
        t_slo=1.5, hot_groups=12, share_p=0.65, zipf_a=1.3),
    "rag": ScenarioSpec(
        name="rag", workload_mix=_RAG_MIX,
        ctx_median=int(14 * _mix_scale(_RAG_MIX)), ctx_sigma=0.7,
        out_median=64, slo_class="standard", slo_metric="ttft",
        t_slo=8.0, hot_groups=0, share_p=0.0),
    "agentic": ScenarioSpec(
        name="agentic", workload_mix=_AGENTIC_MIX,
        ctx_median=int(2 * _mix_scale(_AGENTIC_MIX)), ctx_sigma=0.4,
        out_median=96, slo_class="standard", slo_metric="jct",
        t_slo=12.0, turns_mean=3.5, turn_gap_s=3.0),
    "classify": ScenarioSpec(
        name="classify", workload_mix=_CLASSIFY_MIX,
        ctx_median=int(1 * _mix_scale(_CLASSIFY_MIX)), ctx_sigma=0.3,
        out_median=1, out_sigma=0.0, slo_class="batch",
        slo_metric="ttft", t_slo=4.0, hot_groups=6, share_p=0.8),
}


# ---------------------------------------------------------------------------
# Tenant composition
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TenantSpec:
    """One tenant = one archetype stream under one arrival process."""

    name: str
    scenario: str                 # ARCHETYPES key
    rate: float                   # primary rate of the arrival process
    arrival: str = "poisson"      # poisson | diurnal | mmpp
    arrival_kw: Dict[str, object] = field(default_factory=dict)
    overrides: Dict[str, object] = field(default_factory=dict)
    # ScenarioSpec field overrides (e.g. tighter t_slo for a paid tier)


def default_tenants(rate_scale: float = 1.0) -> List[TenantSpec]:
    """The standard mixed-production tenant set used by the trace-grid
    benchmark: diurnal chat, steady RAG, bursty agentic, and an offline
    classification batch source."""
    return [
        TenantSpec("chat-web", "chat", 3.0 * rate_scale, "diurnal",
                   {"amplitude": 0.6, "gamma_shape": 4.0}),
        TenantSpec("rag-search", "rag", 1.0 * rate_scale, "poisson"),
        TenantSpec("agents", "agentic", 0.6 * rate_scale, "mmpp",
                   {"mean_on": 6.0, "mean_off": 14.0}),
        TenantSpec("classify-batch", "classify", 2.0 * rate_scale, "mmpp",
                   {"mean_on": 4.0, "mean_off": 10.0}),
    ]


def build_tenant_trace(tenant: TenantSpec, duration: float, seed: int,
                       stream: int = 0, group_start: int = 0
                       ) -> Tuple[Trace, int]:
    """One tenant's trace; deterministic in ``(tenant, duration, seed,
    stream)``.  Returns ``(trace, next_free_group)``."""
    spec = ARCHETYPES[tenant.scenario]
    if tenant.overrides:
        spec = replace(spec, **tenant.overrides)
    rng = np.random.default_rng((seed, 0x7E1A_17, stream))
    proc = make_arrivals(tenant.arrival, tenant.rate, **tenant.arrival_kw)
    times = proc.times(duration, rng)
    events, next_group = generate_events(spec, tenant.name, times, rng,
                                         group_start)
    meta = {"tenant": tenant.name, "scenario": tenant.scenario,
            "arrival": tenant.arrival, "rate": tenant.rate,
            "duration": duration}
    return Trace(events, seed=seed, meta=meta), next_group


def build_trace(tenants: Sequence[TenantSpec], duration: float,
                seed: int = 0) -> Trace:
    """Superpose per-tenant streams into one arrival-ordered trace.

    Each tenant gets an independent child rng stream (indexed by its
    position) and a disjoint prefix-group range, so the composite is
    deterministic in ``(tenants, duration, seed)`` and per-tenant event
    counts are conserved by the merge."""
    parts: List[Trace] = []
    group_start = 0
    for i, ten in enumerate(tenants):
        tr, group_start = build_tenant_trace(ten, duration, seed,
                                             stream=i,
                                             group_start=group_start)
        parts.append(tr)
    merged = Trace.merge(parts, seed=seed)
    merged.meta["duration"] = duration
    merged.meta["tenants"] = [t.name for t in tenants]
    return merged


def scaled_trace(n_events: int, seed: int = 0,
                 tenants: Optional[Sequence[TenantSpec]] = None) -> Trace:
    """A trace with ~``n_events`` events from the default tenant mix —
    the sizing knob the stress benchmarks use.  Rates stay fixed (the
    traffic SHAPE is the point); duration scales with the target."""
    tenants = list(tenants) if tenants is not None else default_tenants()
    mean_rate = sum(
        make_arrivals(t.arrival, t.rate, **t.arrival_kw).mean_rate()
        * max(ARCHETYPES[t.scenario].turns_mean, 1.0)
        for t in tenants)
    duration = max(n_events / max(mean_rate, 1e-9), 1.0)
    return build_trace(tenants, duration, seed=seed)
