"""Trace schema for production-shaped serving workloads.

A :class:`Trace` is an ordered sequence of :class:`TraceEvent` rows — one
per request — carrying everything either serving backend needs to replay
it: arrival time, tenant, scenario archetype, the ``data.synthetic``
workload family, prompt/output lengths, the prefix-sharing group, and the
SLO contract (class + metric + deadline + quality floor).

Determinism contract (DESIGN.md §11): a trace is a pure function of its
build inputs — same seed ⇒ byte-identical ``to_jsonl()`` serialization.
Every numeric field is a plain Python ``int``/``float`` (never a numpy
scalar), so serialization is canonical and the replay hot path stays on
fast native floats.

Both backends replay the SAME trace:

* the event-driven :class:`~repro_torch.serving.simulator.Simulator` consumes
  :meth:`Trace.to_requests` (see :mod:`repro_torch.workloads.replay`);
* the real-execution :class:`~repro_torch.serving.cluster.ClusterRuntime` /
  :class:`~repro_torch.serving.engine.ServingRuntime` replays through
  :func:`repro_torch.workloads.replay.replay_runtime`, which maps
  ``prefix_group`` onto ``prompt_seed`` so shared-prefix groups share
  real prompts (and therefore real pool entries).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.serving.request import Request

# The SLO metrics the serving stack can report violations on — every
# event's slo_metric must be one of these (property-tested).
SLO_METRICS = ("ttft", "jct")


@dataclass(frozen=True)
class TraceEvent:
    """One request of a workload trace."""

    rid: int                 # unique within the trace, == position
    t: float                 # arrival time (s from trace start)
    tenant: str              # originating tenant (superposition source)
    scenario: str            # archetype name (repro_torch.workloads.scenarios)
    workload: str            # data.synthetic family (router label w)
    ctx_tokens: int          # prompt length
    out_tokens: int          # decode budget (1 = prefill-only classify)
    prefix_group: int        # sharing group: equal ids reuse one prefix
    slo_class: str = "standard"   # scheduler class (kvstore.SLO_CLASSES)
    slo_metric: str = "ttft"      # which latency the SLO targets
    t_slo: float = 0.0            # deadline (s); 0 = no SLO
    q_min: float = 0.97           # quality floor for profile selection


@dataclass
class Trace:
    """An arrival-ordered request trace plus its provenance."""

    events: List[TraceEvent]
    seed: Optional[int] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def duration(self) -> float:
        return self.events[-1].t if self.events else 0.0

    def tenants(self) -> List[str]:
        return sorted({e.tenant for e in self.events})

    def counts_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.tenant] = out.get(e.tenant, 0) + 1
        return out

    def counts_by_scenario(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.scenario] = out.get(e.scenario, 0) + 1
        return out

    # ------------------------------------------------------------------
    # Canonical serialization (the byte-identity surface of the
    # determinism contract) — one compact JSON object per line.
    # ------------------------------------------------------------------
    def to_jsonl(self) -> str:
        head = json.dumps({"seed": self.seed, "meta": self.meta},
                          sort_keys=True, separators=(",", ":"))
        rows = [json.dumps(asdict(e), sort_keys=True,
                           separators=(",", ":")) for e in self.events]
        return "\n".join([head] + rows)

    def digest(self) -> str:
        """SHA-1 of the canonical serialization — two traces with equal
        digests are byte-identical."""
        return hashlib.sha1(self.to_jsonl().encode()).hexdigest()

    @staticmethod
    def from_jsonl(text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln]
        head = json.loads(lines[0])
        names = {f.name for f in fields(TraceEvent)}
        events = []
        for ln in lines[1:]:
            d = json.loads(ln)
            events.append(TraceEvent(**{k: v for k, v in d.items()
                                        if k in names}))
        return Trace(events, seed=head.get("seed"),
                     meta=head.get("meta") or {})

    # ------------------------------------------------------------------
    # Superposition: merge per-tenant (or per-scenario) traces into one
    # arrival-ordered trace.  The merge is stable — ties broken by
    # (tenant, original rid) — and conserves every source's event count
    # (property-tested in tests/test_workloads.py).
    # ------------------------------------------------------------------
    @staticmethod
    def merge(traces: Sequence["Trace"], seed: Optional[int] = None
              ) -> "Trace":
        rows = [e for tr in traces for e in tr.events]
        rows.sort(key=lambda e: (e.t, e.tenant, e.rid))
        events = [TraceEvent(rid=i, t=e.t, tenant=e.tenant,
                             scenario=e.scenario, workload=e.workload,
                             ctx_tokens=e.ctx_tokens,
                             out_tokens=e.out_tokens,
                             prefix_group=e.prefix_group,
                             slo_class=e.slo_class,
                             slo_metric=e.slo_metric, t_slo=e.t_slo,
                             q_min=e.q_min)
                  for i, e in enumerate(rows)]
        meta = {"merged": [tr.meta for tr in traces]}
        return Trace(events, seed=seed, meta=meta)

    # ------------------------------------------------------------------
    # Simulator adapter
    # ------------------------------------------------------------------
    def to_requests(self, num_layers: int = 32, kv_heads: int = 8,
                    head_dim: int = 128, bytes_per_el: int = 2
                    ) -> List[Request]:
        """Materialize :class:`~repro_torch.serving.request.Request` objects for
        the event-driven simulator.  ``prefix_group`` becomes the opaque
        ``prefix_key`` (store-resolved pool hits); ``prefix_hit`` is set
        for repeats of an already-seen group so storeless simulations see
        the same hit population."""
        import gc
        seen: set = set()
        out: List[Request] = []
        per_tok = 2.0 * num_layers * kv_heads * head_dim * bytes_per_el
        # Materializing a million acyclic Request objects under
        # generational GC rescans the growing heap for nothing; defer
        # collection for the duration (same rationale as Simulator.run).
        was_enabled = gc.isenabled()
        if was_enabled:
            gc.disable()
        try:
            for e in self.events:
                group = e.prefix_group
                hit = group in seen
                seen.add(group)
                out.append(Request(
                    rid=e.rid, workload=e.workload, arrival=e.t,
                    ctx_tokens=e.ctx_tokens, out_tokens=e.out_tokens,
                    kv_bytes=per_tok * e.ctx_tokens,
                    t_slo=e.t_slo, slo_metric=e.slo_metric, q_min=e.q_min,
                    prefix_hit=hit, slo_class=e.slo_class,
                    prefix_key=(group,)))
        finally:
            if was_enabled:
                gc.enable()
        return out


def validate(trace: Trace) -> None:
    """Structural invariants every generated trace must satisfy (the same
    ones the property tests check): arrivals non-decreasing, rids dense,
    every SLO class/metric registered, lengths positive."""
    from repro_torch.serving.kvstore import SLO_CLASSES
    last = 0.0
    for i, e in enumerate(trace.events):
        if e.rid != i:
            raise ValueError(f"rid {e.rid} at position {i} (must be dense)")
        if e.t < last:
            raise ValueError(f"arrivals decrease at rid {e.rid}")
        last = e.t
        if e.slo_class not in SLO_CLASSES:
            raise ValueError(f"unregistered slo_class {e.slo_class!r}")
        if e.slo_metric not in SLO_METRICS:
            raise ValueError(f"unregistered slo_metric {e.slo_metric!r}")
        if e.ctx_tokens <= 0 or e.out_tokens <= 0:
            raise ValueError(f"non-positive lengths on rid {e.rid}")


def iter_chunks(events: Iterable[TraceEvent], size: int):
    """Yield fixed-size chunks of an event stream (windowed replay)."""
    chunk: List[TraceEvent] = []
    for e in events:
        chunk.append(e)
        if len(chunk) >= size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk
