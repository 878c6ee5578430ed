"""Replay a :class:`~repro_torch.workloads.trace.Trace` into either serving
backend.

One trace, two execution granularities (DESIGN.md §11):

* :func:`replay_simulator` — the event-driven
  :class:`~repro_torch.serving.simulator.Simulator`: events become
  :class:`~repro_torch.serving.request.Request` objects (KV payloads sized by
  :class:`ModelGeom`); millions of requests per sweep.
* :func:`replay_runtime` — the real-execution
  :class:`~repro_torch.serving.cluster.ClusterRuntime` (or its 1x1
  :class:`~repro_torch.serving.engine.ServingRuntime` facade): events are
  submitted as the runtime's virtual clock passes their arrival times,
  with ``prefix_group`` mapped onto ``prompt_seed`` so shared-prefix
  groups share REAL prompts (and therefore real pool entries).

Both adapters are deterministic given the trace: replaying the same trace
twice yields identical results.

The replay loops are serving hot paths: the ``host-sync`` static rule
(DESIGN.md §13) treats every ``replay*`` def here as a hot root, so a
stray device->host sync added to an adapter fails the lint gate the
same way one in ``decode_iteration`` would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.serving.network import BandwidthTrace
from repro_torch.serving.request import Request
from repro_torch.serving.simulator import Policy, SimConfig, SimResult, Simulator
from repro_torch.workloads.trace import Trace


@dataclass(frozen=True)
class ModelGeom:
    """KV geometry used to size simulator payloads from token counts."""

    num_layers: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    bytes_per_el: int = 2

    def kv_bytes(self, ctx_tokens: int) -> float:
        return (2.0 * self.num_layers * self.kv_heads * self.head_dim
                * ctx_tokens * self.bytes_per_el)


DEFAULT_GEOM = ModelGeom()


def trace_requests(trace: Trace, geom: ModelGeom = DEFAULT_GEOM
                   ) -> List[Request]:
    """Simulator-side materialization (thin wrapper over
    :meth:`Trace.to_requests` with a :class:`ModelGeom`)."""
    return trace.to_requests(num_layers=geom.num_layers,
                             kv_heads=geom.kv_heads,
                             head_dim=geom.head_dim,
                             bytes_per_el=geom.bytes_per_el)


def replay_simulator(trace: Trace, policy: Policy,
                     bandwidth: BandwidthTrace,
                     config: Optional[SimConfig] = None,
                     geom: ModelGeom = DEFAULT_GEOM,
                     **sim_kwargs) -> SimResult:
    """Replay the trace through the event-driven simulator.  Extra
    keyword arguments (``store=``, ``scheduler=``, ``topology=``,
    ``routing=``) pass straight through to :class:`Simulator`."""
    sim = Simulator(config or SimConfig(), policy, bandwidth,
                    trace_requests(trace, geom), **sim_kwargs)
    return sim.run()


def replay_runtime(rt, trace: Trace, max_steps: int = 100_000,
                   events: Optional[Sequence] = None) -> list:
    """Replay the trace through a real-execution runtime
    (:class:`ClusterRuntime` / :class:`ServingRuntime`).

    The runtime's virtual clock only advances inside ``step()``, so the
    adapter steps until the clock passes each event's arrival (or
    fast-forwards over idle gaps), then submits it.  Mapping:

    * ``workload``      -> the runtime's prompt family,
    * ``prefix_group``  -> ``prompt_seed`` (equal groups => equal real
      prompts => real pool reuse),
    * ``out_tokens``    -> decode budget (clamped to the runtime's
      ``decode_tokens`` arena budget),
    * SLO contract      -> passed through verbatim.

    ``ctx_tokens`` is fixed by the runtime (``cfg.seq``) — the real
    model's prompt window — which is the documented fidelity gap between
    the two backends (DESIGN.md §11).  Returns the runtime's completed
    list."""
    evs = list(events) if events is not None else list(trace.events)
    evs.sort(key=lambda e: e.t)
    steps = 0
    for ev in evs:
        while rt.clock < ev.t and not rt.scheduler.idle \
                and steps < max_steps:
            rt.step()
            steps += 1
        if rt.clock < ev.t:
            rt.clock = ev.t        # idle gap: jump the virtual clock
        rt.submit(ev.workload, t_slo=ev.t_slo, q_min=ev.q_min,
                  slo_class=ev.slo_class, out_tokens=ev.out_tokens,
                  prompt_seed=ev.prefix_group, slo_metric=ev.slo_metric)
    rt.run(max_steps=max(max_steps - steps, 1))
    return rt.completed
