"""Trace-driven workload harness (DESIGN.md §11).

Schema (:mod:`.trace`), arrival processes (:mod:`.arrivals`), scenario
archetypes + tenant composition (:mod:`.scenarios`), and replay adapters
into both serving backends (:mod:`.replay`).  Everything here is
numpy-only — importable without torch's model stack — so million-event
traces can be generated and simulated anywhere.  The PyTorch package's
copy of the JAX package's ``workloads``: the same seeds give the same
traces, byte for byte.
"""
from repro_torch.workloads.arrivals import (
    ARRIVALS,
    ArrivalProcess,
    DiurnalGammaPoisson,
    OnOffMMPP,
    Poisson,
    make_arrivals,
)
from repro_torch.workloads.replay import (
    DEFAULT_GEOM,
    ModelGeom,
    replay_runtime,
    replay_simulator,
    trace_requests,
)
from repro_torch.workloads.scenarios import (
    ARCHETYPES,
    ScenarioSpec,
    TenantSpec,
    build_tenant_trace,
    build_trace,
    default_tenants,
    generate_events,
    scaled_trace,
)
from repro_torch.workloads.trace import (
    SLO_METRICS,
    Trace,
    TraceEvent,
    iter_chunks,
    validate,
)

__all__ = [
    "ARRIVALS", "ArrivalProcess", "DiurnalGammaPoisson", "OnOffMMPP",
    "Poisson", "make_arrivals",
    "DEFAULT_GEOM", "ModelGeom", "replay_runtime", "replay_simulator",
    "trace_requests",
    "ARCHETYPES", "ScenarioSpec", "TenantSpec", "build_tenant_trace",
    "build_trace", "default_tenants", "generate_events", "scaled_trace",
    "SLO_METRICS", "Trace", "TraceEvent", "iter_chunks", "validate",
]
