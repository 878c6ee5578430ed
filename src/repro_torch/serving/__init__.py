from repro_torch.serving.kvstore import (
    SLO_CLASSES,
    KVTier,
    PrefixKVStore,
    StoreEntry,
    TierHit,
    TierSpec,
    TieredKVStore,
    default_tier_specs,
    slo_rank,
)
from repro_torch.serving.network import (
    GBPS,
    BandwidthTrace,
    GoodputEstimator,
    KVWire,
    WireTransfer,
)
from repro_torch.serving.metrics import (
    latency_summary,
    percentile_row,
    violation_rates,
)
from repro_torch.serving.request import LIFECYCLE, Request, WorkloadMix, kv_bytes_for
from repro_torch.serving.topology import LinkSpec, NetworkTopology, route_name
from repro_torch.serving.scheduler import (
    AdmissionController,
    ContinuousScheduler,
    SchedulerConfig,
    priority_key,
)
from repro_torch.serving.simulator import (
    KVServePolicy,
    NoCompressionPolicy,
    Policy,
    SimConfig,
    SimResult,
    Simulator,
    StaticPolicy,
)

# The runtimes (ServingRuntime / ClusterRuntime and the worker classes)
# live in repro_torch.serving.engine, .cluster and .workers and are
# imported directly by their users: they pull in torch's model stack,
# which the simulator-only path does not need.

__all__ = [
    "GBPS", "BandwidthTrace", "GoodputEstimator", "KVWire", "WireTransfer",
    "LIFECYCLE", "Request", "WorkloadMix",
    "kv_bytes_for", "KVServePolicy", "NoCompressionPolicy", "Policy",
    "SimConfig", "SimResult", "Simulator", "StaticPolicy",
    "PrefixKVStore", "StoreEntry", "SLO_CLASSES", "slo_rank",
    "KVTier", "TierHit", "TierSpec", "TieredKVStore", "default_tier_specs",
    "ContinuousScheduler", "SchedulerConfig", "AdmissionController",
    "priority_key",
    "LinkSpec", "NetworkTopology", "route_name",
    "latency_summary", "percentile_row", "violation_rates",
]
