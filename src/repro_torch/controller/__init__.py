from repro_torch.controller.bandit import BanditConfig, ResidualBandit
from repro_torch.controller.controller import (
    Decision,
    FetchDecision,
    ServiceAwareController,
)
from repro_torch.controller.envelope import (
    LowerEnvelope,
    brute_force_optimal,
    build_envelope,
)
from repro_torch.controller.latency_model import (
    ServiceContext,
    TierFetch,
    bandwidth_threshold,
    baseline_latency,
    expected_tokens_per_step,
    is_beneficial,
    normalized_latency,
    predicted_latency,
    speculative_decode_latency,
    tier_fetch_latency,
)

__all__ = [
    "BanditConfig", "ResidualBandit", "Decision", "FetchDecision",
    "ServiceAwareController",
    "LowerEnvelope", "brute_force_optimal", "build_envelope",
    "ServiceContext", "TierFetch", "bandwidth_threshold", "baseline_latency",
    "expected_tokens_per_step", "is_beneficial", "normalized_latency",
    "predicted_latency", "speculative_decode_latency", "tier_fetch_latency",
]
