"""KVServe core: the paper's unified KV compression pipeline + strategy space."""
from repro_torch.core.kvcache import KVCache
from repro_torch.core.pipeline import CompressedKV, CompressionPipeline
from repro_torch.core.profiles import IDENTITY_PROFILE, Profile, measure_profile
from repro_torch.core.strategy import (
    BASELINES,
    IDENTITY_STRATEGY,
    StrategyConfig,
    enumerate_space,
    estimate_cr,
    is_identity,
    space_sizes,
)

__all__ = [
    "KVCache",
    "CompressedKV",
    "CompressionPipeline",
    "Profile",
    "IDENTITY_PROFILE",
    "measure_profile",
    "StrategyConfig",
    "BASELINES",
    "IDENTITY_STRATEGY",
    "enumerate_space",
    "estimate_cr",
    "is_identity",
    "space_sizes",
]
