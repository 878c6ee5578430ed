"""Heterogeneous-parameter encoding (Alg. 1 line 1).

Categorical strategy fields -> one-hot; numeric fields -> min-max scaled.
The resulting unified embedding lets the GP kernel measure structural
similarity across mixed parameter types.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.strategy import (
    BITS_CHOICES,
    CODECS,
    GRANULARITIES,
    GROUP_CHOICES,
    QUANTIZERS,
    TRANSFORMS,
    StrategyConfig,
)

_CATEGORICAL: List[Tuple[str, Sequence[str]]] = [
    ("transform", TRANSFORMS),
    ("quantizer", QUANTIZERS),
    ("granularity", GRANULARITIES),
    ("codec", CODECS),
]

_NUMERIC: List[Tuple[str, float, float]] = [
    ("key_bits", 1, 16),
    ("value_bits", 1, 16),
    ("group_size", min(GROUP_CHOICES), max(GROUP_CHOICES)),
    ("mixhq_high_bits", 1, 8),
    ("mixhq_low_bits", 1, 8),
    ("retrieval_frac", 0.0, 1.0),
    ("token_heavy_hitter_frac", 0.0, 1.0),
    ("delta_group", 8, 128),
    ("duo_recent", 16, 512),
]

_BOOL = ["layer_pyramid", "symmetric"]


def embedding_dim() -> int:
    return sum(len(v) for _, v in _CATEGORICAL) + len(_NUMERIC) + len(_BOOL) + 3


def encode(cfg: StrategyConfig) -> np.ndarray:
    parts: List[float] = []
    for field, vocab in _CATEGORICAL:
        val = getattr(cfg, field)
        onehot = [1.0 if val == v else 0.0 for v in vocab]
        parts.extend(onehot)
    for field, lo, hi in _NUMERIC:
        val = float(getattr(cfg, field))
        parts.append((val - lo) / (hi - lo))
    for field in _BOOL:
        parts.append(1.0 if getattr(cfg, field) else 0.0)
    # tier bits (cachegen) as scaled numerics
    for i in range(3):
        parts.append(cfg.tier_bits[i] / 8.0)
    return np.asarray(parts, dtype=np.float64)


def encode_batch(cfgs: Sequence[StrategyConfig]) -> np.ndarray:
    return np.stack([encode(c) for c in cfgs])
