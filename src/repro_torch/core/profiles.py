"""Profiles: the paper's ``p = (cr_p, s_p, q_p)`` triple + measurement.

``measure_profile`` runs the real pipeline on sample KV caches and returns
measured compression ratio (bytes, metadata included), encode/decode
throughputs (bytes/s of *uncompressed* KV processed, matching the paper's
definition so that enc+dec time == V/s_p), and a quality score per workload
when a quality function is provided.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.kvcache import KVCache
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.strategy import StrategyConfig, is_identity


def harmonic_throughput(s_enc: float, s_dec: float) -> float:
    """s_p = (1/s_enc + 1/s_dec)^-1 so that V/s_enc + V/s_dec = V/s_p."""
    if math.isinf(s_enc) and math.isinf(s_dec):
        return float("inf")
    return 1.0 / (1.0 / s_enc + 1.0 / s_dec)


@dataclass
class Profile:
    """Measured operating point of one strategy."""

    strategy: StrategyConfig
    cr: float  # compression ratio (>= includes metadata)
    s_enc: float  # bytes/s of uncompressed KV through the encoder
    s_dec: float  # bytes/s through the decoder
    quality: Dict[str, float] = field(default_factory=dict)  # per workload
    mse: float = 0.0

    @property
    def s_eff(self) -> float:
        return harmonic_throughput(self.s_enc, self.s_dec)

    def q(self, workload: str) -> float:
        if not self.quality:
            return 1.0
        if workload in self.quality:
            return self.quality[workload]
        return float(np.mean(list(self.quality.values())))

    def to_json(self) -> str:
        d = asdict(self)
        d["strategy"] = self.strategy.to_json()
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "Profile":
        d = json.loads(s)
        d["strategy"] = StrategyConfig.from_json(d["strategy"])
        return Profile(**d)


IDENTITY_PROFILE = Profile(
    strategy=StrategyConfig(key_bits=16, value_bits=16),
    cr=1.0, s_enc=float("inf"), s_dec=float("inf"), quality={}, mse=0.0,
)


def measure_profile(
    strategy: StrategyConfig,
    kv_samples: Sequence[KVCache],
    quality_fn: Optional[Callable[[StrategyConfig], Dict[str, float]]] = None,
    head_scores: Optional[np.ndarray] = None,
    repeats: int = 1,
) -> Profile:
    """Run the pipeline end-to-end on sample caches and measure (cr, s, q)."""
    pipe = CompressionPipeline(strategy, head_scores=head_scores)
    total_orig = 0
    total_comp = 0
    enc_time = 0.0
    dec_time = 0.0
    sq_err = 0.0
    n_elem = 0
    for kv in kv_samples:
        for _ in range(repeats):
            restored, comp, t_enc, t_dec = pipe.roundtrip(kv)
            enc_time += t_enc
            dec_time += t_dec
        total_orig += kv.nbytes_wire()
        total_comp += comp.total_bytes()
        sq_err += float(((restored.k - kv.k) ** 2).sum() + ((restored.v - kv.v) ** 2).sum())
        n_elem += kv.k.size + kv.v.size

    reps = max(repeats * len(kv_samples), 1)
    v_bytes = total_orig * repeats  # uncompressed bytes pushed through
    s_enc = v_bytes / enc_time if enc_time > 0 else float("inf")
    s_dec = v_bytes / dec_time if dec_time > 0 else float("inf")
    if is_identity(strategy):
        s_enc = s_dec = float("inf")

    quality = quality_fn(strategy) if quality_fn is not None else {}
    return Profile(
        strategy=strategy,
        cr=total_orig / max(total_comp, 1),
        s_enc=s_enc,
        s_dec=s_dec,
        quality=quality,
        mse=sq_err / max(n_elem, 1),
    )


def save_profiles(profiles: List[Profile], path: str) -> None:
    with open(path, "w") as f:
        for p in profiles:
            f.write(p.to_json() + "\n")


def load_profiles(path: str) -> List[Profile]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Profile.from_json(line))
    return out
