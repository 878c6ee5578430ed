"""Strategy space: the paper's unified ``BS = C(Q(T(X)))`` pipeline configs.

A :class:`StrategyConfig` fully determines one point in the searchable
strategy space (Sec. 5.1).  ``enumerate_space`` reproduces the paper's
Fig. 5-left growth: "module" granularity enumerates pipeline/module choices,
"hybrid" additionally sweeps fine-grained parameters (~10^4 candidates).
"""
from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Vocabularies for each pipeline stage.
# ---------------------------------------------------------------------------
TRANSFORMS = ("none", "delta", "hadamard", "affine")
QUANTIZERS = ("uniform", "kivi", "cachegen", "mixhq", "duo")
GRANULARITIES = ("per_head", "per_channel", "per_token")
CODECS = ("none", "zstd1", "zstd3", "zstd10", "bitshuffle_zstd3")

BITS_CHOICES = (2, 3, 4, 6, 8)
GROUP_CHOICES = (32, 64, 128)
DELTA_GROUPS = (16, 64)

# Logical source precision of the KV cache on the wire (bf16 = 2 bytes).
SOURCE_BITS = 16
SOURCE_BYTES = 2
SCALE_BYTES = 2  # fp16 scale
ZP_BYTES = 2  # fp16 zero-point


@dataclass(frozen=True)
class StrategyConfig:
    """One point of the strategy space; hashable, JSON round-trippable."""

    transform: str = "none"  # none | delta | hadamard | affine
    delta_group: int = 64  # anchor spacing for the delta transform

    quantizer: str = "uniform"  # uniform | kivi | cachegen | mixhq | duo
    key_bits: int = 4
    value_bits: int = 4
    granularity: str = "per_channel"  # grouping pattern for uniform
    group_size: int = 64
    symmetric: bool = False

    # MixHQ (the paper's new quantizer component, Sec. 5.1)
    mixhq_high_bits: int = 8
    mixhq_low_bits: int = 2
    retrieval_frac: float = 0.25
    # MixHQ generalisations: layer-pyramid and token heavy-hitter dimensions.
    layer_pyramid: bool = False
    token_heavy_hitter_frac: float = 0.0

    # CacheGen layer tiers (earlier layers more sensitive -> more bits).
    tier_bits: Tuple[int, int, int] = (4, 3, 2)
    tier_fracs: Tuple[float, float] = (0.2, 0.3)  # remainder gets tier 3

    # DuoAttention-style pruning baseline.
    duo_sink: int = 4
    duo_recent: int = 128

    codec: str = "none"

    # ------------------------------------------------------------------
    def key(self) -> str:
        payload = json.dumps(asdict(self), sort_keys=True, default=str)
        return hashlib.sha1(payload.encode()).hexdigest()[:12]

    def short_name(self) -> str:
        if self.quantizer == "mixhq":
            q = f"mixhq{self.mixhq_high_bits}/{self.mixhq_low_bits}"
        elif self.quantizer == "cachegen":
            q = "cachegen" + "".join(str(b) for b in self.tier_bits)
        elif self.quantizer == "duo":
            q = f"duo{self.duo_recent}"
        else:
            q = f"{self.quantizer}{self.key_bits}/{self.value_bits}"
        return f"{self.transform}-{q}-{self.codec}"

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "StrategyConfig":
        d = json.loads(s)
        d["tier_bits"] = tuple(d["tier_bits"])
        d["tier_fracs"] = tuple(d["tier_fracs"])
        return StrategyConfig(**d)

    def validate(self) -> None:
        assert self.transform in TRANSFORMS, self.transform
        assert self.quantizer in QUANTIZERS, self.quantizer
        assert self.granularity in GRANULARITIES, self.granularity
        assert self.codec in CODECS, self.codec
        for b in (self.key_bits, self.value_bits):
            assert 1 <= b <= 16, b  # 16 == passthrough (identity)
        for b in (self.mixhq_high_bits, self.mixhq_low_bits):
            assert 1 <= b <= 8, b
        assert 0.0 <= self.retrieval_frac <= 1.0


# The uncompressed pass-through (cr=1, infinite throughput) — always a
# candidate so the controller can "bypass compression" (paper Sec. 7.2).
IDENTITY_STRATEGY = StrategyConfig(
    transform="none", quantizer="uniform", key_bits=16, value_bits=16, codec="none"
)


def is_identity(cfg: StrategyConfig) -> bool:
    return cfg.key_bits >= 16 and cfg.value_bits >= 16 and cfg.codec == "none"


def device_quantizable(cfg: StrategyConfig,
                       head_dim: Optional[int] = None) -> bool:
    """True when the device ``quant_pack`` kernel produces the strategy's
    quantized form: plain symmetric per-token uniform quantization with
    equal 4- or 8-bit K/V.  ``head_dim`` (when known: the channel width
    the quantizer sees, after any transform's padding) additionally
    requires the quant group to tile the channel axis."""
    return (
        cfg.quantizer == "uniform"
        and cfg.granularity == "per_token"
        and cfg.symmetric
        and cfg.key_bits == cfg.value_bits
        and cfg.key_bits in (4, 8)
        and not is_identity(cfg)
        and (head_dim is None or head_dim % cfg.group_size == 0)
    )


def paged_eligible(cfg: StrategyConfig,
                   head_dim: Optional[int] = None) -> bool:
    """True when a strategy's compressed form can live directly in the
    paged arena's quantized page pool (DESIGN.md §12): device-quantizable,
    with no transform and no entropy codec — exactly the layout the fused
    dequant decode path consumes.  Everything else falls back to the
    materialized fp16-page injection path."""
    return (device_quantizable(cfg, head_dim)
            and cfg.transform == "none" and cfg.codec == "none")


# ---------------------------------------------------------------------------
# Named baselines (paper Sec. 7.1): core algorithms mapped into the pipeline.
# ---------------------------------------------------------------------------
BASELINES: Dict[str, StrategyConfig] = {
    # CacheGen: delta against anchors + layer-tiered quant + entropy coding.
    "cachegen": StrategyConfig(
        transform="delta",
        delta_group=64,
        quantizer="cachegen",
        tier_bits=(4, 3, 2),
        tier_fracs=(0.2, 0.3),
        granularity="per_channel",
        group_size=64,
        codec="zstd3",
    ),
    # KIVI: asymmetric 2-bit; K per-channel / V per-token with group metadata.
    "kivi": StrategyConfig(
        transform="none",
        quantizer="kivi",
        key_bits=2,
        value_bits=2,
        group_size=32,
        symmetric=False,
        codec="none",
    ),
    # DuoAttention: retrieval heads full precision, streaming heads pruned to
    # sink+recent tokens.
    "duoattention": StrategyConfig(
        transform="none",
        quantizer="duo",
        retrieval_frac=0.25,
        duo_sink=4,
        duo_recent=128,
        codec="none",
    ),
    # MixHQ with a robust default (the paper's own component).
    "mixhq": StrategyConfig(
        transform="hadamard",
        quantizer="mixhq",
        mixhq_high_bits=8,
        mixhq_low_bits=2,
        retrieval_frac=0.25,
        group_size=64,
        codec="none",
    ),
}


# ---------------------------------------------------------------------------
# Space enumeration (Fig. 5 left).
# ---------------------------------------------------------------------------
def enumerate_space(level: str = "module") -> List[StrategyConfig]:
    """Enumerate the strategy space.

    level="pipeline": stage choices only (T x Q x C).
    level="module":   + bit-width module parameters (order 10^2).
    level="hybrid":   + fine-grained parameter tuning (order 10^4).
    """
    out: List[StrategyConfig] = []
    if level == "pipeline":
        # Stage *kind* choices only (T x Q), default parameters/codec.
        for t, q in itertools.product(TRANSFORMS, QUANTIZERS):
            out.append(StrategyConfig(transform=t, quantizer=q))
        return _dedup(out)

    bits = BITS_CHOICES if level == "hybrid" else (2, 4, 8)
    groups = GROUP_CHOICES if level == "hybrid" else (64,)
    fracs = (0.125, 0.25, 0.5) if level == "hybrid" else (0.25,)
    codecs = CODECS if level == "hybrid" else ("none", "zstd3")
    transforms = TRANSFORMS if level == "hybrid" else ("none", "delta", "hadamard")

    for t in transforms:
        dgs = DELTA_GROUPS if (t == "delta" and level == "hybrid") else (64,)
        for dg in dgs:
            for codec in codecs:
                # uniform: bits x granularity x group
                grans = GRANULARITIES if level == "hybrid" else ("per_channel",)
                for kb, vb in itertools.product(bits, bits):
                    for g in grans:
                        for gs in groups:
                            out.append(
                                StrategyConfig(
                                    transform=t, delta_group=dg, quantizer="uniform",
                                    key_bits=kb, value_bits=vb, granularity=g,
                                    group_size=gs, codec=codec,
                                )
                            )
                # kivi: bits x group
                for b in bits:
                    for gs in groups:
                        out.append(
                            StrategyConfig(
                                transform=t, delta_group=dg, quantizer="kivi",
                                key_bits=b, value_bits=b, group_size=gs, codec=codec,
                            )
                        )
                # cachegen tiers
                tier_opts = (
                    [(8, 4, 2), (6, 4, 2), (4, 3, 2), (4, 2, 2), (3, 2, 1)]
                    if level == "hybrid"
                    else [(4, 3, 2)]
                )
                for tb in tier_opts:
                    out.append(
                        StrategyConfig(
                            transform=t, delta_group=dg, quantizer="cachegen",
                            tier_bits=tb, codec=codec,
                        )
                    )
                # mixhq: high/low bits x retrieval fraction (+ generalisations)
                hb_opts = (8, 6, 4) if level == "hybrid" else (8,)
                lb_opts = (1, 2, 3) if level == "hybrid" else (2,)
                for hb, lb in itertools.product(hb_opts, lb_opts):
                    for rf in fracs:
                        for gs in groups:
                            out.append(
                                StrategyConfig(
                                    transform=t, delta_group=dg, quantizer="mixhq",
                                    mixhq_high_bits=hb, mixhq_low_bits=lb,
                                    retrieval_frac=rf, group_size=gs, codec=codec,
                                )
                            )
                            if level == "hybrid":
                                out.append(
                                    StrategyConfig(
                                        transform=t, delta_group=dg, quantizer="mixhq",
                                        mixhq_high_bits=hb, mixhq_low_bits=lb,
                                        retrieval_frac=rf, group_size=gs,
                                        layer_pyramid=True, codec=codec,
                                    )
                                )
                # duo pruning
                for rf in fracs:
                    out.append(
                        StrategyConfig(
                            transform=t, delta_group=dg, quantizer="duo",
                            retrieval_frac=rf, codec=codec,
                        )
                    )
    return _dedup(out)


def _dedup(cfgs: List[StrategyConfig]) -> List[StrategyConfig]:
    seen, out = set(), []
    for c in cfgs:
        k = c.key()
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out


def space_sizes() -> Dict[str, int]:
    return {lvl: len(enumerate_space(lvl)) for lvl in ("pipeline", "module", "hybrid")}


# ---------------------------------------------------------------------------
# Analytic CR estimate (used for BO pruning; Observation 2 says relative CR
# rankings are stable, so a bits-accounting estimate orders candidates well).
# ---------------------------------------------------------------------------
def estimate_cr(cfg: StrategyConfig, num_layers: int = 8, kv_heads: int = 4,
                seq: int = 512, head_dim: int = 64) -> float:
    """Cheap data-free CR estimate from bits + metadata accounting."""
    n = num_layers * 2 * kv_heads * seq * head_dim
    orig_bits = n * SOURCE_BITS

    def _meta_bits(groups: int) -> float:
        zp = 0 if cfg.symmetric else ZP_BYTES * 8
        return groups * (SCALE_BYTES * 8 + zp)

    if cfg.quantizer == "uniform":
        kb, vb = min(cfg.key_bits, 16), min(cfg.value_bits, 16)
        payload = n / 2 * kb + n / 2 * vb
        if cfg.granularity == "per_head":
            groups = num_layers * 2 * kv_heads
        elif cfg.granularity == "per_channel":
            groups = num_layers * 2 * kv_heads * head_dim * max(seq // cfg.group_size, 1)
        else:  # per_token
            groups = num_layers * 2 * kv_heads * seq * max(head_dim // cfg.group_size, 1)
        meta = _meta_bits(groups)
    elif cfg.quantizer == "kivi":
        payload = n * cfg.key_bits
        groups_k = num_layers * kv_heads * head_dim * max(seq // cfg.group_size, 1)
        groups_v = num_layers * kv_heads * seq * max(head_dim // cfg.group_size, 1)
        meta = _meta_bits(groups_k + groups_v)
    elif cfg.quantizer == "cachegen":
        f1, f2 = cfg.tier_fracs
        b = (cfg.tier_bits[0] * f1 + cfg.tier_bits[1] * f2
             + cfg.tier_bits[2] * (1 - f1 - f2))
        payload = n * b
        groups = num_layers * 2 * kv_heads * head_dim * max(seq // cfg.group_size, 1)
        meta = _meta_bits(groups)
    elif cfg.quantizer == "mixhq":
        rf = cfg.retrieval_frac
        b = cfg.mixhq_high_bits * rf + cfg.mixhq_low_bits * (1 - rf)
        if cfg.layer_pyramid:
            b *= 0.85  # deeper layers shaved further
        payload = n * b
        groups = num_layers * 2 * kv_heads * head_dim * max(seq // cfg.group_size, 1)
        meta = _meta_bits(groups)
    elif cfg.quantizer == "duo":
        rf = cfg.retrieval_frac
        kept = min((cfg.duo_sink + cfg.duo_recent) / seq, 1.0)
        payload = n * SOURCE_BITS * (rf + (1 - rf) * kept)
        meta = 0.0
    else:  # pragma: no cover
        raise ValueError(cfg.quantizer)

    codec_gain = {
        "none": 1.0, "zstd1": 1.25, "zstd3": 1.35, "zstd10": 1.45,
        "bitshuffle_zstd3": 1.55,
    }[cfg.codec]
    transform_gain = {"none": 1.0, "delta": 1.1, "hadamard": 1.0, "affine": 1.02}[
        cfg.transform
    ]
    comp_bits = (payload / (codec_gain * transform_gain)) + meta
    return float(orig_bits / max(comp_bits, 1.0))
