"""Stage 2 of the pipeline: the Quantizer ``Q``.

Representative methods are decomposed into one bucketed group-quantization
primitive plus per-method *bit-allocation plans*:

  - ``uniform``  : same bits everywhere; granularity in {per_head,
                   per_channel (KIVI-K style, groups along tokens),
                   per_token (KIVI-V style, groups along channels)}.
  - ``kivi``     : K per-channel + V per-token, asymmetric, group metadata
                   (reproduces KIVI's ~5.33x metadata-bounded CR ceiling).
  - ``cachegen`` : layer-tiered bits (earlier layers get more bits).
  - ``mixhq``    : the paper's new component — Mixed-Precision Head-Wise
                   quantization.  Retrieval heads keep high precision,
                   streaming heads get ultra-low bits (instead of being
                   pruned).  Generalises to the layer dimension
                   (``layer_pyramid``) and token dimension
                   (``token_heavy_hitter_frac`` — heavy hitters stay high).
  - ``duo``      : DuoAttention-style pruning baseline (streaming heads keep
                   sink+recent tokens only, at source precision).

All quantizers are *exact-byte accounted*: payload bits + fp16 scale/zp
metadata + masks, so measured CR matches what would cross the wire.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.strategy import SCALE_BYTES, SOURCE_BYTES, ZP_BYTES, StrategyConfig

Array = np.ndarray
_EPS = 1e-8


# ---------------------------------------------------------------------------
# Grouped min/max quantization primitive.
# ---------------------------------------------------------------------------
def _pad_to_multiple(x: Array, axis: int, m: int) -> Tuple[Array, int]:
    s = x.shape[axis]
    rem = (-s) % m
    if rem == 0:
        return x, s
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, mode="edge"), s


def group_quantize(
    x: Array, bits: int, grouping: str, group_size: int, symmetric: bool
) -> Tuple[Array, Array, Optional[Array]]:
    """Quantize ``x: (N, S, D)`` -> (codes uint8 (N,S,D), scale, zp).

    grouping:
      per_head    — one group per (N) slice
      per_channel — stats per channel over token groups of ``group_size``
      per_token   — stats per token over channel groups of ``group_size``
    """
    assert 1 <= bits <= 8
    n, s, d = x.shape
    qmax = (1 << bits) - 1

    if grouping == "per_head":
        xg = x.reshape(n, 1, s * d)
        axis = 2
    elif grouping == "per_channel":
        xp, s0 = _pad_to_multiple(x, 1, group_size)
        g = xp.shape[1] // group_size
        xg = xp.reshape(n, g, group_size, d)
        axis = 2
    elif grouping == "per_token":
        xp, d0 = _pad_to_multiple(x, 2, group_size)
        g = xp.shape[2] // group_size
        xg = xp.reshape(n, s, g, group_size)
        axis = 3
    else:
        raise ValueError(grouping)

    if symmetric:
        amax = np.abs(xg).max(axis=axis, keepdims=True)
        scale = np.maximum(amax / max((1 << (bits - 1)) - 1, 1), _EPS)
        q = np.clip(np.rint(xg / scale) + (1 << (bits - 1)), 0, qmax)
        zp = None
    else:
        mn = xg.min(axis=axis, keepdims=True)
        mx = xg.max(axis=axis, keepdims=True)
        scale = np.maximum((mx - mn) / qmax, _EPS)
        q = np.clip(np.rint((xg - mn) / scale), 0, qmax)
        zp = mn.astype(np.float16)

    codes = q.astype(np.uint8)
    # Un-reshape codes back to (N, S, D), trimming any padding.
    if grouping == "per_head":
        codes = codes.reshape(n, s, d)
    elif grouping == "per_channel":
        codes = codes.reshape(n, -1, d)[:, :s, :]
    else:
        codes = codes.reshape(n, s, -1)[:, :, :d]
    return codes, scale.astype(np.float16), zp


def group_dequantize(
    codes: Array, scale: Array, zp: Optional[Array], bits: int, grouping: str,
    group_size: int, symmetric: bool,
) -> Array:
    n, s, d = codes.shape
    q = codes.astype(np.float32)
    if grouping == "per_head":
        qg = q.reshape(n, 1, s * d)
    elif grouping == "per_channel":
        qp, _ = _pad_to_multiple(q, 1, group_size)
        qg = qp.reshape(n, -1, group_size, d)
    else:
        qp, _ = _pad_to_multiple(q, 2, group_size)
        qg = qp.reshape(n, s, -1, group_size)

    sc = scale.astype(np.float32)
    if symmetric:
        x = (qg - (1 << (bits - 1))) * sc
    else:
        x = qg * sc + zp.astype(np.float32)

    if grouping == "per_head":
        return x.reshape(n, s, d).astype(np.float32)
    if grouping == "per_channel":
        return x.reshape(n, -1, d)[:, :s, :].astype(np.float32)
    return x.reshape(n, s, -1)[:, :, :d].astype(np.float32)


# ---------------------------------------------------------------------------
# Bucketed representation.
# ---------------------------------------------------------------------------
@dataclass
class QuantBucket:
    """A set of (layer, head) slices quantized with one (bits, grouping)."""

    lh_index: Array  # (N, 2) int32 — (layer, head) of each slice
    bits: int
    grouping: str
    group_size: int
    symmetric: bool
    codes: Array  # (N, S, D) uint8, or float16 for passthrough (bits==16)
    scale: Optional[Array]
    zp: Optional[Array]
    token_index: Optional[Array] = None  # token subset (heavy-hitter / duo)

    def payload_bits(self) -> int:
        if self.bits >= 16:
            return int(self.codes.size) * SOURCE_BYTES * 8
        return int(self.codes.size) * self.bits

    def meta_bytes(self) -> int:
        b = 0
        if self.scale is not None:
            b += self.scale.size * SCALE_BYTES
        if self.zp is not None:
            b += self.zp.size * ZP_BYTES
        b += self.lh_index.size * 2  # uint16 slice ids
        if self.token_index is not None:
            b += self.token_index.size * 4
        return int(b)

    def dequantize(self) -> Array:
        if self.bits >= 16:
            return self.codes.astype(np.float32)
        return group_dequantize(
            self.codes, self.scale, self.zp, self.bits, self.grouping,
            self.group_size, self.symmetric,
        )


@dataclass
class QuantizedTensor:
    """Quantized (L, H, S, D) tensor as buckets; positions absent from every
    bucket are pruned (decode to zero)."""

    shape: Tuple[int, int, int, int]
    buckets: List[QuantBucket] = field(default_factory=list)

    def payload_bits(self) -> int:
        return sum(b.payload_bits() for b in self.buckets)

    def meta_bytes(self) -> int:
        return sum(b.meta_bytes() for b in self.buckets)

    def dequantize(self) -> Array:
        out = np.zeros(self.shape, dtype=np.float32)
        for b in self.buckets:
            x = b.dequantize()  # (N, S', D)
            ls, hs = b.lh_index[:, 0], b.lh_index[:, 1]
            if b.token_index is None:
                out[ls, hs] = x
            else:
                out[ls[:, None], hs[:, None], b.token_index[None, :]] = x
        return out


# ---------------------------------------------------------------------------
# Bit-allocation plans per quantizer.
# ---------------------------------------------------------------------------
def head_importance_scores(k: Array) -> Array:
    """Default retrieval-head proxy score: token-axis dispersion of K.

    Retrieval heads carry token-distinguishing keys (high variance across
    tokens); streaming heads have near-constant keys.  Real deployments can
    inject DuoAttention-style calibrated scores instead (see
    ``repro.core.quality.calibrate_head_scores``).
    """
    # k: (L, H, S, D) -> score (L, H)
    centered = k - k.mean(axis=2, keepdims=True)
    return np.sqrt((centered**2).mean(axis=(2, 3)))


def _tier_bits_per_layer(num_layers: int, tier_bits, tier_fracs) -> Array:
    f1, f2 = tier_fracs
    n1 = max(int(round(num_layers * f1)), 1)
    n2 = max(int(round(num_layers * f2)), 1)
    out = np.full((num_layers,), tier_bits[2], dtype=np.int32)
    out[:n1] = tier_bits[0]
    out[n1 : n1 + n2] = tier_bits[1]
    return out


def _quantize_bucketed(
    x: Array, bits_lh: Array, grouping: str, group_size: int, symmetric: bool
) -> QuantizedTensor:
    """Bucket (l, h) slices by bit-width and quantize each bucket."""
    L, H, S, D = x.shape
    qt = QuantizedTensor(shape=(L, H, S, D))
    for bits in np.unique(bits_lh):
        ls, hs = np.nonzero(bits_lh == bits)
        sl = x[ls, hs]  # (N, S, D)
        if bits >= 16:
            qt.buckets.append(
                QuantBucket(
                    lh_index=np.stack([ls, hs], 1).astype(np.int32),
                    bits=16, grouping="passthrough", group_size=0,
                    symmetric=False, codes=sl.astype(np.float16),
                    scale=None, zp=None,
                )
            )
            continue
        codes, scale, zp = group_quantize(sl, int(bits), grouping, group_size, symmetric)
        qt.buckets.append(
            QuantBucket(
                lh_index=np.stack([ls, hs], 1).astype(np.int32),
                bits=int(bits), grouping=grouping, group_size=group_size,
                symmetric=symmetric, codes=codes, scale=scale, zp=zp,
            )
        )
    return qt


def quantize_tensor(
    x: Array,
    cfg: StrategyConfig,
    is_key: bool,
    head_scores: Optional[Array] = None,
) -> QuantizedTensor:
    """Quantize one transformed (L, H, S, D) tensor according to ``cfg``."""
    L, H, S, D = x.shape

    if cfg.quantizer == "uniform":
        bits = cfg.key_bits if is_key else cfg.value_bits
        bits_lh = np.full((L, H), bits, dtype=np.int32)
        return _quantize_bucketed(x, bits_lh, cfg.granularity, cfg.group_size,
                                  cfg.symmetric)

    if cfg.quantizer == "kivi":
        bits = cfg.key_bits if is_key else cfg.value_bits
        grouping = "per_channel" if is_key else "per_token"
        bits_lh = np.full((L, H), bits, dtype=np.int32)
        return _quantize_bucketed(x, bits_lh, grouping, cfg.group_size, False)

    if cfg.quantizer == "cachegen":
        per_layer = _tier_bits_per_layer(L, cfg.tier_bits, cfg.tier_fracs)
        bits_lh = np.broadcast_to(per_layer[:, None], (L, H)).copy()
        return _quantize_bucketed(x, bits_lh, "per_channel", cfg.group_size,
                                  cfg.symmetric)

    if cfg.quantizer == "mixhq":
        return _quantize_mixhq(x, cfg, head_scores)

    if cfg.quantizer == "duo":
        return _quantize_duo(x, cfg, head_scores)

    raise ValueError(cfg.quantizer)


def _resolve_head_scores(x: Array, head_scores: Optional[Array]) -> Array:
    if head_scores is not None:
        assert head_scores.shape == x.shape[:2], (head_scores.shape, x.shape)
        return head_scores
    return head_importance_scores(x)


def _retrieval_mask(scores: Array, frac: float) -> Array:
    """Boolean (L, H): top ``frac`` heads per layer are retrieval heads."""
    L, H = scores.shape
    k = max(int(round(H * frac)), 0)
    mask = np.zeros((L, H), dtype=bool)
    if k > 0:
        idx = np.argsort(-scores, axis=1)[:, :k]
        mask[np.arange(L)[:, None], idx] = True
    return mask


def _quantize_mixhq(x: Array, cfg: StrategyConfig,
                    head_scores: Optional[Array]) -> QuantizedTensor:
    """MixHQ: variable precision allocation instead of binary pruning."""
    L, H, S, D = x.shape
    scores = _resolve_head_scores(x, head_scores)
    retrieval = _retrieval_mask(scores, cfg.retrieval_frac)

    bits_lh = np.where(retrieval, cfg.mixhq_high_bits, cfg.mixhq_low_bits).astype(np.int32)
    if cfg.layer_pyramid:
        # Deeper third of layers: shave one more bit off streaming heads.
        deep = np.arange(L) >= (2 * L) // 3
        shave = deep[:, None] & ~retrieval
        bits_lh = np.where(shave, np.maximum(bits_lh - 1, 1), bits_lh)

    hh_frac = cfg.token_heavy_hitter_frac
    if hh_frac <= 0.0:
        return _quantize_bucketed(x, bits_lh, "per_channel", cfg.group_size,
                                  cfg.symmetric)

    # Token-dimension generalisation (SnapKV-style heavy hitters): globally
    # shared heavy token set stays at high bits inside streaming heads.
    tok_norm = np.sqrt((x**2).mean(axis=(0, 1, 3)))  # (S,)
    k = max(int(round(S * hh_frac)), 1)
    heavy_idx = np.sort(np.argsort(-tok_norm)[:k])
    light_idx = np.setdiff1d(np.arange(S), heavy_idx)

    qt = QuantizedTensor(shape=(L, H, S, D))
    qt_buckets: List[QuantBucket] = []
    # Retrieval heads: all tokens at high bits.
    ls, hs = np.nonzero(retrieval)
    if len(ls):
        sl = x[ls, hs]
        codes, scale, zp = group_quantize(sl, cfg.mixhq_high_bits, "per_channel",
                                          cfg.group_size, cfg.symmetric)
        qt_buckets.append(QuantBucket(np.stack([ls, hs], 1).astype(np.int32),
                                      cfg.mixhq_high_bits, "per_channel",
                                      cfg.group_size, cfg.symmetric, codes, scale, zp))
    ls, hs = np.nonzero(~retrieval)
    if len(ls):
        stream_bits = bits_lh[ls, hs]
        for bits in np.unique(stream_bits):
            sel = stream_bits == bits
            lss, hss = ls[sel], hs[sel]
            heavy = x[lss, hss][:, heavy_idx, :]
            light = x[lss, hss][:, light_idx, :]
            ch, sch, zph = group_quantize(heavy, cfg.mixhq_high_bits, "per_channel",
                                          cfg.group_size, cfg.symmetric)
            cl, scl, zpl = group_quantize(light, int(bits), "per_channel",
                                          cfg.group_size, cfg.symmetric)
            idx = np.stack([lss, hss], 1).astype(np.int32)
            qt_buckets.append(QuantBucket(idx, cfg.mixhq_high_bits, "per_channel",
                                          cfg.group_size, cfg.symmetric, ch, sch,
                                          zph, token_index=heavy_idx))
            qt_buckets.append(QuantBucket(idx, int(bits), "per_channel",
                                          cfg.group_size, cfg.symmetric, cl, scl,
                                          zpl, token_index=light_idx))
    qt.buckets = qt_buckets
    return qt


def _quantize_duo(x: Array, cfg: StrategyConfig,
                  head_scores: Optional[Array]) -> QuantizedTensor:
    """DuoAttention baseline: streaming heads keep sink+recent only (fp16)."""
    L, H, S, D = x.shape
    scores = _resolve_head_scores(x, head_scores)
    retrieval = _retrieval_mask(scores, cfg.retrieval_frac)
    keep_idx = np.unique(
        np.concatenate([
            np.arange(min(cfg.duo_sink, S)),
            np.arange(max(S - cfg.duo_recent, 0), S),
        ])
    )

    qt = QuantizedTensor(shape=(L, H, S, D))
    ls, hs = np.nonzero(retrieval)
    if len(ls):
        qt.buckets.append(QuantBucket(
            np.stack([ls, hs], 1).astype(np.int32), 16, "passthrough", 0, False,
            x[ls, hs].astype(np.float16), None, None,
        ))
    ls, hs = np.nonzero(~retrieval)
    if len(ls):
        qt.buckets.append(QuantBucket(
            np.stack([ls, hs], 1).astype(np.int32), 16, "passthrough", 0, False,
            x[ls, hs][:, keep_idx, :].astype(np.float16), None, None,
            token_index=keep_idx,
        ))
    return qt
