"""Stage 1 of the pipeline: the Transformer ``T`` (pre-processing transforms).

All transforms are exactly (or float-exactly) invertible; they reshape the
distribution so the downstream quantizer loses less information:

  - ``delta``     (CacheGen):  tokens stored as deltas against periodic anchor
                  tokens -> smaller dynamic range on smooth token streams.
  - ``hadamard``  (QuaRot):    orthonormal rotation of the channel dim ->
                  spreads outlier channels across all channels.
  - ``affine``    (AffineQuant, diagonal): per-channel standardisation with
                  stats stored as metadata.

Each transform returns ``(y, ctx)`` where ``ctx`` holds inverse metadata, and
``meta_bytes(ctx)`` accounts for its wire cost.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# Hadamard
# ---------------------------------------------------------------------------
def hadamard_matrix(n: int) -> Array:
    """Orthonormal Hadamard matrix of size n (n must be a power of two)."""
    assert n & (n - 1) == 0, f"hadamard dim {n} not a power of two"
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(n)).astype(np.float32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def hadamard_forward(x: Array) -> Tuple[Array, Dict[str, Any]]:
    d = x.shape[-1]
    dp = _next_pow2(d)
    if dp != d:
        pad = np.zeros(x.shape[:-1] + (dp - d,), dtype=x.dtype)
        x = np.concatenate([x, pad], axis=-1)
    h = hadamard_matrix(dp)
    y = x @ h
    return y.astype(np.float32), {"orig_dim": d, "pad_dim": dp}


def hadamard_inverse(y: Array, ctx: Dict[str, Any]) -> Array:
    h = hadamard_matrix(ctx["pad_dim"])
    x = y @ h.T
    return x[..., : ctx["orig_dim"]].astype(np.float32)


# ---------------------------------------------------------------------------
# Delta (anchor-token differencing along the sequence axis; axis=-2)
# ---------------------------------------------------------------------------
def delta_forward(x: Array, group: int) -> Tuple[Array, Dict[str, Any]]:
    s = x.shape[-2]
    anchors_idx = np.arange(0, s, group)
    anchors = x[..., anchors_idx, :]
    # Broadcast each token's group anchor and subtract.
    anchor_of = anchors_idx[np.minimum(np.arange(s) // group, len(anchors_idx) - 1)]
    y = x - x[..., anchor_of, :]
    # Keep anchors raw (their delta is zero; store anchor values in metadata).
    return y.astype(np.float32), {"group": group, "anchors": anchors.astype(np.float32)}


def delta_inverse(y: Array, ctx: Dict[str, Any]) -> Array:
    group = ctx["group"]
    anchors = ctx["anchors"]
    s = y.shape[-2]
    anchors_idx = np.arange(0, s, group)
    anchor_of = np.minimum(np.arange(s) // group, len(anchors_idx) - 1)
    x = y + anchors[..., anchor_of, :]
    return x.astype(np.float32)


def delta_meta_bytes(ctx: Dict[str, Any]) -> int:
    # Anchors ship at source precision (bf16 = 2 bytes logical).
    return int(ctx["anchors"].size) * 2


# ---------------------------------------------------------------------------
# Affine (diagonal): per-channel standardisation.
# ---------------------------------------------------------------------------
def affine_forward(x: Array) -> Tuple[Array, Dict[str, Any]]:
    # Stats over all axes but the channel axis.
    axes = tuple(range(x.ndim - 1))
    mu = x.mean(axis=axes, keepdims=True)
    sd = x.std(axis=axes, keepdims=True) + 1e-6
    y = (x - mu) / sd
    return y.astype(np.float32), {"mu": mu.astype(np.float32), "sd": sd.astype(np.float32)}


def affine_inverse(y: Array, ctx: Dict[str, Any]) -> Array:
    return (y * ctx["sd"] + ctx["mu"]).astype(np.float32)


def affine_meta_bytes(ctx: Dict[str, Any]) -> int:
    return int(ctx["mu"].size + ctx["sd"].size) * 2


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def apply_transform(name: str, x: Array, delta_group: int = 64):
    if name == "none":
        return x, {"kind": "none"}
    if name == "hadamard":
        y, ctx = hadamard_forward(x)
        ctx["kind"] = "hadamard"
        return y, ctx
    if name == "delta":
        y, ctx = delta_forward(x, delta_group)
        ctx["kind"] = "delta"
        return y, ctx
    if name == "affine":
        y, ctx = affine_forward(x)
        ctx["kind"] = "affine"
        return y, ctx
    raise ValueError(f"unknown transform {name}")


def invert_transform(y: Array, ctx: Dict[str, Any]) -> Array:
    kind = ctx["kind"]
    if kind == "none":
        return y
    if kind == "hadamard":
        return hadamard_inverse(y, ctx)
    if kind == "delta":
        return delta_inverse(y, ctx)
    if kind == "affine":
        return affine_inverse(y, ctx)
    raise ValueError(kind)


def transform_meta_bytes(ctx: Dict[str, Any]) -> int:
    kind = ctx["kind"]
    if kind in ("none", "hadamard"):
        return 0
    if kind == "delta":
        return delta_meta_bytes(ctx)
    if kind == "affine":
        return affine_meta_bytes(ctx)
    raise ValueError(kind)
