"""Gradient compression with error feedback (beyond-paper extension).

The counterpart of the JAX package's ``distribution/grad_compress.py``:

1. ``make_grad_transform`` — quantize gradients (error-feedback corrected)
   before the optimizer, through ``quant_pack`` and ``dequant_unpack`` on
   the card: the wire format of a compressed gradient exchange.
2. ``make_cross_pod_grad_sync`` — average gradients over a
   ``torch.distributed`` group whose ranks are pods, exchanging int codes
   and f16 scales over ``npod - 1`` ring hops (the cross-pod hop that is
   bandwidth-starved in multi-pod training).  Wire bytes drop by 16/bits.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.distribution.kv_transfer import (
    dequantize_rows,
    pack_payload,
    pod_group,
    quantize_rows,
    ring_hop,
    unpack_payload,
)
from repro_torch.models.convert import leaves, tree_map


def _quant_roundtrip(g: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """g through the wire format and back, in f32: quantize with f32
    scales, round the scales to f16, dequantize.  A leaf whose last dim
    the group does not divide is returned as it is."""
    if g.ndim == 0 or g.shape[-1] % min(group, max(g.shape[-1], 1)):
        return g
    gg = min(group, g.shape[-1])
    codes, scale = quantize_rows(g.reshape(-1, g.shape[-1]), bits, gg)
    return dequantize_rows(codes, scale, bits, gg,
                           torch.float32).reshape(g.shape)


def make_grad_transform(bits: int = 8, group: int = 64,
                        error_feedback: bool = True) -> Callable:
    """grad_transform(grads, opt_state) -> (grads_hat, opt_state).

    opt_state must carry an "ef" tree (zeros like grads) when
    error_feedback=True — see ``init_ef_state``.  The error feedback is
    updated in place, one leaf at a time, so a leaf's temporaries are the
    only memory the transform adds beside ``grads_hat``."""

    def transform(grads, opt_state):
        use_ef = error_feedback and "ef" in opt_state

        def leaf(g, e=None):
            corrected = g.float() + e if use_ef else g
            g_hat = _quant_roundtrip(corrected, bits, group)
            if use_ef:
                torch.sub(corrected, g_hat.float(), out=e)
            return g_hat

        if use_ef:
            return tree_map(leaf, grads, opt_state["ef"]), opt_state
        return tree_map(leaf, grads), opt_state

    return transform


def init_ef_state(grads_like) -> Dict[str, Any]:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), grads_like)


def make_cross_pod_grad_sync(process_group=None, bits: int = 8,
                             group: int = 64) -> Callable:
    """Average gradients across pods with quantized exchange.

    Each rank of ``process_group`` (a group, or a ``DeviceMesh`` whose
    "pod" dimension's group it takes) is one pod: it keeps its own grads in
    f32 and receives its peers' as int codes + f16 scales, over a ring of
    npod-1 hops (hop k: send to rank r+k, receive from rank r-k), adding
    them in hop order as the JAX package's ``ppermute`` chain does.
    Returns ``sync(grads) -> grads``."""
    process_group = pod_group(process_group)

    def sync(grads):
        npod = dist.get_world_size(process_group)
        if npod < 2:
            raise ValueError("cross-pod sync needs at least two pods")
        flat = leaves(grads)
        parts, like, how = [], [], []
        for g in flat:
            gg = min(group, g.shape[-1]) if g.ndim else 0
            packable = g.ndim > 0 and g.shape[-1] % gg == 0 and gg % 2 == 0
            sent = (list(quantize_rows(g.reshape(-1, g.shape[-1]), bits, gg))
                    if packable else [g])
            parts += sent
            like += [(t.dtype, tuple(t.shape)) for t in sent]
            how.append(gg if packable else 0)
        payload = pack_payload(parts)
        del parts
        acc = [g if g.ndim == 0 else g.float() for g in flat]
        for k in range(1, npod):
            got = iter(unpack_payload(ring_hop(process_group, payload, k),
                                      like))
            for i, (g, gg) in enumerate(zip(flat, how)):
                if gg:
                    codes, scale = next(got), next(got)
                    acc[i] = acc[i] + dequantize_rows(
                        codes, scale, bits, gg,
                        torch.float32).reshape(g.shape)
                else:
                    acc[i] = acc[i] + next(got).to(acc[i].dtype)
        out = iter([(a / torch.full((), npod, dtype=a.dtype,
                                    device=a.device)).to(g.dtype)
                    for a, g in zip(acc, flat)])
        return tree_map(lambda _: next(out), grads)

    return sync
