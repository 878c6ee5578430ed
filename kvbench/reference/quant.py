"""What a KV profile does to the KV, in plain arithmetic: the quantize
and dequantize of every strategy a frozen profile set may hold, and a
decoder and byte count of the wire payload.  A strategy outside these raises, so a
profile set that grows past them fails the run instead of passing a
comparison it never made."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def supported(strategy: Dict) -> bool:
    """Identity (16-bit pass-through, no codec), or uniform symmetric
    per-token quantization with equal 4- or 8-bit K and V, no transform
    and no codec."""
    if strategy["key_bits"] >= 16 and strategy["value_bits"] >= 16:
        return strategy["codec"] == "none"
    return (strategy["quantizer"] == "uniform"
            and strategy["granularity"] == "per_token"
            and strategy["symmetric"]
            and strategy["transform"] == "none"
            and strategy["codec"] == "none"
            and strategy["key_bits"] == strategy["value_bits"]
            and strategy["key_bits"] in (4, 8))


def qdq(x: torch.Tensor, strategy: Dict) -> torch.Tensor:
    """x (..., D) float32 -> what decode reads after the wire, float32.
    Codes come from the f32 scale absmax / qmax (IEEE divide, round half
    to even); the wire carries the scale in fp16, and the restored value
    is code times that fp16 scale."""
    if not supported(strategy):
        raise ValueError(f"no plain arithmetic for strategy {strategy}")
    x = x.float()
    if strategy["key_bits"] >= 16:
        return x.half().float()
    bits, group = strategy["key_bits"], strategy["group_size"]
    d = x.shape[-1]
    qmax = (1 << (bits - 1)) - 1
    xg = x.reshape(x.shape[:-1] + (d // group, group))
    scale = torch.clamp(xg.abs().amax(dim=-1) / torch.tensor(
        float(qmax), device=x.device), min=1e-8)
    q = torch.clamp(torch.round(xg / scale[..., None]), -qmax - 1, qmax)
    out = q * scale.half().float()[..., None]
    return out.reshape(x.shape)


def payload_kv(payload, device) -> tuple:
    """(K, V) float32 (L, H, S, D) on ``device``, decoded from a wire
    payload with this file's arithmetic: fp16 pass-through bytes, or per
    bucket the packed unsigned codes (big-endian bit order, offset
    2**(bits-1)) times their fp16 group scales."""
    shape = tuple(int(s) for s in payload.shape)
    n = int(np.prod(shape))
    if payload.identity_payload is not None:
        raw = torch.frombuffer(bytearray(payload.identity_payload),
                               dtype=torch.float16, count=2 * n)
        flat = raw.to(device).float()
        return flat[:n].reshape(shape), flat[n:].reshape(shape)
    out = []
    for buckets in (payload.k_buckets, payload.v_buckets):
        if len(buckets) != 1:
            raise ValueError("a per-token payload has one bucket a tensor")
        w = buckets[0]
        raw = torch.frombuffer(bytearray(w.payload), dtype=torch.uint8)
        raw = raw.to(device)
        if w.bits == 8:
            u = raw.to(torch.int16)
        elif w.bits == 4:
            u = torch.stack([raw >> 4, raw & 0x0F], -1).reshape(-1) \
                .to(torch.int16)
        else:
            raise ValueError(f"{w.bits}-bit payload")
        count = int(np.prod(w.codes_shape))
        nb, s, d = w.codes_shape
        codes = (u[:count] - (1 << (w.bits - 1))).float()
        sc = torch.as_tensor(np.asarray(w.scale, dtype=np.float16)
                             .astype(np.float32)).to(device)
        vals = (codes.reshape(nb, s, d // w.group_size, w.group_size)
                * sc.reshape(nb, s, d // w.group_size, 1)).reshape(nb, s, d)
        full = torch.zeros(shape, dtype=torch.float32, device=device)
        lh = torch.as_tensor(np.asarray(w.lh_index), dtype=torch.long,
                             device=device)
        full[lh[:, 0], lh[:, 1]] = vals
        out.append(full)
    return out[0], out[1]


def payload_bytes(payload) -> int:
    """Wire bytes of a payload by the harness's own arithmetic: payload
    bytes, 2 a bucket's (layer, head) index entry, 2 an fp16 scale or
    zero point, 4 a token index, no transform metadata (the profile sets
    hold no transform), and a 64-byte header."""
    if payload.identity_payload is not None:
        return len(payload.identity_payload) + 64
    if payload.k_ctx.get("kind") != "none" \
            or payload.v_ctx.get("kind") != "none":
        raise ValueError("a payload with transform metadata")
    total = 64
    for w in payload.k_buckets + payload.v_buckets:
        total += len(w.payload) + w.lh_index.size * 2
        for meta, per in ((w.scale, 2), (w.zp, 2), (w.token_index, 4)):
            if meta is not None:
                total += meta.size * per
    return total
