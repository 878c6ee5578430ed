"""The unified KV-cache compression pipeline: ``BS = C(Q(T(X)))`` (Sec. 5.1).

``compress`` produces a :class:`CompressedKV` whose *payload is real bytes*
(bit-packed, entropy-coded); ``decompress`` round-trips through those bytes.
Structural metadata (scales, zero-points, transform anchors, indices) is kept
native but exactly byte-accounted, so the reported CR equals
``wire_bytes(original) / wire_bytes(compressed)`` including all metadata —
this reproduces e.g. KIVI's metadata-bounded CR ceiling (paper Sec. 7.3).

Stage implementations and the TPU/host split are described in DESIGN.md
§2-§3; :class:`CompressedKV` is also the payload the serving layer's
prefix-KV pool stores (DESIGN.md §9).

Device path: KV held as torch tensors (:class:`DeviceKVCache`) under a
``paged_eligible`` strategy quantizes with the Hopper ``quant_pack`` kernel
(its plain version for CPU tensors), and a pipeline given a ``device``
decompresses such payloads with ``dequant_unpack``.  The wire form is the
host path's byte for byte; every other strategy takes the numpy stages.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codecs
from repro_torch.core.kvcache import KVCache
from repro_torch.core.quantizers import (
    QuantBucket,
    QuantizedTensor,
    head_importance_scores,
    quantize_tensor,
)
from repro_torch.core.strategy import SOURCE_BYTES, StrategyConfig, is_identity
from repro_torch.core.transforms import apply_transform, invert_transform, transform_meta_bytes
from repro_torch.core.strategy import paged_eligible

HEADER_BYTES = 64  # fixed per-message framing overhead


@dataclass
class _BucketWire:
    """Wire form of one quant bucket: payload bytes + structural metadata."""

    payload: bytes
    bits: int
    grouping: str
    group_size: int
    symmetric: bool
    codes_shape: Tuple[int, ...]
    lh_index: np.ndarray
    scale: Optional[np.ndarray]
    zp: Optional[np.ndarray]
    token_index: Optional[np.ndarray]

    def meta_bytes(self) -> int:
        b = self.lh_index.size * 2
        if self.scale is not None:
            b += self.scale.size * 2
        if self.zp is not None:
            b += self.zp.size * 2
        if self.token_index is not None:
            b += self.token_index.size * 4
        return int(b)


@dataclass
class CompressedKV:
    strategy: StrategyConfig
    shape: Tuple[int, int, int, int]
    k_buckets: List[_BucketWire]
    v_buckets: List[_BucketWire]
    k_ctx: Dict[str, Any]
    v_ctx: Dict[str, Any]
    identity_payload: Optional[bytes] = None  # bypass path

    # ------------------------------------------------------------------
    def payload_bytes(self) -> int:
        if self.identity_payload is not None:
            return len(self.identity_payload)
        return sum(len(b.payload) for b in self.k_buckets + self.v_buckets)

    def meta_bytes(self) -> int:
        if self.identity_payload is not None:
            return HEADER_BYTES
        m = sum(b.meta_bytes() for b in self.k_buckets + self.v_buckets)
        m += transform_meta_bytes(self.k_ctx) + transform_meta_bytes(self.v_ctx)
        return m + HEADER_BYTES

    def total_bytes(self) -> int:
        return self.payload_bytes() + self.meta_bytes()

    def original_bytes(self) -> int:
        return int(np.prod(self.shape)) * 2 * SOURCE_BYTES

    def compression_ratio(self) -> float:
        return self.original_bytes() / max(self.total_bytes(), 1)


class DeviceKVCache(KVCache):
    """:class:`KVCache` whose ``k``/``v`` are (L, H, S, D) torch tensors —
    the KV a prefill left on the device, bf16 or f32."""

    def nbytes_wire(self) -> int:
        return int(self.k.numel() + self.v.numel()) * SOURCE_BYTES

    def to_host(self) -> KVCache:
        return KVCache(self.k.float().cpu().numpy(),
                       self.v.float().cpu().numpy())


def _lh_index(num_layers: int, heads: int) -> np.ndarray:
    ls, hs = np.nonzero(np.ones((num_layers, heads), bool))
    return np.stack([ls, hs], 1).astype(np.int32)


def _device_quantize(x: torch.Tensor, bits: int, group: int,
                     codec: str) -> _BucketWire:
    """One symmetric per-token bucket from the quant_pack kernel: codes
    offset by 2^(bits-1) and fp16 scales, laid out as group_quantize's."""
    from repro_torch.kernels import quant_pack_op

    L, H, S, D = x.shape
    codes, scales = quant_pack_op(x.reshape(L * H * S, D), bits=bits,
                                  group=group)
    if bits == 4:   # nibbles already hold q + 8, low nibble first
        u = torch.stack([codes & 0x0F, codes >> 4], dim=-1)
    else:
        u = (codes.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8)
    u = u.reshape(L * H, S, D).cpu().numpy()
    scale = scales.to(torch.float16).cpu().numpy().reshape(
        L * H, S, D // group, 1)
    return _BucketWire(
        payload=codecs.encode_codes(u, bits, codec), bits=bits,
        grouping="per_token", group_size=group, symmetric=True,
        codes_shape=tuple(u.shape), lh_index=_lh_index(L, H), scale=scale,
        zp=None, token_index=None)


def _device_dequantize(w: _BucketWire, shape, codec: str,
                       device) -> torch.Tensor:
    """Inverse of :func:`_device_quantize` with the dequant_unpack kernel:
    (L, H, S, D) f32 on ``device``."""
    from repro_torch.kernels import dequant_unpack_op

    L, H, S, D = shape
    count = int(np.prod(w.codes_shape))
    u = torch.from_numpy(codecs.decode_codes(w.payload, w.bits, count, codec)
                         ).to(device).reshape(-1, D)
    if w.bits == 4:
        codes = u[:, 0::2] | (u[:, 1::2] << 4)
    else:
        codes = (u.to(torch.int16) - (1 << (w.bits - 1))).to(torch.int8)
    scales = torch.from_numpy(w.scale.reshape(-1, D // w.group_size)).to(
        device).float()
    x = dequant_unpack_op(codes.contiguous(), scales, bits=w.bits,
                          group=w.group_size, out_dtype=torch.float32)
    return x.reshape(L, H, S, D)


# ---------------------------------------------------------------------------
def _encode_quantized(qt: QuantizedTensor, codec: str) -> List[_BucketWire]:
    out = []
    for b in qt.buckets:
        if b.bits >= 16:
            payload = codecs.encode_f16(b.codes, codec)
        else:
            payload = codecs.encode_codes(b.codes, b.bits, codec)
        out.append(
            _BucketWire(
                payload=payload, bits=b.bits, grouping=b.grouping,
                group_size=b.group_size, symmetric=b.symmetric,
                codes_shape=tuple(b.codes.shape), lh_index=b.lh_index,
                scale=b.scale, zp=b.zp, token_index=b.token_index,
            )
        )
    return out


def _decode_quantized(wires: List[_BucketWire], shape, codec: str) -> QuantizedTensor:
    qt = QuantizedTensor(shape=shape)
    for w in wires:
        count = int(np.prod(w.codes_shape))
        if w.bits >= 16:
            codes = codecs.decode_f16(w.payload, count, codec).reshape(w.codes_shape)
        else:
            codes = codecs.decode_codes(w.payload, w.bits, count, codec).reshape(
                w.codes_shape
            )
        qt.buckets.append(
            QuantBucket(
                lh_index=w.lh_index, bits=w.bits, grouping=w.grouping,
                group_size=w.group_size, symmetric=w.symmetric, codes=codes,
                scale=w.scale, zp=w.zp, token_index=w.token_index,
            )
        )
    return qt


class CompressionPipeline:
    """Stateless compressor for one :class:`StrategyConfig`.  ``device``
    (optional) is where :meth:`decompress` restores paged-eligible
    payloads, as a :class:`DeviceKVCache`."""

    def __init__(self, strategy: StrategyConfig,
                 head_scores: Optional[np.ndarray] = None,
                 device=None):
        strategy.validate()
        self.strategy = strategy
        self.head_scores = head_scores
        self.device = device

    def _on_device(self, head_dim: int) -> bool:
        return paged_eligible(self.strategy, head_dim=head_dim)

    # ------------------------------------------------------------------
    def compress(self, kv: KVCache) -> CompressedKV:
        cfg = self.strategy
        if isinstance(kv, DeviceKVCache):
            if self._on_device(kv.head_dim):
                return CompressedKV(
                    strategy=cfg, shape=tuple(kv.shape),
                    k_buckets=[_device_quantize(kv.k, cfg.key_bits,
                                                cfg.group_size, cfg.codec)],
                    v_buckets=[_device_quantize(kv.v, cfg.value_bits,
                                                cfg.group_size, cfg.codec)],
                    k_ctx={"kind": "none"}, v_ctx={"kind": "none"})
            kv = kv.to_host()
        if is_identity(cfg):
            payload = np.concatenate(
                [kv.k.ravel(), kv.v.ravel()]
            ).astype(np.float16).tobytes()
            return CompressedKV(cfg, kv.shape, [], [], {"kind": "none"},
                                {"kind": "none"}, identity_payload=payload)

        k_t, k_ctx = apply_transform(cfg.transform, kv.k, cfg.delta_group)
        v_t, v_ctx = apply_transform(cfg.transform, kv.v, cfg.delta_group)

        scores = self.head_scores
        if scores is None and cfg.quantizer in ("mixhq", "duo"):
            scores = head_importance_scores(kv.k)

        k_q = quantize_tensor(k_t, cfg, is_key=True, head_scores=scores)
        v_q = quantize_tensor(v_t, cfg, is_key=False, head_scores=scores)

        return CompressedKV(
            strategy=cfg, shape=kv.shape,
            k_buckets=_encode_quantized(k_q, cfg.codec),
            v_buckets=_encode_quantized(v_q, cfg.codec),
            k_ctx=k_ctx, v_ctx=v_ctx,
        )

    # ------------------------------------------------------------------
    def decompress(self, comp: CompressedKV) -> KVCache:
        cfg = comp.strategy
        if self.device is not None and comp.identity_payload is None \
                and paged_eligible(cfg, head_dim=comp.shape[3]):
            return DeviceKVCache(
                _device_dequantize(comp.k_buckets[0], comp.shape, cfg.codec,
                                   self.device),
                _device_dequantize(comp.v_buckets[0], comp.shape, cfg.codec,
                                   self.device))
        if comp.identity_payload is not None:
            n = int(np.prod(comp.shape))
            flat = np.frombuffer(comp.identity_payload, dtype=np.float16,
                                 count=2 * n).astype(np.float32)
            k = flat[:n].reshape(comp.shape)
            v = flat[n:].reshape(comp.shape)
            return KVCache(k, v)

        # The quantizer operated on *transformed* tensors whose channel dim
        # may have been padded (hadamard); recover that shape.
        k_shape = self._transformed_shape(comp.shape, comp.k_ctx)
        v_shape = self._transformed_shape(comp.shape, comp.v_ctx)
        k_q = _decode_quantized(comp.k_buckets, k_shape, cfg.codec)
        v_q = _decode_quantized(comp.v_buckets, v_shape, cfg.codec)
        k_t = k_q.dequantize()
        v_t = v_q.dequantize()
        k = invert_transform(k_t, comp.k_ctx)
        v = invert_transform(v_t, comp.v_ctx)
        return KVCache(k, v)

    @staticmethod
    def _transformed_shape(shape, ctx) -> Tuple[int, int, int, int]:
        if ctx.get("kind") == "hadamard":
            return shape[:3] + (ctx["pad_dim"],)
        return tuple(shape)

    # ------------------------------------------------------------------
    def roundtrip(self, kv: KVCache) -> Tuple[KVCache, CompressedKV, float, float]:
        """(restored, compressed, enc_seconds, dec_seconds)."""
        t0 = time.perf_counter()
        comp = self.compress(kv)
        t1 = time.perf_counter()
        restored = self.decompress(comp)
        t2 = time.perf_counter()
        return restored, comp, t1 - t0, t2 - t1
