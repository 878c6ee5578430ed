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
decompresses such payloads with ``dequant_unpack``.  Under
``transform="hadamard"`` the transform stage runs on the device too (the
Hopper ``hadamard`` kernel, one in-order FMA chain per output, which is
numpy's ``x @ h`` bit for bit): a ``device_quantizable`` strategy feeds the
rotated tensor straight to ``quant_pack``, any other pulls it to the host
for the numpy quantizer; a pipeline given a ``device`` inverts it there.
The identity profile's codec runs on the device too: device KV is cast
to fp16 there and copied once to the host (through pinned memory on
CUDA), and a pipeline given a ``device`` copies the fp16 payload back
once and widens it there.  The wire form is the host path's byte for
byte; every other strategy takes the numpy stages.

The two parts of a cache (:class:`KVCache` ``k`` and ``v``) go through
every stage part by part, each at its own width: K under ``key_bits`` and
V under ``value_bits``, or for multi-head latent attention the latent
(``k``) under ``key_bits`` and the rope key (``v``) under ``value_bits``.
A per-token group wider than a part quantizes it as one group a token
(the host quantizer pads the group with the part's last channel, which
moves no group max): the group clamped to the part's width.  The device
stages take a strategy only where its group tiles both parts, so the
latent layout's 128-channel groups (rope key 64 wide) take the host path.
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
from repro_torch.core.transforms import (
    _next_pow2,
    apply_transform,
    invert_transform,
    transform_meta_bytes,
)
from repro_torch.core.strategy import device_quantizable, paged_eligible
from repro_torch.utils.timing import count_bytes, span

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
    v_shape: Optional[Tuple[int, int, int, int]] = None  # None: ``shape``

    @property
    def v_dims(self) -> Tuple[int, int, int, int]:
        """The second part's shape (MLA's rope key is narrower)."""
        return tuple(self.shape if self.v_shape is None else self.v_shape)

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
        return (int(np.prod(self.shape))
                + int(np.prod(self.v_dims))) * SOURCE_BYTES

    def compression_ratio(self) -> float:
        return self.original_bytes() / max(self.total_bytes(), 1)


class DeviceKVCache(KVCache):
    """:class:`KVCache` whose ``k``/``v`` are (L, H, S, D) torch tensors —
    the KV a prefill left on the device, bf16 or f32."""

    @classmethod
    def from_host(cls, kv: KVCache, device) -> "DeviceKVCache":
        """A host :class:`KVCache`'s arrays as tensors on ``device``."""
        return cls(torch.from_numpy(np.ascontiguousarray(kv.k)).to(device),
                   torch.from_numpy(np.ascontiguousarray(kv.v)).to(device))

    def nbytes_wire(self) -> int:
        return int(self.k.numel() + self.v.numel()) * SOURCE_BYTES

    def to_host(self) -> KVCache:
        with span("to_host"):
            k, v = self.k.float(), self.v.float()
            count_bytes("to_host_bytes", k, v)
            return KVCache(k.cpu().numpy(), v.cpu().numpy())


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for off
    CUDA), so that a host clock read after it times the work."""
    device = torch.device(device)
    if device.type == "cuda":
        # lint: sync-ok(stage timers read the wall clock once the device is idle - prefill EWMA, one-shot engine, fused landing)
        torch.cuda.synchronize(device)


def _clock(devices) -> float:
    """``time.perf_counter()`` read once the work queued on each of
    ``devices`` has finished."""
    for d in devices:
        _sync(d)
    return time.perf_counter()


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
    u, scales = u.reshape(L * H, S, D), scales.to(torch.float16)
    with span("to_host"):
        count_bytes("to_host_bytes", u, scales)
        # lint: sync-ok(compress stage - the host codec entropy-codes the device-quantized codes and scales, once per cold request)
        u = u.cpu().numpy()
        # lint: sync-ok(compress stage - the scales follow the codes, once per cold request)
        scale = scales.cpu().numpy().reshape(L * H, S, D // group, 1)
    with span("encode"):
        payload = codecs.encode_codes(u, bits, codec)
    return _BucketWire(
        payload=payload, bits=bits,
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
    with span("unpack"):
        u = torch.from_numpy(codecs.decode_codes(w.payload, w.bits, count,
                                                 codec))
    scales = torch.from_numpy(w.scale.reshape(-1, D // w.group_size))
    with span("to_device"):
        count_bytes("to_device_bytes", u, scales)
        # lint: sync-ok(decompress stage - the host codec's decoded codes and scales go to the device once per landed request)
        u = u.to(device).reshape(-1, D)
        # lint: sync-ok(decompress stage - the scales follow the codes, once per landed request)
        scales = scales.to(device).float()
    if w.bits == 4:
        codes = u[:, 0::2] | (u[:, 1::2] << 4)
    else:
        codes = (u.to(torch.int16) - (1 << (w.bits - 1))).to(torch.int8)
    x = dequant_unpack_op(codes.contiguous(), scales, bits=w.bits,
                          group=w.group_size, out_dtype=torch.float32)
    return x.reshape(L, H, S, D)


def _rotate(x: torch.Tensor, pad_dim: int) -> torch.Tensor:
    """The Hadamard stage on x's device: (..., D) -> (..., pad_dim) f32,
    the channel axis zero-padded to ``pad_dim`` as ``hadamard_forward``
    pads it, through the hadamard kernel.  H is symmetric, so the same
    call inverts it."""
    from repro_torch.kernels import hadamard_op

    d = x.shape[-1]
    flat = x.reshape(-1, d)
    if pad_dim != d:
        flat = torch.nn.functional.pad(flat, (0, pad_dim - d))
    return hadamard_op(flat.contiguous(), out_dtype=torch.float32).reshape(
        x.shape[:-1] + (pad_dim,))


def _staging(nbytes: int, device) -> torch.Tensor:
    """``nbytes`` of host memory for one copy of the identity codec,
    pinned when ``device`` is CUDA.  Pinned blocks come from PyTorch's
    caching host allocator, which hands a freed block to the next request
    of its size (rounded up to a power of two): past the first request
    of a size no request pins memory.  Each direction copies out of the block before
    it returns, so no payload aliases it."""
    pin = torch.device(device).type == "cuda"
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)


def _identity_payload(kv: "DeviceKVCache") -> bytes:
    """The identity profile's payload of device KV: K then V, each in its
    own shape's order, cast to fp16 on their device (round to nearest
    even, as numpy's ``astype``), copied once to the host, then into
    bytes of the payload's own."""
    k, v = kv.k.reshape(-1), kv.v.reshape(-1)
    n = k.numel()
    with span("to_host"):
        flat = torch.empty(n + v.numel(), dtype=torch.float16,
                           device=k.device)
        flat[:n].copy_(k)
        flat[n:].copy_(v)
        count_bytes("to_host_bytes", flat)
        host = _staging(2 * flat.numel(), k.device).view(torch.float16)
        host.copy_(flat)        # waits for the copy: one a cold request
    with span("encode"):
        return host.numpy().tobytes()


def _identity_restore(comp: "CompressedKV", device) -> "DeviceKVCache":
    """Inverse of :func:`_identity_payload`: the fp16 payload copied into
    staging memory, then once to ``device``, widened to f32 there."""
    n, nv = int(np.prod(comp.shape)), int(np.prod(comp.v_dims))
    with span("unpack"):
        host = _staging(2 * (n + nv), device)
        host.numpy()[:] = np.frombuffer(comp.identity_payload, np.uint8,
                                        count=host.numel())
        host = host.view(torch.float16)
    with span("to_device"):
        count_bytes("to_device_bytes", host)
        # lint: sync-ok(identity decompress - one fp16 copy of the payload from pinned memory a landed request)
        flat = host.to(device)
    flat = flat.float()
    return DeviceKVCache(flat[:n].reshape(comp.shape),
                         flat[n:].reshape(comp.v_dims))


def _v_shape(shape, v_shape) -> Optional[Tuple[int, int, int, int]]:
    """``CompressedKV.v_shape``: None where both parts have one shape, so
    an MHA payload is what it was before parts could differ."""
    return None if tuple(v_shape) == tuple(shape) else tuple(v_shape)


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

    def _on_device(self, widths) -> bool:
        """Whether the device stages take the strategy at every part's
        width."""
        return all(paged_eligible(self.strategy, head_dim=d) for d in widths)

    def _needs_scores(self) -> bool:
        """Whether the quantizer takes head scores from the K itself."""
        return (self.head_scores is None
                and self.strategy.quantizer in ("mixhq", "duo"))

    def _quantize(self, k_t, v_t, k_ctx, v_ctx, shape, v_shape,
                  scores_of) -> CompressedKV:
        """Stages Q and C of transformed host arrays (``scores_of()``
        gives the K the default head scores are taken from)."""
        cfg = self.strategy
        scores = self.head_scores
        if self._needs_scores():
            scores = head_importance_scores(scores_of())
        k_q = quantize_tensor(k_t, cfg, is_key=True, head_scores=scores)
        v_q = quantize_tensor(v_t, cfg, is_key=False, head_scores=scores)
        return CompressedKV(
            strategy=cfg, shape=shape,
            k_buckets=_encode_quantized(k_q, cfg.codec),
            v_buckets=_encode_quantized(v_q, cfg.codec),
            k_ctx=k_ctx, v_ctx=v_ctx, v_shape=_v_shape(shape, v_shape),
        )

    def _compress_rotated(self, kv: "DeviceKVCache") -> CompressedKV:
        """The Hadamard stage on the device, then ``quant_pack`` for a
        device-quantizable strategy or the numpy quantizer otherwise."""
        cfg = self.strategy
        k_ctx, v_ctx = ({"orig_dim": d, "pad_dim": _next_pow2(d),
                         "kind": "hadamard"}
                        for d in (kv.head_dim, kv.v_head_dim))
        k_t = _rotate(kv.k, k_ctx["pad_dim"])
        v_t = _rotate(kv.v, v_ctx["pad_dim"])
        if all(device_quantizable(cfg, head_dim=c["pad_dim"])
               for c in (k_ctx, v_ctx)):
            return CompressedKV(
                strategy=cfg, shape=tuple(kv.shape),
                k_buckets=[_device_quantize(k_t, cfg.key_bits,
                                            cfg.group_size, cfg.codec)],
                v_buckets=[_device_quantize(v_t, cfg.value_bits,
                                            cfg.group_size, cfg.codec)],
                k_ctx=k_ctx, v_ctx=v_ctx,
                v_shape=_v_shape(kv.shape, kv.v_shape))
        # The default head scores read the unrotated K: pulled beside the
        # rotated tensors when the quantizer asks for them.
        k = kv.k.float() if self._needs_scores() else None
        with span("to_host"):
            count_bytes("to_host_bytes", k_t, v_t)
            if k is not None:
                count_bytes("to_host_bytes", k)
            # lint: sync-ok(host-quantizer compress path for profiles the device quantizer does not take, once per cold request)
            k_h, v_h = k_t.cpu().numpy(), v_t.cpu().numpy()
            k = None if k is None else k.cpu().numpy()
        with span("encode"):
            return self._quantize(k_h, v_h, k_ctx, v_ctx, tuple(kv.shape),
                                  kv.v_shape, lambda: k)

    # ------------------------------------------------------------------
    def compress(self, kv: KVCache) -> CompressedKV:
        cfg = self.strategy
        if isinstance(kv, DeviceKVCache):
            if self._on_device((kv.head_dim, kv.v_head_dim)):
                return CompressedKV(
                    strategy=cfg, shape=tuple(kv.shape),
                    k_buckets=[_device_quantize(kv.k, cfg.key_bits,
                                                cfg.group_size, cfg.codec)],
                    v_buckets=[_device_quantize(kv.v, cfg.value_bits,
                                                cfg.group_size, cfg.codec)],
                    k_ctx={"kind": "none"}, v_ctx={"kind": "none"},
                    v_shape=_v_shape(kv.shape, kv.v_shape))
            if is_identity(cfg):
                return CompressedKV(cfg, tuple(kv.shape), [], [],
                                    {"kind": "none"}, {"kind": "none"},
                                    identity_payload=_identity_payload(kv),
                                    v_shape=_v_shape(kv.shape, kv.v_shape))
            if cfg.transform == "hadamard":
                return self._compress_rotated(kv)
            kv = kv.to_host()
        with span("encode"):
            if is_identity(cfg):
                payload = np.concatenate(
                    [kv.k.ravel(), kv.v.ravel()]
                ).astype(np.float16).tobytes()
                return CompressedKV(cfg, kv.shape, [], [], {"kind": "none"},
                                    {"kind": "none"}, identity_payload=payload,
                                    v_shape=_v_shape(kv.shape, kv.v_shape))

            k_t, k_ctx = apply_transform(cfg.transform, kv.k, cfg.delta_group)
            v_t, v_ctx = apply_transform(cfg.transform, kv.v, cfg.delta_group)
            return self._quantize(k_t, v_t, k_ctx, v_ctx, kv.shape,
                                  kv.v_shape, lambda: kv.k)

    # ------------------------------------------------------------------
    def decompress(self, comp: CompressedKV) -> KVCache:
        cfg = comp.strategy
        v_dims = comp.v_dims
        if self.device is not None:
            if comp.identity_payload is not None:
                return _identity_restore(comp, self.device)
            if self._on_device((comp.shape[3], v_dims[3])):
                return DeviceKVCache(
                    _device_dequantize(comp.k_buckets[0], comp.shape,
                                       cfg.codec, self.device),
                    _device_dequantize(comp.v_buckets[0], v_dims,
                                       cfg.codec, self.device))
            if comp.k_ctx.get("kind") == "hadamard":
                return DeviceKVCache(
                    self._restore_rotated(cfg, comp.k_buckets, comp.shape,
                                          comp.k_ctx),
                    self._restore_rotated(cfg, comp.v_buckets, v_dims,
                                          comp.v_ctx))
        with span("unpack"):
            if comp.identity_payload is not None:
                n, nv = int(np.prod(comp.shape)), int(np.prod(v_dims))
                flat = np.frombuffer(comp.identity_payload, dtype=np.float16,
                                     count=n + nv).astype(np.float32)
                k = flat[:n].reshape(comp.shape)
                v = flat[n:].reshape(v_dims)
                return KVCache(k, v)

            # The quantizer operated on *transformed* tensors whose channel
            # dim may have been padded (hadamard); recover that shape.
            k_shape = self._transformed_shape(comp.shape, comp.k_ctx)
            v_shape = self._transformed_shape(v_dims, comp.v_ctx)
            k_q = _decode_quantized(comp.k_buckets, k_shape, cfg.codec)
            v_q = _decode_quantized(comp.v_buckets, v_shape, cfg.codec)
            k_t = k_q.dequantize()
            v_t = v_q.dequantize()
            k = invert_transform(k_t, comp.k_ctx)
            v = invert_transform(v_t, comp.v_ctx)
            return KVCache(k, v)

    def _restore_rotated(self, cfg: StrategyConfig,
                         wires: List[_BucketWire], shape,
                         ctx: Dict[str, Any]) -> torch.Tensor:
        """Dequantize one rotated tensor (``dequant_unpack`` for a
        device-quantizable payload, else the numpy quantizer, moved to
        the device), invert the Hadamard stage on the device and slice
        back to ``orig_dim``."""
        t_shape = self._transformed_shape(shape, ctx)
        if device_quantizable(cfg, head_dim=ctx["pad_dim"]):
            y = _device_dequantize(wires[0], t_shape, cfg.codec, self.device)
        else:
            with span("unpack"):
                y = torch.from_numpy(_decode_quantized(
                    wires, t_shape, cfg.codec).dequantize())
            with span("to_device"):
                count_bytes("to_device_bytes", y)
                # lint: sync-ok(host-dequantizer decompress path, once per landed request)
                y = y.to(self.device)
        return _rotate(y, ctx["pad_dim"])[..., :ctx["orig_dim"]]

    @staticmethod
    def _transformed_shape(shape, ctx) -> Tuple[int, int, int, int]:
        if ctx.get("kind") == "hadamard":
            return shape[:3] + (ctx["pad_dim"],)
        return tuple(shape)

    # ------------------------------------------------------------------
    def roundtrip(self, kv: KVCache) -> Tuple[KVCache, CompressedKV, float, float]:
        """(restored, compressed, enc_seconds, dec_seconds).  The clock
        is read after the queued work of the input's device and of the
        pipeline's ``device`` has finished."""
        devices = ([kv.k.device] if isinstance(kv, DeviceKVCache) else []) \
            + ([self.device] if self.device is not None else [])
        t0 = _clock(devices)
        comp = self.compress(kv)
        t1 = _clock(devices)
        restored = self.decompress(comp)
        t2 = _clock(devices)
        return restored, comp, t1 - t0, t2 - t1
