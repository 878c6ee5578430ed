"""Plain PyTorch versions of every Hopper kernel (the correctness ground truth).

Each ``X_ref`` computes what the CUDA kernel behind ``ops.X_op`` computes,
with the same cast points, in eager PyTorch.  The wrappers take these on a
CPU tensor; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each kernel against its ``X_ref`` on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


# ---------------------------------------------------------------------------
# Group quantization (symmetric, per-group along the last axis)
# ---------------------------------------------------------------------------
def quantize_ref(x: torch.Tensor, bits: int, group: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (codes int8 (..., D), scales f32 (..., D/group))."""
    d = x.shape[-1]
    assert d % group == 0
    qmax = (1 << (bits - 1)) - 1
    xg = x.reshape(x.shape[:-1] + (d // group, group)).float()
    amax = xg.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA divide by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE divide of the host quantizer
    scale = torch.clamp(amax / torch.full((), qmax, dtype=amax.dtype,
                                          device=amax.device), min=1e-8)
    q = torch.clamp(torch.round(xg / scale[..., None]), -qmax - 1, qmax)
    return q.reshape(x.shape).to(torch.int8), scale


def dequantize_ref(codes: torch.Tensor, scale: torch.Tensor, group: int,
                   dtype=torch.float32) -> torch.Tensor:
    d = codes.shape[-1]
    qg = codes.reshape(codes.shape[:-1] + (d // group, group)).float()
    x = qg * scale[..., None].float()
    return x.reshape(codes.shape).to(dtype)


def pack_int4_ref(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8,7] -> packed uint8 (last dim halved), low nibble
    first."""
    u = (codes.to(torch.int32) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,)).to(
        torch.int8)


def quant_pack_ref(x: torch.Tensor, bits: int, group: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ops.quant_pack_op: group-quantize, then pack to
    nibbles when bits == 4 (int8 codes pass through)."""
    codes, scale = quantize_ref(x, bits, group)
    if bits == 4:
        codes = pack_int4_ref(codes)
    return codes, scale


def dequant_unpack_ref(codes: torch.Tensor, scale: torch.Tensor, bits: int,
                       group: int, dtype=torch.float32) -> torch.Tensor:
    """Plain version of ops.dequant_unpack_op: unpack nibbles when
    bits == 4, then dequantize."""
    if bits == 4:
        codes = unpack_int4_ref(codes)
    return dequantize_ref(codes, scale, group, dtype=dtype)


# ---------------------------------------------------------------------------
# Paged quantized decode attention, Pallas interface
# ---------------------------------------------------------------------------
def _gather_pages(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, PS, X) pool + (B, PPS) table -> (B, Hkv, PPS*PS, X)."""
    g = pool[bt.long()]                       # (B, PPS, Hkv, PS, X)
    g = g.movedim(2, 1)                       # (B, Hkv, PPS, PS, X)
    return g.reshape(g.shape[0], g.shape[1], -1, g.shape[-1])


def paged_attention_ref(
    q: torch.Tensor,             # (B, Hkv, Gq, D)
    k_codes: torch.Tensor,       # (P, Hkv, PS, D) int8 or (P, Hkv, PS, D/2) u8
    k_scale: torch.Tensor,       # (P, Hkv, PS, D/group) f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, PPS) int32 page ids; 0 = unmapped
    kv_lens: torch.Tensor,       # (B,) int32 valid lengths, each >= 1
    bits: int,
    group: int,
) -> torch.Tensor:
    """Plain version of ops.paged_attention_op: gather each slot's pages
    into a contiguous view, dequantize in f32, and take masked softmax
    attention of the one query per slot; normalized, in q's dtype."""
    d = q.shape[-1]
    k = dequant_unpack_ref(_gather_pages(k_codes, block_tables),
                           _gather_pages(k_scale, block_tables), bits, group)
    v = dequant_unpack_ref(_gather_pages(v_codes, block_tables),
                           _gather_pages(v_scale, block_tables), bits, group)
    s = k.shape[2]
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k) / math.sqrt(d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_lens.to(q.device).long()[:, None])        # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", probs, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged decode attention over the serving arena's layout
# ---------------------------------------------------------------------------
# The arena entry's sums are taken in the CUDA kernel's order, so that the
# kernel and this version round alike: one block of _THREADS threads per
# (slot, KV head), warps of 32 lanes.
_THREADS = 128


def _strided_sums(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., N) -> (..., width): entry i adds x[i], x[i + width], ... in
    turn (one thread's strided loop); zero padding adds nothing."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, -(-n // width) * width - n))
    x = x.reshape(x.shape[:-1] + (-1, width))
    acc = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    return acc


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """(..., 32) -> (...,): a warp's xor-shuffle sum (16, 8, 4, 2, 1)."""
    idx = torch.arange(32, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ off]
    return acc[..., 0]


def _warp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) of bf16-valued f32 operands as one warp takes it:
    lane l adds the products at l, l + 32, ... then the lanes butterfly.
    The products are exact in f32, so the order fixes every rounding."""
    return _butterfly(_strided_sums(a * b, 32))


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x, -1) as the kernel's block takes it: each thread a strided
    sum, each warp a butterfly, then the warps in order."""
    parts = _strided_sums(x, _THREADS)
    warps = _butterfly(parts.reshape(parts.shape[:-1] + (-1, 32)))
    total = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        total = total + warps[..., w]
    return total


def paged_attention_arena_ref(
    q: torch.Tensor,          # (B, Hkv, Gq, D) bf16
    k_pool: torch.Tensor,     # (P, PS, Hkv, D) bf16 fp pool
    v_pool: torch.Tensor,
    k_codes: torch.Tensor,    # (P, PS, Hkv, D) int8 quant pool
    k_scale: torch.Tensor,    # (P, PS, Hkv, D) f32 per-channel scales
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, PPS) int32
    kv_lens: torch.Tensor,       # (B,) int32: positions < kv_lens are seen
    quant_lens: torch.Tensor,    # (B,) int32: positions < quant_lens read
                                 # the quant pool, the rest the fp pool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ops.paged_attention_arena_op: the serving decode
    step's read of the paged arena.  Quant-resident positions dequantize
    in f32 and round to bf16; scores are bf16 dots (f32 sums, in the
    kernel's order, rounded to bf16) scaled in f32, masked with
    finfo(f32).min; p rounds to bf16 for the sum over positions (in the
    kernel's order).  Returns the UNNORMALIZED bf16 ``out`` (B, Hkv, Gq,
    D) with f32 row max ``m`` and denominator ``l`` (B, Hkv, Gq), exactly
    as the JAX package's ``multihead_attention(return_stats=True)`` over
    ``_blend_quant``'s view."""
    b, hkv, gq, d = q.shape
    bt = block_tables.long()

    def view(pool):  # (P, PS, H, X) -> (B, S, H, X)
        g = pool[bt]
        return g.reshape(g.shape[0], -1, *g.shape[3:])

    s = bt.shape[1] * k_pool.shape[1]
    use_q = (torch.arange(s, device=q.device)[None, :]
             < quant_lens.to(q.device).long()[:, None])[:, :, None, None]
    kq = (view(k_codes).float() * view(k_scale)).to(torch.bfloat16)
    vq = (view(v_codes).float() * view(v_scale)).to(torch.bfloat16)
    k = torch.where(use_q, kq, view(k_pool))
    v = torch.where(use_q, vq, view(v_pool))
    scores = _warp_dot(q.float()[:, :, :, None, :],
                       k.float().permute(0, 2, 1, 3)[:, :, None])
    scores = scores.to(torch.bfloat16).float() * (1.0 / math.sqrt(d))
    seen = (torch.arange(s, device=q.device)[None, :]
            < kv_lens.to(q.device).long()[:, None])[:, None, None, :]
    scores = torch.where(seen, scores, torch.finfo(torch.float32).min)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = _block_sum(p)
    # p (rounded to bf16) times v, summed over positions in order, as the
    # kernel's one-thread-per-channel loop does (the products are exact)
    pb = p.to(torch.bfloat16).float()
    vt = v.float().permute(0, 2, 1, 3)                 # (B, Hkv, S, D)
    out = torch.zeros((b, hkv, gq, d), device=q.device)
    for t in range(s):
        out = out + pb[..., t, None] * vt[:, :, None, t]
    return out.to(torch.bfloat16), m, l
