"""Plain PyTorch versions of every Hopper kernel (the correctness ground truth).

Each ``X_ref`` computes what the CUDA kernel behind ``ops.X_op`` computes,
with the same cast points, in eager PyTorch.  The wrappers take these on a
CPU tensor; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each kernel against its ``X_ref`` on the card.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.transforms import hadamard_matrix


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
# Hadamard transform
# ---------------------------------------------------------------------------
_HADAMARD: Dict[Tuple[int, str], torch.Tensor] = {}


def hadamard_table(d: int, device) -> torch.Tensor:
    """The host pipeline's f32 (d, d) Hadamard table
    (``transforms.hadamard_matrix``) on ``device``, cached."""
    key = (d, str(device))
    h = _HADAMARD.get(key)
    if h is None:
        # lint: sync-ok(plain version's table, built once per size and device and cached)
        h = torch.from_numpy(hadamard_matrix(d)).to(device)
        _HADAMARD[key] = h
    return h


@functools.lru_cache(maxsize=None)
def hadamard_entry(d: int) -> float:
    """The magnitude c of every entry of the host's f32 (d, d) Hadamard
    table: entry (k, j) is c times (-1) ** popcount(k & j)."""
    return float(hadamard_matrix(d)[0, 0])


def hadamard_ref(x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ops.hadamard_op: x (T, D) @ H_D in f32, cast to
    ``out_dtype`` (default x's dtype)."""
    h = hadamard_table(x.shape[-1], x.device)
    return (x.float() @ h).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Quantized flash-decode attention (dense KV)
# ---------------------------------------------------------------------------
def decode_attention_ref(
    q: torch.Tensor,         # (B, Hkv, Gq, D) f32/bf16
    k_codes: torch.Tensor,   # (B, Hkv, S, D) int8
    k_scale: torch.Tensor,   # (B, Hkv, S, D/group) f32
    v_codes: torch.Tensor,   # (B, Hkv, S, D) int8
    v_scale: torch.Tensor,   # (B, Hkv, S, D/group) f32
    group: int,
    kv_len=None,             # None | int | (B,) per-slot valid lengths
) -> torch.Tensor:
    """Plain version of ops.decode_attention_op (on unpacked int8 codes):
    dequantize in f32, take the f32 scores over sqrt(D), mask positions at
    or beyond ``kv_len``, softmax, and the f32 sum of p * v, cast to q's
    dtype.  A (B,) ``kv_len`` masks each batch row at its own length."""
    d = q.shape[-1]
    s = k_codes.shape[2]
    k = dequantize_ref(k_codes, k_scale, group)        # (B, Hkv, S, D)
    v = dequantize_ref(v_codes, v_scale, group)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k) / math.sqrt(d)
    if kv_len is not None:
        lens = torch.atleast_1d(torch.as_tensor(kv_len, device=q.device))
        mask = (torch.arange(s, device=q.device)[None, :]
                < lens.long()[:, None])                 # (B|1, S)
        scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", probs, v).to(q.dtype)


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
    into a contiguous view, unpack, and take the dense decode attention
    (:func:`decode_attention_ref`) masked at each slot's length."""
    kc, vc = (_gather_pages(c, block_tables) for c in (k_codes, v_codes))
    if bits == 4:
        kc, vc = unpack_int4_ref(kc), unpack_int4_ref(vc)
    return decode_attention_ref(q, kc, _gather_pages(k_scale, block_tables),
                                vc, _gather_pages(v_scale, block_tables),
                                group, kv_len=kv_lens)


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


def _arena_kv(k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
              block_tables, quant_lens):
    """Each slot's (B, S, Hkv, D) bf16 K and V views of the arena:
    quant-resident positions (below quant_lens) dequantize in f32 and
    round to bf16, the rest read the fp pool."""
    bt = block_tables.long()

    def view(pool):  # (P, PS, H, X) -> (B, S, H, X)
        g = pool[bt]
        return g.reshape(g.shape[0], -1, *g.shape[3:])

    s = bt.shape[1] * k_pool.shape[1]
    use_q = (torch.arange(s, device=bt.device)[None, :]
             < quant_lens.to(bt.device).long()[:, None])[:, :, None, None]
    kq = (view(k_codes).float() * view(k_scale)).to(torch.bfloat16)
    vq = (view(v_codes).float() * view(v_scale)).to(torch.bfloat16)
    return (torch.where(use_q, kq, view(k_pool)),
            torch.where(use_q, vq, view(v_pool)))


def _capped(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    """Gemma-2's attention softcap, tanh(s / cap) * cap, with the IEEE
    divide: the divisor is a tensor, because PyTorch's CUDA divide by a
    Python scalar multiplies by its reciprocal."""
    if not softcap:
        return scores
    cap = torch.full((), softcap, dtype=scores.dtype, device=scores.device)
    return torch.tanh(scores / cap) * softcap


def _arena_seen(kv_lens: torch.Tensor, s: int, w: int, window: int,
                device) -> torch.Tensor:
    """(B, 1 or W, S): the positions query token j of slot b sees over the
    arena, p < kv_lens[b] and, under a sliding window, p > kv_lens[b] + j
    - window (the JAX package's attention_scores_mask at the token's
    position kv_lens[b] + j)."""
    pos = torch.arange(s, device=device)
    lens = kv_lens.to(device).long()[:, None, None]
    seen = pos < lens
    if window > 0:
        j = torch.arange(w, device=device)[None, :, None]
        seen = seen & (pos > lens + j - window)
    return seen


def _empty_rows(out, m, l, seen):
    """The arena entries' convention for a row that sees no position (a
    never-used slot at kv_len 0, or a window that ends before the
    prefix): m = -inf, l = 0, out = 0, as the kernels leave it.  Every
    other row keeps its bits; the caller's merge gives exp(m - m_new) = 0
    for such a row either way."""
    empty = ~seen.any(-1)
    return (out.masked_fill(empty[..., None], 0),
            m.masked_fill(empty, -math.inf), l.masked_fill(empty, 0.0))


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
    window: int = 0,             # > 0: only positions > kv_lens - window
    softcap: float = 0.0,        # > 0: scores tanh(s / cap) * cap
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ops.paged_attention_arena_op: the serving decode
    step's read of the paged arena.  Quant-resident positions dequantize
    in f32 and round to bf16; scores are bf16 dots (f32 sums, in the
    kernel's order, rounded to bf16) scaled in f32, then capped
    (``softcap``), then masked with finfo(f32).min (positions >= kv_lens
    and, with ``window``, <= kv_lens - window); p rounds to bf16 for the
    sum over positions (in the kernel's order).  Returns the UNNORMALIZED
    bf16 ``out`` (B, Hkv, Gq, D) with f32 row max ``m`` and denominator
    ``l`` (B, Hkv, Gq), exactly as the JAX package's
    ``multihead_attention(return_stats=True)`` over ``_blend_quant``'s
    view, except that a row that sees no position gives m = -inf, l = 0
    and out = 0 (the JAX mask averages the whole view there; the step's
    merge discards either)."""
    b, hkv, gq, d = q.shape
    k, v = _arena_kv(k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
                     block_tables, quant_lens)
    s = k.shape[1]
    scores = _warp_dot(q.float()[:, :, :, None, :],
                       k.float().permute(0, 2, 1, 3)[:, :, None])
    scores = _capped(scores.to(torch.bfloat16).float() * (1.0 / math.sqrt(d)),
                     softcap)
    seen = _arena_seen(kv_lens, s, 1, window, q.device)[:, None]
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
    return _empty_rows(out.to(torch.bfloat16), m, l, seen)


# ---------------------------------------------------------------------------
# Paged multi-token verify attention, Pallas interface
# ---------------------------------------------------------------------------
def paged_verify_attention_ref(
    q: torch.Tensor,             # (B, Hkv, W, Gq, D)
    k_codes: torch.Tensor,       # (P, Hkv, PS, D) int8 or (P, Hkv, PS, D/2) u8
    k_scale: torch.Tensor,       # (P, Hkv, PS, D/group) f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, PPS) int32 page ids; 0 = unmapped
    kv_lens: torch.Tensor,       # (B,) int32; query 0's visible length
    bits: int,
    group: int,
) -> torch.Tensor:
    """Plain version of ops.paged_verify_attention_op: the speculative
    verify step's attention of W consecutive queries per slot.  Query
    ``j`` of slot ``b`` attends cache positions ``< kv_lens[b] + j`` (the
    staircase: each new token's own scattered row included, its
    successors excluded); f32 math, normalized, in q's dtype."""
    d = q.shape[-1]
    w = q.shape[2]
    k = dequant_unpack_ref(_gather_pages(k_codes, block_tables),
                           _gather_pages(k_scale, block_tables), bits, group)
    v = dequant_unpack_ref(_gather_pages(v_codes, block_tables),
                           _gather_pages(v_scale, block_tables), bits, group)
    s = k.shape[2]
    scores = torch.einsum("bhwgd,bhsd->bhwgs", q.float(), k) / math.sqrt(d)
    limit = (kv_lens.to(q.device).long()[:, None]
             + torch.arange(w, device=q.device)[None, :])      # (B, W)
    mask = (torch.arange(s, device=q.device)[None, None, :]
            < limit[..., None])                                # (B, W, S)
    scores = scores.masked_fill(~mask[:, None, :, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhwgs,bhsd->bhwgd", probs, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged multi-token verify attention over the serving arena's layout
# ---------------------------------------------------------------------------
def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) as one thread takes it: in order over the last axis,
    from zero (the products of bf16-valued operands are exact in f32)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      device=a.device)
    for i in range(a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def paged_verify_attention_arena_ref(
    q: torch.Tensor,          # (B, Hkv, Gq, W, D) bf16
    k_pool: torch.Tensor,     # (P, PS, Hkv, D) bf16 fp pool
    v_pool: torch.Tensor,
    k_codes: torch.Tensor,    # (P, PS, Hkv, D) int8 quant pool
    k_scale: torch.Tensor,    # (P, PS, Hkv, D) f32 per-channel scales
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, PPS) int32
    kv_lens: torch.Tensor,       # (B,) int32: every row sees positions
                                 # < kv_lens (the committed prefix)
    quant_lens: torch.Tensor,    # (B,) int32: positions < quant_lens read
                                 # the quant pool, the rest the fp pool
    window: int = 0,             # > 0: token j sees p > kv_lens + j - window
    softcap: float = 0.0,        # > 0: scores tanh(s / cap) * cap
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ops.paged_verify_attention_arena_op: the
    speculative verify step's read of the committed prefix in the paged
    arena, for W * Gq query rows per KV head.  The rounding points are
    paged_attention_arena_ref's, the cap and the mask too, with each
    token's own window bound: token j sits at position kv_lens + j; a
    row whose window ends before the prefix sees nothing and gives m =
    -inf, l = 0, out = 0.  The sums run in the verify kernel's order:
    each score in order over D, each row's denominator as one warp takes
    it, each output in order over the positions.  Returns the
    UNNORMALIZED bf16 ``out`` (B, Hkv, Gq, W, D) with f32 ``m`` and ``l``
    (B, Hkv, Gq, W), which the caller merges with the W new tokens'
    intra-block attention in closed form."""
    b, hkv, gq, w, d = q.shape
    k, v = _arena_kv(k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
                     block_tables, quant_lens)
    s = k.shape[1]
    qr = q.float().reshape(b, hkv, gq * w, 1, d)
    scores = _seq_dot(qr, k.float().permute(0, 2, 1, 3)[:, :, None])
    scores = _capped(scores.to(torch.bfloat16).float() * (1.0 / math.sqrt(d)),
                     softcap)
    seen = _arena_seen(kv_lens, s, w, window, q.device)     # (B, 1|W, S)
    seen = seen[:, None, None].expand(b, 1, gq, w, s).reshape(b, 1, gq * w, s)
    scores = torch.where(seen, scores, torch.finfo(torch.float32).min)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = _butterfly(_strided_sums(p, 32))
    pb = p.to(torch.bfloat16).float()
    vt = v.float().permute(0, 2, 1, 3)                 # (B, Hkv, S, D)
    out = torch.zeros((b, hkv, gq * w, d), device=q.device)
    for t in range(s):
        out = out + pb[..., t, None] * vt[:, :, None, t]
    out, m, l = _empty_rows(out.to(torch.bfloat16), m, l, seen)
    return (out.reshape(b, hkv, gq, w, d), m.reshape(b, hkv, gq, w),
            l.reshape(b, hkv, gq, w))
