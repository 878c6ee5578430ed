"""Transformer layers in PyTorch: the JAX package's ``models/layers.py``.

RMSNorm and qk-norm, RoPE (plain or YaRN-scaled) and M-RoPE, GQA
attention (softcap, sliding window) with an online-softmax chunked path
and ``return_stats``, the attention sublayer's prefill, decode and
cross-attention paths (the decode reads the cache read-only and merges
the new token in closed form), the gated MLP, top-k MoE with capacity
in both of the JAX package's forms (GShard one-hot dispatch and sorted
scatter), and token embedding / unembedding with the final softcap.
Compute dtype is bf16 with f32 softmax and normalisation, and every cast
point is the JAX package's: greedy argmax flips on 1-ulp differences.

The decode path reads either a dense cache ``{"k", "v"}`` (B, Smax, Hkv, D)
or one layer of the paged arena (:class:`PagedKV`), which goes through the
Hopper ``paged_attention_arena`` kernel for one token per slot and the
``paged_verify_attention_arena`` kernel for the speculative verify step's
several.  No ``scaled_dot_product_attention``
anywhere: prefill attention and the projections are plain einsums.

Multi-head latent attention (deepseek-v2, :func:`apply_mla`) has no JAX
counterpart: its prefill attends in the expanded form, its decode in the
absorbed form over the cached latent and rope key (the paged arena through
the Hopper ``paged_mla_attention`` kernel).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, is_mla, norm_topk_prob
from repro_torch.kernels import (
    paged_attention_arena_op,
    paged_mla_attention_op,
    paged_verify_attention_arena_op,
)
from repro_torch.utils import dtensor_step
from repro_torch.utils.shard_hint import shard_hint

COMPUTE_DTYPE = torch.bfloat16
ATTN_CHUNK = 1024  # KV chunk for the online-softmax path


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def rmsnorm_headdim(scale: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: rmsnorm over the head_dim axis of (B, S, H, D)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def yarn_get_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor (the published DeepSeek-V2 code)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(cfg: ModelConfig, dim: int,
                     device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): each frequency slot i blends the
    interpolated ``theta^(-i/(dim/2)) / factor`` and the original by a
    linear ramp between the correction dims of ``beta_fast`` and
    ``beta_slow`` rotations over the original context.  Computed in f64 and
    rounded to f32, on ``device`` (no host copy: the decode step is
    captured in a CUDA graph)."""
    base, factor = cfg.rope_theta, cfg.yarn_factor
    orig = cfg.yarn_original_max_position

    def corr_dim(rot: float) -> float:
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(corr_dim(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    extra = 1.0 / base ** (2 * i / dim)
    return (extra / factor * ramp + extra * (1 - ramp)).float()


def rope_inv_freq(cfg: ModelConfig, dim: int, device=None) -> torch.Tensor:
    """The inverse frequencies of a ``dim``-wide rotation under ``cfg``:
    YaRN's where the config scales RoPE, else plain."""
    if cfg.yarn_factor > 1:
        return yarn_frequencies(cfg, dim, device)
    return rope_frequencies(dim, cfg.rope_theta, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               inv_freq: Optional[torch.Tensor] = None,
               mscale: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32.  ``inv_freq`` overrides
    ``theta``'s frequencies (YaRN), ``mscale`` multiplies cos and sin."""
    freqs = (rope_frequencies(x.shape[-1], theta, device=x.device)
             if inv_freq is None else inv_freq)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    # f32 cos/sin, correctly rounded (through f64; the table is tiny)
    cos = torch.cos(angles.double()).float()[:, :, None, :]
    sin = torch.sin(angles.double()).float()[:, :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return _rotate(x, cos, sin)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions3 (3, B, S); frequency slots split
    2:1:1 over the (temporal, height, width) position streams."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_frequencies(d, theta, device=x.device)
    t_sec = half // 2
    h_sec = (half - t_sec) // 2
    # which position stream each frequency slot reads (made on the
    # device: a copy from the host cannot enter a captured decode step)
    sec_of = torch.cat([
        torch.zeros(t_sec, dtype=torch.long, device=x.device),
        torch.ones(h_sec, dtype=torch.long, device=x.device),
        torch.full((half - t_sec - h_sec,), 2, dtype=torch.long,
                   device=x.device),
    ])
    pos = positions3.permute(1, 2, 0).float()              # (B, S, 3)
    angles = pos[..., sec_of] * freqs                      # (B, S, half)
    cos = torch.cos(angles.double()).float()[:, :, None, :]
    sin = torch.sin(angles.double()).float()[:, :, None, :]
    return _rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _mask_value() -> float:
    return torch.finfo(torch.float32).min


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh(x / cap) * cap with the IEEE divide on every device (a tensor
    divisor: PyTorch's CUDA divide by a Python scalar multiplies by its
    reciprocal), as the paged arena kernels cap their scores."""
    if cap and cap > 0:
        return torch.tanh(x / torch.full((), cap, dtype=x.dtype,
                                         device=x.device)) * cap
    return x


def _einsum_bf16(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum with the JAX package's semantics: bf16 operands, f32
    sums, the result rounded to bf16.  On the card that is cuBLAS's bf16
    product (f32 accumulation, reduced-precision reductions off); on the
    CPU it goes through the f32 product, whose sums are the XLA CPU
    backend's, where PyTorch's CPU bf16 kernels sum in another order.
    Meta tensors (the dry-run's shapes) take the card's form."""
    a, b = a.to(COMPUTE_DTYPE), b.to(COMPUTE_DTYPE)
    if a.device.type != "cpu":
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(COMPUTE_DTYPE)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          causal: bool, window: int,
                          kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Boolean validity mask from position vectors: (Sq, Sk) for an
    unbatched ``q_pos`` with scalar ``kv_valid``, else (B, Sq, Sk)."""
    q = q_pos
    batched = q.dim() == 2 or (kv_valid is not None and kv_valid.dim() == 1)
    if batched and q.dim() == 1:
        q = q[None]
    qp = q[..., :, None]
    kp = k_pos[None, None, :] if batched else k_pos[None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape[:-1] + (k_pos.shape[-1],),
                                          kp.shape),
                   dtype=torch.bool, device=k_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window and window > 0:
        m = m & (kp > (qp - window))
    if kv_valid is not None:
        kv = kv_valid
        m = m & (kp < (kv[:, None, None] if kv.dim() == 1 else kv))
    return m


def multihead_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_valid: Optional[torch.Tensor] = None,
    chunk: int = ATTN_CHUNK,
    return_stats: bool = False,
    scale: Optional[float] = None,
):
    """GQA attention; direct for short KV and single-query decode, chunked
    online softmax over the KV axis otherwise.  v may be narrower than q
    and k (MLA); ``scale`` defaults to 1/sqrt(D)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale

    qg = q.reshape(b, sq, hkv, g, dh).to(COMPUTE_DTYPE)
    k = k.to(COMPUTE_DTYPE)
    v = v.to(COMPUTE_DTYPE)

    if sk <= chunk or sq == 1:
        scores = _einsum_bf16("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        scores = _softcap(scores, softcap)
        mask = attention_scores_mask(q_positions, k_positions, causal,
                                     window, kv_valid)
        mask = mask if mask.dim() == 3 else mask[None]   # (B|1, Sq, Sk)
        scores = torch.where(mask[:, None, None], scores, _mask_value())
        if return_stats:
            m = scores.amax(dim=-1)
            probs = torch.exp(scores - m[..., None])
            l = probs.sum(dim=-1)
            out = _einsum_bf16("bhgqk,bkhd->bhgqd", probs, v)
            return out, m, l  # out UNNORMALISED (b,h,g,q,dh)
        probs = torch.softmax(scores, dim=-1)
        out = _einsum_bf16("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(b, sq, hq, dv)

    # ---- chunked online softmax over KV ----
    n_chunks = sk // chunk
    assert sk % chunk == 0, (sk, chunk)
    m_run = torch.full((b, hkv, g, sq), float("-inf"), device=q.device)
    l_run = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=COMPUTE_DTYPE,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        s = _einsum_bf16("bqhgd,bkhd->bhgqk", qg, k[:, sl]).float() * scale
        s = _softcap(s, softcap)
        mask = attention_scores_mask(q_positions, k_positions[sl], causal,
                                     window, kv_valid)
        mask = mask if mask.dim() == 3 else mask[None]
        s = torch.where(mask[:, None, None], s, _mask_value())
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = _einsum_bf16("bhgqk,bkhd->bhgqd", p, v[:, sl])
        acc = acc * alpha[..., None].to(COMPUTE_DTYPE) + pv
        m_run = m_new
    if return_stats:
        return acc, m_run, l_run
    out = acc / torch.clamp(l_run, min=1e-30)[..., None].to(COMPUTE_DTYPE)
    out = out.movedim(3, 1)  # (b, sq, hkv, g, dv)
    return out.reshape(b, sq, hq, dv)


def dense_decode_attention(q, k, v, ck, cv, cache_pos, *, window: int,
                           softcap: float, k_base: int = 0, combine=None,
                           scale: Optional[float] = None):
    """The decode step's attention over a dense cache: q, k, v (B, S, ·, D)
    the S new tokens at positions cache_pos .. cache_pos+S-1, ck / cv
    (B, Smax, Hkv, D) the cache read-only; returns (B, S, H, D).  The
    cache's statistics are taken first and the new tokens merge in
    closed form (``_merge_new_tokens``).  ``k_base`` is the position of
    the cache's first row and ``combine`` reduces the statistics across
    a cache split along its positions (both for a rank's slice of a
    sharded cache, ``utils/dtensor_step.py``).  ``scale`` as
    :func:`multihead_attention`'s."""
    s = q.shape[1]
    offs = torch.arange(s, dtype=torch.int32, device=q.device)
    if cache_pos.dim() == 1:
        q_pos = cache_pos[:, None] + offs[None, :]    # (B, S) per slot
    else:
        q_pos = cache_pos + offs                      # (S,)
    k_pos = k_base + torch.arange(ck.shape[1], dtype=torch.int32,
                                  device=q.device)
    out_old, m_old, l_old = multihead_attention(
        q, ck, cv, q_positions=q_pos, k_positions=k_pos, causal=True,
        window=window, softcap=softcap, kv_valid=cache_pos,
        return_stats=True, scale=scale,
    )  # (b,h,g,S,dh), (b,h,g,S), (b,h,g,S)
    if combine is not None:
        out_old, m_old, l_old = combine(out_old, m_old, l_old)
    return _merge_new_tokens(q, k, v, out_old, m_old, l_old, window=window,
                             softcap=softcap, scale=scale)


def _merge_new_tokens(q, k, v, out_old, m_old, l_old, *, window: int,
                      softcap: float, scale: Optional[float] = None):
    """The S new tokens' (k, v) merged into the cache's online-softmax
    statistics (unnormalised output (b, h, g, S, dh), max and
    denominator (b, h, g, S)); returns the attention output (B, S, H,
    D).  S > 1 (the verify step) attends among the new tokens under an
    intra-block causal mask.  v may be narrower than q and k (MLA's
    latent); ``scale`` as :func:`multihead_attention`'s."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    offs = torch.arange(s, dtype=torch.int32, device=q.device)
    qg = q.reshape(b, s, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    if s == 1:
        s_new = _einsum_bf16("bqhgd,bqhd->bhgq", qg, k).float()
        s_new = _softcap(s_new * scale, softcap)
        m_new = torch.maximum(m_old, s_new)
        alpha = torch.exp(m_old - m_new)
        p_new = torch.exp(s_new - m_new)
        v_b = v.reshape(b, 1, hkv, 1, dv).permute(0, 2, 3, 1, 4)
        num = (out_old.float() * alpha[..., None]
               + p_new[..., None] * v_b.float())
        den = l_old * alpha + p_new
    else:
        # Intra-block attention of the s new tokens over themselves:
        # query row i sees new token j iff j <= i (positions are
        # consecutive, so the sliding window reduces to j > i - w).
        s_blk = _einsum_bf16("bqhgd,bjhd->bhgqj", qg, k).float()
        s_blk = _softcap(s_blk * scale, softcap)
        blk_ok = offs[None, :] <= offs[:, None]           # (Sq, Sj)
        if window and window > 0:
            blk_ok = blk_ok & (offs[None, :] > offs[:, None] - window)
        s_blk = torch.where(blk_ok[None, None, None], s_blk,
                            _mask_value())
        m_new = torch.maximum(m_old, s_blk.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p_blk = torch.exp(s_blk - m_new[..., None])
        # f32 x f32, as the JAX package's einsum of p_blk and v
        pv = torch.einsum("bhgqj,bjhd->bhgqd", p_blk, v.float())
        num = out_old.float() * alpha[..., None] + pv
        den = l_old * alpha + p_blk.sum(dim=-1)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    out = out.to(COMPUTE_DTYPE).movedim(3, 1)  # (b, S, h, g, dv)
    return out.reshape(b, s, hkv * g, dv)


@dataclass
class PagedKV:
    """One attention layer's view of the paged decode arena: bf16 fp pools
    and int8 code / f32 per-channel scale pools, all (P, PS, Hkv, D), with
    the step's block tables (B, PPS) and quant-resident lengths (B,).  An
    MLA layer's ``k`` pools hold the latent (P, PS, 1, kv_lora_rank) and
    its ``v`` pools the rope key (P, PS, 1, qk_rope_head_dim)."""

    k: torch.Tensor
    v: torch.Tensor
    k_codes: torch.Tensor
    k_scale: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    block_tables: torch.Tensor
    quant_lens: torch.Tensor


def apply_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    positions: torch.Tensor,  # (B, S), or (3, B, S) for M-RoPE
    causal: bool = True,
    local: bool = False,
    cache=None,
    cache_pos: Optional[torch.Tensor] = None,
    xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention sublayer.  Returns (out, new_cache).

      - prefill / training: cache None -> attention over x, new_cache
        {"k","v"}
      - decode: cache {"k","v"} (B, Smax, Hkv, D) or :class:`PagedKV`,
        ``cache_pos`` the S tokens' first position: a scalar (every row
        at the same position) or (B,) per slot; new_cache
        {"k_new","v_new"} (B, S, Hkv, D)
      - cross-attention: ``xattn_kv`` the precomputed (k, v) of the
        encoder output; q is not rotated and nothing is cached
    """
    if is_mla(cfg) and xattn_kv is None:
        return apply_mla(params, cfg, x, positions=positions, cache=cache,
                         cache_pos=cache_pos)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cap = cfg.attn_softcap
    xc = x.to(COMPUTE_DTYPE)
    q = _einsum_bf16("bsd,dhk->bshk", xc, params["wq"])
    if cfg.qk_norm:
        q = rmsnorm_headdim(params["q_norm"], q, cfg.rmsnorm_eps)
    window = cfg.sliding_window if local else 0

    if xattn_kv is not None:
        k, v = xattn_kv
        out = dtensor_step.attend(
            multihead_attention, q, k, v,
            q_positions=torch.arange(s, dtype=torch.int32, device=x.device),
            k_positions=torch.arange(k.shape[1], dtype=torch.int32,
                                     device=x.device),
            causal=False, softcap=cap)
        y = _einsum_bf16("bshk,hkd->bsd", out, params["wo"])
        return y.to(x.dtype), None

    k = _einsum_bf16("bsd,dhk->bshk", xc, params["wk"])
    v = _einsum_bf16("bsd,dhk->bshk", xc, params["wv"])
    if cfg.qk_norm:
        k = rmsnorm_headdim(params["k_norm"], k, cfg.rmsnorm_eps)
    rotate = apply_mrope if cfg.mrope else apply_rope
    q = rotate(q, positions, cfg.rope_theta)
    k = rotate(k, positions, cfg.rope_theta)

    if cache is None:
        pos1 = torch.arange(s, dtype=torch.int32, device=x.device)
        out = dtensor_step.attend(multihead_attention, q, k, v,
                                  q_positions=pos1, k_positions=pos1,
                                  causal=causal, window=window, softcap=cap)
        new_cache = {"k": k, "v": v}
    else:
        # Decode: the cache is READ-ONLY here; the new tokens' (k, v) merge
        # in closed form via online-softmax statistics and the caller
        # writes them into the cache once per step.  s == 1 is the plain
        # decode step; s > 1 is the speculative verify step, whose s new
        # tokens sit at positions cache_pos .. cache_pos+s-1 and attend to
        # each other under an intra-block causal mask.
        hkv = k.shape[2]
        g = cfg.num_heads // cfg.kv_heads
        if isinstance(cache, PagedKV):
            # the kernels cap the scores and apply a local layer's window
            # (each verify row's own bound) on the committed prefix
            slot_pos = cache_pos.expand(b) if cache_pos.dim() == 0 \
                else cache_pos
            if s == 1:
                o, m, l = paged_attention_arena_op(
                    q.reshape(b, hkv, g, hd).contiguous(), cache.k, cache.v,
                    cache.k_codes, cache.k_scale, cache.v_codes,
                    cache.v_scale, cache.block_tables, slot_pos,
                    cache.quant_lens, window=window, softcap=cap)
                out_old, m_old, l_old = o[:, :, :, None], m[..., None], \
                    l[..., None]
            else:
                # every row reads the committed prefix (< cache_pos)
                out_old, m_old, l_old = paged_verify_attention_arena_op(
                    q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)
                    .contiguous(), cache.k, cache.v, cache.k_codes,
                    cache.k_scale, cache.v_codes, cache.v_scale,
                    cache.block_tables, slot_pos, cache.quant_lens,
                    window=window, softcap=cap)
            out = _merge_new_tokens(q, k, v, out_old, m_old, l_old,
                                    window=window, softcap=cap)
        else:
            out = dtensor_step.decode_attend(
                dense_decode_attention, q, k, v, cache["k"], cache["v"],
                cache_pos, window=window, softcap=cap)
        new_cache = {"k_new": k, "v_new": v}

    y = _einsum_bf16("bshk,hkd->bsd", out, params["wo"])
    return y.to(x.dtype), new_cache


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """(qk_nope + qk_rope)^-1/2, times YaRN's mscale(mscale_all_dim)^2
    where the config scales RoPE (the published DeepSeek-V2 code)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor > 1 and cfg.yarn_mscale_all_dim:
        m = yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        scale = scale * m * m
    return scale


def apply_mla(params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, cache=None,
              cache_pos: Optional[torch.Tensor] = None):
    """Multi-head latent attention (DeepSeek-V2, no query compression).
    Returns (out, new_cache) as :func:`apply_attention`.

    ``wkv_a`` projects x to the latent (``kv_lora_rank``), RMS-normed by
    ``kv_norm``, and the rope key (``qk_rope_head_dim``, one head shared by
    all), which RoPE rotates by halves as the port's other models do (the
    published code de-interleaves pairs first: with seeded weights the same
    map up to a fixed permutation of ``wq``'s and ``wkv_a``'s rope
    columns).  The cache holds the latent under "k" (B, S, 1, rank) and the
    rotated rope key under "v" (B, S, 1, rope).

      - prefill: the expanded form, ``wkv_b`` lifting the latent to each
        head's nope key and value, attention at qk width nope + rope;
      - decode: the absorbed form: each head's nope query folded through
        its ``wkv_b`` key columns onto the latent, scores over latent and
        rope key together, the latent itself the value, then lifted by the
        ``wkv_b`` value columns.  The paged arena reads the cache through
        the ``paged_mla_attention`` kernel (one token a slot; the verify
        step is refused) and the step's own token merges in closed form."""
    if cfg.q_lora_rank is not None:
        raise NotImplementedError(f"{cfg.name}: MLA with query compression")
    b, s, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = mla_softmax_scale(cfg)
    inv = rope_inv_freq(cfg, rope, device=x.device)
    mcs = (yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale)
           / yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
           if cfg.yarn_factor > 1 and cfg.yarn_mscale_all_dim else 1.0)
    xc = x.to(COMPUTE_DTYPE)
    q = _einsum_bf16("bsd,dhk->bshk", xc, params["wq"])
    kv = _einsum_bf16("bsd,dk->bsk", xc, params["wkv_a"])
    c = rmsnorm({"scale": params["kv_norm"]}, kv[..., :r],
                cfg.rmsnorm_eps)[:, :, None]                 # (B, S, 1, r)
    q_nope = q[..., :nope]
    q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta, inv, mcs)
    k_pe = apply_rope(kv[..., None, r:], positions, cfg.rope_theta, inv,
                      mcs)                                   # (B, S, 1, rope)
    wkv_b = params["wkv_b"]                                  # (r, H, nope+v)
    if cache is None:
        kvb = _einsum_bf16("bsc,chk->bshk", c[:, :, 0], wkv_b)
        k = torch.cat([kvb[..., :nope], k_pe.expand(b, s, h, rope)], dim=-1)
        pos1 = torch.arange(s, dtype=torch.int32, device=x.device)
        out = multihead_attention(
            torch.cat([q_nope, q_pe], dim=-1), k, kvb[..., nope:],
            q_positions=pos1, k_positions=pos1, causal=True, scale=scale)
        new_cache = {"k": c, "v": k_pe}
    else:
        q_abs = _einsum_bf16("bshn,chn->bshc", q_nope, wkv_b[..., :nope])
        q_cat = torch.cat([q_abs, q_pe], dim=-1)         # (B, S, H, r+rope)
        k_new = torch.cat([c, k_pe], dim=-1)             # (B, S, 1, r+rope)
        if isinstance(cache, PagedKV):
            if s != 1:
                raise NotImplementedError(
                    f"{cfg.name}: no MLA speculative verify step")
            slot_pos = cache_pos.expand(b) if cache_pos.dim() == 0 \
                else cache_pos
            o, m, l = paged_mla_attention_op(
                q_abs[:, 0].contiguous(), q_pe[:, 0].contiguous(), cache.k,
                cache.v, cache.block_tables, slot_pos, scale)
            out_lat = _merge_new_tokens(
                q_cat, k_new, c, o[:, None, :, None], m[:, None, :, None],
                l[:, None, :, None], window=0, softcap=0.0, scale=scale)
        else:
            ck = torch.cat([cache["k"], cache["v"]], dim=-1)
            out_lat = dense_decode_attention(
                q_cat, k_new, c, ck, cache["k"], cache_pos, window=0,
                softcap=0.0, scale=scale)
        out = _einsum_bf16("bshc,chv->bshv", out_lat, wkv_b[..., nope:])
        new_cache = {"k_new": c, "v_new": k_pe}
    y = _einsum_bf16("bshk,hkd->bsd", out, params["wo"])
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(COMPUTE_DTYPE)
    g = _einsum_bf16("bsd,df->bsf", xc, params["wi_gate"])
    u = _einsum_bf16("bsd,df->bsf", xc, params["wi_up"])
    gf = g.float()
    h = (gf * torch.sigmoid(gf)).to(COMPUTE_DTYPE) * u   # jax.nn.silu
    y = _einsum_bf16("bsf,fd->bsd", h, params["wo"])
    return y.to(x.dtype)


def _silu_bf16(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` of a bf16 tensor in f32, rounded back to bf16."""
    gf = g.float()
    return (gf * torch.sigmoid(gf)).to(COMPUTE_DTYPE)


def _experts(params, buf: torch.Tensor, spec: str) -> torch.Tensor:
    """Every expert's gated MLP on its dispatch buffer ``buf`` (``spec``
    names its axes, expert axis ``e`` and model axis ``d`` last), in
    plain bf16 products: the JAX package computes this outside any
    kernel."""
    lhs = spec[:-1]
    g = _einsum_bf16(f"{spec},edf->{lhs}f", buf, params["wi_gate"])
    u = _einsum_bf16(f"{spec},edf->{lhs}f", buf, params["wi_up"])
    h = _silu_bf16(g) * u
    return _einsum_bf16(f"{lhs}f,efd->{spec}", h, params["wo"])


def moe_route(params, cfg: ModelConfig, x: torch.Tensor):
    """The router over x (..., d): (probs (..., E) f32, top_w (..., k)
    renormalised unless ``cfg.norm_topk_prob`` is False, top_ids (..., k)).
    Ties in the probabilities (frequent: the logits are a bf16 product)
    break as ``jax.lax.top_k`` breaks
    them, lower expert index first, through a stable descending sort;
    ``torch.topk`` promises no order among equal values."""
    k = cfg.experts_per_token
    logits = _einsum_bf16("...d,de->...e", x, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = vals[..., :k], ids[..., :k]
    if norm_topk_prob(cfg):
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_ids


def _einsum_queue(cfg: ModelConfig, top_ids: torch.Tensor):
    """The einsum form's dispatch: tokens queue per batch row along S,
    earlier tokens first.  Returns (mask (B, S, E) f32 membership, pos
    (B, S, E) queue positions, keep (B, S, E) bool, cap)."""
    s = top_ids.shape[1]
    cap = max(int(math.ceil(s * cfg.experts_per_token / cfg.num_experts
                            * cfg.capacity_factor)), 1)
    cap = min(cap, s)
    # experts are distinct within a token's top-k
    mask = F.one_hot(top_ids, cfg.num_experts).float().sum(dim=2)
    pos = torch.cumsum(mask, dim=1) - mask
    return mask, pos, (pos < cap) & (mask > 0), cap


def _sort_queue(cfg: ModelConfig, top_ids: torch.Tensor):
    """The sort form's dispatch: the T·k assignments of ``top_ids`` (T, k)
    sorted stably by expert, each expert's queue in token order.  Returns
    (sort_idx, sorted_ids, counts (E,), pos_in_expert, keep, cap), the
    last three per sorted assignment."""
    t, k = top_ids.shape
    cap = max(int(math.ceil(t * k / cfg.num_experts
                            * cfg.capacity_factor)), 1)
    flat_ids = top_ids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    counts = torch.bincount(flat_ids, minlength=cfg.num_experts)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_expert = (torch.arange(t * k, device=top_ids.device)
                     - starts[sorted_ids])
    return (sort_idx, sorted_ids, counts, pos_in_expert,
            pos_in_expert < cap, cap)


def moe_assignments(params, cfg: ModelConfig, x: torch.Tensor):
    """(top_ids (B, S, k), kept (B, S, k) bool): which (token, expert)
    assignments of x (B, S, d) ``apply_moe`` routes and which of them its
    capacity keeps, in ``cfg.moe_impl``'s queue."""
    b, s, _ = x.shape
    _, _, top_ids = moe_route(params, cfg, x)
    if cfg.moe_impl == "einsum":
        keep = _einsum_queue(cfg, top_ids)[2]
        return top_ids, keep.gather(2, top_ids)
    sort_idx, *_, keep, _ = _sort_queue(cfg, top_ids.reshape(b * s, -1))
    kept = torch.empty_like(keep).index_copy(0, sort_idx, keep)
    return top_ids, kept.reshape(top_ids.shape)


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor):
    """Top-k MoE with capacity, ``cfg.moe_impl`` choosing the form:
    "einsum" (GShard one-hot dispatch and combine; tokens queue per batch
    row along S) or "sort" (capacity-sorted scatter and gather; tokens
    queue over all B·S).  Returns (y, aux): aux is the Switch-style
    load-balancing loss."""
    if cfg.moe_impl == "einsum":
        return _apply_moe_einsum(params, cfg, x)
    return _apply_moe_sort(params, cfg, x)


def _apply_moe_einsum(params, cfg: ModelConfig, x: torch.Tensor):
    e, k = cfg.num_experts, cfg.experts_per_token
    probs, top_w, top_ids = moe_route(params, cfg, x)
    mask, pos, keep, cap = _einsum_queue(cfg, top_ids)
    # (B, S, E) gate weights
    gates_e = (F.one_hot(top_ids, e).float() * top_w[..., None]).sum(dim=2)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = mask.mean(dim=(0, 1)) / k
    aux = (me * ce).sum() * e

    # a dropped token's one-hot row is zeroed by ``keep``, as
    # ``jax.nn.one_hot`` of an index past ``cap`` is
    disp = keep[..., None] * F.one_hot(pos.long().clamp(max=cap - 1),
                                       cap).to(COMPUTE_DTYPE)  # (B,S,E,C)
    disp = shard_hint(disp, ("pod", "data"), None, "model", None)
    xb = x.to(COMPUTE_DTYPE)
    buf = dtensor_step.expert_einsum(_einsum_bf16, "bsec,bsd->becd", disp,
                                     xb)                      # (B, E, C, d)
    buf = shard_hint(buf, ("pod", "data"), "model", None, None)
    yb = _experts(params, buf, "becd")
    yb = shard_hint(yb, ("pod", "data"), "model", None, None)
    combine = (disp.float() * gates_e[..., None]).to(COMPUTE_DTYPE)
    y = dtensor_step.expert_einsum(_einsum_bf16, "becd,bsec->bsd", yb,
                                   combine)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xb).to(COMPUTE_DTYPE)
    return y.to(x.dtype), aux


def _apply_moe_sort(params, cfg: ModelConfig, x: torch.Tensor):
    """Sorted capacity-based top-k MoE (drop on overflow)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, top_w, top_ids = moe_route(params, cfg, xt)
    sort_idx, sorted_ids, counts, pos_in_expert, keep, cap = _sort_queue(
        cfg, top_ids)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = counts.float() / (t * k)
    aux = (me * ce).sum() * e

    slot = sorted_ids * cap + torch.clamp(pos_in_expert, max=cap - 1)
    token_of = sort_idx // k
    # Kept assignments own distinct slots and dropped ones add zeros, so
    # the scatter-add is exact in any order.
    gathered = xt[token_of].to(COMPUTE_DTYPE) * keep[:, None]
    buf = torch.zeros((e * cap, d), dtype=COMPUTE_DTYPE, device=x.device)
    buf = buf.index_add(0, slot, gathered)
    # Expert parallelism: pin the dispatch buffer and the expert compute to
    # the model axis (a no-op off a mesh).
    buf = shard_hint(buf.reshape(e, cap, d), "model", None, None)
    yb = shard_hint(_experts(params, buf, "ecd"), "model", None, None)

    y_flat = yb.reshape(e * cap, d)[slot] * keep[:, None]    # (T*k, d)
    w_sorted = top_w.reshape(-1)[sort_idx]
    contrib = (y_flat.float() * w_sorted[:, None]).to(COMPUTE_DTYPE)
    # The JAX package scatter-adds each token's k contributions into a
    # bf16 zero buffer in sorted order, rounding after each add; sorted
    # order within a token is its experts' ascending ids.  Summed here in
    # that order, deterministically on any device.
    per_tok = torch.empty_like(contrib).index_copy(0, sort_idx, contrib)
    per_tok = per_tok.reshape(t, k, d)
    order = torch.argsort(top_ids, dim=-1)                   # (T, k)
    per_tok = per_tok.gather(1, order[..., None].expand(t, k, d))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xt[None])[0].to(COMPUTE_DTYPE)
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return dtensor_step.embed(params["tok"], tokens)


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    logits = _einsum_bf16("bsd,dv->bsv", x, w).float()
    return _softcap(logits, cfg.final_softcap)
