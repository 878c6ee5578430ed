"""Transformer layers in PyTorch: the dense GQA subset of the JAX package's
``models/layers.py`` that the serving path runs.

RMSNorm, RoPE, GQA attention with an online-softmax chunked path and
``return_stats``, the attention sublayer's prefill and decode paths (the
decode reads the cache read-only and merges the new token in closed form),
the gated MLP, and token embedding / unembedding.  Compute dtype is bf16
with f32 softmax and normalisation, and every cast point is the JAX
package's: greedy argmax flips on 1-ulp differences.

The decode path reads either a dense cache ``{"k", "v"}`` (B, Smax, Hkv, D)
or one layer of the paged arena (:class:`PagedKV`), which goes through the
Hopper ``paged_attention_arena`` kernel.  No ``scaled_dot_product_attention``
anywhere: prefill attention and the projections are plain einsums.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention_arena_op

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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    # f32 cos/sin, correctly rounded (through f64; the table is tiny)
    cos = torch.cos(angles.double()).float()[:, :, None, :]
    sin = torch.sin(angles.double()).float()[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _mask_value() -> float:
    return torch.finfo(torch.float32).min


def _einsum_bf16(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum with the JAX package's semantics: bf16 operands, f32
    sums, the result rounded to bf16.  On the card that is cuBLAS's bf16
    product (f32 accumulation, reduced-precision reductions off); on the
    CPU it goes through the f32 product, whose sums are the XLA CPU
    backend's, where PyTorch's CPU bf16 kernels sum in another order."""
    a, b = a.to(COMPUTE_DTYPE), b.to(COMPUTE_DTYPE)
    if a.is_cuda:
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
    kv_valid: Optional[torch.Tensor] = None,
    chunk: int = ATTN_CHUNK,
    return_stats: bool = False,
):
    """GQA attention; direct for short KV and single-query decode, chunked
    online softmax over the KV axis otherwise."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)

    qg = q.reshape(b, sq, hkv, g, dh).to(COMPUTE_DTYPE)
    k = k.to(COMPUTE_DTYPE)
    v = v.to(COMPUTE_DTYPE)

    if sk <= chunk or sq == 1:
        scores = _einsum_bf16("bqhgd,bkhd->bhgqk", qg, k).float() * scale
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
        return out.reshape(b, sq, hq, dh)

    # ---- chunked online softmax over KV ----
    n_chunks = sk // chunk
    assert sk % chunk == 0, (sk, chunk)
    m_run = torch.full((b, hkv, g, sq), float("-inf"), device=q.device)
    l_run = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=COMPUTE_DTYPE,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        s = _einsum_bf16("bqhgd,bkhd->bhgqk", qg, k[:, sl]).float() * scale
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
    out = out.movedim(3, 1)  # (b, sq, hkv, g, dh)
    return out.reshape(b, sq, hq, dh)


@dataclass
class PagedKV:
    """One attention layer's view of the paged decode arena: bf16 fp pools
    and int8 code / f32 per-channel scale pools, all (P, PS, Hkv, D), with
    the step's block tables (B, PPS) and quant-resident lengths (B,)."""

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
    positions: torch.Tensor,  # (B, S)
    causal: bool = True,
    local: bool = False,
    cache=None,
    cache_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention sublayer.  Returns (out, new_cache).

      - prefill: cache None -> causal attention over x, new_cache {"k","v"}
      - decode: cache {"k","v"} (B, Smax, Hkv, D) or :class:`PagedKV`,
        ``cache_pos`` (B,) per-slot positions; new_cache {"k_new","v_new"}
    """
    if cfg.qk_norm or cfg.mrope or cfg.attn_softcap:
        raise NotImplementedError("the port's attention covers dense GQA")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = _einsum_bf16("bsd,dhk->bshk", xc, params["wq"])
    window = cfg.sliding_window if local else 0
    k = _einsum_bf16("bsd,dhk->bshk", xc, params["wk"])
    v = _einsum_bf16("bsd,dhk->bshk", xc, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        pos1 = torch.arange(s, dtype=torch.int32, device=x.device)
        out = multihead_attention(q, k, v, q_positions=pos1, k_positions=pos1,
                                  causal=causal, window=window)
        new_cache = {"k": k, "v": v}
    else:
        # Decode: the cache is READ-ONLY here; the new token's (k, v)
        # merges in closed form via online-softmax statistics and the
        # caller writes it into the cache once per step.
        if s != 1 or cache_pos is None or cache_pos.dim() != 1:
            raise NotImplementedError("decode covers one token per slot at "
                                      "per-slot positions")
        hkv = k.shape[2]
        g = cfg.num_heads // cfg.kv_heads
        q_pos = cache_pos.to(torch.int32)[:, None]
        if isinstance(cache, PagedKV):
            if window:
                raise NotImplementedError("paged arena: no sliding window")
            o, m, l = paged_attention_arena_op(
                q.reshape(b, hkv, g, hd).contiguous(), cache.k, cache.v,
                cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale,
                cache.block_tables, cache_pos, cache.quant_lens)
            out_old, m_old, l_old = o[:, :, :, None], m[..., None], \
                l[..., None]
        else:
            smax = cache["k"].shape[1]
            k_pos = torch.arange(smax, dtype=torch.int32, device=x.device)
            out_old, m_old, l_old = multihead_attention(
                q, cache["k"], cache["v"], q_positions=q_pos,
                k_positions=k_pos, causal=True, window=window,
                kv_valid=cache_pos, return_stats=True,
            )  # (b,h,g,1,dh), (b,h,g,1), (b,h,g,1)
        qg = q.reshape(b, s, hkv, g, hd)
        scale = 1.0 / math.sqrt(hd)
        s_new = _einsum_bf16("bqhgd,bqhd->bhgq", qg, k).float() * scale
        m_new = torch.maximum(m_old, s_new)
        alpha = torch.exp(m_old - m_new)
        p_new = torch.exp(s_new - m_new)
        v_b = v.reshape(b, 1, hkv, 1, hd).permute(0, 2, 3, 1, 4)
        num = (out_old.float() * alpha[..., None]
               + p_new[..., None] * v_b.float())
        den = l_old * alpha + p_new
        out = num / torch.clamp(den, min=1e-30)[..., None]
        out = out.to(COMPUTE_DTYPE).movedim(3, 1)  # (b, S, h, g, dh)
        out = out.reshape(b, s, hkv * g, hd)
        new_cache = {"k_new": k, "v_new": v}

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


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.final_softcap:
        raise NotImplementedError("the port's unembed has no softcap")
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return _einsum_bf16("bsd,dv->bsv", x, w).float()
