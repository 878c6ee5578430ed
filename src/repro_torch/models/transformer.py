"""The decoder stack in PyTorch: (optional prefix layers) + repeated layer
blocks, the dense-attention subset of the JAX package's
``models/transformer.py``.

Parameters and caches keep the JAX package's ``{"prefix", "blocks"}``
layout, with block leaves stacked on a leading ``n_blocks`` axis; where the
JAX package scans over blocks, this module loops.  Caches are updated in
place (the JAX package returns new arrays), which keeps one copy of a
serving arena in device memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L

COMPUTE_DTYPE = L.COMPUTE_DTYPE


# ---------------------------------------------------------------------------
# Structure resolution
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StackPlan:
    prefix_specs: Tuple[LayerSpec, ...]
    period_specs: Tuple[LayerSpec, ...]
    n_blocks: int


def plan_stack(cfg: ModelConfig) -> StackPlan:
    specs = cfg.layer_specs()
    # Pull an irregular prefix (e.g. deepseek dense first layer[s]) out front.
    for prefix_len in range(0, min(len(specs), 4)):
        rest = specs[prefix_len:]
        for period in (1, 2, 4, 8, 16):
            if len(rest) == 0 or len(rest) % period:
                continue
            blocks = [tuple(rest[i : i + period]) for i in range(0, len(rest), period)]
            if all(b == blocks[0] for b in blocks):
                return StackPlan(tuple(specs[:prefix_len]), blocks[0],
                                 len(rest) // period)
    # Fully irregular: everything is prefix (no scan).
    return StackPlan(tuple(specs), (), 0)


def _check_supported(cfg: ModelConfig, plan: StackPlan) -> None:
    for spec in plan.prefix_specs + plan.period_specs:
        if spec.kind != "attn" or spec.moe:
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense attention stacks only")
    if cfg.encoder_decoder or cfg.vision_prefix_frac > 0:
        raise NotImplementedError(f"{cfg.name}: decoder-only text models")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ModelConfig) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], float]]]:
    """{sublayer: {leaf: (shape, normal scale or 0 for ones)}} of one layer."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, \
        cfg.kv_heads
    out = {
        "ln1": {"scale": ((d,), 0.0)},
        "mixer": {
            "wq": ((d, h, hd), 1.0 / math.sqrt(d)),
            "wk": ((d, kv, hd), 1.0 / math.sqrt(d)),
            "wv": ((d, kv, hd), 1.0 / math.sqrt(d)),
            "wo": ((h, hd, d), 1.0 / math.sqrt(h * hd)),
        },
    }
    if cfg.d_ff > 0:
        out["ln2"] = {"scale": ((d,), 0.0)}
        out["mlp"] = {
            "wi_gate": ((d, cfg.d_ff), 1.0 / math.sqrt(d)),
            "wi_up": ((d, cfg.d_ff), 1.0 / math.sqrt(d)),
            "wo": ((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff)),
        }
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaf shapes (stacked blocks included)."""
    plan = plan_stack(cfg)
    _check_supported(cfg, plan)
    layer = {k: {n: s for n, (s, _) in sub.items()}
             for k, sub in _layer_shapes(cfg).items()}
    embed = {"tok": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (cfg.d_model, cfg.vocab_size)
    blocks = {}
    if plan.n_blocks > 0:
        blocks = {f"layer{j}": {k: {n: (plan.n_blocks,) + s
                                    for n, s in sub.items()}
                                for k, sub in layer.items()}
                  for j in range(len(plan.period_specs))}
    return {
        "embed": embed,
        "final_norm": {"scale": (cfg.d_model,)},
        "prefix": {f"layer{i}": layer for i in range(len(plan.prefix_specs))},
        "blocks": blocks,
    }


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the JAX package's shapes and scales
    (normal(0, scale) weights, RMSNorm scales of one).  The numbers differ
    from the JAX package's init; stacked leaves are drawn block by block
    so a full-width model never holds more than one f32 block in flight.
    ``dtype=torch.bfloat16`` is the serving-only form."""
    plan = plan_stack(cfg)
    _check_supported(cfg, plan)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(shape, scale, n=None):
        if scale == 0.0:
            return torch.ones(((n,) if n else ()) + shape, dtype=dtype,
                              device=device)
        if n is None:
            return (torch.randn(shape, generator=gen, device=device)
                    * scale).to(dtype)
        out = torch.empty((n,) + shape, dtype=dtype, device=device)
        for i in range(n):
            out[i] = (torch.randn(shape, generator=gen, device=device)
                      * scale).to(dtype)
        return out

    def layer(n=None):
        return {k: {name: leaf(s, sc, n) for name, (s, sc) in sub.items()}
                for k, sub in _layer_shapes(cfg).items()}

    embed = {"tok": leaf((cfg.vocab_size, cfg.d_model), 1.0)}
    if not cfg.tie_embeddings:
        embed["unembed"] = leaf((cfg.d_model, cfg.vocab_size),
                                1.0 / math.sqrt(cfg.d_model))
    return {
        "embed": embed,
        "final_norm": {"scale": leaf((cfg.d_model,), 0.0)},
        "prefix": {f"layer{i}": layer() for i in range(len(plan.prefix_specs))},
        "blocks": ({f"layer{j}": layer(plan.n_blocks)
                    for j in range(len(plan.period_specs))}
                   if plan.n_blocks > 0 else {}),
    }


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------
def _block(tree, i: int):
    """Block ``i`` of a stacked subtree (params, dense caches or paged)."""
    if isinstance(tree, L.PagedKV):
        return replace(tree, k=tree.k[i], v=tree.v[i],
                       k_codes=tree.k_codes[i], k_scale=tree.k_scale[i],
                       v_codes=tree.v_codes[i], v_scale=tree.v_scale[i])
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_layer(lp, cfg: ModelConfig, spec: LayerSpec, x, *, positions,
                 cache=None, cache_pos=None):
    """Returns (x, attention kv or new-token update)."""
    h = L.rmsnorm(lp["ln1"], x, cfg.rmsnorm_eps)
    y, kv = L.apply_attention(lp["mixer"], cfg, h, positions=positions,
                              local=spec.local, cache=cache,
                              cache_pos=cache_pos)
    x = x + y
    if cfg.d_ff > 0:
        h2 = L.rmsnorm(lp["ln2"], x, cfg.rmsnorm_eps)
        x = x + L.apply_mlp(lp["mlp"], h2)
    return x, kv


def _run_stack(params, cfg: ModelConfig, plan: StackPlan, x, *, positions,
               caches=None, cache_pos=None, on_kv=None):
    """Run prefix + blocks; ``on_kv(part, name, block, kv)`` receives each
    attention layer's kv (prefill) or new-token update (decode)."""
    for i, spec in enumerate(plan.prefix_specs):
        name = f"layer{i}"
        c_in = caches["prefix"][name] if caches is not None else None
        x, kv = _apply_layer(params["prefix"][name], cfg, spec, x,
                             positions=positions, cache=c_in,
                             cache_pos=cache_pos)
        on_kv("prefix", name, None, kv)
    for blk in range(plan.n_blocks):
        bp = _block(params["blocks"], blk)
        for j, spec in enumerate(plan.period_specs):
            name = f"layer{j}"
            c_in = (_block(caches["blocks"][name], blk)
                    if caches is not None else None)
            x, kv = _apply_layer(bp[name], cfg, spec, x, positions=positions,
                                 cache=c_in, cache_pos=cache_pos)
            on_kv("blocks", name, blk, kv)
    return x


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return L.embed_tokens(params["embed"], tokens).to(COMPUTE_DTYPE)


def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Prompt processing: ``batch["tokens"]`` (B, S).  Returns
    (last-token logits (B, 1, V) f32, caches padded to ``max_len``)."""
    plan = plan_stack(cfg)
    _check_supported(cfg, plan)
    tokens = batch["tokens"]
    x = _embed(params, tokens)
    bsz, seq = x.shape[0], x.shape[1]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=x.device)[None].expand(bsz, seq)
    caches = init_cache(cfg, bsz, max(max_len, seq), device=x.device)

    def store(part, name, blk, kv):
        c = caches[part][name]
        for key in ("k", "v"):
            buf = c[key] if blk is None else c[key][blk]
            buf[:, :seq] = kv[key].to(COMPUTE_DTYPE)

    x = _run_stack(params, cfg, plan, x, positions=positions, on_kv=store)
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    logits = L.unembed(params["embed"], cfg, x[:, -1:, :])
    return logits, caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    """One decode step of the slot arena: ``tokens`` (B, 1), ``pos`` (B,)
    int32 per-slot positions.  Returns (logits (B, 1, V), updates).

    With dense caches the new K/V row of each slot is written in place at
    its position (``_merge_decode_updates``) and ``updates`` is the cache.
    With paged caches (:class:`~repro_torch.models.layers.PagedKV` leaves)
    ``updates`` holds each layer's ``{"k_new", "v_new"}`` (B, 1, Hkv, D),
    blocks stacked on a leading axis, for the arena to scatter to pages."""
    plan = plan_stack(cfg)
    _check_supported(cfg, plan)
    x = _embed(params, tokens)
    bsz, s = x.shape[0], x.shape[1]
    pos = pos.to(torch.int32)
    positions = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                            device=x.device)[None, :]
    new: Dict[str, Dict[str, Any]] = {"prefix": {}, "blocks": {}}

    def collect(part, name, blk, kv):
        if blk is None:
            new[part][name] = kv
        else:
            new[part].setdefault(name, {"k_new": [], "v_new": []})
            for key in ("k_new", "v_new"):
                new[part][name][key].append(kv[key])

    x = _run_stack(params, cfg, plan, x, positions=positions, caches=caches,
                   cache_pos=pos, on_kv=collect)
    for sub in new["blocks"].values():
        for key in ("k_new", "v_new"):
            sub[key] = torch.stack(sub[key])
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    if _is_paged(caches):
        return logits, new
    return logits, _merge_decode_updates(new, caches, pos)


def _is_paged(caches) -> bool:
    return any(isinstance(c, L.PagedKV)
               for part in ("prefix", "blocks")
               for c in caches[part].values())


def _merge_decode_updates(new_caches, caches, cache_pos):
    """Write each layer's new K/V token row into the dense cache buffers at
    every slot's own position, in place; returns ``caches``."""
    rows = torch.arange(cache_pos.shape[0], device=cache_pos.device)
    p = cache_pos.long()
    for part, stacked in (("prefix", False), ("blocks", True)):
        for name, c in new_caches[part].items():
            for key, nk in (("k", "k_new"), ("v", "v_new")):
                buf = caches[part][name][key]
                upd = c[nk][..., 0, :, :].to(buf.dtype)  # (·, B, H, D)
                if stacked:
                    buf[:, rows, p] = upd
                else:
                    buf[rows, p] = upd
    return caches


# ---------------------------------------------------------------------------
# Cache construction (the serving arena and prefill outputs)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zeroed bf16 K/V caches: (B, max_len, Hkv, D) per attention layer,
    block layers stacked on a leading ``n_blocks`` axis."""
    plan = plan_stack(cfg)
    _check_supported(cfg, plan)
    shape = (batch, max_len, cfg.kv_heads, cfg.resolved_head_dim)

    def attn_cache(n=None):
        full = ((n,) if n else ()) + shape
        return {"k": torch.zeros(full, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(full, dtype=COMPUTE_DTYPE, device=device)}

    return {
        "prefix": {f"layer{i}": attn_cache()
                   for i in range(len(plan.prefix_specs))},
        "blocks": ({f"layer{j}": attn_cache(plan.n_blocks)
                    for j in range(len(plan.period_specs))}
                   if plan.n_blocks > 0 else {}),
    }
