"""The model stack in PyTorch: dense / MoE / SSM / hybrid decoders and the
whisper encoder-decoder, built as (optional prefix layers) + repeated layer
blocks, as the JAX package's ``models/transformer.py``: the training
forward, prefill and the decode step.

Parameters and caches keep the JAX package's ``{"prefix", "blocks"}``
layout, with block leaves stacked on a leading ``n_blocks`` axis; where the
JAX package scans over blocks, this module loops.  Caches are updated in
place (the JAX package returns new arrays), which keeps one copy of a
serving arena in device memory.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.utils import dtensor_step
from repro_torch.utils.dtensor_step import pin_batch

COMPUTE_DTYPE = L.COMPUTE_DTYPE
_ENC_SPEC = LayerSpec(kind="attn", moe=False, local=False)


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


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
# A leaf spec is (shape, axes, init, n): axes names each dimension's
# logical axis (``distribution/sharding.py`` maps them to mesh axes, as the
# JAX package's ``Pm`` leaves carry them); init is a normal's scale, "ones",
# "zeros" or a numpy constant; n stacks the leaf on a leading "layers" axis.
def _mlp_specs(d: int, d_ff: int) -> Dict[str, Any]:
    return {"wi_gate": ((d, d_ff), ("embed", "mlp"), 1.0 / math.sqrt(d), None),
            "wi_up": ((d, d_ff), ("embed", "mlp"), 1.0 / math.sqrt(d), None),
            "wo": ((d_ff, d), ("mlp", "embed"), 1.0 / math.sqrt(d_ff), None)}


def _norm_spec(d: int):
    return ((d,), (None,), "ones", None)


def _attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, \
        cfg.kv_heads
    out = {
        "wq": ((d, h, hd), ("embed", "heads", "head_dim"),
               1.0 / math.sqrt(d), None),
        "wk": ((d, kv, hd), ("embed", "kv_heads", "head_dim"),
               1.0 / math.sqrt(d), None),
        "wv": ((d, kv, hd), ("embed", "kv_heads", "head_dim"),
               1.0 / math.sqrt(d), None),
        "wo": ((h, hd, d), ("heads", "head_dim", "embed"),
               1.0 / math.sqrt(h * hd), None),
    }
    if cfg.qk_norm:
        out["q_norm"] = _norm_spec(hd)
        out["k_norm"] = _norm_spec(hd)
    return out


def _mamba_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, di, n, r, kc = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    # A initialised to -[1..n] per channel (S4D-real init)
    a_init = np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                    (di, n)))
    return {
        "in_proj": ((d, 2 * di), ("embed", "mlp"), 1.0 / math.sqrt(d), None),
        "conv_w": ((di, kc), ("mlp", None), 0.5, None),
        "conv_b": ((di,), ("mlp",), "zeros", None),
        "x_proj": ((di, r + 2 * n), ("mlp", None), 1.0 / math.sqrt(di), None),
        "dt_proj_w": ((r, di), (None, "mlp"), 1.0 / math.sqrt(r), None),
        "dt_proj_b": ((di,), ("mlp",), np.log(np.expm1(
            np.full((di,), 0.01, dtype=np.float32))), None),
        "a_log": ((di, n), ("mlp", "state"), a_init, None),
        "d_skip": ((di,), ("mlp",), "ones", None),
        "out_proj": ((di, d), ("mlp", "embed"), 1.0 / math.sqrt(di), None),
    }


def _layer_specs(cfg: ModelConfig, spec: LayerSpec,
                 cross: bool = False) -> Dict[str, Any]:
    """One layer's leaf specs, sublayer by sublayer (``_init_layer``)."""
    d, f = cfg.d_model, cfg.d_ff
    out: Dict[str, Any] = {"ln1": {"scale": _norm_spec(d)}}
    out["mixer"] = (_attn_specs(cfg) if spec.kind == "attn"
                    else _mamba_specs(cfg))
    if cross:
        out["lnx"] = {"scale": _norm_spec(d)}
        out["xattn"] = _attn_specs(cfg)
    if f > 0:
        out["ln2"] = {"scale": _norm_spec(d)}
        if spec.moe:
            e = cfg.num_experts
            out["mlp"] = {
                "router": ((d, e), ("embed", "experts"), 1.0 / math.sqrt(d),
                           None),
                "wi_gate": ((e, d, f), ("experts", "embed", "expert_mlp"),
                            1.0 / math.sqrt(d), None),
                "wi_up": ((e, d, f), ("experts", "embed", "expert_mlp"),
                          1.0 / math.sqrt(d), None),
                "wo": ((e, f, d), ("experts", "expert_mlp", "embed"),
                       1.0 / math.sqrt(f), None),
            }
            if cfg.num_shared_experts > 0:
                out["mlp"]["shared"] = _mlp_specs(
                    d, f * cfg.num_shared_experts)
        else:
            out["mlp"] = _mlp_specs(d, f)
    return out


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    shape, axes, init, _ = tree
    return (shape, axes, init, n)


def _param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    plan = plan_stack(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    cross = cfg.encoder_decoder
    embed = {"tok": ((v, d), ("vocab", "embed"), 1.0, None)}
    if not cfg.tie_embeddings:
        embed["unembed"] = ((d, v), ("embed", "vocab"), 1.0 / math.sqrt(d),
                            None)
    tree = {
        "embed": embed,
        "final_norm": {"scale": _norm_spec(d)},
        "prefix": {f"layer{i}": _layer_specs(cfg, spec, cross)
                   for i, spec in enumerate(plan.prefix_specs)},
        "blocks": ({f"layer{j}": _stacked(_layer_specs(cfg, spec, cross),
                                          plan.n_blocks)
                    for j, spec in enumerate(plan.period_specs)}
                   if plan.n_blocks > 0 else {}),
    }
    if cfg.encoder_decoder:
        tree["encoder"] = {
            "blocks": {"layer0": _stacked(_layer_specs(cfg, _ENC_SPEC),
                                          cfg.enc_layers)},
            "final_norm": {"scale": _norm_spec(d)},
        }
    return tree


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(*tree)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaf shapes (stacked blocks included)."""
    return _map_specs(lambda shape, axes, init, n: ((n,) if n else ()) + shape,
                      _param_specs(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the JAX package's shapes and
    initialisers (normal(0, scale) weights, RMSNorm scales of one, the
    mamba mixer's constants).  The numbers differ from the JAX package's
    init; stacked leaves are drawn block by block, so a full-width model
    never holds more than one f32 block of one leaf in flight.
    ``dtype=torch.bfloat16`` is the serving-only form; ``device="meta"``
    gives the shapes only (the dry-run's parameters)."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def draw(shape, init):
        if isinstance(init, str):
            fill = torch.ones if init == "ones" else torch.zeros
            return fill(shape, dtype=dtype, device=device)
        if isinstance(init, np.ndarray):
            return torch.as_tensor(init, dtype=torch.float32).to(
                device=device, dtype=dtype)
        return (torch.randn(shape, generator=gen, device=device)
                * init).to(dtype)

    def leaf(shape, axes, init, n):
        if device.type == "meta":
            return torch.empty(((n,) if n else ()) + shape, dtype=dtype,
                                device=device)
        if n is None:
            return draw(shape, init)
        out = torch.empty((n,) + shape, dtype=dtype, device=device)
        for i in range(n):
            out[i] = draw(shape, init)
        return out

    return _map_specs(leaf, _param_specs(cfg))


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
                 cache=None, cache_pos=None, xattn_kv=None,
                 causal: bool = True):
    """Returns (x, mixer output, aux): the attention kv (prefill), its
    new-token update (decode) or the mamba state, and the MoE's
    load-balancing loss (None for a dense MLP).  ``xattn_kv`` (xk, xv)
    adds the decoder's cross-attention sublayer; ``causal`` False is the
    encoder's self-attention."""
    h = pin_batch(L.rmsnorm(lp["ln1"], x, cfg.rmsnorm_eps))
    if spec.kind == "attn":
        y, kv = L.apply_attention(lp["mixer"], cfg, h, positions=positions,
                                  local=spec.local, causal=causal,
                                  cache=cache, cache_pos=cache_pos)
    else:
        y, kv = S.apply_mamba(lp["mixer"], cfg, h, state=cache)
    x = x + pin_batch(y)
    if xattn_kv is not None:
        hx = pin_batch(L.rmsnorm(lp["lnx"], x, cfg.rmsnorm_eps))
        yx, _ = L.apply_attention(lp["xattn"], cfg, hx, positions=positions,
                                  xattn_kv=xattn_kv)
        x = x + pin_batch(yx)
    aux = None
    if cfg.d_ff > 0:
        h2 = pin_batch(L.rmsnorm(lp["ln2"], x, cfg.rmsnorm_eps))
        if spec.moe:
            y2, aux = L.apply_moe(lp["mlp"], cfg, h2)
        else:
            y2 = L.apply_mlp(lp["mlp"], h2)
        x = x + pin_batch(y2)
    return x, kv, aux


def _xkv(tree) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    return None if tree is None else (tree["xk"], tree["xv"])


def _run_block(params, cfg: ModelConfig, plan: StackPlan, blk: int, x, aux,
               *, positions, caches, cache_pos, xattn_kv, on_kv):
    """Block ``blk``'s period layers (one step of the JAX package's scan)."""
    bp = _block(params["blocks"], blk)
    for j, spec in enumerate(plan.period_specs):
        name = f"layer{j}"
        c_in = (_block(caches["blocks"][name], blk)
                if caches is not None else None)
        xkv = (_xkv(_block(xattn_kv["blocks"][name], blk))
               if xattn_kv is not None else None)
        x, kv, a = _apply_layer(bp[name], cfg, spec, x, positions=positions,
                                cache=c_in, cache_pos=cache_pos,
                                xattn_kv=xkv)
        if a is not None:
            aux = aux + a
        on_kv("blocks", name, blk, kv)
    return x, aux


def _drop_kv(part, name, blk, kv) -> None:
    """The training forward keeps no cache."""


def _run_stack(params, cfg: ModelConfig, plan: StackPlan, x, *, positions,
               caches=None, cache_pos=None, xattn_kv=None, on_kv=_drop_kv,
               remat: bool = False):
    """Run prefix + blocks; returns (x, aux summed over the MoE layers in
    layer order).  ``on_kv(part, name, block, kv)`` receives each layer's
    mixer output (prefill) or update (decode).  ``remat`` recomputes each
    block in the backward pass instead of keeping its activations
    (``jax.checkpoint`` on the JAX package's scan body); it runs a block
    twice, so only the training forward sets it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(plan.prefix_specs):
        name = f"layer{i}"
        c_in = caches["prefix"][name] if caches is not None else None
        xkv = (_xkv(xattn_kv["prefix"][name]) if xattn_kv is not None
               else None)
        x, kv, a = _apply_layer(params["prefix"][name], cfg, spec, x,
                                positions=positions, cache=c_in,
                                cache_pos=cache_pos, xattn_kv=xkv)
        if a is not None:
            aux = aux + a
        on_kv("prefix", name, None, kv)
    for blk in range(plan.n_blocks):
        run = functools.partial(_run_block, params, cfg, plan, blk,
                                positions=positions, caches=caches,
                                cache_pos=cache_pos, xattn_kv=xattn_kv,
                                on_kv=on_kv)
        x, aux = (torch.utils.checkpoint.checkpoint(run, x, aux,
                                                    use_reentrant=False)
                  if remat else run(x, aux))
    return x, aux


# ---------------------------------------------------------------------------
# Embedding helpers / positions
# ---------------------------------------------------------------------------
def _positions_for(cfg: ModelConfig, batch, seq: int, bsz: int, device):
    """(B, S) positions, or (3, B, S) for M-RoPE (``batch["positions"]``
    where the inputs give them)."""
    if cfg.mrope:
        if "positions" in batch:
            return batch["positions"]
        return torch.arange(seq, dtype=torch.int32,
                            device=device)[None, None].expand(3, bsz, seq)
    return torch.arange(seq, dtype=torch.int32,
                        device=device)[None].expand(bsz, seq)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return pin_batch(L.embed_tokens(params["embed"], tokens)
                     .to(COMPUTE_DTYPE))


def _embed_inputs(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, after the vision patch embeddings where a VLM's
    inputs carry them."""
    x = _embed(params, batch["tokens"])
    if cfg.vision_prefix_frac > 0 and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(COMPUTE_DTYPE), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------
def _encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings (the conv
    front end is a stub in both packages), with sinusoidal positions."""
    bsz, s, _ = frames.shape
    d = cfg.d_model
    dev = frames.device
    pos = torch.arange(s, dtype=torch.float32, device=dev)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=dev)[None, :]
    # lint: sync-ok(whisper encoder positions, once per prefill - a scalar base)
    angle = (pos / torch.pow(torch.tensor(10000.0, device=dev),
                             2 * dim / d)).double()
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).float()
    x = frames.to(COMPUTE_DTYPE) + pe.to(COMPUTE_DTYPE)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=dev)[None].expand(bsz, s)
    enc = params["encoder"]
    for i in range(cfg.enc_layers):
        x, _, _ = _apply_layer(_block(enc["blocks"], i)["layer0"], cfg,
                               _ENC_SPEC, x, positions=positions,
                               causal=False)
    return L.rmsnorm(enc["final_norm"], x, cfg.rmsnorm_eps)


def _cross_kv(cfg: ModelConfig, params, enc_out: torch.Tensor):
    """Every decoder layer's cross-attention K/V of the encoder output:
    {"prefix": {name: {"xk", "xv"}}, "blocks": {name: stacked}}."""
    plan = plan_stack(cfg)
    xc = enc_out.to(COMPUTE_DTYPE)

    def kv_of(lp):
        return {"xk": L._einsum_bf16("bsd,dhk->bshk", xc, lp["xattn"]["wk"]),
                "xv": L._einsum_bf16("bsd,dhk->bshk", xc, lp["xattn"]["wv"])}

    prefix = {f"layer{i}": kv_of(params["prefix"][f"layer{i}"])
              for i in range(len(plan.prefix_specs))}
    blocks = {}
    for j in range(len(plan.period_specs) if plan.n_blocks > 0 else 0):
        per = [kv_of(_block(params["blocks"], b)[f"layer{j}"])
               for b in range(plan.n_blocks)]
        blocks[f"layer{j}"] = {k: torch.stack([p[k] for p in per])
                               for k in ("xk", "xv")}
    return {"prefix": prefix, "blocks": blocks}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch, remat: bool = False):
    """Full-sequence forward (training): ``batch["tokens"]`` (B, S), plus
    ``frames`` (whisper) or ``patch_embeds`` / ``positions`` (VLM).
    Returns (logits (B, S, V) f32, aux f32 scalar: the MoE layers'
    load-balancing loss, zero without them).  Nothing on this path
    writes in place, so autograd runs through it."""
    plan = plan_stack(cfg)
    xattn_kv = None
    if cfg.encoder_decoder:
        xattn_kv = _cross_kv(cfg, params, _encode(cfg, params,
                                                  batch["frames"]))
        x = _embed(params, batch["tokens"])
    else:
        x = _embed_inputs(params, cfg, batch)
    bsz, seq = x.shape[0], x.shape[1]
    positions = _positions_for(cfg, batch, seq, bsz, x.device)
    x, aux = _run_stack(params, cfg, plan, x, positions=positions,
                        xattn_kv=xattn_kv, remat=remat)
    x = pin_batch(L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps))
    return L.unembed(params["embed"], cfg, x), aux


def prefill(cfg: ModelConfig, params, batch, max_len: int, caches=None):
    """Prompt processing (``forward``'s inputs).  Returns (last-token
    logits (B, 1, V) f32, caches): attention K/V padded to ``max_len``,
    each mamba layer's state after the prompt, and for whisper
    ``{"self": caches, "cross": cross-attention K/V}``.  ``caches`` are
    zeroed buffers to fill, ``init_cache``'s tree (the dry-run passes
    them placed as DTensors); None allocates them."""
    plan = plan_stack(cfg)
    xattn_kv = None
    if cfg.encoder_decoder:
        xattn_kv = _cross_kv(cfg, params, _encode(cfg, params,
                                                  batch["frames"]))
        x = _embed(params, batch["tokens"])
    else:
        x = _embed_inputs(params, cfg, batch)
    bsz, seq = x.shape[0], x.shape[1]
    positions = _positions_for(cfg, batch, seq, bsz, x.device)
    if caches is None:
        caches = init_cache(cfg, bsz, max(max_len, seq), device=x.device)
    if cfg.encoder_decoder:
        caches = caches["self"]

    def store(part, name, blk, kv):
        c = caches[part][name]
        for key, val in kv.items():
            buf = c[key] if blk is None else c[key][blk]
            dtensor_step.fill(_fill, buf, val)

    x, _ = _run_stack(params, cfg, plan, x, positions=positions,
                      xattn_kv=xattn_kv, on_kv=store)
    x = pin_batch(L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps))
    logits = L.unembed(params["embed"], cfg, x[:, -1:, :])
    if cfg.encoder_decoder:
        caches = {"self": caches, "cross": xattn_kv}
    return logits, caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    """One decode step: ``tokens`` (B, S); ``pos`` the S tokens' first
    position, a scalar (every row at the same position) or (B,) int32
    per slot (the slot arena).  S == 1 is the plain step; S > 1 is the
    speculative verify step, whose S tokens occupy positions pos ..
    pos+S-1 and get logits back for every position.  Returns (logits
    (B, S, V), updates).

    With dense caches each attention layer's S new K/V rows are written
    in place from the position (``_merge_decode_updates``), each mamba
    layer's state is replaced, and ``updates`` is the cache.  With paged
    caches (:class:`~repro_torch.models.layers.PagedKV` leaves)
    ``updates`` holds each layer's ``{"k_new", "v_new"}`` (B, S, Hkv, D),
    blocks stacked on a leading axis, for the arena to scatter to
    pages."""
    plan = plan_stack(cfg)
    xattn_kv = None
    self_caches = caches
    if cfg.encoder_decoder:
        xattn_kv, self_caches = caches["cross"], caches["self"]
    x = _embed(params, tokens)
    bsz, s = x.shape[0], x.shape[1]
    # lint: sync-ok(the serving steps pass pos as a device tensor, which is not copied - a host int pos is copied once per step)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    offs = torch.arange(s, dtype=torch.int32, device=x.device)
    base = (pos[:, None] + offs[None, :] if pos.dim() == 1
            else (pos + offs)[None].expand(bsz, s))
    positions = base[None].expand(3, bsz, s) if cfg.mrope else base
    new: Dict[str, Dict[str, Any]] = {"prefix": {}, "blocks": {}}

    def collect(part, name, blk, kv):
        if blk is None:
            new[part][name] = kv
        else:
            lists = new[part].setdefault(name, {key: [] for key in kv})
            for key, val in kv.items():
                lists[key].append(val)

    x, _ = _run_stack(params, cfg, plan, x, positions=positions,
                      caches=self_caches, cache_pos=pos, xattn_kv=xattn_kv,
                      on_kv=collect)
    for sub in new["blocks"].values():
        for key in sub:
            sub[key] = torch.stack(sub[key])
    x = pin_batch(L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps))
    logits = L.unembed(params["embed"], cfg, x)
    if _is_paged(self_caches):
        return logits, new
    self_caches = _merge_decode_updates(new, self_caches, pos)
    if cfg.encoder_decoder:
        return logits, {"self": self_caches, "cross": xattn_kv}
    return logits, self_caches


def _fill(buf, val) -> None:
    """A prompt's K/V (B, S, H, D) into a cache buffer's first S rows, or
    a mamba state whole."""
    if val.shape[1] != buf.shape[1]:
        buf = buf[:, :val.shape[1]]
    buf.copy_(val.to(buf.dtype))


def _is_paged(caches) -> bool:
    return any(isinstance(c, L.PagedKV)
               for part in ("prefix", "blocks")
               for c in caches[part].values())


def _merge_decode_updates(new_caches, caches, cache_pos):
    """Write each attention layer's S new K/V token rows into the dense
    cache buffers, in place, and replace each mamba layer's state (it is
    small, so it is carried whole); returns ``caches``.  A scalar
    ``cache_pos`` writes every row at that position, a (B,) one each slot
    at its own.  As the JAX package's dynamic-update-slice, a start past
    ``Smax - S`` is clamped so the S rows fit."""
    for part, stacked in (("prefix", False), ("blocks", True)):
        for name, c in new_caches[part].items():
            if "k_new" not in c:             # mamba state
                for key, val in c.items():
                    caches[part][name][key].copy_(val)
                continue
            for key, nk in (("k", "k_new"), ("v", "v_new")):
                buf = caches[part][name][key]
                upd = c[nk].to(buf.dtype)                # (·, B, S, H, D)
                s, smax = upd.shape[-3], buf.shape[-3]
                start = cache_pos.long().clamp(min=0, max=smax - s)
                dtensor_step.write_rows(_write_rows, buf, upd, start, stacked)
    return caches


def _write_rows(buf, upd, start, stacked: bool) -> None:
    """``upd``'s S rows into ``buf`` from ``start``: a scalar writes every
    slot's rows there, a (B,) one each slot's at its own."""
    s = upd.shape[-3]
    p = start[..., None] + torch.arange(s, device=start.device)
    if start.dim() == 0:
        if stacked:
            buf[:, :, p] = upd
        else:
            buf[:, p] = upd
        return
    rows = torch.arange(start.shape[0], device=start.device)
    if stacked:
        buf[:, rows[:, None], p] = upd
    else:
        buf[rows[:, None], p] = upd


# ---------------------------------------------------------------------------
# Cache construction (the serving arena and prefill outputs)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device="cuda"):
    """Zeroed caches: bf16 K/V (B, max_len, Hkv, D) per attention layer,
    a zeroed state per mamba layer, block layers stacked on a leading
    ``n_blocks`` axis; whisper's are ``{"self", "cross"}``, the cross K/V
    (B, enc_len or max_len, Hkv, D) per decoder layer."""
    plan = plan_stack(cfg)
    hd = cfg.resolved_head_dim

    def kv(keys, length, n=None):
        full = ((n,) if n else ()) + (batch, length, cfg.kv_heads, hd)
        return {k: torch.zeros(full, dtype=COMPUTE_DTYPE, device=device)
                for k in keys}

    def layer_cache(spec, n=None):
        if spec.kind == "attn":
            return kv(("k", "v"), max_len, n)
        return S.init_mamba_state(cfg, batch, device=device, n=n)

    def tree(make):
        return {
            "prefix": {f"layer{i}": make(spec, None)
                       for i, spec in enumerate(plan.prefix_specs)},
            "blocks": ({f"layer{j}": make(spec, plan.n_blocks)
                        for j, spec in enumerate(plan.period_specs)}
                       if plan.n_blocks > 0 else {}),
        }

    caches = tree(layer_cache)
    if cfg.encoder_decoder:
        cross = tree(lambda spec, n: kv(("xk", "xv"), enc_len or max_len, n))
        caches = {"self": caches, "cross": cross}
    return caches
