"""The plain forward pass of the benchmark's decoder configurations
(deepseek-moe-16b, qwen3-4b): float32, TF32 off, one layer at a time.

It reads the weights the benchmark made, in the serving layout (embedding
``tok`` (V, d), ``unembed`` (d, V), ``prefix`` layers and a stack of
``blocks`` with a leading layer axis), and follows the configuration
file's equations:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, over d and, for
  qk-norm, over each head's D before RoPE;
* RoPE by rotating halves, inverse frequencies ``theta^(-i / (D/2))``;
* grouped-query attention, query head h reading KV head ``h // (H/Hkv)``,
  scores scaled by ``D^-1/2``;
* a SiLU-gated MLP; for MoE layers a softmax router over every expert,
  the top k by a stable descending sort with their weights renormalised,
  and shared experts as one MLP of their summed width.  In the prompt
  pass a batch row's tokens queue per expert in position order and the
  first ``ceil(S k / E * capacity_factor)`` are kept (the port's
  capacity); decode runs one token a row a step, which no capacity cuts.

``forward`` runs the prompt, quantizes its KV by the request's profile
(``quant.qdq``), then runs the served tokens over that KV, so the
continuation sees what the serving path's decode saw.  ``lowp`` rounds
both operands of every product to fp8 e4m3 (per-tensor scale): the
benchmark's control.

This file is the module of the configurations whose ``"reference"`` key
names it (``kvb.spec.load_model`` lists what a module provides).  Their
cache has two parts a layer, K and V, each (Hkv, S, D) a request; the
wire payload, its byte count and the check of a profile's arithmetic are
``quant``'s.  The helpers that read or build the program's own objects
(``landed_parts``, ``warm_cache``) import nothing of it: the harness hands
them the objects.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from reference import quant

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Plain:
    """Products in f32, or through fp8 operands for the control."""

    def __init__(self, lowp: bool):
        self.lowp = lowp

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.lowp:
            a, b = _fp8(a), _fp8(b)
        return torch.einsum(eq, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D); pos (S,) int."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[None, :, None]
    sin = torch.sin(ang).float()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(P: Plain, q, k, v, q_pos, k_pos) -> torch.Tensor:
    """q (B, Sq, H, D), k / v (B, Sk, Hkv, D): causal by position."""
    h, hkv = q.shape[2], k.shape[2]
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = P.ein("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = k_pos[None, :] <= q_pos[:, None]
    s = s.masked_fill(~mask[None, None], float("-inf"))
    return P.ein("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def mlp(P: Plain, p, x: torch.Tensor) -> torch.Tensor:
    g = P.ein("nd,df->nf", x, p["wi_gate"])
    u = P.ein("nd,df->nf", x, p["wi_up"])
    return P.ein("nf,fd->nd", torch.nn.functional.silu(g) * u, p["wo"])


def moe(P: Plain, cfg: Dict, p, x: torch.Tensor,
        capacity: bool) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    probs = torch.softmax(P.ein("bsd,de->bse", x, p["router"]), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = vals[..., :k], ids[..., :k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = torch.ones_like(ids, dtype=torch.bool)
    if capacity:
        cap = max(int(math.ceil(s * k / e * cfg["capacity_factor"])), 1)
        cap = min(cap, s)
        member = torch.zeros((b, s, e), device=x.device)
        member.scatter_(2, ids, 1.0)
        queue = torch.cumsum(member, dim=1) - member
        kept = queue.gather(2, ids) < cap
    xf, wf, idf, kf = (x.reshape(-1, d), w.reshape(-1, k),
                       ids.reshape(-1, k), kept.reshape(-1, k))
    y = torch.zeros_like(xf)
    for ex in range(e):
        rows, slot = torch.nonzero((idf == ex) & kf, as_tuple=True)
        if rows.numel() == 0:
            continue
        ep = {name: p[name][ex] for name in ("wi_gate", "wi_up", "wo")}
        y.index_add_(0, rows, mlp(P, ep, xf[rows]) * wf[rows, slot, None])
    if "shared" in p:
        y = y + mlp(P, p["shared"], xf)
    return y.reshape(b, s, d)


def _layer_params(params, i: int):
    """Layer ``i`` of the serving layout: the ``prefix`` layers, then the
    ``blocks`` of ``period`` layers, each leaf stacked over blocks."""
    n_pre = len(params["prefix"])
    if i < n_pre:
        return params["prefix"][f"layer{i}"]
    j = i - n_pre
    period = len(params["blocks"])
    return _index(params["blocks"][f"layer{j % period}"], j // period)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    return tree[i]


def _f32(tree):
    if isinstance(tree, dict):
        return {key: _f32(val) for key, val in tree.items()}
    return tree.float()


def forward(cfg: Dict, params, prompts: torch.Tensor, cont: torch.Tensor,
            strategies: Sequence[Dict], lowp: bool = False,
            on_kv: Optional[Callable[[int, Tuple[torch.Tensor, ...]],
                                     None]] = None):
    """prompts (B, S0) and served tokens cont (B, S1) int64 on the weights'
    device.  Returns (first-token logits (B, V), logits after each served
    token (B, S1, V)), float32.  ``on_kv(layer, (k, v))`` receives each
    layer's prompt KV after the request's profile, (B, S0, Hkv, D)."""
    P = Plain(lowp)
    dev = prompts.device
    eps, theta = cfg["rmsnorm_eps"], cfg["rope_theta"]
    b, s0 = prompts.shape
    s1 = cont.shape[1]
    tok = params["embed"]["tok"]
    x0 = tok[prompts].float()
    x1 = tok[cont].float()
    pos0 = torch.arange(s0, device=dev)
    pos1 = torch.arange(s0, s0 + s1, device=dev)
    pos_all = torch.cat([pos0, pos1])
    for i in range(cfg["num_layers"]):
        lp = _f32(_layer_params(params, i))
        mx = lp["mixer"]
        outs = []
        kvs = []
        for x, pos in ((x0, pos0), (x1, pos1)):
            h = rmsnorm(x, lp["ln1"]["scale"], eps)
            q = P.ein("bsd,dhk->bshk", h, mx["wq"])
            k = P.ein("bsd,dhk->bshk", h, mx["wk"])
            v = P.ein("bsd,dhk->bshk", h, mx["wv"])
            if cfg.get("qk_norm"):
                q = rmsnorm(q, mx["q_norm"], eps)
                k = rmsnorm(k, mx["k_norm"], eps)
            kvs.append((rope(q, pos, theta), rope(k, pos, theta), v))
        (q0, k0, v0), (q1, k1, v1) = kvs
        a0 = attention(P, q0, k0, v0, pos0, pos0)
        kq = torch.stack([quant.qdq(k0[r], strategies[r]) for r in range(b)])
        vq = torch.stack([quant.qdq(v0[r], strategies[r]) for r in range(b)])
        if on_kv is not None:
            on_kv(i, (kq, vq))
        a1 = attention(P, q1, torch.cat([kq, k1], 1), torch.cat([vq, v1], 1),
                       pos1, pos_all)
        x0 = x0 + P.ein("bshk,hkd->bsd", a0, mx["wo"])
        x1 = x1 + P.ein("bshk,hkd->bsd", a1, mx["wo"])
        if "ln2" in lp:
            for j, (x, cap) in enumerate(((x0, True), (x1, False))):
                h = rmsnorm(x, lp["ln2"]["scale"], eps)
                if "router" in lp["mlp"]:
                    y = moe(P, cfg, lp["mlp"], h, capacity=cap)
                else:
                    y = mlp(P, lp["mlp"], h.reshape(-1, h.shape[-1])
                            ).reshape(h.shape)
                outs.append(x + y)
            x0, x1 = outs
        del lp
    fn = params["final_norm"]["scale"]
    w = params["embed"].get("unembed")
    w = params["embed"]["tok"].T if w is None else w
    w = w.float()
    first = P.ein("bd,dv->bv", rmsnorm(x0[:, -1], fn, eps), w)
    rest = P.ein("bsd,dv->bsv", rmsnorm(x1, fn, eps), w)
    return first, rest


# -- the rest of the module's contract ---------------------------------------
supported = quant.supported
payload_parts = quant.payload_kv
payload_bytes = quant.payload_bytes


def landed_parts(dw, idx: int, seq: int) -> tuple:
    """The first layer's K and V of decode worker ``dw``'s arena slot
    ``idx``, positions below ``seq``, as (H, S, D) device tensors: the
    pages the slot's block row names, gathered (a copy, so later reuse of
    the pages cannot change it).  The first attention layer is the
    prefix's ``layer0`` where the model has a prefix, else block 0 of
    ``layer0``."""
    import numpy as np

    page = dw.cfg.page_size
    n = -(-seq // page)
    tree = dw._arena
    leaf = tree["prefix"].get("layer0")
    row = np.asarray(dw.page_table.block_row(idx, dw._pps))[:n]
    out = []
    for key in ("k", "v"):
        buf = leaf[key] if leaf is not None else tree["blocks"]["layer0"][key][0]
        rows = torch.as_tensor(row, dtype=torch.long, device=buf.device)
        pages = buf[rows]                       # (n, page, H, D)
        out.append(pages.reshape(n * page, *pages.shape[2:])[:seq]
                   .transpose(0, 1))
    return tuple(out)


def warm_cache(cfg: Dict, seq: int, device, pipeline):
    """A request's KV at ``seq`` positions, (L, Hkv, S, D) bf16 K and V
    drawn on ``device``, as the program's ``pipeline.DeviceKVCache``: what
    set-up compresses and decompresses once a profile."""
    shape = (cfg["num_layers"], cfg["kv_heads"], seq, cfg["head_dim"])
    gen = torch.Generator(device=device).manual_seed(1)
    return pipeline.DeviceKVCache(
        torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16),
        torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16))


def sizes(cfg: Dict) -> Dict[str, int]:
    """The counts ``kvb.counts`` sums, from the configuration file:

    * ``weights_per_token``: weights one token multiplies by in one
      forward: attention projections, the MLP or the router, its k routed
      experts and the shared ones, and the unembedding (the embedding is
      a lookup); ``unembed`` the unembedding's share;
    * ``attn_layers``; per attention layer, ``attn_flops_per_position``,
      QK and PV of one query against one cached position,
      ``cache_elems_per_position``, the elements a position holds (K and
      V), ``query_elems_per_slot``, a decoding slot's query read and
      output written, and ``stat_elems_per_slot``, its f32 statistics
      (m and l a head)."""
    d, h, hkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["kv_heads"],
                     cfg["head_dim"])
    f = cfg["d_ff"]
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    n = 0
    for i in range(cfg["num_layers"]):
        n += attn
        if cfg.get("num_experts", 0) and i >= cfg.get("moe_dense_prefix", 0):
            n += d * cfg["num_experts"]
            n += cfg["experts_per_token"] * 3 * d * f
            n += 3 * d * f * cfg.get("num_shared_experts", 0)
        else:
            n += 3 * d * f
    unembed = d * cfg["vocab_size"]
    return {"weights_per_token": n + unembed, "unembed": unembed,
            "attn_layers": int(cfg["num_layers"]),
            "attn_flops_per_position": 4 * h * hd,
            "cache_elems_per_position": 2 * hkv * hd,
            "query_elems_per_slot": 2 * h * hd,
            "stat_elems_per_slot": 2 * h}


QKV = ("wq", "wk", "wv")


def init_scale(path: Tuple[str, ...], shape: Tuple[int, ...]) -> float:
    """The standard deviation ``kvb.weights`` draws the leaf at ``path``
    (of the port's parameter tree, shape ``shape``) with: 1 for the token
    table, 0 (zeros) for the RMSNorm scales, else 1/sqrt(fan-in), the
    fan-in of a routed expert's matrix and of a stacked block leaf taken
    without its leading axis."""
    name = path[-1]
    if name == "tok":
        return 1.0
    if name in ("scale", "q_norm", "k_norm"):
        return 0.0
    core = shape[1:] if path[0] == "blocks" else shape
    if "mlp" in path and name in ("wi_gate", "wi_up", "wo") \
            and len(core) == 3:
        core = core[1:]                     # a routed expert's matrix
    fan_in = core[0] if name in QKV else math.prod(core[:-1])
    return 1.0 / math.sqrt(fan_in)
