"""The plain forward pass of DeepSeek-V2-Lite (multi-head latent attention
beside deepseek-moe-16b's MoE): float32, TF32 off, one layer at a time,
from the published config's keys (``configs/deepseek-v2-lite.json``).

It reads the weights the benchmark made, in the serving layout (``tok``
(V, d), ``unembed`` (d, V), ``blocks`` stacked on a leading axis), and
follows the published DeepSeek-V2 modelling code:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``;
* attention without query compression (``q_lora_rank`` null): ``wq`` gives
  each head a nope query (``qk_nope_head_dim``) and a rope query
  (``qk_rope_head_dim``); ``wkv_a`` gives the latent (``kv_lora_rank``),
  RMS-normed by ``kv_norm``, and one rope key shared by all heads;
  ``wkv_b`` lifts the latent to each head's nope key and value
  (``v_head_dim``); scores over nope and rope together, scaled by
  ``(qk_nope + qk_rope)^-1/2 * mscale(mscale_all_dim)^2``;
* YaRN RoPE (``rope_scaling``): the inverse frequencies blend the
  original and the ``factor``-interpolated ones by a linear ramp between
  the correction dims of ``beta_fast`` and ``beta_slow`` rotations over
  ``original_max_position_embeddings``, cos and sin times
  ``mscale(mscale) / mscale(mscale_all_dim)``; RoPE rotates halves of the
  rope dims (the published code de-interleaves pairs first: with seeded
  weights the same map up to a fixed permutation of ``wq``'s and
  ``wkv_a``'s rope columns, and the port rotates halves too);
* a SiLU-gated MLP, ``intermediate_size`` wide in the first
  ``first_k_dense_replace`` layers; after them a softmax router over the
  ``n_routed_experts``, the top ``num_experts_per_tok`` by a stable
  descending sort, their weights renormalised only where
  ``norm_topk_prob`` says so and scaled by ``routed_scaling_factor``, and
  the shared experts as one MLP of their summed width.  In the prompt pass
  a batch row's tokens queue per expert in position order and the first
  ``ceil(S k / E * capacity_factor)`` are kept (the port's capacity, a
  departure); decode runs one token a row a step, which no capacity cuts.

Attention is computed in the expanded form, in blocks of queries, so that
eight 8k-token prompts fit on the card.  ``forward`` runs the prompt,
quantizes its cache by the request's profile, then runs the served tokens
over that cache, so the continuation sees what the serving path's decode
saw.  ``lowp`` rounds both operands of every product to fp8 e4m3
(``decoder.Plain``): the benchmark's control.

This file is the module of the configurations whose ``"reference"`` key
names it (``kvb.spec.load_model`` lists what a module provides).  Their
cache has two parts a layer, of unequal width: the normed latent (1, S,
kv_lora_rank) and the rotated rope key (1, S, qk_rope_head_dim) a
request.  A profile's ``key_bits`` apply to the latent and its
``value_bits`` to the rope key; a per-token group wider than a part is
clamped to the part's width.  It imports nothing of the program: the
harness hands ``landed_parts`` and ``warm_cache`` the objects they read.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from reference import decoder, quant

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Q_BLOCK = 512      # queries a block of the attention


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: Dict, device) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse
    frequencies, in f64."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    freq_extra = 1.0 / base ** (2 * i / dim)
    freq_inter = freq_extra / factor
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
         mscale: float) -> torch.Tensor:
    """x (B, S, H, D); pos (S,) int; halves rotated."""
    half = x.shape[-1] // 2
    ang = pos.double()[:, None] * inv[None]
    cos = (torch.cos(ang) * mscale).float()[None, :, None]
    sin = (torch.sin(ang) * mscale).float()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(P: decoder.Plain, q, k, v, q_pos, k_pos,
              scale: float) -> torch.Tensor:
    """q, k (B, S, H, Dqk), v (B, Sk, H, Dv): causal by position, in
    blocks of Q_BLOCK queries."""
    out = []
    for i in range(0, q.shape[1], Q_BLOCK):
        qb, pb = q[:, i:i + Q_BLOCK], q_pos[i:i + Q_BLOCK]
        s = P.ein("bqhd,bkhd->bhqk", qb, k) * scale
        mask = k_pos[None, :] <= pb[:, None]
        s = s.masked_fill(~mask[None, None], float("-inf"))
        out.append(P.ein("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v))
        del s
    return torch.cat(out, dim=1)


def moe(P: decoder.Plain, cfg: Dict, p, x: torch.Tensor,
        capacity: bool) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the routed experts and the shared ones."""
    b, s, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(P.ein("bsd,de->bse", x, p["router"]), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = vals[..., :k], ids[..., :k]
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    w = w * cfg["routed_scaling_factor"]
    kept = torch.ones_like(ids, dtype=torch.bool)
    if capacity:
        cap = min(max(int(math.ceil(s * k / e * cfg["capacity_factor"])), 1),
                  s)
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
        y.index_add_(0, rows, decoder.mlp(P, ep, xf[rows])
                     * wf[rows, slot, None])
    y = y + decoder.mlp(P, p["shared"], xf)
    return y.reshape(b, s, d)


def _check_shapes(cfg: Dict, params) -> None:
    """The weights have the published widths, or the run fails."""
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    nope, rp, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("the reference has no query compression")
    lp0 = decoder._layer_params(params, 0)
    want = {"wq": (d, h, nope + rp), "wkv_a": (d, r + rp), "kv_norm": (r,),
            "wkv_b": (r, h, nope + vd), "wo": (h, vd, d)}
    got = {n: tuple(lp0["mixer"][n].shape) for n in want}
    dense = tuple(lp0["mlp"]["wi_gate"].shape)
    n_layers = len(params["prefix"]) + len(params["blocks"]) * (
        next(iter(params["blocks"].values()))["ln1"]["scale"].shape[0]
        if params["blocks"] else 0)
    if (got != want or dense != (d, cfg["intermediate_size"])
            or n_layers != cfg["num_hidden_layers"]
            or tuple(params["embed"]["tok"].shape)
            != (cfg["vocab_size"], d)):
        raise ValueError(f"weights {got}, dense {dense}, {n_layers} layers: "
                         f"not the published widths {want}")


def _qdq(x: torch.Tensor, strategy: Dict) -> torch.Tensor:
    """``quant.qdq`` of one part, its group clamped to the part's width."""
    return quant.qdq(x, dict(strategy, group_size=min(strategy["group_size"],
                                                      x.shape[-1])))


def forward(cfg: Dict, params, prompts: torch.Tensor, cont: torch.Tensor,
            strategies: Sequence[Dict], lowp: bool = False,
            on_kv: Optional[Callable[[int, Tuple[torch.Tensor, ...]],
                                     None]] = None):
    """prompts (B, S0) and served tokens cont (B, S1) int64 on the weights'
    device.  Returns (first-token logits (B, V), logits after each served
    token (B, S1, V)), float32.  ``on_kv(layer, (latent, rope))`` receives
    each layer's prompt cache after the request's profile, (B, S0, 1, W)."""
    _check_shapes(cfg, params)
    P = decoder.Plain(lowp)
    dev = prompts.device
    eps = cfg["rms_norm_eps"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rs = cfg["rope_scaling"]
    inv = yarn_inv_freq(cfg, dev)
    mcs = (yarn_mscale(float(rs["factor"]), rs["mscale"])
           / yarn_mscale(float(rs["factor"]), rs["mscale_all_dim"]))
    scale = softmax_scale(cfg)
    b, s0 = prompts.shape
    s1 = cont.shape[1]
    tok = params["embed"]["tok"]
    x0, x1 = tok[prompts].float(), tok[cont].float()
    pos0 = torch.arange(s0, device=dev)
    pos1 = torch.arange(s0, s0 + s1, device=dev)
    pos_all = torch.cat([pos0, pos1])

    def expand(mx, c, k_pe):
        """Each head's key (nope from the latent, the shared rope key) and
        value, from the latent c (B, S, r) and k_pe (B, S, 1, rope)."""
        kvb = P.ein("bsc,chk->bshk", c, mx["wkv_b"])
        k = torch.cat([kvb[..., :nope],
                       k_pe.expand(-1, -1, kvb.shape[2], -1)], dim=-1)
        return k, kvb[..., nope:]

    for i in range(cfg["num_hidden_layers"]):
        lp = decoder._f32(decoder._layer_params(params, i))
        mx = lp["mixer"]
        proj = []
        for x, pos in ((x0, pos0), (x1, pos1)):
            h = decoder.rmsnorm(x, lp["ln1"]["scale"], eps)
            q = P.ein("bsd,dhk->bshk", h, mx["wq"])
            kv = P.ein("bsd,dk->bsk", h, mx["wkv_a"])
            c = decoder.rmsnorm(kv[..., :r], mx["kv_norm"], eps)
            k_pe = rope(kv[..., None, r:], pos, inv, mcs)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, inv, mcs)],
                          dim=-1)
            proj.append((q, c, k_pe))
        (q0, c0, pe0), (q1, c1, pe1) = proj
        k0, v0 = expand(mx, c0, pe0)
        a0 = attention(P, q0, k0, v0, pos0, pos0, scale)
        del k0, v0
        cq = torch.stack([_qdq(c0[j], strategies[j]) for j in range(b)])
        peq = torch.stack([_qdq(pe0[j], strategies[j]) for j in range(b)])
        if on_kv is not None:
            on_kv(i, (cq[:, :, None], peq))
        kq, vq = expand(mx, torch.cat([cq, c1], 1), torch.cat([peq, pe1], 1))
        a1 = attention(P, q1, kq, vq, pos1, pos_all, scale)
        del kq, vq
        x0 = x0 + P.ein("bshk,hkd->bsd", a0, mx["wo"])
        x1 = x1 + P.ein("bshk,hkd->bsd", a1, mx["wo"])
        outs = []
        for x, cap in ((x0, True), (x1, False)):
            h = decoder.rmsnorm(x, lp["ln2"]["scale"], eps)
            if "router" in lp["mlp"]:
                y = moe(P, cfg, lp["mlp"], h, capacity=cap)
            else:
                y = decoder.mlp(P, lp["mlp"], h.reshape(-1, h.shape[-1])
                                ).reshape(h.shape)
            outs.append(x + y)
        x0, x1 = outs
        del lp
    fn = params["final_norm"]["scale"]
    w = params["embed"]["unembed"].float()
    first = P.ein("bd,dv->bv", decoder.rmsnorm(x0[:, -1], fn, eps), w)
    rest = P.ein("bsd,dv->bsv", decoder.rmsnorm(x1, fn, eps), w)
    return first, rest


# -- the rest of the module's contract ---------------------------------------
supported = quant.supported
payload_bytes = quant.payload_bytes
landed_parts = decoder.landed_parts


def _bucket(w, shape, device) -> torch.Tensor:
    """One per-token bucket of a part of ``shape`` (L, H, S, W), f32: the
    packed unsigned codes (big-endian bit order, offset 2**(bits-1)) times
    their fp16 group scales, the group clamped to W."""
    raw = torch.frombuffer(bytearray(w.payload), dtype=torch.uint8).to(device)
    if w.bits == 8:
        u = raw.to(torch.int16)
    elif w.bits == 4:
        u = torch.stack([raw >> 4, raw & 0x0F], -1).reshape(-1) \
            .to(torch.int16)
    else:
        raise ValueError(f"{w.bits}-bit payload")
    nb, s, d = w.codes_shape
    g = min(w.group_size, d)
    codes = (u[:nb * s * d] - (1 << (w.bits - 1))).float()
    sc = torch.as_tensor(np.asarray(w.scale, dtype=np.float16)
                         .astype(np.float32)).to(device)
    vals = (codes.reshape(nb, s, d // g, g)
            * sc.reshape(nb, s, d // g, 1)).reshape(nb, s, d)
    full = torch.zeros(shape, dtype=torch.float32, device=device)
    lh = torch.as_tensor(np.asarray(w.lh_index), dtype=torch.long,
                         device=device)
    full[lh[:, 0], lh[:, 1]] = vals
    return full


def payload_parts(payload, device) -> tuple:
    """(latent, rope key) float32 (L, 1, S, W) on ``device``, decoded from a
    wire payload with this file's arithmetic: fp16 pass-through bytes, the
    latent's first, or one per-token bucket a part."""
    shapes = [tuple(int(x) for x in payload.shape)]
    shapes.append(tuple(int(x) for x in (payload.v_shape or payload.shape)))
    if payload.identity_payload is not None:
        n = [int(np.prod(sh)) for sh in shapes]
        raw = torch.frombuffer(bytearray(payload.identity_payload),
                               dtype=torch.float16, count=sum(n))
        flat = raw.to(device).float()
        return (flat[:n[0]].reshape(shapes[0]),
                flat[n[0]:].reshape(shapes[1]))
    out = []
    for buckets, sh in zip((payload.k_buckets, payload.v_buckets), shapes):
        if len(buckets) != 1:
            raise ValueError("a per-token payload has one bucket a part")
        out.append(_bucket(buckets[0], sh, device))
    return tuple(out)


def warm_cache(cfg: Dict, seq: int, device, pipeline):
    """A request's cache at ``seq`` positions, (L, 1, S, W) bf16 latent and
    rope key drawn on ``device``, as the program's
    ``pipeline.DeviceKVCache``: what set-up compresses and decompresses
    once a profile."""
    lead = (cfg["num_hidden_layers"], 1, seq)
    gen = torch.Generator(device=device).manual_seed(1)
    return pipeline.DeviceKVCache(*(
        torch.randn(lead + (w,), generator=gen, device=device,
                    dtype=torch.bfloat16)
        for w in (cfg["kv_lora_rank"], cfg["qk_rope_head_dim"])))


def sizes(cfg: Dict) -> Dict[str, int]:
    """The counts ``kvb.counts`` sums (``decoder.sizes`` says what each
    is), from the published config, with attention in the absorbed form
    the decode step reads: a cached position is the latent and the rope
    key (576 elements at the published widths), scored by each head over
    both and summed over the latent (2 x 16 x (576 + 512) flops); a
    decoding slot reads each head's query over both and writes its output
    over the latent, 16 x (576 + 512) elements, and 2 statistics a head."""
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    nope, rp, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    f = cfg["moe_intermediate_size"]
    attn = d * h * (nope + rp) + d * (r + rp) + r * h * (nope + vd) \
        + h * vd * d
    n = 0
    for i in range(cfg["num_hidden_layers"]):
        n += attn
        if i >= cfg["first_k_dense_replace"]:
            n += d * cfg["n_routed_experts"]
            n += cfg["num_experts_per_tok"] * 3 * d * f
            n += 3 * d * f * cfg["n_shared_experts"]
        else:
            n += 3 * d * cfg["intermediate_size"]
    unembed = d * cfg["vocab_size"]
    return {"weights_per_token": n + unembed, "unembed": unembed,
            "attn_layers": int(cfg["num_hidden_layers"]),
            "attn_flops_per_position": 2 * h * (r + rp + r),
            "cache_elems_per_position": r + rp,
            "query_elems_per_slot": h * (r + rp + r),
            "stat_elems_per_slot": 2 * h}


def init_scale(path: Tuple[str, ...], shape: Tuple[int, ...]) -> float:
    """The standard deviation ``kvb.weights`` draws the leaf at ``path``
    with: 1 for the token table, 0 (zeros) for the RMSNorm scales (the
    latent's ``kv_norm`` among them), else 1/sqrt(fan-in), the fan-in of a
    routed expert's matrix and of a stacked block leaf taken without its
    leading axis, of ``wq`` and ``wkv_b`` their first axis."""
    name = path[-1]
    if name == "tok":
        return 1.0
    if name in ("scale", "kv_norm"):
        return 0.0
    core = shape[1:] if path[0] == "blocks" else shape
    if "mlp" in path and name in ("wi_gate", "wi_up", "wo") \
            and len(core) == 3:
        core = core[1:]                     # a routed expert's matrix
    fan_in = core[0] if name in ("wq", "wkv_b") else math.prod(core[:-1])
    return 1.0 / math.sqrt(fan_in)
