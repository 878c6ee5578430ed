"""The yardstick: operations and bytes the algorithm needs, from the
configuration file's sizes, and the card's published peaks.  Kept with
the benchmark so that a change to the program cannot move it."""
from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA H100 SXM data sheet, dense rates.
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def _attn_layers(cfg: Dict) -> int:
    return int(cfg["num_layers"])


def matmul_params_per_token(cfg: Dict) -> int:
    """Weights one token multiplies by in one forward: attention
    projections, the MLP or the router, its k routed experts and the
    shared ones, and the unembedding (the embedding is a lookup)."""
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
    return n + d * cfg["vocab_size"]


def decode_step_flops(cfg: Dict, contexts: Iterable[int]) -> float:
    """One decode step: for each live slot, 2 x the per-token weights and
    QK and PV over its ``context`` positions (the new token's included)
    in every attention layer."""
    per_tok = 2.0 * matmul_params_per_token(cfg)
    per_pos = 4.0 * cfg["num_heads"] * cfg["head_dim"] * _attn_layers(cfg)
    return sum(per_tok + per_pos * c for c in contexts)


def prefill_flops(cfg: Dict, seq: int) -> float:
    """One prompt of ``seq`` tokens: the weights for every token, the
    unembedding for the last only, causal QK and PV."""
    unembed = cfg["d_model"] * cfg["vocab_size"]
    weights = 2.0 * ((matmul_params_per_token(cfg) - unembed) * seq
                     + unembed)
    attn = (4.0 * cfg["num_heads"] * cfg["head_dim"] * _attn_layers(cfg)
            * seq * (seq + 1) / 2)
    return weights + attn


def paged_attention_bytes(cfg: Dict, kv_lens: Iterable[int],
                          quant_lens: Iterable[int], n_slots: int,
                          pages_per_slot: int, page_size: int) -> float:
    """One decode step's ``paged_attention_arena`` calls, all layers: each
    live slot's K and V positions read once (2 bytes a bf16 element, 5 a
    quant-resident one: int8 code and f32 scale), the scratch page that
    parked slots read once, the queries, block tables and lengths read,
    the output (bf16) and the two f32 statistics written."""
    hkv, hd, h = cfg["kv_heads"], cfg["head_dim"], cfg["num_heads"]
    elems = 0.0
    for kv, ql in zip(kv_lens, quant_lens):
        q_res = min(ql, kv)
        elems += 5 * q_res + 2 * (kv - q_res)
    per_layer = 2 * hkv * hd * elems                  # K and V
    per_layer += 2 * hkv * hd * page_size * 2         # scratch page, K and V
    per_layer += n_slots * h * hd * 2 * 2             # q in, out
    per_layer += n_slots * h * 4 * 2                  # m, l
    per_layer += n_slots * (pages_per_slot + 2) * 4   # tables, lengths
    return per_layer * _attn_layers(cfg)


def quant_pack_bytes(rows: int, dim: int, bits: int, group: int,
                     in_bytes: int) -> float:
    """One ``quant_pack`` call: x read, codes and f32 scales written."""
    return rows * dim * (in_bytes + bits / 8) + rows * (dim // group) * 4
