"""The yardstick: operations and bytes the algorithm needs, from the
configuration file's sizes, and the card's published peaks.  Kept with
the benchmark so that a change to the program cannot move it.  What
depends on the model's layout comes from its module's ``sizes(cfg)``
(``kvb.spec.load_model``), a file of the benchmark too; these are the
sums over a step's slots and a prompt's positions."""
from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA H100 SXM data sheet, dense rates.
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def decode_step_flops(sizes: Dict, contexts: Iterable[int]) -> float:
    """One decode step: for each live slot, 2 x the per-token weights and
    QK and PV over its ``context`` positions (the new token's included)
    in every attention layer."""
    per_tok = 2.0 * sizes["weights_per_token"]
    per_pos = 1.0 * sizes["attn_flops_per_position"] * sizes["attn_layers"]
    return sum(per_tok + per_pos * c for c in contexts)


def prefill_flops(sizes: Dict, seq: int) -> float:
    """One prompt of ``seq`` tokens: the weights for every token, the
    unembedding for the last only, causal QK and PV."""
    unembed = sizes["unembed"]
    weights = 2.0 * ((sizes["weights_per_token"] - unembed) * seq
                     + unembed)
    attn = (1.0 * sizes["attn_flops_per_position"] * sizes["attn_layers"]
            * seq * (seq + 1) / 2)
    return weights + attn


def paged_attention_bytes(sizes: Dict, kv_lens: Iterable[int],
                          quant_lens: Iterable[int], n_slots: int,
                          pages_per_slot: int, page_size: int) -> float:
    """One decode step's ``paged_attention_arena`` calls, all layers: each
    live slot's cached positions read once (2 bytes a bf16 element, 5 a
    quant-resident one: int8 code and f32 scale), the scratch page that
    parked slots read once, the queries, block tables and lengths read,
    the output (bf16) and the f32 statistics written."""
    cache = sizes["cache_elems_per_position"]
    elems = 0.0
    for kv, ql in zip(kv_lens, quant_lens):
        q_res = min(ql, kv)
        elems += 5 * q_res + 2 * (kv - q_res)
    per_layer = cache * elems                         # cached positions
    per_layer += cache * page_size * 2                # scratch page
    per_layer += n_slots * sizes["query_elems_per_slot"] * 2   # q in, out
    per_layer += n_slots * sizes["stat_elems_per_slot"] * 4    # m, l
    per_layer += n_slots * (pages_per_slot + 2) * 4   # tables, lengths
    return per_layer * sizes["attn_layers"]


def quant_pack_bytes(rows: int, dim: int, bits: int, group: int,
                     in_bytes: int) -> float:
    """One ``quant_pack`` call: x read, codes and f32 scales written."""
    return rows * dim * (in_bytes + bits / 8) + rows * (dim // group) * 4
