"""Hopper (sm_90a) CUDA kernels for the KV-compression hot paths.

  quant_pack             fused group-quantize + int4/int8 pack (prefill side)
  dequant_unpack         unpack + dequantize (decode side)
  decode_attention       quantized flash-decode attention over a dense
                         (B, Hkv, S, D) int8/int4 KV cache, the Pallas
                         kernel's interface (no serving path calls it)
  paged_attention        block-table page gather + fused dequant decode
                         attention, the Pallas kernel's interface
  paged_attention_arena  the same kernel over the serving arena's per-layer
                         fp + quant pools, returning (out, m, l) for the
                         decode step's closed-form new-token merge
  paged_verify_attention the speculative verify step's W-token attention
                         (staircase mask), the Pallas kernel's interface
  paged_verify_attention_arena
                         the verify step's read of the arena's committed
                         prefix for W * Gq rows, returning (out, m, l)
  hadamard               x @ H_D with f32 accumulation, the pipeline's
                         Hadamard transform stage (compress and decompress)
  paged_mla_attention    multi-head latent attention's absorbed decode read
                         of the arena's latent and rope pools (DeepSeek-V2),
                         returning (out, m, l) as the arena entries do

Each kernel: CUDA C++ in ``csrc/`` built by ``build.py``, a wrapper in
``ops.py`` with a launch counter, and a plain PyTorch version in ``ref.py``.
"""
from repro_torch.kernels.ops import (
    decode_attention_op,
    dequant_unpack_op,
    hadamard_op,
    launches,
    paged_attention_arena_op,
    paged_attention_op,
    paged_mla_attention_op,
    paged_verify_attention_arena_op,
    paged_verify_attention_op,
    quant_pack_op,
    reset_launches,
)

__all__ = ["decode_attention_op", "dequant_unpack_op", "hadamard_op",
           "paged_attention_arena_op", "paged_attention_op",
           "paged_mla_attention_op",
           "paged_verify_attention_arena_op", "paged_verify_attention_op",
           "quant_pack_op", "launches", "reset_launches"]
