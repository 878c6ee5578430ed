"""Hopper (sm_90a) CUDA kernels for the KV-compression hot paths.

  quant_pack             fused group-quantize + int4/int8 pack (prefill side)
  dequant_unpack         unpack + dequantize (decode side)
  paged_attention        block-table page gather + fused dequant decode
                         attention, the Pallas kernel's interface
  paged_attention_arena  the same kernel over the serving arena's per-layer
                         fp + quant pools, returning (out, m, l) for the
                         decode step's closed-form new-token merge

Each kernel: CUDA C++ in ``csrc/`` built by ``build.py``, a wrapper in
``ops.py`` with a launch counter, and a plain PyTorch version in ``ref.py``.
"""
from repro_torch.kernels.ops import (
    dequant_unpack_op,
    launches,
    paged_attention_arena_op,
    paged_attention_op,
    quant_pack_op,
    reset_launches,
)

__all__ = ["dequant_unpack_op", "paged_attention_arena_op",
           "paged_attention_op", "quant_pack_op", "launches",
           "reset_launches"]
