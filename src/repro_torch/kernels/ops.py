"""Public wrappers of the Hopper kernels.

``interpret=None`` resolves from the tensor's device: a CPU tensor takes
the plain PyTorch version in ``ref.py``, a CUDA tensor launches the CUDA
kernel (building it on first use) or raises.  ``interpret=True`` asks for
the plain version on any device; ``interpret=False`` insists on the
kernel.  There is no silent fallback: a kernel that does not build or
launch raises.

Every wrapper carries ``launches``, a plain integer it adds one to each
time it launches its kernel (and at no other time), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

# Dynamic shared memory a Hopper block may use.
_MAX_SMEM = 232_448


def _use_kernel(t: torch.Tensor, interpret: Optional[bool]) -> bool:
    if interpret is None:
        return t.is_cuda
    if interpret:
        return False
    if not t.is_cuda:
        raise ValueError("interpret=False launches the CUDA kernel, which "
                         "needs CUDA tensors")
    return True


def _check(t: torch.Tensor, name: str, dtypes, device: torch.device,
           shape: Optional[Tuple[int, ...]] = None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _launch(lib: str, fn: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(build.load(lib), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _smem_bytes(gq: int, d: int, pps: int, ps: int) -> int:
    return 4 * (gq * d + gq * pps * ps + 4) + 4 * pps


# ---------------------------------------------------------------------------
def quant_pack_op(x: torch.Tensor, bits: int = 8, group: int = 64,
                  interpret: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused symmetric group-quantize + pack.  x (T, D) bf16/f32 ->
    (codes (T, D) int8 or (T, D/2) uint8 nibbles, scales (T, D/group) f32)."""
    if bits not in (4, 8) or group % 2 or x.dim() != 2 \
            or x.shape[1] % group:
        raise ValueError(f"quant_pack: bits={bits} group={group} "
                         f"x{tuple(x.shape)}")
    if not _use_kernel(x, interpret):
        return ref.quant_pack_ref(x, bits, group)
    _check(x, "x", (torch.float32, torch.bfloat16), x.device)
    t, d = x.shape
    codes = torch.empty((t, d if bits == 8 else d // 2),
                        dtype=torch.int8 if bits == 8 else torch.uint8,
                        device=x.device)
    scales = torch.empty((t, d // group), dtype=torch.float32,
                         device=x.device)
    _launch("quant_pack", "quant_pack", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scales.data_ptr(), t, d, bits, group)
    quant_pack_op.launches += 1
    return codes, scales


def dequant_unpack_op(codes: torch.Tensor, scales: torch.Tensor,
                      bits: int = 8, group: int = 64,
                      out_dtype: torch.dtype = torch.bfloat16,
                      interpret: Optional[bool] = None) -> torch.Tensor:
    """Unpack + dequantize: codes (T, D) int8 or (T, D/2) uint8, scales
    (T, D/group) f32 -> (T, D) ``out_dtype`` (f32 or bf16)."""
    if bits not in (4, 8) or group % 2 or codes.dim() != 2:
        raise ValueError(f"dequant_unpack: bits={bits} group={group} "
                         f"codes{tuple(codes.shape)}")
    if not _use_kernel(codes, interpret):
        return ref.dequant_unpack_ref(codes, scales, bits, group,
                                      dtype=out_dtype)
    t = codes.shape[0]
    d = codes.shape[1] * (2 if bits == 4 else 1)
    if d % group or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dequant_unpack: D={d} group={group} "
                         f"out_dtype={out_dtype}")
    _check(codes, "codes", (torch.int8,) if bits == 8 else (torch.uint8,),
           codes.device)
    _check(scales, "scales", (torch.float32,), codes.device, (t, d // group))
    out = torch.empty((t, d), dtype=out_dtype, device=codes.device)
    _launch("dequant_unpack", "dequant_unpack", codes.device,
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), t, d, bits, group)
    dequant_unpack_op.launches += 1
    return out


def paged_attention_op(q: torch.Tensor, k_codes: torch.Tensor,
                       k_scale: torch.Tensor, v_codes: torch.Tensor,
                       v_scale: torch.Tensor, block_tables: torch.Tensor,
                       kv_lens: torch.Tensor, bits: int = 8, group: int = 64,
                       interpret: Optional[bool] = None) -> torch.Tensor:
    """Paged quantized decode attention, the Pallas kernel's interface:
    q (B, Hkv, Gq, D); code pools (P, Hkv, PS, D) int8 or (P, Hkv, PS,
    D/2) uint8 with (P, Hkv, PS, D/group) f32 scales; block_tables
    (B, PPS) int32 (0 = the scratch page); kv_lens (B,) int32, each >= 1.
    Returns the normalized (B, Hkv, Gq, D) output in q's dtype."""
    if not _use_kernel(q, interpret):
        return ref.paged_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                       block_tables, kv_lens, bits, group)
    b, hkv, gq, d = q.shape
    p, _, ps, _ = k_codes.shape
    pps = block_tables.shape[1]
    cw = d if bits == 8 else d // 2
    cdt = (torch.int8,) if bits == 8 else (torch.uint8,)
    dev = q.device
    _check(q, "q", (torch.float32, torch.bfloat16), dev)
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _check(t, name, cdt, dev, (p, hkv, ps, cw))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t, name, (torch.float32,), dev, (p, hkv, ps, d // group))
    _check(block_tables, "block_tables", (torch.int32,), dev, (b, pps))
    _check(kv_lens, "kv_lens", (torch.int32,), dev, (b,))
    if bits not in (4, 8) or d % group or gq > 16 \
            or _smem_bytes(gq, d, pps, ps) > _MAX_SMEM:
        raise ValueError(f"paged_attention: bits={bits} group={group} "
                         f"Gq={gq} D={d} PPS*PS={pps * ps}")
    out = torch.empty_like(q)
    _launch("paged_attention", "paged_attention", dev, q.data_ptr(),
            int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            b, hkv, gq, d, pps, ps, bits, group, 1.0 / math.sqrt(d))
    paged_attention_op.launches += 1
    return out


def paged_attention_arena_op(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_codes: torch.Tensor, k_scale: torch.Tensor, v_codes: torch.Tensor,
    v_scale: torch.Tensor, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, quant_lens: torch.Tensor,
    interpret: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged decode attention over one layer of the serving arena:
    q (B, Hkv, Gq, D) bf16; fp pools (P, PS, Hkv, D) bf16; quant pools
    (P, PS, Hkv, D) int8 codes and f32 per-channel scales; block_tables
    (B, PPS) int32; kv_lens (B,) int32 (positions < kv_lens are seen);
    quant_lens (B,) int32 (positions < quant_lens read the quant pool).
    Returns (unnormalized bf16 out (B, Hkv, Gq, D), f32 m, f32 l
    (B, Hkv, Gq)) for the caller's closed-form merge of the new token."""
    if not _use_kernel(q, interpret):
        return ref.paged_attention_arena_ref(
            q, k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
            block_tables, kv_lens, quant_lens)
    b, hkv, gq, d = q.shape
    p, ps = k_pool.shape[:2]
    pps = block_tables.shape[1]
    dev = q.device
    pool_shape = (p, ps, hkv, d)
    _check(q, "q", (torch.bfloat16,), dev)
    for name, t, dt in (("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16),
                        ("k_codes", k_codes, torch.int8),
                        ("v_codes", v_codes, torch.int8),
                        ("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32)):
        _check(t, name, (dt,), dev, pool_shape)
    _check(block_tables, "block_tables", (torch.int32,), dev, (b, pps))
    _check(kv_lens, "kv_lens", (torch.int32,), dev, (b,))
    _check(quant_lens, "quant_lens", (torch.int32,), dev, (b,))
    if gq > 16 or _smem_bytes(gq, d, pps, ps) > _MAX_SMEM:
        raise ValueError(f"paged_attention_arena: Gq={gq} D={d} "
                         f"PPS*PS={pps * ps}")
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, gq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, gq), dtype=torch.float32, device=dev)
    _launch("paged_attention", "paged_attention_arena", dev, q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(),
            quant_lens.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, hkv, gq, d, pps, ps, 1.0 / math.sqrt(d))
    paged_attention_arena_op.launches += 1
    return out, m, l


KERNEL_OPS = (quant_pack_op, dequant_unpack_op, paged_attention_op,
              paged_attention_arena_op)
for _op in KERNEL_OPS:
    _op.launches = 0


def reset_launches() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launches() -> Dict[str, int]:
    return {op.__name__: op.launches for op in KERNEL_OPS}
