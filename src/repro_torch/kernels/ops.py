"""Public wrappers of the Hopper kernels.

``interpret=None`` resolves from the tensor's device: a CPU tensor takes
the plain PyTorch version in ``ref.py``, a CUDA tensor launches the CUDA
kernel (building it on first use) or raises.  ``interpret=True`` asks for
the plain version on any device; ``interpret=False`` insists on the
kernel.  There is no silent fallback: a kernel that does not build or
launch raises.

Every wrapper carries ``launches``, a plain integer it adds one to each
time it launches its kernel (and at no other time), so a run can show
that its main path went through the kernels.  The paged attention
wrappers count one per call although a call issues two CUDA kernels
(the split design's phases A and B).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

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
    # The raw handle of the current stream: building a torch Stream object
    # costs ~6 us of host time per call (H100 machine, torch 2.11), and the
    # paged attention wrappers run once per layer per decode step.
    with torch.cuda.device(device):
        rc = getattr(build.load(lib), fn)(
            *args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


# What the paged attention kernels take, and why.  Both share
# csrc/paged_split.cuh's design, two CUDA launches per wrapper call (the
# launch counter still adds one per call).  Phase A cuts each slot's view
# into chunks of 16-128 positions across blocks and writes every row's
# scores and each chunk's max to an f32 workspace allocated here: (B, Hkv,
# rows, PPS*PS rounded up to 4) scores, then (B, Hkv, rows,
# ceil(PPS*PS / 16)) chunk maxima.  Phase B takes each row's exact max
# from the chunk maxima and sums p * v per (slot, KV head, 16 channels)
# over the positions in order, so the arena entries keep ref.py's
# rounding points and sums.  A block reads only its chunk's or stage's
# block-table entries and rows go to tiles of 32 on a second grid axis,
# so neither the view, the block table nor the rows have a cap but device
# memory.  The bound is bytes (every visible K and V element read once);
# what still holds the kernels back is latency (phase A's loads and dot
# products do not overlap; phase B's stages are barrier-separated steps in
# few warps) and the arena's f32 per-channel scales (5 bytes per
# quant-resident element).  What they refuse:
#   * D not a multiple of 16 in [16, 512]: 8-channel vector units, phase
#     B's 16-channel slices, a tile's q in shared memory;
#   * an empty block table (PPS < 1);
#   * pools not 16-byte aligned (vector loads).
# decode_attention splits each slot's positions into blocks of
# _DECODE_SPLIT and gives each thread four channels of p * v: D a multiple
# of 4, at most 512.
_SPLIT_MIN_CHUNK = 16      # paged_split.cuh's kMinChunk
_DECODE_SPLIT = 64         # decode_attention.cu's kSplit


def _arena_entry(fn: str, window: int, softcap: float):
    """(C function, its last arguments before the stream) of an arena
    entry.  A window or a softcap takes the ``_window_cap`` entry, whose
    kernels apply them under a template flag; without either, the call
    runs the same kernels as before the two existed."""
    if window or softcap:
        return fn + "_window_cap", (int(window), float(softcap))
    return fn, ()


def _check_paged_shape(name: str, rows: int, d: int, pps: int) -> None:
    """Raise where the paged attention kernels cannot take the shape."""
    if rows < 1 or d < 16 or d % 16 or d > 512 or pps < 1:
        raise ValueError(f"{name}: rows={rows} D={d} PPS={pps} (D a "
                         f"multiple of 16 in [16, 512], PPS >= 1)")


def _check_aligned(name: str, **pools: torch.Tensor) -> None:
    for pool, t in pools.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {pool} is not 16-byte aligned "
                             f"(vector loads)")


def _split_workspace(b: int, hkv: int, rows: int, s: int,
                     dev) -> torch.Tensor:
    """The paged kernels' f32 workspace: every row's scores over the view,
    then every row's chunk maxima."""
    return torch.empty(b * hkv * rows * (-(-s // 4) * 4
                                         + -(-s // _SPLIT_MIN_CHUNK)),
                       dtype=torch.float32, device=dev)


# quant_pack and dequant_unpack stream over the flat T * D elements in
# 16-byte chunks, through a vector path where the shape allows it:
# quant_pack when x is 16-byte aligned and a group is 1-128 whole chunks
# of x, a power of two of them (group a multiple of 8 for bf16, of 4 for
# f32); dequant_unpack when a group is a multiple of 4 (f32 out) or 8
# (bf16 out) elements and the codes are aligned to one chunk's code
# bytes.  Every other shape they accept takes the scalar path of the same
# library, with the same results.


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


def decode_attention_op(q: torch.Tensor, k_codes: torch.Tensor,
                        k_scale: torch.Tensor, v_codes: torch.Tensor,
                        v_scale: torch.Tensor, bits: int = 8, group: int = 64,
                        kv_len=None, block_s: int = 256,
                        interpret: Optional[bool] = None) -> torch.Tensor:
    """Quantized flash-decode attention over a dense KV cache, the Pallas
    kernel's interface: q (B, Hkv, Gq, D) f32/bf16; codes (B, Hkv, S, D)
    int8 or (B, Hkv, S, D/2) uint8 nibbles; scales (B, Hkv, S, D/group)
    f32.  ``kv_len``: None (= S), an int for every slot, or a (B,) int32
    tensor of per-slot lengths (each >= 1).  ``block_s`` is the Pallas
    kernel's step, validated only (S must be a multiple of
    ``min(block_s, S)``): the CUDA kernel splits the positions into fixed
    blocks of 64 and combines the splits in a second launch, through an
    f32 workspace allocated here.  Returns (B, Hkv, Gq, D) in q's
    dtype."""
    if q.dim() != 4 or k_codes.dim() != 4:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} "
                         f"k_codes{tuple(k_codes.shape)}")
    b, hkv, gq, d = q.shape
    s = k_codes.shape[2]
    bs = min(block_s, s)
    if bits not in (4, 8) or bs < 1 or s % bs or group < 1 or d % group:
        raise ValueError(f"decode_attention: bits={bits} group={group} "
                         f"D={d} S={s} block_s={block_s}")
    cw = d if bits == 8 else d // 2
    dev = q.device
    _check(q, "q", (torch.float32, torch.bfloat16), dev)
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _check(t, name, (torch.int8,) if bits == 8 else (torch.uint8,), dev,
               (b, hkv, s, cw))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t, name, (torch.float32,), dev, (b, hkv, s, d // group))
    lens, static_len = None, s
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        _check(kv_len, "kv_len", (torch.int32,), dev, (b,))
        lens = kv_len
    elif kv_len is not None:
        kv_len = static_len = int(kv_len)
    if not _use_kernel(q, interpret):
        if bits == 4:
            k_codes, v_codes = (ref.unpack_int4_ref(k_codes),
                                ref.unpack_int4_ref(v_codes))
        return ref.decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                        group, kv_len=kv_len)
    if d % 4 or d > 512 or any(t.data_ptr() % 4 for t in (k_codes, v_codes)):
        raise ValueError(f"decode_attention: D={d} (a multiple of 4, at most "
                         f"512), codes 4-byte aligned")
    ws = torch.empty(b * hkv * gq * -(-s // _DECODE_SPLIT) * (d + 2),
                     dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    _launch("decode_attention", "decode_attention", dev, q.data_ptr(),
            int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            None if lens is None else lens.data_ptr(), static_len,
            ws.data_ptr(), out.data_ptr(), b, hkv, gq, s, d, bits, group,
            1.0 / math.sqrt(d))
    decode_attention_op.launches += 1
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
    if bits not in (4, 8) or d % group:
        raise ValueError(f"paged_attention: bits={bits} group={group} D={d}")
    _check_paged_shape("paged_attention", gq, d, pps)
    _check_aligned("paged_attention", k_codes=k_codes, k_scale=k_scale,
                   v_codes=v_codes, v_scale=v_scale)
    ws = _split_workspace(b, hkv, gq, pps * ps, dev)
    out = torch.empty_like(q)
    _launch("paged_attention", "paged_attention", dev, q.data_ptr(),
            int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, hkv, gq, d, pps, ps, bits, group,
            1.0 / math.sqrt(d))
    paged_attention_op.launches += 1
    return out


def paged_attention_arena_op(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_codes: torch.Tensor, k_scale: torch.Tensor, v_codes: torch.Tensor,
    v_scale: torch.Tensor, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, quant_lens: torch.Tensor,
    window: int = 0, softcap: float = 0.0,
    interpret: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged decode attention over one layer of the serving arena:
    q (B, Hkv, Gq, D) bf16; fp pools (P, PS, Hkv, D) bf16; quant pools
    (P, PS, Hkv, D) int8 codes and f32 per-channel scales; block_tables
    (B, PPS) int32; kv_lens (B,) int32 (positions < kv_lens are seen);
    quant_lens (B,) int32 (positions < quant_lens read the quant pool).
    ``window`` > 0 (a local layer's sliding window) also hides positions
    <= kv_lens - window; ``softcap`` > 0 caps each scaled score as
    tanh(s / softcap) * softcap before the mask.  Returns (unnormalized
    bf16 out (B, Hkv, Gq, D), f32 m, f32 l (B, Hkv, Gq)) for the caller's
    closed-form merge of the new token; a row that sees no position
    (kv_len 0, or window 1) gives m = -inf, l = 0, out = 0."""
    if window < 0 or softcap < 0:
        raise ValueError(f"paged_attention_arena: window={window} "
                         f"softcap={softcap}")
    if not _use_kernel(q, interpret):
        return ref.paged_attention_arena_ref(
            q, k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
            block_tables, kv_lens, quant_lens, window, softcap)
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
    _check_paged_shape("paged_attention_arena", gq, d, pps)
    _check_aligned("paged_attention_arena", k_pool=k_pool, v_pool=v_pool,
                   k_codes=k_codes, k_scale=k_scale, v_codes=v_codes,
                   v_scale=v_scale)
    ws = _split_workspace(b, hkv, gq, pps * ps, dev)
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, gq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, gq), dtype=torch.float32, device=dev)
    fn, extra = _arena_entry("paged_attention_arena", window, softcap)
    _launch("paged_attention", fn, dev, q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(),
            quant_lens.data_ptr(), ws.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, hkv, gq, d, pps, ps,
            1.0 / math.sqrt(d), *extra)
    paged_attention_arena_op.launches += 1
    return out, m, l


def paged_verify_attention_op(q: torch.Tensor, k_codes: torch.Tensor,
                              k_scale: torch.Tensor, v_codes: torch.Tensor,
                              v_scale: torch.Tensor,
                              block_tables: torch.Tensor,
                              kv_lens: torch.Tensor, bits: int = 8,
                              group: int = 64,
                              interpret: Optional[bool] = None
                              ) -> torch.Tensor:
    """Paged multi-token verify attention, the Pallas kernel's interface:
    q (B, Hkv, W, Gq, D) W consecutive verify tokens per slot, query
    ``j`` masked at ``kv_lens[b] + j`` (the staircase); code pools as
    :func:`paged_attention_op`'s; kv_lens (B,) int32, each >= 1.
    Returns the normalized (B, Hkv, W, Gq, D) output in q's dtype."""
    if not _use_kernel(q, interpret):
        return ref.paged_verify_attention_ref(
            q, k_codes, k_scale, v_codes, v_scale, block_tables, kv_lens,
            bits, group)
    b, hkv, w, gq, d = q.shape
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
    if bits not in (4, 8) or d % group:
        raise ValueError(f"paged_verify_attention: bits={bits} "
                         f"group={group} D={d}")
    _check_paged_shape("paged_verify_attention", w * gq, d, pps)
    _check_aligned("paged_verify_attention", k_codes=k_codes,
                   k_scale=k_scale, v_codes=v_codes, v_scale=v_scale)
    ws = _split_workspace(b, hkv, w * gq, pps * ps, dev)
    out = torch.empty_like(q)
    _launch("paged_verify_attention", "paged_verify_attention", dev,
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
            k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, hkv, w, gq, d, pps, ps, bits, group,
            1.0 / math.sqrt(d))
    paged_verify_attention_op.launches += 1
    return out


def paged_verify_attention_arena_op(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_codes: torch.Tensor, k_scale: torch.Tensor, v_codes: torch.Tensor,
    v_scale: torch.Tensor, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, quant_lens: torch.Tensor,
    window: int = 0, softcap: float = 0.0,
    interpret: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The speculative verify step's read of one layer of the serving
    arena: q (B, Hkv, Gq, W, D) bf16 (W consecutive tokens per slot);
    pools as :func:`paged_attention_arena_op`'s; kv_lens (B,) int32 (every
    row sees positions < kv_lens: the committed prefix); quant_lens (B,)
    int32.  ``window`` > 0 hides from token j (at position kv_lens + j)
    the positions <= kv_lens + j - window, so each row has its own lower
    bound; ``softcap`` as :func:`paged_attention_arena_op`'s.  Returns
    (unnormalized bf16 out (B, Hkv, Gq, W, D), f32 m, f32 l (B, Hkv, Gq,
    W)) for the caller's closed-form merge of the W new tokens; a row
    that sees no position gives m = -inf, l = 0, out = 0."""
    if window < 0 or softcap < 0:
        raise ValueError(f"paged_verify_attention_arena: window={window} "
                         f"softcap={softcap}")
    if not _use_kernel(q, interpret):
        return ref.paged_verify_attention_arena_ref(
            q, k_pool, v_pool, k_codes, k_scale, v_codes, v_scale,
            block_tables, kv_lens, quant_lens, window, softcap)
    b, hkv, gq, w, d = q.shape
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
    _check_paged_shape("paged_verify_attention_arena", gq * w, d, pps)
    _check_aligned("paged_verify_attention_arena", k_pool=k_pool,
                   v_pool=v_pool, k_codes=k_codes, k_scale=k_scale,
                   v_codes=v_codes, v_scale=v_scale)
    ws = _split_workspace(b, hkv, gq * w, pps * ps, dev)
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, gq, w), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, gq, w), dtype=torch.float32, device=dev)
    fn, extra = _arena_entry("paged_verify_attention_arena", window,
                             softcap)
    _launch("paged_verify_attention", fn, dev,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(),
            quant_lens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, gq, w, d,
            pps, ps, 1.0 / math.sqrt(d), *extra)
    paged_verify_attention_arena_op.launches += 1
    return out, m, l


# paged_mla_attention: the absorbed MLA decode (csrc/paged_mla_attention.cu)
# at the published DeepSeek-V2 shape only: 16 query heads over one latent
# head of 512 channels and a rope key of 64.  Phase A gives each (split of
# a slot's positions, slot) a block that keeps the split's online-softmax
# state; phase B combines the splits.  The split is the largest of
# 256 ... 32 positions that still gives the card two blocks an SM (on the
# H100 at 16 slots of 8.2k positions a split of 256 took 0.110 / 0.164 /
# 0.315 ms with 2 / 8 / 16 slots live, one of 512 0.184 / 0.281 / 0.305).
_MLA_SHAPE = (16, 512, 64)     # heads, latent, rope
_MLA_TILE = 32                 # the kernel's positions a tile


def _mla_split(b: int, view: int) -> int:
    split = 256
    while split > _MLA_TILE and b * -(-view // split) < 2 * 132:
        split //= 2
    return split


def paged_mla_attention_op(
    q_abs: torch.Tensor, q_pe: torch.Tensor, lat_pool: torch.Tensor,
    rope_pool: torch.Tensor, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, sm_scale: float,
    interpret: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-head latent attention's decode read of one layer of the
    paged arena, in the absorbed form: q_abs (B, H, R) bf16 (each head's
    nope query folded onto the latent), q_pe (B, H, P) bf16 (its rotated
    rope query); pools (NP, PS, 1, R) latent and (NP, PS, 1, P) rope key,
    bf16; block_tables (B, PPS) int32; kv_lens (B,) int32.  Each position
    t < kv_lens on a page other than the scratch page 0 is seen, scored
    against latent and rope key together and weighted onto the latent.
    Returns (unnormalized bf16 out (B, H, R), f32 m, f32 l (B, H)) for the
    caller's closed-form merge of the new token; a row that sees nothing
    (a parked slot) gives m = -inf, l = 0, out = 0.  It reads no quant
    pool: the latent layout never holds quant-resident pages
    (``strategy.quant_resident`` refuses it)."""
    if not _use_kernel(q_abs, interpret):
        return ref.paged_mla_attention_ref(q_abs, q_pe, lat_pool, rope_pool,
                                           block_tables, kv_lens, sm_scale)
    b, h, r = q_abs.shape
    pr = q_pe.shape[-1]
    np_, ps = lat_pool.shape[:2]
    pps = block_tables.shape[1]
    dev = q_abs.device
    if (h, r, pr) != _MLA_SHAPE or pps < 1:
        raise ValueError(f"paged_mla_attention: H={h} R={r} P={pr} PPS={pps}"
                         f" (the kernel takes H, R, P = {_MLA_SHAPE})")
    _check(q_abs, "q_abs", (torch.bfloat16,), dev)
    _check(q_pe, "q_pe", (torch.bfloat16,), dev, (b, h, pr))
    _check(lat_pool, "lat_pool", (torch.bfloat16,), dev, (np_, ps, 1, r))
    _check(rope_pool, "rope_pool", (torch.bfloat16,), dev, (np_, ps, 1, pr))
    _check(block_tables, "block_tables", (torch.int32,), dev, (b, pps))
    _check(kv_lens, "kv_lens", (torch.int32,), dev, (b,))
    _check_aligned("paged_mla_attention", lat_pool=lat_pool,
                   rope_pool=rope_pool)
    split = _mla_split(b, pps * ps)
    n_split = -(-(pps * ps) // split)
    ws_acc = torch.empty(b * n_split * h * r, dtype=torch.float32,
                         device=dev)
    ws_ml = torch.empty(b * n_split * h * 2, dtype=torch.float32, device=dev)
    out = torch.empty((b, h, r), dtype=torch.bfloat16, device=dev)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, h), dtype=torch.float32, device=dev)
    _launch("paged_mla_attention", "paged_mla_attention", dev,
            q_abs.data_ptr(), q_pe.data_ptr(), lat_pool.data_ptr(),
            rope_pool.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, r, pr, pps, ps,
            split, float(sm_scale))
    paged_mla_attention_op.launches += 1
    return out, m, l


def hadamard_op(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
                interpret: Optional[bool] = None) -> torch.Tensor:
    """Blockwise Hadamard transform, the Pallas kernel's function:
    x (T, D) bf16/f32 @ H_D with f32 accumulation, out ``out_dtype``
    (f32 or bf16; default x's dtype).  D is a power of two (the kernel
    takes 4 <= D <= 512); T is any length, with no block multiple.  The
    kernel reads no table: it takes the host table's entry c = H[0][0]
    and derives each entry's sign, +c or -c, from popcount(k & j)."""
    if x.dim() != 2 or x.shape[1] < 1 or x.shape[1] & (x.shape[1] - 1):
        raise ValueError(f"hadamard: x{tuple(x.shape)}, D must be a power "
                         f"of two")
    out_dtype = out_dtype or x.dtype
    if not _use_kernel(x, interpret):
        return ref.hadamard_ref(x, out_dtype)
    t, d = x.shape
    if not 4 <= d <= 512 or out_dtype not in (torch.float32,
                                              torch.bfloat16):
        raise ValueError(f"hadamard: D={d} out_dtype={out_dtype}")
    _check(x, "x", (torch.float32, torch.bfloat16), x.device)
    _check_aligned("hadamard", x=x)
    out = torch.empty((t, d), dtype=out_dtype, device=x.device)
    _launch("hadamard", "hadamard", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), ref.hadamard_entry(d),
            out.data_ptr(), int(out_dtype == torch.bfloat16), t, d)
    hadamard_op.launches += 1
    return out


KERNEL_OPS = (quant_pack_op, dequant_unpack_op, decode_attention_op,
              paged_attention_op, paged_attention_arena_op,
              paged_verify_attention_op, paged_verify_attention_arena_op,
              hadamard_op, paged_mla_attention_op)
for _op in KERNEL_OPS:
    _op.launches = 0


def reset_launches() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launches() -> Dict[str, int]:
    return {op.__name__: op.launches for op in KERNEL_OPS}
