"""The port's CUDA kernels on the card, against their plain versions.

Every test here launches a Hopper kernel, so every one is marked ``gpu``
and skips where there is no NVIDIA GPU (a CUDA kernel has no CPU mode).
The file imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: quant_pack and dequant_unpack bit for bit (quant_pack also
against the host quantizer, on ``quant_boundary``'s rows and on the
shapes that take the kernels' scalar path); the Pallas-
interface paged (verify) attention and decode_attention with f32 q within
atol 2e-5 / rtol 1e-4 (f32 sums in another order; an online softmax for
decode_attention), decode_attention with bf16 q within 1 bf16 ulp, or
within the f32 atol 2e-5 where one bf16 ulp is finer than that (outputs
below 2.6e-3 in magnitude, whose last bits the f32 sums' order sets); the
arena entries' m and l within rtol 1e-5 and their bf16 output within 2
bf16 ulps, also with gemma-2's softcap and sliding window (``window`` and
``softcap``), where a row that sees no position gives m = -inf, l = 0
and out = 0 in both; hadamard within 1e-5 of each row's L2
norm against its plain version (cuBLAS sums in another order) and bit for
bit against numpy's ``x @ h`` on the host at D 64, 128 and 256 (one
in-order FMA chain per output, a BLAS micro-kernel's order).  The kernels
that split work across blocks (the attention kernels) are launched twice
on their edge cases, and the two results must be equal bit for bit.
A decode worker's paged one-token step replayed from its CUDA graph
emits the plain step's tokens and writes its pages bit for bit.
paged_mla_attention (DeepSeek-V2's absorbed decode, 16 heads over a
512-wide latent and a 64-wide rope key) against its plain version: m
within rtol 1e-5, l within rtol 1e-4 (8k-position f32 sums split across
blocks and rescaled), the bf16 output within 2 ulps where it exceeds 1e-4
of the row's l (sums that cancel set the last bits of smaller outputs),
and two launches equal bit for bit; beside it the MHA arena entry at
deepseek-moe-16b's decode shape keeps its bits.  The identity profile's
codec on the card (fp16 cast on the device, one copy each way through
pinned memory) keeps the host path's payload and landed pages bit
for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
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
from repro_torch.core.quantizers import group_quantize  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.quant_boundary import boundary_rows  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol: float = 0.0) -> int:
    """Largest distance in bf16 units in the last place, over the
    elements that differ by more than ``atol``."""
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    ulps = (ordered(a) - ordered(b)).abs()
    ulps = ulps[(a.float() - b.float()).abs() > atol]
    return int(ulps.max()) if ulps.numel() else 0


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t", [1, 77, 4096])
def test_quant_pack_and_dequant_unpack(cuda, bits, t):
    gen = torch.Generator(device=cuda).manual_seed(t + bits)
    x = torch.randn(t, 128, generator=gen, device=cuda) * 3
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        codes, scales = quant_pack_op(xd, bits=bits, group=64)
        cref, sref = R.quant_pack_ref(xd, bits, 64)
        assert torch.equal(codes, cref) and torch.equal(scales, sref)
        for od in (torch.float32, torch.bfloat16):
            got = dequant_unpack_op(codes, scales, bits=bits, group=64,
                                    out_dtype=od)
            assert torch.equal(got, R.dequant_unpack_ref(codes, scales,
                                                         bits, 64, od))


def _host_wire_codes(x: np.ndarray, bits: int, group: int):
    """The host quantizer's offset uint8 codes and fp16 scales of x."""
    t, d = x.shape
    codes, scales, _ = group_quantize(x.reshape(1, t, d), bits, "per_token",
                                      group, True)
    return codes.reshape(t, d), scales.reshape(t, d // group)


def _as_wire(codes: torch.Tensor, bits: int) -> np.ndarray:
    c = R.unpack_int4_ref(codes) if bits == 4 else codes
    return (c.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8).cpu() \
        .numpy()


@pytest.mark.parametrize("t", [1, 77, 4097])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quant_pack_boundary_rows(cuda, bf16, bits, group, t):
    """Quotients on .5, one grid step off it, where the reciprocal
    shortcut differs, at +-qmax, all zero, below the scale floor: the
    kernel equals its plain version and the host quantizer bit for bit."""
    x = boundary_rows(t, 128, group, bits, bf16, seed=t + group + bits)
    xd = torch.from_numpy(x).to(cuda, torch.bfloat16 if bf16
                                else torch.float32)
    codes, scales = quant_pack_op(xd, bits=bits, group=group)
    cref, sref = R.quant_pack_ref(xd, bits, group)
    assert torch.equal(codes, cref) and torch.equal(scales, sref)
    host_codes, host_scales = _host_wire_codes(x, bits, group)
    np.testing.assert_array_equal(_as_wire(codes, bits), host_codes)
    np.testing.assert_array_equal(
        scales.to(torch.float16).cpu().numpy(), host_scales)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", ["group2", "group6", "group10",
                                  "odd_offset", "t1", "group4_bf16"])
def test_quant_pack_scalar_path(cuda, case, bits):
    """Shapes the vector path cannot take (a group that is not whole
    16-byte chunks of x, an x at an odd element offset) go to the scalar
    path of the same library: bit for bit as well.  T 1 takes the vector
    path with a single warp."""
    group, d, t = {"group2": (2, 64, 33), "group6": (6, 96, 77),
                   "group10": (10, 160, 5), "odd_offset": (64, 128, 77),
                   "t1": (64, 128, 1), "group4_bf16": (4, 64, 9)}[case]
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        x = boundary_rows(t, d, group, bits, bf16, seed=len(case) + bits)
        if case == "odd_offset":
            flat = torch.zeros(t * d + 1, dtype=dt, device=cuda)
            flat[1:] = torch.from_numpy(x.ravel()).to(cuda, dt)
            xd = flat[1:].view(t, d)
            assert xd.data_ptr() % 16 and xd.is_contiguous()
        else:
            xd = torch.from_numpy(x).to(cuda, dt)
        codes, scales = quant_pack_op(xd, bits=bits, group=group)
        cref, sref = R.quant_pack_ref(xd, bits, group)
        assert torch.equal(codes, cref) and torch.equal(scales, sref)
        host_codes, _ = _host_wire_codes(x, bits, group)
        np.testing.assert_array_equal(_as_wire(codes, bits), host_codes)
        for od in (torch.float32, torch.bfloat16):
            got = dequant_unpack_op(codes, scales, bits=bits, group=group,
                                    out_dtype=od)
            assert torch.equal(got, R.dequant_unpack_ref(codes, scales,
                                                         bits, group, od))


@pytest.mark.parametrize("t", [1, 77, 4097])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_unpack_grid(cuda, bits, group, t):
    """Every code value at every place of a group, f32 and bf16 out, and
    the codes at an offset that breaks the vector path's alignment."""
    gen = torch.Generator(device=cuda).manual_seed(t + group + bits)
    lo, hi = (-128, 128) if bits == 8 else (0, 256)
    cw = 128 if bits == 8 else 64
    dt = torch.int8 if bits == 8 else torch.uint8
    codes = torch.randint(lo, hi, (t, cw), generator=gen, device=cuda,
                          dtype=torch.int32).to(dt)
    scales = torch.rand(t, 128 // group, generator=gen, device=cuda) * 0.1
    scales[:, 0] = 1e-8
    flat = torch.zeros(t * cw + 1, dtype=dt, device=cuda)
    flat[1:] = codes.ravel()
    shifted = flat[1:].view(t, cw)
    for od in (torch.float32, torch.bfloat16):
        want = R.dequant_unpack_ref(codes, scales, bits, group, od)
        for c in (codes, shifted):
            got = dequant_unpack_op(c, scales, bits=bits, group=group,
                                    out_dtype=od)
            assert torch.equal(got, want)


def test_dequant_unpack_nibble_order(cuda):
    """int4: byte j holds output 2j in its low nibble, 2j + 1 in its high
    one, each as nibble - 8."""
    lo = torch.arange(64, device=cuda) % 16
    hi = (torch.arange(64, device=cuda) * 7 + 3) % 16
    packed = (lo | (hi << 4)).to(torch.uint8).repeat(3, 1)
    scales = torch.tensor([[0.5, 2.0]] * 3, device=cuda)
    for od in (torch.float32, torch.bfloat16):
        got = dequant_unpack_op(packed, scales, bits=4, group=64,
                                out_dtype=od).float()
        want = torch.stack([lo - 8, hi - 8], dim=-1).reshape(128).float()
        want = want * torch.tensor([0.5] * 64 + [2.0] * 64, device=cuda)
        assert torch.equal(got, want.expand(3, 128))


def test_quant_pack_beyond_one_launch(cuda):
    """An input of more than 2^30 elements, which the launchers cut into
    pieces of whole groups: rows on both sides of the cut and at the end
    equal the plain version."""
    t = (1 << 30) // 128 + 77
    x = torch.randn(t, 128, dtype=torch.bfloat16, device=cuda)
    codes, scales = quant_pack_op(x, bits=4, group=64)
    out = dequant_unpack_op(codes, scales, bits=4, group=64,
                            out_dtype=torch.bfloat16)
    cut = (1 << 30) // 128
    for r0, r1 in ((0, 8), (cut - 8, cut + 8), (t - 8, t)):
        c, s = R.quant_pack_ref(x[r0:r1], 4, 64)
        assert torch.equal(codes[r0:r1], c) and torch.equal(scales[r0:r1], s)
        assert torch.equal(out[r0:r1],
                           R.dequant_unpack_ref(c, s, 4, 64, torch.bfloat16))


def _pallas_pools(gen, dev, b, hkv, s, d, bits, group, ps):
    """Dense K/V scattered into shuffled quantized pages (P, Hkv, PS, D')."""
    pps = s // ps
    n_pages = 1 + b * pps
    pools = []
    for _ in range(2):
        x = torch.randn(n_pages, hkv, ps, d, generator=gen, device=dev)
        pools += list(R.quant_pack_ref(x, bits, group))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    return pools, perm.reshape(b, pps).to(torch.int32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,hkv,gq,d,s,group,ps", [
    (2, 2, 4, 64, 256, 32, 16),
    (3, 8, 4, 128, 1056, 64, 16),
])
def test_paged_attention(cuda, bits, b, hkv, gq, d, s, group, ps):
    gen = torch.Generator(device=cuda).manual_seed(bits + s)
    pools, bt = _pallas_pools(gen, cuda, b, hkv, s, d, bits, group, ps)
    q = torch.randn(b, hkv, gq, d, generator=gen, device=cuda)
    lens = torch.tensor([s, s // 2 - 3, 1][:b], dtype=torch.int32,
                        device=cuda)
    got = paged_attention_op(q, *pools, bt, lens, bits=bits, group=group)
    want = R.paged_attention_ref(q, *pools, bt, lens, bits, group)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    # scratch page 0 poisoned, beyond-length entries pointed at it
    bt0 = bt.clone()
    bt0[1, 1:] = 0
    a = paged_attention_op(q, *pools, bt0, lens.clamp(max=ps), bits=bits,
                           group=group)
    poisoned = [p.clone() for p in pools]
    poisoned[0][0] = 7 if bits == 4 else 127
    poisoned[1][0] = 1e9
    b2 = paged_attention_op(q, *poisoned, bt0, lens.clamp(max=ps),
                            bits=bits, group=group)
    assert torch.equal(a, b2)


def _arena_case(dev, seed, b=6, hkv=8, gq=4, d=128, ps=16, pps=66):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * pps
    shape = (n_pages, ps, hkv, d)
    fp = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(2)]
    codes = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [(torch.rand(shape[:-1] + (d // 64,), generator=gen,
                          device=dev) * 0.05 + 1e-3).half().float()
              .repeat_interleave(64, -1) for _ in range(2)]
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, pps).to(torch.int32)
    view = pps * ps
    lens = torch.tensor([1040, 1030, 1024, view - 1, 17, 1][:b],
                        dtype=torch.int32, device=dev)
    qlens = torch.tensor([1024, 0, 1024, 0, 9, 0][:b], dtype=torch.int32,
                         device=dev)
    q = torch.randn(b, hkv, gq, d, generator=gen, device=dev).to(
        torch.bfloat16)
    return (q, fp[0], fp[1], codes[0], scales[0], codes[1], scales[1], bt,
            lens, qlens)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_arena(cuda, seed):
    args = _arena_case(cuda, seed)
    out, m, l = paged_attention_arena_op(*args)
    r_out, r_m, r_l = R.paged_attention_arena_ref(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,hkv,w,gq,d,s,group,ps", [
    (2, 2, 3, 4, 64, 256, 32, 16),
    (3, 8, 5, 4, 128, 1072, 64, 16),
])
def test_paged_verify_attention(cuda, bits, b, hkv, w, gq, d, s, group, ps):
    gen = torch.Generator(device=cuda).manual_seed(bits + s + w)
    pools, bt = _pallas_pools(gen, cuda, b, hkv, s, d, bits, group, ps)
    q = torch.randn(b, hkv, w, gq, d, generator=gen, device=cuda)
    lens = torch.tensor([s - w, s // 2 - 3, 1][:b], dtype=torch.int32,
                        device=cuda)
    got = paged_verify_attention_op(q, *pools, bt, lens, bits=bits,
                                    group=group)
    want = R.paged_verify_attention_ref(q, *pools, bt, lens, bits, group)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    # W = 1 is the one-token kernel
    one = paged_verify_attention_op(q[:, :, :1].contiguous(), *pools, bt,
                                    lens, bits=bits, group=group)
    dec = paged_attention_op(q[:, :, 0].contiguous(), *pools, bt, lens,
                             bits=bits, group=group)
    torch.testing.assert_close(one[:, :, 0], dec, atol=2e-5, rtol=1e-4)
    # scratch page 0 poisoned, beyond-length entries pointed at it
    bt0 = bt.clone()
    bt0[1, 1:] = 0
    short = lens.clamp(max=ps - w + 1)
    a = paged_verify_attention_op(q, *pools, bt0, short, bits=bits,
                                  group=group)
    poisoned = [p.clone() for p in pools]
    poisoned[0][0] = 7 if bits == 4 else 127
    poisoned[1][0] = 1e9
    b2 = paged_verify_attention_op(q, *poisoned, bt0, short, bits=bits,
                                   group=group)
    assert torch.equal(a, b2)


@pytest.mark.parametrize("seed,w", [(0, 2), (1, 5)])
def test_paged_verify_attention_arena(cuda, seed, w):
    args = list(_arena_case(cuda, seed, pps=67))
    b, hkv, gq, d = args[0].shape
    gen = torch.Generator(device=cuda).manual_seed(10 + seed)
    args[0] = torch.randn(b, hkv, gq, w, d, generator=gen,
                          device=cuda).to(torch.bfloat16)
    out, m, l = paged_verify_attention_arena_op(*args)
    r_out, r_m, r_l = R.paged_verify_attention_arena_ref(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, 64, device=cuda)
    with pytest.raises(ValueError):
        quant_pack_op(x[:, ::2].contiguous()[:, :30])   # D % group
    with pytest.raises(ValueError):
        quant_pack_op(x.t())                            # not contiguous
    with pytest.raises(TypeError):
        quant_pack_op(x.to(torch.float16))
    args = list(_arena_case(cuda, 0, b=1, pps=1, d=1024))
    with pytest.raises(ValueError):                 # D > 512
        paged_attention_arena_op(*args)
    args[0] = torch.zeros(1, 8, 4, 9, 1024, dtype=torch.bfloat16,
                          device=cuda)
    with pytest.raises(ValueError):
        paged_verify_attention_arena_op(*args)
    q, kc, ks, vc, vs = _dense_case(cuda, 0, 1, 1, 4, 64, 128, 8, 64,
                                    torch.float32)
    with pytest.raises(ValueError):
        decode_attention_op(q, kc, ks, vc, vs, bits=8, block_s=48)
    with pytest.raises(ValueError):
        decode_attention_op(q, kc, ks, vc, vs, bits=5)
    with pytest.raises(TypeError):
        decode_attention_op(q.half(), kc, ks, vc, vs)
    with pytest.raises(ValueError):
        decode_attention_op(q, kc[:, :, :32], ks, vc, vs)
    with pytest.raises(ValueError):
        decode_attention_op(q, kc, ks, vc, vs, kv_len=torch.ones(
            2, dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# Shapes the attention kernels refused before their score rows moved to a
# device workspace and their query rows to tiles
# ---------------------------------------------------------------------------
def test_paged_attention_arena_long_view(cuda):
    """llama3.1-8b arena decode over 16,400 positions (a 16k prompt)."""
    args = list(_arena_case(cuda, 3, pps=1025))
    args[8] = torch.tensor([16_400, 16_390, 9000, 1040, 17, 1],
                           dtype=torch.int32, device=cuda)
    args[9] = torch.tensor([16_384, 0, 9000, 1024, 9, 0],
                           dtype=torch.int32, device=cuda)
    out, m, l = paged_attention_arena_op(*args)
    r_out, r_m, r_l = R.paged_attention_arena_ref(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2


@pytest.mark.parametrize("hkv,gq,w,pps", [(8, 4, 5, 256), (4, 7, 5, 67)])
def test_paged_verify_attention_arena_wide(cuda, hkv, gq, w, pps):
    """W = 5 verify over 4,096 positions; qwen2.5-7b's W * Gq = 35 rows."""
    args = list(_arena_case(cuda, 4, hkv=hkv, gq=gq, pps=pps))
    view = pps * 16
    args[8] = torch.tensor([view - w, view // 2, 1030, 1, 17, 600],
                           dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    args[0] = torch.randn(6, hkv, gq, w, 128, generator=gen,
                          device=cuda).to(torch.bfloat16)
    out, m, l = paged_verify_attention_arena_op(*args)
    r_out, r_m, r_l = R.paged_verify_attention_arena_ref(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2


@pytest.mark.parametrize("bits", [4, 8])
def test_paged_attention_many_query_rows(cuda, bits):
    """granite-20b's Gq 48 over one KV head, and W * Gq = 35 verify rows
    through the Pallas interfaces."""
    gen = torch.Generator(device=cuda).manual_seed(6 + bits)
    pools, bt = _pallas_pools(gen, cuda, 2, 1, 2048, 128, bits, 64, 16)
    lens = torch.tensor([2048, 777], dtype=torch.int32, device=cuda)
    q = torch.randn(2, 1, 48, 128, generator=gen, device=cuda)
    got = paged_attention_op(q, *pools, bt, lens, bits=bits, group=64)
    want = R.paged_attention_ref(q, *pools, bt, lens, bits, 64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    qv = torch.randn(2, 1, 5, 7, 128, generator=gen, device=cuda)
    lens = lens - 5
    got = paged_verify_attention_op(qv, *pools, bt, lens, bits=bits,
                                    group=64)
    want = R.paged_verify_attention_ref(qv, *pools, bt, lens, bits, 64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The split design's edges: at the main shape (6 slots, 8 KV heads, a view
# of 1056 or 1072 positions) phase A takes chunks of 32 positions (W <= 2)
# or 64 (W = 5) and phase B stages of 128
# ---------------------------------------------------------------------------
_SPLIT_LENS = {
    # chunk boundary and one either side, then slots shorter than a chunk
    # and the parked row at view - 1 (set below)
    "boundaries": ([1024, 1023, 1025, None, 17, 1],
                   [1000, 33, 1025, 0, 9, 0]),      # quant_lens mid-chunk
    # a slot whose later chunks all lie beyond its length, a tile boundary
    "short": ([64, 63, 65, 100, 128, 129],
              [40, 63, 0, 100, 64, 1]),
}


def _two_launches(op, *args, **kw):
    """The op's result, after checking that a second launch on the same
    input gives the same bits (no atomics, one order per sum)."""
    first = op(*args, **kw)
    second = op(*args, **kw)
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    second if isinstance(second, tuple) else (second,)):
        assert torch.equal(a, b)
    return first


@pytest.mark.parametrize("w", [1, 2, 5])
@pytest.mark.parametrize("lens", sorted(_SPLIT_LENS))
def test_split_edges_arena(cuda, w, lens):
    args = list(_arena_case(cuda, 20 + w, pps=66 if w == 1 else 67))
    view = args[7].shape[1] * 16
    kv, qv = _SPLIT_LENS[lens]
    args[8] = torch.tensor([view - 1 if n is None else n for n in kv],
                           dtype=torch.int32, device=cuda)
    args[9] = torch.tensor(qv, dtype=torch.int32, device=cuda)
    if w == 1:
        op, plain = paged_attention_arena_op, R.paged_attention_arena_ref
    else:
        b, hkv, gq, d = args[0].shape
        gen = torch.Generator(device=cuda).manual_seed(30 + w)
        args[0] = torch.randn(b, hkv, gq, w, d, generator=gen,
                              device=cuda).to(torch.bfloat16)
        op, plain = (paged_verify_attention_arena_op,
                     R.paged_verify_attention_arena_ref)
    out, m, l = _two_launches(op, *args)
    r_out, r_m, r_l = plain(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2


# gemma-2's cap and window at its shape (Hkv 8, Gq 2, D 256) over
# 320-position views (chunks of 16, stages of 128): (W, window, cap,
# kv_lens), as chip_smoke.py's phase 2 holds them
_WINDOW_EDGES = {
    "window1": (1, 1, 50.0, [0, 1, 17, 100, 319, 200]),
    "window2-nocap": (1, 2, 0.0, [0, 1, 17, 100, 319, 200]),
    "window16-midchunk": (1, 16, 50.0, [0, 40, 100, 319, 24, 7]),
    "window17-chunkedge": (1, 17, 50.0, [48, 64, 96, 0, 17, 1]),
    "window40-below": (1, 40, 50.0, [300, 319, 150, 160, 0, 41]),
    "window-past-length": (1, 4096, 50.0, [0, 1, 17, 100, 319, 200]),
    "cap-only": (1, 0, 50.0, [0, 1, 17, 100, 319, 200]),
    "verify5-window3": (5, 3, 50.0, [0, 40, 100, 315, 17, 200]),
    "verify5-window16": (5, 16, 50.0, [48, 64, 96, 315, 17, 1]),
    "verify2-window40-cap2": (2, 40, 2.0, [300, 318, 150, 160, 0, 41]),
    "gemma2-decode": (1, 4096, 50.0, [1024, 4095, 4096, 4097, 6000]),
    "gemma2-verify5": (5, 4096, 50.0, [1024, 4095, 4096, 4097, 6000]),
}


@pytest.mark.parametrize("case", sorted(_WINDOW_EDGES))
def test_arena_window_and_softcap(cuda, case):
    """Both arena entries with a window and a cap against their plain
    versions, each launched twice (bit-equal); the rows that see nothing
    (kv_len 0, window 1, verify tokens past a short window) give m =
    -inf, l = 0, out = 0."""
    w, window, cap, lens = _WINDOW_EDGES[case]
    pps = -(-(max(lens) + 6) // 16)
    args = list(_arena_case(cuda, len(case), b=len(lens), hkv=8, gq=2,
                            d=256, pps=pps))
    args[8] = torch.tensor(lens, dtype=torch.int32, device=cuda)
    args[9] = torch.minimum(args[8], torch.tensor(
        [0, 9, 1024, 160, 4096, 33][:len(lens)], dtype=torch.int32,
        device=cuda))
    if w == 1:
        op, plain = paged_attention_arena_op, R.paged_attention_arena_ref
    else:
        b, hkv, gq, d = args[0].shape
        gen = torch.Generator(device=cuda).manual_seed(w)
        args[0] = torch.randn(b, hkv, gq, w, d, generator=gen,
                              device=cuda).to(torch.bfloat16)
        op, plain = (paged_verify_attention_arena_op,
                     R.paged_verify_attention_arena_ref)
    out, m, l = _two_launches(op, *args, window=window, softcap=cap)
    r_out, r_m, r_l = plain(*args, window, cap)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, r_out) <= 2
    empty = torch.isneginf(m)
    assert torch.equal(empty, torch.isneginf(r_m))
    assert bool((l[empty] == 0).all()) and bool((out[empty] == 0).all())
    if lens[0] == 0:
        assert bool(empty[0].all())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("w", [1, 2, 5])
def test_split_edges_pallas(cuda, bits, w):
    """The Pallas interfaces at the same edges; for W > 1 the staircase
    crosses a chunk boundary (at W=5 the rows of slot 0 see 62..66
    positions, of slot 1 1023..1027)."""
    gen = torch.Generator(device=cuda).manual_seed(40 + w + bits)
    s = 1056 if w == 1 else 1072
    pools, bt = _pallas_pools(gen, cuda, 6, 8, s, 128, bits, 64, 16)
    if w == 1:
        q = torch.randn(6, 8, 4, 128, generator=gen, device=cuda)
        lens = [1024, 1023, 1025, s - 1, 17, 1]
    else:
        q = torch.randn(6, 8, w, 4, 128, generator=gen, device=cuda)
        lens = [{2: 63, 5: 62}[w], 1023, 1025 - w, s - w, 17, 1]
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if w == 1:
        got = _two_launches(paged_attention_op, q, *pools, bt, lens,
                            bits=bits, group=64)
        want = R.paged_attention_ref(q, *pools, bt, lens, bits, 64)
    else:
        got = _two_launches(paged_verify_attention_op, q, *pools, bt, lens,
                            bits=bits, group=64)
        want = R.paged_verify_attention_ref(q, *pools, bt, lens, bits, 64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# decode_attention: dense quantized flash-decode
# ---------------------------------------------------------------------------
def _dense_case(dev, seed, b, hkv, gq, s, d, bits, group, q_dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hkv, gq, d, generator=gen, device=dev).to(q_dtype)
    kc, ks = R.quant_pack_ref(torch.randn(b, hkv, s, d, generator=gen,
                                          device=dev), bits, group)
    vc, vs = R.quant_pack_ref(torch.randn(b, hkv, s, d, generator=gen,
                                          device=dev), bits, group)
    return q, kc, ks, vc, vs


def _decode_want(q, kc, ks, vc, vs, bits, group, kv_len):
    if bits == 4:
        kc, vc = R.unpack_int4_ref(kc), R.unpack_int4_ref(vc)
    return R.decode_attention_ref(q, kc, ks, vc, vs, group, kv_len=kv_len)


def _hold(got, want):
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert _bf16_ulps(got, want, atol=2e-5) <= 1


_SLOT_LENS = (1056, 1040, 600, 17, 1, 1031)   # chip_smoke.py's case (a)
# decode_attention.cu splits the positions into blocks of 64: split - 1,
# split, split + 1, a last split of one position, two full splits, one
_EDGE_LENS = (63, 64, 65, 129, 128, 1)


@pytest.mark.parametrize("case", [
    # (b, hkv, gq, s, d, bits, group, block_s, kv_len, q dtype)
    *[(6, 8, 4, 1056, 128, bits, 64, 32, "slots", dt)
      for bits in (8, 4) for dt in ("f32", "bf16")],   # slot-arena decode
    (2, 2, 4, 1024, 128, 8, 64, 256, None, "f32"),     # kernel_throughput
    *[(b, hkv, gq, s, d, bits, g, blk, s - s // 4, "f32")
      for bits in (4, 8)
      for b, hkv, gq, d, s, g, blk in [(2, 2, 4, 64, 512, 64, 128),
                                       (1, 4, 8, 128, 256, 32, 256),
                                       (3, 1, 2, 128, 1024, 128, 256)]],
    (1, 8, 4, 32768, 128, 4, 64, 256, 32000, "f32"),   # long context
    (1, 1, 48, 2048, 128, 8, 64, 256, None, "bf16"),   # granite-20b Gq 48
    (6, 8, 4, 1056, 128, 8, 64, 32, "edges", "f32"),   # the split's edges
    (6, 8, 4, 1056, 128, 4, 64, 32, "edges", "bf16"),
    (2, 8, 4, 256, 128, 8, 64, 64, 65, "f32"),
    # rows that are no whole 16-byte chunk, scales left in device memory
    (2, 2, 3, 100, 12, 8, 4, 100, None, "f32"),
    (2, 2, 3, 100, 40, 4, 8, 100, 99, "f32"),
    (1, 2, 5, 200, 512, 4, 1, 200, 150, "bf16"),
])
def test_decode_attention(cuda, case):
    """Each case launched twice (the results equal bit for bit: no atomics,
    one combine order), against the plain version; with a (B,) length
    vector, each row alone at its length equals its row of the batch."""
    b, hkv, gq, s, d, bits, group, block_s, kv_len, dt = case
    q, kc, ks, vc, vs = _dense_case(
        cuda, s + gq + bits, b, hkv, gq, s, d, bits, group,
        torch.float32 if dt == "f32" else torch.bfloat16)
    if kv_len in ("slots", "edges"):
        kv_len = torch.tensor(_SLOT_LENS if kv_len == "slots" else _EDGE_LENS,
                              dtype=torch.int32, device=cuda)
    before = decode_attention_op.launches
    got = _two_launches(decode_attention_op, q, kc, ks, vc, vs, bits=bits,
                        group=group, kv_len=kv_len, block_s=block_s)
    assert decode_attention_op.launches == before + 2
    _hold(got, _decode_want(q, kc, ks, vc, vs, bits, group, kv_len))
    if isinstance(kv_len, torch.Tensor):  # each row alone, at its length
        for i, n in enumerate(kv_len.tolist()):
            one = decode_attention_op(
                q[i:i + 1], kc[i:i + 1], ks[i:i + 1], vc[i:i + 1],
                vs[i:i + 1], bits=bits, group=group, kv_len=n,
                block_s=block_s)
            assert torch.equal(one[0], got[i])


@pytest.mark.parametrize("bits", [4, 8])
def test_decode_attention_equals_paged_over_the_gathered_view(cuda, bits):
    """paged_attention over a block table = decode_attention over the
    gathered view (the two kernels sum in other orders: f32 tolerance)."""
    gen = torch.Generator(device=cuda).manual_seed(11 + bits)
    b, hkv, gq, d, s, ps = 6, 8, 4, 128, 1056, 16
    pools, bt = _pallas_pools(gen, cuda, b, hkv, s, d, bits, 64, ps)
    lens = torch.tensor(_SLOT_LENS, dtype=torch.int32, device=cuda)
    q = torch.randn(b, hkv, gq, d, generator=gen, device=cuda)
    paged = paged_attention_op(q, *pools, bt, lens, bits=bits, group=64)
    dense = [R._gather_pages(p, bt).contiguous() for p in pools]
    got = decode_attention_op(q, *dense, bits=bits, group=64, kv_len=lens,
                              block_s=32)
    torch.testing.assert_close(got, paged, atol=2e-5, rtol=1e-4)


def test_runtime_launches_every_kernel(cuda):
    """A reduced llama3.1-8b served PD-separated on the paged arena goes
    through all three kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

    cfg = get_config("llama3.1-8b-reduced")
    rt = ServingRuntime(
        static_profile=Profile(StrategyConfig(
            quantizer="uniform", key_bits=8, value_bits=8,
            granularity="per_token", symmetric=True, group_size=16),
            cr=2.0, s_enc=5e8, s_dec=5e8),
        config=RuntimeConfig(seq=64, decode_tokens=6, mode="pd", paged=True,
                             page_size=8, pd_inject_restored=True),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=4, max_prefills_per_step=2),
        device=cuda)
    rt.model_cfg = cfg
    rt.params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    reset_launches()
    for seed in (0, 1, 0):           # the third request is a pool hit
        rt.submit("qalike", prompt_seed=seed)
    rt.run()
    counts = launches()
    assert [r.pool_hit for r in sorted(rt.completed, key=lambda r: r.rid)] \
        == [False, False, True]
    assert counts["quant_pack_op"] >= 2 and counts["dequant_unpack_op"] >= 2
    assert counts["paged_attention_arena_op"] > 0
    assert all(np.all(np.asarray(r.tokens) < cfg.vocab_size)
               for r in rt.completed)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-scout-17b-a16e", "qwen2-vl-72b",
                                  "gemma2-9b"])
def test_family_runtime_launches_every_kernel(cuda, arch):
    """A reduced MoE (Gq 1 for deepseek, 2 for llama4-scout's reduced
    heads), M-RoPE or gemma-2 (softcap, window 16 on alternate layers,
    crossed by the 64-token prompts) model served PD-separated on the
    paged arena goes through all three kernels, and its routing and
    positions run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

    cfg = get_config(arch + "-reduced")
    rt = ServingRuntime(
        static_profile=Profile(StrategyConfig(
            quantizer="uniform", key_bits=8, value_bits=8,
            granularity="per_token", symmetric=True, group_size=16),
            cr=2.0, s_enc=5e8, s_dec=5e8),
        config=RuntimeConfig(seq=64, decode_tokens=6, mode="pd", paged=True,
                             page_size=8, pd_inject_restored=True),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=4, max_prefills_per_step=2),
        device=cuda)
    rt.model_cfg = cfg
    rt.params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    reset_launches()
    for seed in (0, 1, 0):           # the third request is a pool hit
        rt.submit("qalike", prompt_seed=seed)
    rt.run()
    counts = launches()
    assert [r.pool_hit for r in sorted(rt.completed, key=lambda r: r.rid)] \
        == [False, False, True]
    assert counts["quant_pack_op"] >= 2 and counts["dequant_unpack_op"] >= 2
    assert counts["paged_attention_arena_op"] > 0
    for dw in rt.decode_workers:
        dw.page_table.check()
        assert dw.page_table.free_pages == dw.page_table.num_pages - 1


@pytest.mark.parametrize("arch,seq", [("deepseek-moe-16b", 46),
                                      ("gemma2-9b", 4096),
                                      ("deepseek-v2-lite", 46)])
def test_paged_step_graph_replays_the_plain_step(cuda, arch, seq):
    """A decode worker's one-token step, captured once as a CUDA graph and
    replayed, against the plain ``_paged_steps`` arena call on copies of
    the same pools (``test_torch_paged_step.held_to_plain_step``: joins,
    a quant-resident landing, a parked slot, a release, page growth
    across a boundary): tokens and every non-scratch page bit-equal at
    each of the 20 steps.  Two-layer cuts at full width: deepseek's dense
    layer and an MoE layer (64 experts top-6, 2 shared, 16 x 128 MHA);
    gemma2's local layer (window 4096, crossed from step 0) and global
    layer, cap 50; deepseek-v2-lite's dense layer (10944 wide) and an MoE
    layer over its latent and rope pages.  One capture, one replay a step,
    and the replays add
    the captured launches to the wrappers' counters; rebinding the params
    or the pools captures again."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config, register
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.workers import PagedStep
    from repro_torch.utils import timing
    from test_torch_paged_step import STEPS, held_to_plain_step

    cfg = register(dataclasses.replace(get_config(arch), name=f"{arch}-2l",
                                       num_layers=2))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    seen = []

    def hook(dw, i, n):
        assert dw._paged_step.graph is not None
        seen.append(n)

    tracer = timing.Tracer()
    timing.install(tracer)
    try:
        dw = held_to_plain_step(cfg, params, cuda, seq, step_hook=hook)
        dw.model.params = {k: v for k, v in params.items()}
        dw.model.params["final_norm"] = {
            k: t.clone() for k, t in params["final_norm"].items()}
        dw.decode_iteration([])
        dw._arena = None
        dw.decode_iteration([])
    finally:
        timing.uninstall()
    counts = collections.Counter()
    for c in tracer.counts:
        counts[c.name] += c.value
    assert counts["decode_graph_capture"] == 3
    assert counts["decode_graph_replay"] == STEPS + 2
    assert seen == [(PagedStep.WARMUP + 1) * 2] + [2] * (STEPS - 1)


def test_speculative_runtime_launches_the_verify_kernel(cuda):
    """A reduced llama3.1-8b served speculatively on the paged arena takes
    its verify steps through the verify kernel.  The two-model draft (the
    target as its own draft) always offers drafts; n-gram lookahead finds
    none in a random model's output."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

    cfg = get_config("llama3.1-8b-reduced")
    rt = ServingRuntime(
        static_profile=Profile(StrategyConfig(
            quantizer="uniform", key_bits=8, value_bits=8,
            granularity="per_token", symmetric=True, group_size=16),
            cr=2.0, s_enc=5e8, s_dec=5e8),
        config=RuntimeConfig(seq=64, decode_tokens=12, mode="pd",
                             paged=True, page_size=8, spec_k=4,
                             spec_kind="model"),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=4, max_prefills_per_step=2),
        device=cuda)
    rt.model_cfg = cfg
    rt.params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    reset_launches()
    for seed in (0, 1, 0):
        rt.submit("codelike", prompt_seed=seed)
    rt.run()
    counts = launches()
    done = rt.completed
    assert len(done) == 3
    assert sum(r.drafts_offered for r in done) > 0
    assert sum(r.verify_steps for r in done) > 0
    assert counts["paged_verify_attention_arena_op"] > 0
    for dw in rt.decode_workers:
        dw.page_table.check()
        assert dw.page_table.free_pages == dw.page_table.num_pages - 1


def _hadamard_tile_rows(d: int) -> int:
    """hadamard.cu's rows per tile: 256 threads, 8 columns a thread (4 at
    D = 4), 2 rows a thread."""
    return 256 // (d // min(d, 8)) * 2


@pytest.mark.parametrize("d", [4, 8, 64, 128, 256, 512])
@pytest.mark.parametrize("t", [1, 77, 4096, "tile-1", "tile+1"])
def test_hadamard(cuda, d, t):
    """Against the plain version within 1e-5 of each row's norm, and bit
    for bit against numpy's ``x @ h`` on the host at D 64, 128 and 256
    (at D 4, 8 and 512 BLAS may block or vectorise K otherwise); bf16 out
    is the f32 result rounded, for f32 and bf16 in."""
    from repro_torch.core.transforms import hadamard_matrix

    if isinstance(t, str):
        t = _hadamard_tile_rows(d) + (1 if t == "tile+1" else -1)
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    x = torch.randn(t, d, generator=gen, device=cuda) * 3
    x[:, 3 % d] *= 40                              # an outlier channel
    h = hadamard_matrix(d)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        before = hadamard_op.launches
        got = hadamard_op(xd, out_dtype=torch.float32)
        assert hadamard_op.launches == before + 1
        norm = xd.float().norm(dim=1, keepdim=True)
        want = R.hadamard_ref(xd, torch.float32)
        assert bool(((got - want).abs() <= 1e-5 * norm).all())
        # numpy takes a vector routine, which sums in another order, for
        # a single row: hold that row against its product as a matrix
        xh = xd.float().cpu().numpy()
        host = (np.concatenate([xh, xh]) @ h)[:t] if t == 1 else xh @ h
        if d in (64, 128, 256):
            np.testing.assert_array_equal(got.cpu().numpy(), host)
        assert torch.equal(hadamard_op(xd, out_dtype=torch.bfloat16),
                           got.to(torch.bfloat16))
        # out_dtype defaults to x's: bf16 out is the f32 result rounded
        assert torch.equal(hadamard_op(xd), got.to(dt))
        # H is symmetric and orthonormal: the transform is an involution
        back = hadamard_op(got)
        assert bool(((back - xd.float()).abs() <= 1e-5 * norm).all())


def test_device_hadamard_stage_keeps_the_host_wire_bytes(cuda):
    """A Hadamard + int8 per-token strategy compresses device KV through
    hadamard and quant_pack, to the host path's bytes, and decompresses
    through dequant_unpack and hadamard on the card."""
    from repro_torch.core.pipeline import CompressionPipeline, DeviceKVCache
    from repro_torch.core.strategy import StrategyConfig

    gen = torch.Generator(device=cuda).manual_seed(3)
    k, v = (torch.randn(4, 2, 77, 128, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kv = DeviceKVCache(k, v)
    cfg = StrategyConfig(transform="hadamard", quantizer="uniform",
                         key_bits=8, value_bits=8, granularity="per_token",
                         symmetric=True, group_size=64)
    reset_launches()
    got = CompressionPipeline(cfg).compress(kv)
    want = CompressionPipeline(cfg).compress(kv.to_host())
    assert launches()["hadamard_op"] == 2 and launches()["quant_pack_op"] == 2
    assert got.total_bytes() == want.total_bytes()
    for gb, wb in zip(got.k_buckets + got.v_buckets,
                      want.k_buckets + want.v_buckets):
        assert gb.payload == wb.payload
        np.testing.assert_array_equal(gb.scale, wb.scale)
    restored = CompressionPipeline(cfg, device=cuda).decompress(got)
    host = CompressionPipeline(cfg).decompress(want)
    assert launches()["dequant_unpack_op"] == 2
    assert launches()["hadamard_op"] == 4
    np.testing.assert_array_equal(restored.k.cpu().numpy(), host.k)
    np.testing.assert_array_equal(restored.v.cpu().numpy(), host.v)


# ---------------------------------------------------------------------------
# training and the cross-pod paths: the quantizer round trip through the
# kernels, bit for bit against the plain version on the host
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(3, 4, 128), (64,), (5, 32), (4096, 192)])
def test_grad_roundtrip_kernels_equal_plain(cuda, bits, shape):
    from repro_torch.distribution.grad_compress import _quant_roundtrip

    n, d = int(np.prod(shape)), shape[-1]
    x = boundary_rows(n // d, d, min(64, d), bits, False,
                      seed=n).reshape(shape)
    reset_launches()
    got = _quant_roundtrip(torch.from_numpy(x).to(cuda), bits, 64)
    want = _quant_roundtrip(torch.from_numpy(x), bits, 64)
    assert launches()["quant_pack_op"] == launches()["dequant_unpack_op"] == 1
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


def test_odd_group_on_the_card_raises(cuda):
    """The kernels take even groups only; a card tensor with an odd group
    is refused, not quantized by the plain version."""
    from repro_torch.distribution.grad_compress import _quant_roundtrip

    x = torch.ones(7, 3, device=cuda)
    reset_launches()
    with pytest.raises(ValueError):
        _quant_roundtrip(x, 8, 64)
    assert launches()["quant_pack_op"] == 0


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_sym_kernels_equal_plain(cuda, bits, dtype):
    from repro_torch.distribution.kv_transfer import (
        dequantize_sym, quantize_sym)

    x = torch.from_numpy(boundary_rows(
        96, 128, 64, bits, dtype == torch.bfloat16, seed=bits)).to(dtype)
    x = x.reshape(2, 48, 128)
    q, s = quantize_sym(x.to(cuda), bits, 64)
    wq, ws = quantize_sym(x, bits, 64)
    assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws)
    for out in (torch.bfloat16, torch.float32, torch.float16):
        assert torch.equal(dequantize_sym(q, s, 64, dtype=out).cpu(),
                           dequantize_sym(wq, ws, 64, dtype=out))


def test_train_step_with_compression_launches_the_kernels(cuda, tmp_path):
    """A reduced llama train step on the card: finite loss, quant_pack
    and dequant_unpack once per leaf; its state checkpoints
    and restores onto the card (and onto the host) bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.grad_compress import (
        init_ef_state, make_grad_transform)
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.models.convert import flatten

    cfg = get_config("llama3.1-8b-reduced")
    params = init_params(cfg, seed=0, device=cuda)
    opt = init_opt_state(params)
    opt["ef"] = init_ef_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=4),
                           remat=True, grad_transform=make_grad_transform(8))
    tokens, mask = make_batch("mixed", 2, 64, seed=0)
    reset_launches()
    params, opt, m = step(params, opt, {
        "tokens": torch.as_tensor(tokens).to(cuda),
        "mask": torch.as_tensor(mask[:, 1:]).to(cuda)})
    n = len(list(flatten(params)))
    assert np.isfinite(float(m["loss"]))
    assert launches()["quant_pack_op"] == launches()["dequant_unpack_op"] == n
    state = {"params": params, "opt": opt}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    for dev in (cuda, torch.device("cpu")):
        back = mgr.restore(state, device=dev)
        for (path, a), (_, b) in zip(flatten(state), flatten(back)):
            assert b.device.type == dev.type, path
            assert torch.equal(a.cpu(), b.cpu()), path


_RESTORE_ON_CUDA_MESH = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.distribution.sharding import tree_shardings
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import init_params
from repro_torch.models.axes import param_axes
from repro_torch.models.convert import flatten

torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[2],
                        rank=0, world_size=1)
cfg = get_config("tiny-lm")
params = init_params(cfg, seed=1, device="cuda")
mgr = CheckpointManager(sys.argv[1])
mgr.save(1, params)
mesh = make_test_mesh(data=1, model=1, device_type="cuda")
shardings = tree_shardings(param_axes(cfg), params, mesh)
back = mgr.restore(init_params(cfg, device="meta"), shardings=shardings)
for (path, a), (_, b) in zip(flatten(params), flatten(back)):
    assert isinstance(b, DTensor) and b.device.type == "cuda", path
    assert torch.equal(a, b.to_local()), path
dist.destroy_process_group()
print("ok")
"""


def test_restore_with_shardings_onto_a_cuda_mesh(cuda, tmp_path):
    """``CheckpointManager.restore(..., shardings=)`` lands every leaf as a
    DTensor on a one-rank NCCL mesh on the card, bit-equal to the saved
    tensors (its own process: the group is the process's default)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent
                                          / "src"))
    r = subprocess.run([sys.executable, "-c", _RESTORE_ON_CUDA_MESH,
                        str(tmp_path / "ckpt"), str(tmp_path / "init")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-3000:]


def _mla_case(dev, seed, b, ps=16, pps=521):
    """The published shape: H 16, latent 512, rope key 64; slot i's
    kv_len spread over 1k-8k (row 0 the longest), the last row parked
    (its table all the scratch page 0) where b > 2."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * pps
    lat = torch.randn((n_pages, ps, 1, 512), generator=gen,
                      device=dev).to(torch.bfloat16)
    rope = (torch.randn((n_pages, ps, 1, 64), generator=gen, device=dev)
            * 2).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, pps).to(torch.int32)
    lens = torch.linspace(8192, 1024, b, device=dev).round().to(torch.int32)
    if b > 2:
        bt[-1] = 0
        lens[-1] = pps * ps - 1
    q_abs = (torch.randn((b, 16, 512), generator=gen, device=dev)
             * 0.05).to(torch.bfloat16)
    q_pe = (torch.randn((b, 16, 64), generator=gen, device=dev)
            * 0.05).to(torch.bfloat16)
    return q_abs, q_pe, lat, rope, bt, lens, 192 ** -0.5 * 1.5896


@pytest.mark.parametrize("b", [1, 3, 16])
def test_paged_mla_attention(cuda, b):
    args = _mla_case(cuda, b, b)
    out, m, l = paged_mla_attention_op(*args)
    r_out, r_m, r_l = R.paged_mla_attention_ref(*args)
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-4, atol=0)
    near = 1e-4 * float(r_l.max())
    assert _bf16_ulps(out, r_out, atol=near) <= 2
    again = paged_mla_attention_op(*args)
    for x, y in zip((out, m, l), again):
        assert torch.equal(x, y)
    if b > 2:       # the parked row sees nothing
        assert torch.all(m[-1] == float("-inf")) and torch.all(l[-1] == 0)
        assert torch.all(out[-1] == 0)


def test_mha_arena_keeps_its_bits_beside_the_mla_kernel(cuda):
    """deepseek-moe-16b's decode read (B 16, Hkv 16, Gq 1, D 128) gives
    the same bits before and after the MLA library is loaded and run on
    the same stream, within 2 ulps of its plain version."""
    args = _arena_case(cuda, 5, b=6, hkv=16, gq=1, d=128)
    before = paged_attention_arena_op(*args)
    paged_mla_attention_op(*_mla_case(cuda, 9, 3))
    after = paged_attention_arena_op(*args)
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    r_out, r_m, r_l = R.paged_attention_arena_ref(*args)
    torch.testing.assert_close(after[1], r_m, rtol=1e-5, atol=0)
    assert _bf16_ulps(after[0], r_out) <= 2


# ---------------------------------------------------------------------------
# the identity profile's codec on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite"])
def test_identity_device_codec_keeps_the_host_paths_bits(cuda, arch):
    """At the cells' cache widths (MHA 16 x 128 a part; MLA's 512-wide
    latent and 64-wide rope key) and 512 positions: the identity payload
    is the old host path's (``to_host()``, numpy's concatenate and fp16
    cast) by digest, fp16's overflow and subnormal edges included; the
    paged arena landed from its restore on the card is bit-equal to one
    landed from the host-decoded arrays; and a second, shorter payload
    made through the same pinned block leaves the first unchanged."""
    import hashlib

    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as P
    from repro_torch.core.profiles import IDENTITY_PROFILE
    from repro_torch.core.quality import (
        _attn_layers, init_paged_pools, inject_kv_paged)

    cfg, strategy, seq, page = get_config(arch), IDENTITY_PROFILE.strategy, \
        512, 16
    part, name, _ = _attn_layers(cfg)[0]
    leaf = init_paged_pools(cfg, 2, page, 64, device=cuda)[0][part][name]
    n_layers = len(_attn_layers(cfg))
    gen = torch.Generator(device=cuda).manual_seed(31)
    k, v = ((torch.randn((n_layers, *leaf[key].shape[-2:-1], seq,
                          leaf[key].shape[-1]), generator=gen, device=cuda)
             * 3).to(torch.bfloat16) for key in ("k", "v"))
    edges = torch.tensor([65504.0, 65520.0, -7e4, 2.0 ** -24, 2.0 ** -25,
                          3 * 2.0 ** -25, -(2.0 ** -26), -0.0, 1e-9],
                         device=cuda).to(torch.bfloat16)
    for t in (k, v):
        t.view(-1)[:edges.numel()] = edges

    def host_payload(kv):
        h = kv.to_host()
        with np.errstate(over="ignore"):
            return np.concatenate([h.k.ravel(), h.v.ravel()]) \
                .astype(np.float16).tobytes()

    def digest(b):
        return hashlib.sha256(b).hexdigest()

    kv = P.DeviceKVCache(k, v)
    first = P.CompressionPipeline(strategy).compress(kv)
    want = digest(host_payload(kv))
    assert digest(first.identity_payload) == want
    assert P._staging(8, cuda).is_pinned()
    # 3/4 of the positions: the same power-of-two pinned block, reused
    short = P.DeviceKVCache(k[:, :, :seq * 3 // 4].contiguous(),
                            v[:, :, :seq * 3 // 4].contiguous())
    second = P.CompressionPipeline(strategy).compress(short)
    assert digest(second.identity_payload) == digest(host_payload(short))
    assert digest(first.identity_payload) == want
    assert len(second.identity_payload) * 4 == len(first.identity_payload) * 3

    pages = list(range(1, seq // page + 1))
    landed = []
    for restored in (P.CompressionPipeline(strategy, device=cuda)
                     .decompress(first),
                     P.CompressionPipeline(strategy).decompress(first)):
        assert isinstance(restored, P.DeviceKVCache) == (not landed)
        pool = init_paged_pools(cfg, len(pages) + 1, page, 64,
                                device=cuda)[0]
        landed.append(inject_kv_paged(cfg, pool, pages, restored, page))
    got, ref = landed
    for part in ("prefix", "blocks"):
        for name, c in ref[part].items():
            for key, t in c.items():
                assert torch.equal(got[part][name][key].view(torch.int16),
                                   t.view(torch.int16)), (part, name, key)
    assert digest(first.identity_payload) == want
