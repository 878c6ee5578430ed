"""The port's CUDA kernels on the card, against their plain versions.

Every test here launches a Hopper kernel, so every one is marked ``gpu``
and skips where there is no NVIDIA GPU (a CUDA kernel has no CPU mode).
The file imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: quant_pack and dequant_unpack bit for bit; the Pallas-
interface paged (verify) attention within atol 2e-5 / rtol 1e-4 (f32 sums
in another order); the arena entries' m and l within rtol 1e-5 and their
bf16 output within 2 bf16 ulps; hadamard within 1e-5 of each row's L2
norm against its plain version (cuBLAS sums in another order) and bit for
bit against numpy's ``x @ h`` on the host (one in-order FMA chain per
output, a BLAS micro-kernel's order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    dequant_unpack_op,
    hadamard_op,
    launches,
    paged_attention_arena_op,
    paged_attention_op,
    paged_verify_attention_arena_op,
    paged_verify_attention_op,
    quant_pack_op,
    reset_launches,
)
from repro_torch.kernels import ref as R  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    return int((ordered(a) - ordered(b)).abs().max())


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
    args = list(_arena_case(cuda, 0, b=1, pps=4))
    args[0] = torch.zeros(1, 8, 4, 9, 128, dtype=torch.bfloat16,
                          device=cuda)                  # 36 rows > 32
    with pytest.raises(ValueError):
        paged_verify_attention_arena_op(*args)


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


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 77, 4096])
def test_hadamard(cuda, d, t):
    from repro_torch.core.transforms import hadamard_matrix

    gen = torch.Generator(device=cuda).manual_seed(t + d)
    x = torch.randn(t, d, generator=gen, device=cuda) * 3
    x[:, 3] *= 40                                  # an outlier channel
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
        np.testing.assert_array_equal(got.cpu().numpy(), host)
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
