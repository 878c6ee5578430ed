"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU every ``*_op`` of the port takes its plain PyTorch version, so
these tests hold those versions against the JAX package: its Pallas
kernels in interpret mode and its oracles compiled with XLA's excess
precision off (:func:`_exact`), so each operation rounds at its written
dtype, as the port computes.  Inputs are made with numpy
from a seed.  ``test_torch_gpu.py`` holds the CUDA kernels themselves
against these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quality as JQ  # noqa: E402
from repro.core.quantizers import group_dequantize, group_quantize  # noqa: E402
from repro.kernels import ops as K  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    dequant_unpack_op,
    paged_attention_arena_op,
    paged_attention_op,
    quant_pack_op,
)
from repro_torch.kernels import ref as R  # noqa: E402


def _t(a, dtype=None):
    """numpy/jax array -> CPU torch tensor (bf16 via f32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 units in the last place (same signs)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32) >> 16
        return np.where(i < 0, -(i & 0x7FFF), i).astype(np.int64)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _exact(fn, *args):
    """``fn(*args)`` jitted with ``xla_allow_excess_precision`` off: XLA's
    default keeps f32 inside fused CPU kernels where the JAX code rounds
    to bf16.  Equal, bit for bit, to running ``fn`` op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---------------------------------------------------------------------------
# quant_pack / dequant_unpack: bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t", [1, 7, 129, 256])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quant_pack_matches_jax_bit_for_bit(bits, t, dtype):
    d, group = 128, 64
    rng = np.random.default_rng(1000 + t + bits)
    x = jnp.asarray(rng.standard_normal((t, d)) * 3, dtype)
    codes, scales = quant_pack_op(_t(x), bits=bits, group=group)
    # op by op: compiled whole, XLA turns the divide by the group scale
    # into a multiply by its reciprocal, which the host quantizer (the
    # wire contract) does not
    with jax.disable_jit():
        cref, sref = K.quant_pack_ref(x.astype(jnp.float32), bits, group)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(cref))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sref))
    assert codes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    # the Pallas kernel (interpret mode) agrees on f32 inputs
    if dtype == jnp.float32 and t == 129:
        cop, _ = K.quant_pack_op(x, bits=bits, group=group, interpret=True)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(cop))


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_pack_equals_host_group_quantize(bits):
    """The wire contract: offset codes and fp16 scales equal the numpy
    quantizer's (core/quantizers.py) bit for bit."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 50, 128)) * 2).astype(np.float32)
    codes, scales, _ = group_quantize(x, bits, "per_token", 32, True)
    c, s = quant_pack_op(_t(x.reshape(-1, 128)), bits=bits, group=32)
    c = R.unpack_int4_ref(c) if bits == 4 else c
    u = (c.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8)
    np.testing.assert_array_equal(u.numpy().reshape(codes.shape), codes)
    np.testing.assert_array_equal(
        s.to(torch.float16).numpy().reshape(scales.shape), scales)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("out_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("t", [5, 128])
def test_dequant_unpack_matches_jax_bit_for_bit(bits, out_dtype, t):
    rng = np.random.default_rng(bits + t)
    x = jnp.asarray(rng.standard_normal((t, 64)) * 3, jnp.float32)
    codes, scales = K.quant_pack_ref(x, bits, 32)
    want = K.dequant_unpack_op(codes, scales, bits=bits, group=32,
                               out_dtype=out_dtype, interpret=True)
    got = dequant_unpack_op(_t(codes), _t(scales), bits=bits, group=32,
                            out_dtype=torch.float32
                            if out_dtype == jnp.float32 else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_dequant_unpack_equals_host_group_dequantize():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 40, 128)) * 2).astype(np.float32)
    codes, scales, zp = group_quantize(x, 8, "per_token", 64, True)
    want = group_dequantize(codes, scales, zp, 8, "per_token", 64, True)
    signed = _t((codes.astype(np.int16) - 128).astype(np.int8)).reshape(-1, 128)
    got = dequant_unpack_op(signed, _t(scales.astype(np.float32)).reshape(-1, 2),
                            bits=8, group=64, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


# ---------------------------------------------------------------------------
# paged_attention (a): the Pallas interface
# ---------------------------------------------------------------------------
def _paged_pools(k, v, bits, group, page_size, rng):
    """Scatter dense (B,H,S,D) K/V into shuffled quantized page pools."""
    b, hkv, s, d = k.shape
    kc8, ks = K.quantize_ref(k, bits, group)
    vc8, vs = K.quantize_ref(v, bits, group)
    kc = K.pack_int4_ref(kc8) if bits == 4 else kc8
    vc = K.pack_int4_ref(vc8) if bits == 4 else vc8
    pps = s // page_size
    n_pages = 1 + b * pps          # page 0 = scratch, never mapped
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, pps)
    cw, cdt = kc.shape[-1], np.asarray(kc).dtype
    pools = [np.zeros((n_pages, hkv, page_size, cw), cdt),
             np.zeros((n_pages, hkv, page_size, d // group), np.float32),
             np.zeros((n_pages, hkv, page_size, cw), cdt),
             np.zeros((n_pages, hkv, page_size, d // group), np.float32)]
    for i in range(b):
        for p in range(pps):
            sl = slice(p * page_size, (p + 1) * page_size)
            for pool, src in zip(pools, (kc, ks, vc, vs)):
                pool[bt[i, p]] = np.asarray(src[i, :, sl])
    return pools, bt.astype(np.int32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,hkv,gq,d,s,group,ps", [
    (2, 2, 4, 64, 256, 32, 16),
    (1, 4, 8, 128, 128, 64, 8),
    (3, 1, 2, 128, 512, 128, 64),
])
def test_paged_attention_matches_jax(bits, b, hkv, gq, d, s, group, ps):
    rng = np.random.default_rng(bits * 31 + s + ps)
    q = rng.standard_normal((b, hkv, gq, d)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    pools, bt = _paged_pools(k, v, bits, group, ps, rng)
    kv_lens = np.asarray([s, max(s // 2 - 3, 1), 1][:b], np.int32)
    want = K.paged_attention_op(jnp.asarray(q), *map(jnp.asarray, pools),
                                jnp.asarray(bt), jnp.asarray(kv_lens),
                                bits=bits, group=group, interpret=True)
    got = paged_attention_op(_t(q), *map(_t, pools), _t(bt), _t(kv_lens),
                             bits=bits, group=group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_paged_attention_scratch_pages_inert():
    """Poison the scratch page 0 and point every beyond-length entry at
    it: no row's output may move."""
    rng = np.random.default_rng(5)
    b, hkv, gq, d, s, group, ps = 2, 2, 4, 64, 128, 32, 16
    q = _t(rng.standard_normal((b, hkv, gq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    pools, bt = _paged_pools(k, v, 8, group, ps, rng)
    bt[:, 2:] = 0
    kv_lens = _t(np.asarray([ps + 3, ps], np.int32))
    out_a = paged_attention_op(q, *map(_t, pools), _t(bt), kv_lens, bits=8,
                               group=group)
    poisoned = [p.copy() for p in pools]
    poisoned[0][0], poisoned[2][0] = 127, -128
    poisoned[1][0], poisoned[3][0] = 1e9, 1e9
    out_b = paged_attention_op(q, *map(_t, poisoned), _t(bt), kv_lens,
                               bits=8, group=group)
    np.testing.assert_array_equal(out_a.numpy(), out_b.numpy())


# ---------------------------------------------------------------------------
# paged_attention (b): the serving arena's layout and rounding points
# ---------------------------------------------------------------------------
def _arena_case(seed, b=4, hkv=2, gq=2, d=32, ps=8, pps=5, group=16):
    """Random arena pools (P, PS, Hkv, D), shuffled block tables, mixed
    quant / fp residency, a parked row at the view's last position."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * pps
    shape = (n_pages, ps, hkv, d)
    fp = lambda: np.asarray(jnp.asarray(rng.standard_normal(shape),  # noqa: E731
                                        jnp.bfloat16))
    codes = lambda: rng.integers(-128, 128, shape).astype(np.int8)  # noqa: E731
    # per-channel scales that are fp16 group scales broadcast (the runtime's)
    def scales():
        g = (rng.random(shape[:-1] + (d // group,)) * 0.05 + 1e-3)
        return np.repeat(g.astype(np.float16).astype(np.float32), group, -1)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, pps).astype(
        np.int32)
    view = pps * ps
    kv_lens = np.asarray([view - 1, 17, 3, view - 1][:b], np.int32)
    quant_lens = np.asarray([24, 9, 0, 0][:b], np.int32)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, gq, d)),
                               jnp.bfloat16))
    return q, (fp(), fp(), codes(), scales(), codes(), scales()), bt, \
        kv_lens, quant_lens


def _jax_arena_attention(q, pools, bt, kv_lens, quant_lens):
    """The JAX package's decode read of the paged arena, op by op:
    _blend_quant over _paged_view, then multihead_attention's stats."""
    b, hkv, gq, d = q.shape

    def read(q, kp, vp, kc, ks, vc, vs, bt, ql, pos):
        kview = JQ._blend_quant(JQ._paged_view(kp, bt, True),
                                JQ._paged_view(kc, bt, True),
                                JQ._paged_view(ks, bt, True), ql, True)
        vview = JQ._blend_quant(JQ._paged_view(vp, bt, True),
                                JQ._paged_view(vc, bt, True),
                                JQ._paged_view(vs, bt, True), ql, True)
        return JL.multihead_attention(
            q.reshape(b, 1, hkv * gq, d), kview, vview,
            q_positions=pos[:, None],
            k_positions=jnp.arange(kview.shape[1], dtype=jnp.int32),
            causal=True, kv_valid=pos, return_stats=True)

    out, m, l = _exact(read, *map(jnp.asarray, (q, *pools, bt, quant_lens,
                                                  kv_lens)))
    return (np.asarray(out[:, :, :, 0], np.float32),
            np.asarray(m[..., 0]), np.asarray(l[..., 0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_attention_arena_matches_jax_decode_read(seed):
    q, pools, bt, kv_lens, quant_lens = _arena_case(seed)
    want_out, want_m, want_l = _jax_arena_attention(q, pools, bt, kv_lens,
                                                    quant_lens)
    out, m, l = paged_attention_arena_op(
        _t(q), *map(_t, pools), _t(bt), _t(kv_lens), _t(quant_lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=1e-5)
    assert _bf16_ulps(out.float().numpy(), want_out) <= 2
    # the plain version is the same function as paged_attention_arena_ref
    ref = R.paged_attention_arena_ref(_t(q), *map(_t, pools), _t(bt),
                                      _t(kv_lens), _t(quant_lens))
    np.testing.assert_array_equal(out.float().numpy(), ref[0].float().numpy())


def test_paged_attention_arena_scratch_and_tail_inert():
    """Positions at or beyond a slot's length (scratch page included)
    never reach its output."""
    q, pools, bt, kv_lens, quant_lens = _arena_case(7)
    bt[1, 3:] = 0
    base = paged_attention_arena_op(_t(q), *map(_t, pools), _t(bt),
                                    _t(kv_lens), _t(quant_lens))
    poisoned = [p.copy() for p in pools]
    for p in poisoned:
        p[0] = 100
    row1_tail = bt[1, kv_lens[1] // 8 + 1:]
    for p in poisoned:
        p[row1_tail[row1_tail > 0]] = 100
    again = paged_attention_arena_op(_t(q), *map(_t, poisoned), _t(bt),
                                     _t(kv_lens), _t(quant_lens))
    for x, y in zip(base, again):
        np.testing.assert_array_equal(x[1:3].float().numpy(),
                                      y[1:3].float().numpy())


# ---------------------------------------------------------------------------
# dispatch: no hidden fallback
# ---------------------------------------------------------------------------
def test_interpret_false_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        quant_pack_op(torch.zeros(4, 64), interpret=False)
