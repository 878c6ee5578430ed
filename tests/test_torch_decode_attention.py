"""The port's decode_attention (repro_torch.kernels) against the JAX package's.

On the CPU ``decode_attention_op`` takes its plain PyTorch version
(``ref.decode_attention_ref`` after unpacking int4 nibbles).  These tests
mirror ``tests/test_kernels.py``'s decode-attention tests and hold that
version against the JAX Pallas kernel in interpret mode (atol 2e-5 /
rtol 1e-4, as there: an online softmax sums in another order) and against
the JAX oracle compiled with XLA's excess precision off (atol 1e-6 /
rtol 1e-5: the same operations, f32 sums in another order).  Inputs are
made with numpy from a seed.  ``test_torch_gpu.py`` holds the CUDA kernel
against the plain version on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as K  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    decode_attention_op,
    paged_attention_op,
)
from repro_torch.kernels import ops as O  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

SHAPES = [  # b, hkv, gq, d, s, group, block_s: tests/test_kernels.py's
    (2, 2, 4, 64, 512, 64, 128),
    (1, 4, 8, 128, 256, 32, 256),
    (3, 1, 2, 128, 1024, 128, 256),
]


def _t(a):
    """numpy/jax array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a))


def _exact(fn, *args):
    """``fn(*args)`` jitted with ``xla_allow_excess_precision`` off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _case(seed, b, hkv, gq, d, s, bits, group):
    """(q, codes as the kernel takes them, unpacked int8 codes, scales)."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b, hkv, gq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    kc8, ks = K.quantize_ref(k, bits, group)
    vc8, vs = K.quantize_ref(v, bits, group)
    kc = K.pack_int4_ref(kc8) if bits == 4 else kc8
    vc = K.pack_int4_ref(vc8) if bits == 4 else vc8
    return q, (kc, ks, vc, vs), (kc8, ks, vc8, vs)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,hkv,gq,d,s,group,blk", SHAPES)
def test_decode_attention_matches_jax(bits, b, hkv, gq, d, s, group, blk):
    q, packed, plain = _case(bits + b + s, b, hkv, gq, d, s, bits, group)
    kv_len = s - s // 4
    got = decode_attention_op(_t(q), *map(_t, packed), bits=bits,
                              group=group, kv_len=kv_len, block_s=blk)
    pallas = K.decode_attention_op(q, *packed, bits=bits, group=group,
                                   kv_len=kv_len, block_s=blk,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=1e-4)
    oracle = _exact(lambda *a: K.decode_attention_ref(*a, group,
                                                      kv_len=kv_len),
                    q, *plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("q_dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_kv_len_forms(bits, q_dtype):
    """None, a static int and a (B,) int32 vector (the slot-arena decode)
    against the JAX oracle; each row of the vector form equals the row
    alone at its own length.  bf16 q: within 1 bf16 ulp of the oracle's
    cast (atol 2e-5 where one bf16 ulp is finer)."""
    b, hkv, gq, d, s, group, blk = 4, 2, 4, 64, 512, 64, 128
    q, packed, plain = _case(31 + bits, b, hkv, gq, d, s, bits, group)
    q = q.astype(q_dtype)
    qt = _t(q.astype(jnp.float32)).to(
        torch.float32 if q_dtype == jnp.float32 else torch.bfloat16)
    lens = np.asarray([s, s // 2, 3, s - 17], np.int32)
    for kv_len, jax_len in ((None, None), (s // 3, s // 3),
                            (_t(lens), jnp.asarray(lens))):
        got = decode_attention_op(qt, *map(_t, packed), bits=bits,
                                  group=group, kv_len=kv_len, block_s=blk)
        want = np.asarray(_exact(
            lambda *a: K.decode_attention_ref(*a, group, kv_len=jax_len),
            q, *plain).astype(jnp.float32))
        g = got.float().numpy()
        if q_dtype == jnp.float32:
            np.testing.assert_allclose(g, want, atol=1e-6, rtol=1e-5)
        else:
            diff = np.abs(g - want)
            ulp = np.abs(want) * 2.0 ** -7
            assert bool(np.all((diff <= ulp) | (diff <= 2e-5)))
    for i, n in enumerate(lens):
        one = decode_attention_op(qt[i:i + 1], *(_t(a[i:i + 1])
                                                 for a in packed),
                                  bits=bits, group=group, kv_len=int(n),
                                  block_s=blk)
        np.testing.assert_allclose(one[0].float().numpy(),
                                   got[i].float().numpy(), atol=2e-5,
                                   rtol=1e-4)


def test_decode_attention_quantized_close_to_exact():
    """int8 KV attention stays close to full-precision attention."""
    b, hkv, gq, d, s = 2, 2, 4, 64, 512
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, hkv, gq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kc, ks = R.quant_pack_ref(_t(k), 8, 64)
    vc, vs = R.quant_pack_ref(_t(v), 8, 64)
    out = decode_attention_op(_t(q), kc, ks, vc, vs, bits=8, group=64)
    scores = np.einsum("bhgd,bhsd->bhgs", q, k) / math.sqrt(d)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    exact = np.einsum("bhgs,bhsd->bhgd", p / p.sum(-1, keepdims=True), v)
    assert float(np.abs(out.numpy() - exact).max()) < 0.05


def _pools(kc, ks, vc, vs, page_size, rng):
    """Scatter dense (B, H, S, ·) codes and scales into shuffled pages."""
    b, hkv, s = kc.shape[:3]
    pps = s // page_size
    n_pages = 1 + b * pps          # page 0 = scratch, never mapped
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, pps)
    pools = [np.zeros((n_pages, hkv, page_size) + a.shape[3:], a.dtype)
             for a in map(np.asarray, (kc, ks, vc, vs))]
    for i in range(b):
        for p in range(pps):
            sl = slice(p * page_size, (p + 1) * page_size)
            for pool, src in zip(pools, (kc, ks, vc, vs)):
                pool[bt[i, p]] = np.asarray(src[i, :, sl])
    return pools, bt.astype(np.int32)


@pytest.mark.parametrize("bits", [4, 8])
def test_paged_attention_equals_dense_over_the_gathered_view(bits):
    """The plain paged attention over a block table equals the plain dense
    decode attention over the pre-scatter arrays: the gather is a pure
    relabeling (test_kernels.py's identity, on the port)."""
    b, hkv, gq, d, s, group, ps = 3, 2, 4, 64, 256, 32, 16
    q, packed, _ = _case(77 + bits, b, hkv, gq, d, s, bits, group)
    pools, bt = _pools(*packed, ps, np.random.default_rng(bits))
    lens = np.asarray([s, s // 2 - 3, 1], np.int32)
    paged = paged_attention_op(_t(q), *map(_t, pools), _t(bt), _t(lens),
                               bits=bits, group=group)
    dense = decode_attention_op(_t(q), *map(_t, packed), bits=bits,
                                group=group, kv_len=_t(lens))
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_decode_attention_refuses_what_the_pallas_kernel_asserts():
    q, packed, _ = _case(5, 1, 2, 4, 64, 128, 8, 64)
    q, packed = _t(q), [_t(a) for a in packed]
    with pytest.raises(ValueError):                     # S % block_s
        decode_attention_op(q, *packed, block_s=48)
    with pytest.raises(ValueError):
        decode_attention_op(q, *packed, bits=5)
    with pytest.raises(ValueError):                     # D % group
        decode_attention_op(q, *packed, group=48)
    with pytest.raises(ValueError):                     # codes' shape
        decode_attention_op(q, packed[0][:, :1].contiguous(), *packed[1:])
    with pytest.raises(ValueError):                     # (B,) lengths
        decode_attention_op(q, *packed, kv_len=torch.ones(
            3, dtype=torch.int32))
    with pytest.raises(TypeError):
        decode_attention_op(q.double(), *packed)
    with pytest.raises(TypeError):                      # int4 wants uint8
        decode_attention_op(q, *packed, bits=4)


@pytest.mark.parametrize("name,rows,d,pps", [
    ("llama3.1-8b decode, 16,400 positions", 4, 128, 1025),
    ("granite-20b decode, Gq 48", 48, 128, 66),
    ("qwen2.5-7b verify, W * Gq = 35", 35, 128, 67),
    ("W = 5 verify, 4,096 positions", 20, 128, 256),
    ("llama3.1-8b, 262,144 positions", 4, 128, 16384),
])
def test_attention_shape_checks_take_long_views_and_many_rows(name, rows, d,
                                                              pps):
    """Neither paged kernel caps a slot's view, its block table or its query
    rows: each block reads only its chunk's (phase A) or tile's (phase B)
    block-table entries, and rows go to tiles.  Only D outside the
    multiples of 16 in [16, 512] and an empty block table are refused."""
    O._check_paged_shape(name, rows, d, pps)
    O._check_paged_shape(name, rows, d, 60_000)
    with pytest.raises(ValueError):
        O._check_paged_shape(name, rows, 100, pps)
    with pytest.raises(ValueError):
        O._check_paged_shape(name, rows, 1024, pps)
    with pytest.raises(ValueError):
        O._check_paged_shape(name, rows, d, 0)
