"""The split design of the decode_attention kernel, on the CPU.

``csrc/decode_attention.cu`` cuts each slot's positions into splits of a
fixed 64 positions (flash-decoding): phase 1 writes, per (row, split), the
split's local max m, its denominator l and its unnormalized f32 sum of
p * v; phase 2 takes M, the max of the splits' m, and sums l and the
output over the splits in split order, each split rescaled by
exp(m_i - M), then divides by max(l, 1e-30).  A CUDA kernel has no CPU
mode, so these tests hold a step-by-step model of that arithmetic against
the plain version (``ref.decode_attention_ref``) and the JAX Pallas kernel
in interpret mode, at the kernel's tolerances: f32 q within atol 2e-5 +
rtol 1e-4 (f32 sums in another order); bf16 q within 1 bf16 ulp wherever
the difference exceeds atol 2e-5 (one bf16 ulp of an output below 2.6e-3
is finer than the f32 sums' order sets).  Inputs are made with numpy from
a seed.  ``test_torch_gpu.py`` holds the kernel itself.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ops as O  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

SPLIT = O._DECODE_SPLIT            # decode_attention.cu's kSplit
B, HKV, GQ, D, S, GROUP, BLOCK_S = 3, 2, 4, 64, 256, 32, 64
LENS = (1, SPLIT - 1, SPLIT + 1)   # one position, split - 1, split + 1
STATIC = 2 * SPLIT + 1             # a last split of one position


def _split_model(q, kc, ks, vc, vs, bits, group, kv_len):
    """decode_attention's two phases over the whole batch at once: every
    slot padded to ceil(S / 64) splits, those past its length holding the
    neutral element (m = -inf, l = 0, a zero sum), which phase 2's
    rescale factor exp(-inf) = 0 turns into exact zeros."""
    if bits == 4:
        kc, vc = R.unpack_int4_ref(kc), R.unpack_int4_ref(vc)
    b, hkv, gq, d = q.shape
    s = kc.shape[2]
    ns = -(-s // SPLIT)
    k = R.dequantize_ref(kc, ks, group)                 # (B, Hkv, S, D)
    v = R.dequantize_ref(vc, vs, group)
    if kv_len is None:
        lens = torch.full((b,), s)
    elif isinstance(kv_len, torch.Tensor):
        lens = kv_len.long().clamp(max=s)
    else:
        lens = torch.full((b,), min(int(kv_len), s))
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k) \
        * (1.0 / math.sqrt(d))
    seen = torch.arange(s)[None, :] < lens[:, None]     # (B, S)
    pad = ns * SPLIT - s
    scores = torch.nn.functional.pad(
        scores.masked_fill(~seen[:, None, None, :], -math.inf), (0, pad),
        value=-math.inf).reshape(b, hkv, gq, ns, SPLIT)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(
        b, hkv, ns, SPLIT, d)
    # phase 1, per (row, split)
    m = scores.amax(-1)                                  # (B, Hkv, Gq, ns)
    p = torch.where(m[..., None] == -math.inf, torch.zeros(()),
                    torch.exp(scores - m[..., None]))
    l_i = p.sum(-1)
    acc = torch.einsum("bhgnj,bhnjd->bhgnd", p, v)
    # phase 2: rescale to the splits' max, sum in split order
    mx = m.amax(-1, keepdim=True)
    a = torch.exp(m - mx)
    l_tot = torch.zeros(l_i.shape[:-1])
    out = torch.zeros(acc.shape[:-2] + (d,))
    for i in range(ns):
        l_tot = l_tot + a[..., i] * l_i[..., i]
        out = out + a[..., i, None] * acc[..., i, :]
    return (out / l_tot.clamp_min(1e-30)[..., None]).to(q.dtype)


def _case(seed, bits, q_dtype, near_zero=False):
    """(q for JAX, codes and scales for JAX, the same for torch)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV, GQ, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    if near_zero:
        # a near-uniform softmax over V rows that cancel in pairs: every
        # output lies within a few 1e-3 of zero
        q *= 1e-3
        v[:, :, 1::2] = -v[:, :, 0::2]
    jq = jnp.asarray(q, q_dtype)
    jkv = []
    for x in (k, v):
        c8, sc = K.quantize_ref(jnp.asarray(x), bits, GROUP)
        jkv += [K.pack_int4_ref(c8) if bits == 4 else c8, sc]
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        torch.float32 if q_dtype == jnp.float32 else torch.bfloat16)
    return jq, jkv, [tq] + [torch.from_numpy(np.array(a)) for a in jkv]


def _kv_len(kind):
    if kind == "vector":
        return (torch.tensor(LENS, dtype=torch.int32),
                jnp.asarray(LENS, jnp.int32))
    return {"none": (None, None), "static": (STATIC, STATIC)}[kind]


def _hold(got, want):
    """The kernel's tolerance: f32 atol 2e-5 + rtol 1e-4; bf16 one ulp
    wherever the difference exceeds atol 2e-5."""
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)
    else:
        diff = np.abs(g - w)
        ulp = np.abs(w) * 2.0 ** -7
        assert bool(np.all((diff <= ulp) | (diff <= 2e-5)))


@pytest.mark.parametrize("kind", ["none", "static", "vector"])
@pytest.mark.parametrize("q_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits", [4, 8])
def test_split_model_matches_plain_and_pallas(bits, q_dtype, kind):
    jq, jkv, (q, kc, ks, vc, vs) = _case(7 + bits, bits, q_dtype)
    kv_len, jax_len = _kv_len(kind)
    got = _split_model(q, kc, ks, vc, vs, bits, GROUP, kv_len)
    plain = O.decode_attention_op(q, kc, ks, vc, vs, bits=bits, group=GROUP,
                                  kv_len=kv_len, block_s=BLOCK_S)
    _hold(got, plain)
    pallas = K.decode_attention_op(jq, *jkv, bits=bits, group=GROUP,
                                   kv_len=jax_len, block_s=BLOCK_S,
                                   interpret=True)
    _hold(got, np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
def test_split_model_near_zero_bf16(bits):
    """bf16 q with outputs near zero (even lengths, so that every V row
    has its negation in view): the one-ulp gate holds beyond atol 2e-5,
    and the outputs really are that small."""
    jq, jkv, (q, kc, ks, vc, vs) = _case(21 + bits, bits, jnp.bfloat16,
                                         near_zero=True)
    lens = (2, SPLIT - 2, SPLIT + 2)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    jax_len = jnp.asarray(lens, jnp.int32)
    got = _split_model(q, kc, ks, vc, vs, bits, GROUP, kv_len)
    assert float(got.float().abs().max()) < 1e-2
    plain = O.decode_attention_op(q, kc, ks, vc, vs, bits=bits, group=GROUP,
                                  kv_len=kv_len, block_s=BLOCK_S)
    assert plain.dtype == torch.bfloat16
    _hold(got, plain)
    pallas = K.decode_attention_op(jq, *jkv, bits=bits, group=GROUP,
                                   kv_len=jax_len, block_s=BLOCK_S,
                                   interpret=True)
    _hold(got, np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
def test_slot_alone_equals_its_batched_row(bits):
    """Split boundaries and the combine order depend on position indices
    only: each slot alone at its length, as an int, equals its row of the
    batch with the (B,) vector bit for bit, although the batch pads the
    shorter slots with neutral splits."""
    _, _, (q, kc, ks, vc, vs) = _case(3 + bits, bits, jnp.float32)
    lens = torch.tensor(LENS, dtype=torch.int32)
    batch = _split_model(q, kc, ks, vc, vs, bits, GROUP, lens)
    for i, n in enumerate(LENS):
        one = _split_model(*(t[i:i + 1] for t in (q, kc, ks, vc, vs)), bits,
                           GROUP, n)
        assert torch.equal(one[0], batch[i])


def test_one_split_is_the_plain_softmax():
    """A length inside the first split leaves one split to combine, whose
    rescale factor is exp(0) = 1: the model is then the plain softmax up
    to the f32 sums' order."""
    _, _, (q, kc, ks, vc, vs) = _case(5, 8, jnp.float32)
    got = _split_model(q, kc, ks, vc, vs, 8, GROUP, SPLIT)
    want = R.decode_attention_ref(q, kc, ks, vc, vs, GROUP, kv_len=SPLIT)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
