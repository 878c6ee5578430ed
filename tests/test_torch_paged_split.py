"""The split design of the paged attention kernels, on the CPU.

``csrc/paged_split.cuh`` cuts each slot's positions across blocks: phase
A writes every row's scores and each chunk's max, phase B takes the row
max as the max of the chunk maxima and walks the positions in stages of
128, adding each row's denominator as ``kLWidth`` virtual threads (128 for
paged_attention, 32 for paged_verify_attention) and each (row, channel)
output in one chain over the positions in order.  A CUDA kernel has no
CPU mode, so these tests hold a step-by-step model of that arithmetic
against the plain versions (``kernels/ref.py``, bit for bit) and the JAX
package's decode read, and measure why the output's sum is not split into
per-chunk partials.  ``test_torch_gpu.py`` holds the kernels themselves.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quality as JQ  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

_STAGE = 128  # paged_split.cuh's kTileB


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _arena_case(seed, b, hkv, gq, w, d, ps, pps, kv_lens, quant_lens):
    """Arena pools (P, PS, Hkv, D) from numpy, as the runtime fills them:
    bf16 pages, int8 codes and fp16 group scales broadcast per channel."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * pps
    shape = (n_pages, ps, hkv, d)

    def fp():
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    def codes():
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(
            np.int8))

    def scales():
        g = rng.random(shape[:-1] + (d // 16,)) * 0.05 + 1e-3
        return torch.from_numpy(np.repeat(
            g.astype(np.float16).astype(np.float32), 16, -1))

    pools = (fp(), fp(), codes(), scales(), codes(), scales())
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(
        b, pps).astype(np.int32))
    qshape = (b, hkv, gq, d) if w == 1 else (b, hkv, gq, w, d)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(
        np.float32)).to(torch.bfloat16)
    return (q, *pools, bt, torch.tensor(kv_lens, dtype=torch.int32),
            torch.tensor(quant_lens, dtype=torch.int32))


def _split_model(q, kp, vp, kc, ks, vc, vs, bt, kv_lens, quant_lens,
                 chunk=16):
    """The arena entries' arithmetic in the kernels' steps: W = 1 is
    paged_attention_arena (scores as one warp sums them, the denominator
    over 128 virtual threads), W > 1 paged_verify_attention_arena (scores
    in order over D, the denominator over 32).  Returns (out, m, l) shaped
    as the entry returns them."""
    verify = q.dim() == 5
    b, hkv, gq = q.shape[:3]
    d = q.shape[-1]
    k, v = R._arena_kv(kp, vp, kc, ks, vc, vs, bt, quant_lens)
    s = k.shape[1]
    qr = q.float().reshape(b, hkv, -1, 1, d)
    kt = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B, Hkv, 1, S, D)
    dot = R._seq_dot(qr, kt) if verify else R._warp_dot(qr, kt)
    scores = _bf16(dot) * (1.0 / math.sqrt(d))              # (B, Hkv, R, S)
    seen = (torch.arange(s)[None, :] < kv_lens.long()[:, None])[:, None,
                                                                None, :]
    # phase A: each chunk's max over the positions its rows see
    masked = torch.where(seen, scores, -math.inf)
    cmax = [masked[..., c:c + chunk].amax(-1) for c in range(0, s, chunk)]
    m = torch.stack(cmax, -1).amax(-1)
    # phase B: stages of 128 positions, the denominator's virtual threads
    # and one chain per (row, channel) over the positions in order
    lw = 32 if verify else 128
    acc_l = torch.zeros(scores.shape[:-1] + (lw,))
    out = torch.zeros(scores.shape[:-1] + (d,))
    vt = v.float().permute(0, 2, 1, 3)                      # (B, Hkv, S, D)
    for t0 in range(0, s, _STAGE):
        n = min(_STAGE, s - t0)
        p = torch.where(seen[..., t0:t0 + n],
                        torch.exp(scores[..., t0:t0 + n] - m[..., None]),
                        torch.zeros(()))
        for r in range(lw):
            for tt in range(r, n, lw):
                acc_l[..., r] = acc_l[..., r] + p[..., tt]
        pb = _bf16(p)
        for tt in range(n):
            out = out + pb[..., tt, None] * vt[:, :, None, t0 + tt]
    trees = R._butterfly(acc_l.reshape(acc_l.shape[:-1] + (lw // 32, 32)))
    l = trees[..., 0]
    for g in range(1, lw // 32):
        l = l + trees[..., g]
    shape = q.shape[:-1]
    return out.to(torch.bfloat16).reshape(q.shape), m.reshape(shape), \
        l.reshape(shape)


_CASES = {
    # (B, Hkv, Gq, W, D, PS, PPS, kv_lens, quant_lens): views of 160 and
    # 168 positions, so two stages and ten or eleven chunks; lengths at a
    # stage boundary and either side of it, shorter than a chunk, and the
    # parked row at view - 1; quant_lens mid-chunk
    "decode": (3, 2, 4, 1, 128, 8, 20, [128, 65, 159], [40, 0, 129]),
    "decode-short": (3, 2, 4, 1, 64, 8, 20, [1, 17, 63], [1, 9, 0]),
    "verify-w2": (3, 2, 4, 2, 128, 8, 21, [127, 64, 167], [40, 0, 129]),
    "verify-w5": (3, 2, 4, 5, 64, 8, 21, [129, 17, 1], [0, 9, 1]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_split_arithmetic_equals_the_plain_version(case):
    """The split changes no rounding point and no sum's order: the model
    equals paged_(verify_)attention_arena_ref bit for bit."""
    b, hkv, gq, w, d, ps, pps, kv, qv = _CASES[case]
    args = _arena_case(sum(map(ord, case)), b, hkv, gq, w, d, ps, pps, kv,
                       qv)
    plain = (R.paged_attention_arena_ref if w == 1 else
             R.paged_verify_attention_arena_ref)(*args)
    for got, want in zip(_split_model(*args), plain):
        assert torch.equal(got, want)


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_arithmetic_matches_jax_decode_read(seed):
    """The model against the JAX package's decode read of the paged arena
    (_blend_quant over _paged_view, multihead_attention's stats), at the
    arena tolerances: m and l rel 1e-5, out 2 bf16 ulps."""
    b, hkv, gq, w, d, ps, pps, kv, qv = _CASES["decode"]
    args = _arena_case(seed, b, hkv, gq, w, d, ps, pps, kv, qv)
    q, *pools, bt, kv_lens, quant_lens = args

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

    def jnp_of(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    w_out, w_m, w_l = _exact(read, *map(jnp_of, (q, *pools, bt, quant_lens,
                                                kv_lens)))
    out, m, l = _split_model(*args)
    np.testing.assert_allclose(m.numpy(), np.asarray(w_m[..., 0]),
                               rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(w_l[..., 0]),
                               rtol=1e-5)
    assert _ulps(out, torch.from_numpy(np.asarray(
        w_out[:, :, :, 0], np.float32))).max() <= 2


def _ulps(a, b):
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    return (ordered(a) - ordered(b)).abs()


def test_chunk_partials_would_move_the_arena_output():
    """Why phase B keeps one chain per (row, channel): summing p * v per
    chunk of 64 positions and the partials after (flash-decoding's combine
    at the exact row max, so every rounding point stays) moves outputs that
    cancel to near zero by more than the arena's 2 bf16 ulps.  Measured at
    the main shape (6 slots, 8 KV heads, Gq 4, D 128, lengths 1024-1055),
    over four seeded draws."""
    worst, beyond = 0, 0
    for seed in range(4):
        args = _arena_case(seed, 6, 8, 4, 1, 128, 16, 66,
                           [1040, 1030, 1024, 1055, 1050, 1024],
                           [1024, 0, 1024, 0, 0, 1024])
        q, kp, vp, kc, ks, vc, vs, bt, kv_lens, quant_lens = args
        out, m, _ = R.paged_attention_arena_ref(*args)
        k, v = R._arena_kv(kp, vp, kc, ks, vc, vs, bt, quant_lens)
        s = k.shape[1]
        scores = _bf16(R._warp_dot(
            q.float()[:, :, :, None, :],
            k.float().permute(0, 2, 1, 3)[:, :, None])) / math.sqrt(128)
        seen = (torch.arange(s)[None, :]
                < kv_lens.long()[:, None])[:, None, None, :]
        pb = _bf16(torch.where(seen, torch.exp(scores - m[..., None]),
                               torch.zeros(())))
        vt = v.float().permute(0, 2, 1, 3)
        total = torch.zeros(out.shape)
        for c0 in range(0, s, 64):
            part = torch.zeros(out.shape)
            for t in range(c0, min(c0 + 64, s)):
                part = part + pb[..., t, None] * vt[:, :, None, t]
            total = total + part
        u = _ulps(total.to(torch.bfloat16), out)
        worst, beyond = max(worst, int(u.max())), beyond + int((u > 2).sum())
    print(f"chunk partials against the in-order sum: worst {worst} bf16 "
          f"ulps, {beyond} outputs beyond 2 ulps of 4 x 24,576")
    assert worst > 2
