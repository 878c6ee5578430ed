"""The port's speculative decoding (repro_torch) against the JAX package's.

Five parts, smallest first:

1. ``accept_length`` and ``NGramDraft`` proposals equal the JAX package's
   on seeded histories (pure host code, exact).
2. The plain versions of the two verify-attention entries against the JAX
   package: ``paged_verify_attention_ref`` against the Pallas kernel in
   interpret mode (atol 2e-5 / rtol 1e-4: f32 sums in another order),
   including W = 1 equal to ``paged_attention`` and the blind rejected
   suffix; ``paged_verify_attention_arena_ref`` against the JAX verify
   step's cache read (``_blend_quant`` view, ``multihead_attention`` with
   ``return_stats``): m and l within rtol 1e-5, out within 2 bf16 ulps.
3. The model's S = 3 verify step on tiny-lm with the cached weights, with
   ``tests/test_torch_model.py``'s gate: within atol 2e-2 + rtol 1.6e-2 of
   each tensor's scale, and element-wise at all but 0.1% of the entries
   of one attention layer fed the JAX layer's input (dense cache and
   paged caches through the arena entry's plain version); the whole
   step's logits (``decode_step`` on paged and on dense caches) within
   the scale bound with equal greedy tokens, and the port's verify step
   functions' tokens and page writes.  A whole step is not gated element
   by element: one bf16 rounding flip in a layer (XLA's CPU exp is not
   correctly rounded) spreads through the next layers (ROADMAP Queue 3).
4. The port's speculative ``ServingRuntime`` against a live JAX
   speculative runtime on the same weights, over
   ``tests/_runtime_scenario.py``'s pinned stream, in four
   configurations (n-gram k=2 paged pd, n-gram k=4 paged pool, n-gram k=2
   dense pd, two-model k=2 paged pd).  ``pool_hit``, ``wire_bytes``, every
   ``breakdown`` entry and the speculation tallies (``verify_steps``,
   ``spec_committed``, ``drafts_offered``, ``drafts_accepted``) must be
   equal; greedy tokens must be equal up to a step whose JAX top-2 logit
   gap lies within ``test_torch_runtime.py``'s tolerance, where the test
   prints the flip and stops comparing that request (a flipped token
   changes the n-gram history and with it every later draft).  The page
   table must be clean afterwards.
5. One ``spec_adaptive=True`` run with a controller that asks for k = 7:
   the slots get the cap, 3, and the realized accept rates flow back,
   exactly as in the JAX runtime.

The JAX runtimes run in one subprocess with
``--xla_allow_excess_precision=false`` (see ``test_torch_runtime.py``),
which also records the JAX logits' top-2 for every committed token.  The
gate is the JAX speculative run, never plain decoding: the JAX package's
own speculative-vs-plain exactness tests fail on this tree (ROADMAP
Queue 3).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quality as JQ  # noqa: E402
from repro.kernels import ops as K  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.core import quality as PQ  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    paged_attention_op,
    paged_verify_attention_arena_op,
    paged_verify_attention_op,
)
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import from_jax_arrays  # noqa: E402
from repro_torch.models.layers import PagedKV  # noqa: E402
from test_torch_kernels import _arena_case, _bf16_ulps, _paged_pools  # noqa: E402
from test_torch_model import _close, _exact, _paged_case, _t, _tree_t  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEQ, DECODE_TOKENS, PAGE_SIZE = 64, 6, 8


# ---------------------------------------------------------------------------
# 1. accept rule and n-gram proposer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_and_accept_length_match_jax(seed):
    from repro.serving import speculative as J
    from repro_torch.serving import speculative as P

    rng = np.random.default_rng(seed)
    n = 1 + seed % 3
    jd, pd = J.NGramDraft(max_ngram=n), P.NGramDraft(max_ngram=n)
    live = {}                                   # rid -> idx
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0 or not live:                 # a request lands
            rid, idx = step, int(rng.integers(0, 8))
            prompt = rng.integers(0, 5, int(rng.integers(1, 12))).tolist()
            first = int(rng.integers(0, 5))
            jd.start(idx, rid, prompt, first)
            pd.start(idx, rid, prompt, first)
            live[rid] = idx
        elif op == 1:                           # tokens commit
            rid = int(rng.choice(list(live)))
            toks = rng.integers(0, 5, int(rng.integers(1, 4))).tolist()
            jd.commit(live[rid], rid, toks)
            pd.commit(live[rid], rid, toks)
        elif op == 2 and len(live) > 1:         # a request leaves
            rid = int(rng.choice(list(live)))
            jd.stop(live[rid], rid)
            pd.stop(live[rid], rid)
            del live[rid]
        items = [(idx, rid, 0, 0) for rid, idx in live.items()]
        budgets = {idx: int(rng.integers(0, 6)) for idx in live.values()}
        got = pd.propose_all(items, budgets)
        assert got == jd.propose_all(items, budgets)
        for drafts in got.values():
            outs = rng.integers(0, 5, len(drafts) + 1).tolist()
            if drafts and rng.random() < 0.5:
                outs[:len(drafts) // 2] = drafts[:len(drafts) // 2]
            assert P.accept_length(drafts, outs) == J.accept_length(drafts,
                                                                    outs)


# ---------------------------------------------------------------------------
# 2a. paged_verify_attention, the Pallas interface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,hkv,gq,d,s,group,ps,w", [
    (2, 2, 4, 64, 256, 32, 16, 3),
    (1, 4, 8, 128, 128, 64, 8, 5),
    (3, 1, 2, 128, 512, 128, 64, 2),
])
def test_paged_verify_attention_matches_jax(bits, b, hkv, gq, d, s, group,
                                            ps, w):
    rng = np.random.default_rng(bits * 77 + s + ps + w)
    q = rng.standard_normal((b, hkv, w, gq, d)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    pools, bt = _paged_pools(k, v, bits, group, ps, rng)
    kv_lens = np.asarray([s - w, max(s // 2 - 3, 1), 1][:b], np.int32)
    want = K.paged_verify_attention_op(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(bt),
        jnp.asarray(kv_lens), bits=bits, group=group, interpret=True)
    got = paged_verify_attention_op(_t(q), *map(_t, pools), _t(bt),
                                    _t(kv_lens), bits=bits, group=group)
    assert got.shape == (b, hkv, w, gq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    ref = R.paged_verify_attention_ref(_t(q), *map(_t, pools), _t(bt),
                                       _t(kv_lens), bits, group)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_paged_verify_attention_width1_is_paged_attention():
    """W = 1: the staircase collapses to the plain length mask."""
    rng = np.random.default_rng(11)
    b, hkv, gq, d, s, group, ps = 2, 2, 4, 64, 128, 32, 16
    q = _t(rng.standard_normal((b, hkv, 1, gq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    pools, bt = _paged_pools(k, v, 8, group, ps, rng)
    kv_lens = _t(np.asarray([s, s // 2], np.int32))
    ver = paged_verify_attention_op(q, *map(_t, pools), _t(bt), kv_lens,
                                    bits=8, group=group)
    dec = paged_attention_op(q[:, :, 0], *map(_t, pools), _t(bt), kv_lens,
                             bits=8, group=group)
    np.testing.assert_allclose(ver[:, :, 0].numpy(), dec.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_paged_verify_attention_rejected_suffix_blind():
    """Query j is blind to positions >= kv_lens + j: clobbering the last
    verify position's K/V moves only the last row."""
    rng = np.random.default_rng(23)
    b, hkv, gq, d, s, group, ps, w = 1, 2, 4, 64, 128, 32, 16, 4
    q = _t(rng.standard_normal((b, hkv, w, gq, d)).astype(np.float32))
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    base = 40
    pools, bt = _paged_pools(jnp.asarray(k), jnp.asarray(v), 8, group, ps,
                             np.random.default_rng(99))
    lens = _t(np.asarray([base], np.int32))
    out_a = paged_verify_attention_op(q, *map(_t, pools), _t(bt), lens,
                                      bits=8, group=group)
    k[:, :, base + w - 2], v[:, :, base + w - 2] = 9.0, -9.0
    pools2, _ = _paged_pools(jnp.asarray(k), jnp.asarray(v), 8, group, ps,
                             np.random.default_rng(99))
    out_b = paged_verify_attention_op(q, *map(_t, pools2), _t(bt), lens,
                                      bits=8, group=group)
    np.testing.assert_array_equal(out_a[:, :, :w - 1].numpy(),
                                  out_b[:, :, :w - 1].numpy())
    assert not np.array_equal(out_a[:, :, w - 1].numpy(),
                              out_b[:, :, w - 1].numpy())


# ---------------------------------------------------------------------------
# 2b. paged_verify_attention_arena: the verify step's cache read
# ---------------------------------------------------------------------------
def _jax_verify_read(q, pools, bt, kv_lens, quant_lens):
    """The JAX package's verify-step read of the paged arena, op by op:
    _blend_quant over _paged_view, then multihead_attention's stats for
    W queries at positions kv_lens .. kv_lens+W-1 (every row masked at
    kv_lens, the committed prefix).  q is (B, Hkv, Gq, W, D)."""
    b, hkv, gq, w, d = q.shape

    def read(q, kp, vp, kc, ks, vc, vs, bt, ql, pos):
        kview = JQ._blend_quant(JQ._paged_view(kp, bt, True),
                                JQ._paged_view(kc, bt, True),
                                JQ._paged_view(ks, bt, True), ql, True)
        vview = JQ._blend_quant(JQ._paged_view(vp, bt, True),
                                JQ._paged_view(vc, bt, True),
                                JQ._paged_view(vs, bt, True), ql, True)
        qs = jnp.moveaxis(q, 3, 1).reshape(b, w, hkv * gq, d)
        return JL.multihead_attention(
            qs, kview, vview,
            q_positions=pos[:, None] + jnp.arange(w, dtype=jnp.int32),
            k_positions=jnp.arange(kview.shape[1], dtype=jnp.int32),
            causal=True, kv_valid=pos, return_stats=True)

    out, m, l = _exact(read, *map(jnp.asarray, (q, *pools, bt, quant_lens,
                                                  kv_lens)))
    return np.asarray(out, np.float32), np.asarray(m), np.asarray(l)


@pytest.mark.parametrize("seed,w", [(0, 2), (1, 3), (2, 5)])
def test_paged_verify_attention_arena_matches_jax_verify_read(seed, w):
    q1, pools, bt, kv_lens, quant_lens = _arena_case(seed)
    b, hkv, gq, d = q1.shape
    rng = np.random.default_rng(100 + seed)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, gq, w, d)),
                               jnp.bfloat16))
    want_out, want_m, want_l = _jax_verify_read(q, pools, bt, kv_lens,
                                                quant_lens)
    out, m, l = paged_verify_attention_arena_op(
        _t(q), *map(_t, pools), _t(bt), _t(kv_lens), _t(quant_lens))
    assert out.dtype == torch.bfloat16 and out.shape == (b, hkv, gq, w, d)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=1e-5)
    assert _bf16_ulps(out.float().numpy(), want_out) <= 2
    ref = R.paged_verify_attention_arena_ref(_t(q), *map(_t, pools), _t(bt),
                                             _t(kv_lens), _t(quant_lens))
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref[0].float().numpy())


def test_paged_verify_attention_arena_scratch_and_tail_inert():
    """Positions at or beyond a slot's committed length (the verify step's
    own new rows, the scratch page) never reach its output."""
    q1, pools, bt, kv_lens, quant_lens = _arena_case(7)
    b, hkv, gq, d = q1.shape
    q = _t(np.repeat(q1[:, :, :, None], 3, axis=3))
    bt[1, 3:] = 0
    base = paged_verify_attention_arena_op(q, *map(_t, pools), _t(bt),
                                           _t(kv_lens), _t(quant_lens))
    poisoned = [p.copy() for p in pools]
    row1_tail = bt[1, kv_lens[1] // 8 + 1:]
    for p in poisoned:
        p[0] = 100
        p[row1_tail[row1_tail > 0]] = 100
    again = paged_verify_attention_arena_op(q, *map(_t, poisoned), _t(bt),
                                            _t(kv_lens), _t(quant_lens))
    for x, y in zip(base, again):
        np.testing.assert_array_equal(x[1:3].float().numpy(),
                                      y[1:3].float().numpy())
    # every row of a slot reads the same prefix: equal queries, equal rows
    out, m, l = base
    np.testing.assert_array_equal(out[..., 0, :].float().numpy(),
                                  out[..., 2, :].float().numpy())
    np.testing.assert_array_equal(m[..., 0].numpy(), m[..., 2].numpy())
    np.testing.assert_array_equal(l[..., 0].numpy(), l[..., 2].numpy())


# ---------------------------------------------------------------------------
# 3. the model's verify step (tiny-lm, S = 3)
# ---------------------------------------------------------------------------
B, PSEQ, MAX_LEN, S = 3, 40, 48, 3


@pytest.fixture(scope="module")
def tiny(reference_model):
    """(cfg, jax params, port params, prompts, JAX prefill caches)."""
    cfg, jp = reference_model
    pp = from_jax_arrays(jax.tree_util.tree_map(np.asarray, jp), cfg,
                         device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, PSEQ)).astype(np.int32)
    _, caches = _exact(
        lambda p, t: JT.prefill(cfg, p, {"tokens": t}, MAX_LEN), jp,
        jnp.asarray(toks))
    return cfg, jp, pp, toks, caches


def _verify_tokens(toks, seed=1):
    """(B, S) verify blocks: each slot's last prompt token then drafts."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (B, S)).astype(np.int32)
    out[:, 0] = toks[:, -1]
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_verify_attention_layer_matches(tiny, paged):
    """One attention layer at S = 3 on the JAX layer's input, per block:
    the dense cache read, or the paged arena through the verify entry's
    plain version against the JAX layer over _blend_quant's view."""
    from repro.models import layers as JLy
    from repro_torch.models import layers as PL
    cfg, jp, pp, toks, jc = tiny
    ps = 8
    pool, qc, qs, bt, quant_len = _paged_case(cfg, jc, B, PSEQ, ps, seed=4)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.bfloat16)
    pos = np.asarray([40, 33, 42], np.int32)
    positions = pos[:, None] + np.arange(S, dtype=np.int32)[None]

    def layer(p, h, c, ps_, cp):
        return JLy.apply_attention(p, cfg, h, positions=ps_, cache=c,
                                   cache_pos=cp)[0]

    for blk in range(PT.plan_stack(cfg).n_blocks):
        lj = jax.tree_util.tree_map(lambda a: a[blk],
                                    jp["blocks"]["layer0"]["mixer"])
        lp = PT._block(pp["blocks"], blk)["layer0"]["mixer"]
        if paged:
            cj = {key: JQ._blend_quant(
                JQ._paged_view(jnp.asarray(pool["blocks"]["layer0"][key][blk]),
                               jnp.asarray(bt), True),
                JQ._paged_view(jnp.asarray(qc["blocks"]["layer0"][key][blk]),
                               jnp.asarray(bt), True),
                JQ._paged_view(jnp.asarray(qs["blocks"]["layer0"][key][blk]),
                               jnp.asarray(bt), True),
                jnp.asarray(quant_len), True) for key in ("k", "v")}
            cp = PagedKV(*(_t(a["layer0"][key][blk])
                           for a, key in ((pool["blocks"], "k"),
                                          (pool["blocks"], "v"),
                                          (qc["blocks"], "k"),
                                          (qs["blocks"], "k"),
                                          (qc["blocks"], "v"),
                                          (qs["blocks"], "v"))),
                         _t(bt), _t(quant_len))
        else:
            cj = jax.tree_util.tree_map(lambda a: a[blk],
                                        jc["blocks"]["layer0"])
            cp = _tree_t(cj)
        want = _exact(layer, lj, x, cj, jnp.asarray(positions),
                      jnp.asarray(pos))
        got, new = PL.apply_attention(lp, cfg, _t(x), positions=_t(positions),
                                      cache=cp, cache_pos=_t(pos))
        assert new["k_new"].shape == (B, S, cfg.kv_heads,
                                      cfg.resolved_head_dim)
        _close(got, want)


def test_dense_verify_decode_matches(tiny):
    cfg, jp, pp, toks, jc = tiny
    vt = _verify_tokens(toks)
    pos = np.asarray([40, 33, 45], np.int32)      # row 2 at max_len - S
    jl, jc2 = _exact(lambda p, c, t, ps: JT.decode_step(cfg, p, c, t, ps),
                     jp, jc, jnp.asarray(vt), jnp.asarray(pos))
    pl, pc2 = PT.decode_step(cfg, pp, _tree_t(jc), _t(vt), _t(pos))
    assert pl.shape == (B, S, cfg.vocab_size)
    _close(pl, jl, frac=None)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _close(pc2["blocks"]["layer0"]["k"], jc2["blocks"]["layer0"]["k"],
           frac=None)
    # each slot wrote exactly its S rows
    before = _t(jc["blocks"]["layer0"]["v"]).float()
    changed = (pc2["blocks"]["layer0"]["v"].float() != before).any(-1).any(-1)
    rows = {(b, s) for _, b, s in changed.nonzero().tolist()}
    assert rows <= {(b, int(p) + j) for b, p in enumerate(pos)
                    for j in range(S)}


def test_paged_verify_decode_matches(tiny):
    """The port's S = 3 decode_step on paged caches (the arena verify
    entry's plain version on the CPU) against the JAX decode_step at S = 3
    on _blend_quant's dense view of the same pools, mixed residency."""
    cfg, jp, pp, toks, jc = tiny
    ps = 8
    pool, qc, qs, bt, quant_len = _paged_case(cfg, jc, B, PSEQ, ps, seed=5)
    vt = _verify_tokens(toks, seed=2)
    pos = np.asarray([40, 40, 33], np.int32)

    def view_decode(p, pool, qc, qs, bt, ql, t, ps_):
        view = {"prefix": {}, "blocks": {
            name: {key: JQ._blend_quant(
                JQ._paged_view(pool["blocks"][name][key], bt, False),
                JQ._paged_view(qc["blocks"][name][key], bt, False),
                JQ._paged_view(qs["blocks"][name][key], bt, False),
                ql, False) for key in ("k", "v")}
            for name in pool["blocks"]}}
        return JT.decode_step(cfg, p, view, t, ps_)[0]

    jarr = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa
    jl = _exact(view_decode, jp, jarr(pool), jarr(qc), jarr(qs),
                jnp.asarray(bt), jnp.asarray(quant_len), jnp.asarray(vt),
                jnp.asarray(pos))
    tpool, tqc, tqs = _tree_t(pool), _tree_t(qc), _tree_t(qs)
    caches = {"prefix": {}, "blocks": {
        name: PagedKV(c["k"], c["v"], tqc["blocks"][name]["k"],
                      tqs["blocks"][name]["k"], tqc["blocks"][name]["v"],
                      tqs["blocks"][name]["v"], _t(bt), _t(quant_len))
        for name, c in tpool["blocks"].items()}}
    pl, new = PT.decode_step(cfg, pp, caches, _t(vt), _t(pos))
    assert new["blocks"]["layer0"]["k_new"].shape[2] == S
    _close(pl, jl, frac=None)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


def test_paged_verify_step_matches(tiny):
    """The port's paged verify step function (tokens, all S rows
    scattered to pages, parked row at view_len - S) against the JAX
    package's _paged_verify_steps."""
    cfg, jp, pp, toks, jc = tiny
    ps = 8
    pool, qc, qs, bt, quant_len = _paged_case(cfg, jc, B, PSEQ, ps, seed=6)
    vt = _verify_tokens(toks, seed=3)
    pos = np.asarray([40, 40, 33], np.int32)
    mask = np.asarray([True, True, False])
    jarr = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa
    jverify = JQ._paged_verify_steps(cfg.name, ps, S)
    jtok, jpool = _exact(jverify, jp, jarr(pool), jarr(qc), jarr(qs),
                         jnp.asarray(bt), jnp.asarray(quant_len),
                         jnp.asarray(vt), jnp.asarray(pos),
                         jnp.asarray(mask))
    pverify = PQ._paged_verify_steps(cfg.name, ps, S)
    ptok, ppool = pverify(pp, _tree_t(pool), _tree_t(qc), _tree_t(qs),
                          _t(bt), _t(quant_len), _t(vt), _t(pos), _t(mask))
    assert ptok.shape == (B, S)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for name in pool["blocks"]:
        for key in ("k", "v"):
            _close(ppool["blocks"][name][key], jpool["blocks"][name][key],
                   frac=None)


# ---------------------------------------------------------------------------
# 4-5. the speculative runtime against the JAX package's, live
# ---------------------------------------------------------------------------
CONFIGS = {
    "ngram-k2-paged-pd": dict(mode="pd", paged=True, spec_k=2),
    "ngram-k4-paged-pool": dict(mode="pool", paged=True, spec_k=4),
    "ngram-k2-dense-pd": dict(mode="pd", paged=False, spec_k=2),
    "model-k2-paged-pd": dict(mode="pd", paged=True, spec_k=2,
                              spec_kind="model"),
    "adaptive-k3-paged-pd": dict(mode="pd", paged=True, spec_k=3,
                                 spec_adaptive=True),
}
TALLIES = ("spec_k", "verify_steps", "spec_committed", "drafts_offered",
           "drafts_accepted")


class _SpySpecController:
    """Asks for k = 7 on every request (above any cap) and records the
    accept-rate feedback."""

    def __init__(self, decision_cls, profile):
        self._decision_cls, self._profile = decision_cls, profile
        self.accepts = []

    def select(self, ctx):
        return self._decision_cls(self._profile, 0, 0, 0.0, spec_k=7)

    def observe(self, ctx, decision, latency):
        pass

    def observe_accept(self, workload, route, rate):
        self.accepts.append([workload, route, rate])


def _build(pkg, name, reference_model=None, **extra):
    """The pinned scenario's runtime from package ``pkg`` ("repro" or
    "repro_torch") in configuration ``name``: tests/_runtime_scenario.py's
    settings with a paged-eligible int8 per-token profile, so pool and
    decode-side pool hits land as quant pages on the paged arena."""
    import importlib
    prof_mod = importlib.import_module(f"{pkg}.core.profiles")
    strat_mod = importlib.import_module(f"{pkg}.core.strategy")
    ctrl_mod = importlib.import_module(f"{pkg}.controller")
    serving = importlib.import_module(f"{pkg}.serving")
    engine = importlib.import_module(f"{pkg}.serving.engine")
    profile = prof_mod.Profile(strat_mod.StrategyConfig(
        quantizer="uniform", key_bits=8, value_bits=8,
        granularity="per_token", symmetric=True, group_size=32),
        cr=2.0, s_enc=5e8, s_dec=5e8)
    rt = engine.ServingRuntime(
        static_profile=profile,
        config=engine.RuntimeConfig(
            seq=SEQ, decode_tokens=DECODE_TOKENS, prefill_tok_s=2000.0,
            decode_tok_s=500.0, page_size=PAGE_SIZE, **CONFIGS[name]),
        trace=serving.BandwidthTrace.constant(1 * serving.GBPS),
        scheduler=serving.SchedulerConfig(max_slots=6,
                                          max_prefills_per_step=2,
                                          max_queue=32),
        **extra)
    if reference_model is not None:
        rt.model_cfg, rt.params = reference_model
    if rt.cfg.spec_adaptive:
        spy = _SpySpecController(ctrl_mod.Decision, profile)
        rt.static_profile = None
        rt.controller = spy
        for pw in rt.prefill_workers:
            pw.controller = spy
    return rt


def _result(rt, outputs):
    out = {}
    for c in rt.completed:
        rec = dict(outputs[str(c.rid)], wire_bytes=int(c.wire_bytes),
                   breakdown=dict(c.breakdown), route=c.route)
        rec.update({k: int(getattr(c, k)) for k in TALLIES})
        out[str(c.rid)] = rec
    accepts = rt.controller.accepts if rt.cfg.spec_adaptive else []
    return {"requests": out, "accepts": accepts}


def _jax_reference(out_path: str) -> None:
    """The JAX side (run as ``python tests/test_torch_speculative.py
    OUT.json``): every configuration's result, with the JAX top-2 logits
    behind each committed token.  A verify step's row j of slot s sits at
    position pos[s] + j; the last row computed at a position during a
    request's occupancy of its slot is the one its committed token came
    from (a commit moves the slot past it for good).  The two-model
    draft's own steps are built from the unlogged model functions."""
    import jax

    import repro.models as M
    from repro.serving import speculative as SP
    from _runtime_scenario import SCENARIO, run_scenario

    real_pre, real_dec = M.prefill, M.decode_step
    log = {"prefill": [], "decode": []}

    def top2(logits):
        return jax.lax.top_k(logits.astype(jnp.float32), 2)[0]

    def prefill(cfg, params, batch, max_len):
        logits, caches = real_pre(cfg, params, batch, max_len)
        jax.debug.callback(
            lambda t, g: log["prefill"].append((np.asarray(t).tobytes(),
                                                np.asarray(g))),
            batch["tokens"][0], top2(logits[0, -1]), ordered=True)
        return logits, caches

    def decode_step(cfg, params, caches, tokens, pos):
        logits, caches = real_dec(cfg, params, caches, tokens, pos)
        jax.debug.callback(
            lambda p, g: log["decode"].append((np.asarray(p),
                                               np.asarray(g))),
            pos, top2(logits), ordered=True)
        return logits, caches

    def draft_steps(self):
        if self._fns is None:
            M.prefill, M.decode_step = real_pre, real_dec
            try:
                self._fns = JQ._jitted_steps.__wrapped__(
                    self.model.cfg.name, self.seq, self.n_slots,
                    self.max_len)
            finally:
                M.prefill, M.decode_step = prefill, decode_step
        return self._fns

    M.prefill, M.decode_step = prefill, decode_step
    SP.ModelDraft._jitted = draft_steps
    ref = JQ.get_reference_model()
    prompts = {}
    for w, _, seed, _, _ in SCENARIO:
        toks, _ = JQ._prompts_for(w, 1, SEQ, seed)
        prompts[(w, seed)] = np.asarray(toks, np.int32)[0].tobytes()
    results = {}
    for name in CONFIGS:
        log["prefill"].clear()
        log["decode"].clear()
        rt = _build("repro", name, ref)
        out = _result(rt, run_scenario(rt))
        jax.effects_barrier()
        first_gap = dict(log["prefill"])
        segs = {}                         # slot -> [{position: top2}]
        for pos, g in log["decode"]:
            for s in range(len(pos)):
                for j in range(g.shape[1]):
                    p = int(pos[s]) + j
                    if p >= SEQ + DECODE_TOKENS:
                        continue          # parked rows and spare drafts
                    if j == 0 and p == SEQ:
                        segs.setdefault(s, []).append({})
                    segs[s][-1][p] = g[s, j].tolist()
        by_slot = {}
        for c in sorted(rt.completed, key=lambda c: (c.done, c.rid)):
            by_slot.setdefault(c.slot, []).append(c)
        for s, occupants in by_slot.items():
            for c, seg in zip(occupants, segs.get(s, [])):
                key = prompts[(c.workload, SCENARIO[c.rid][2])]
                rec = out["requests"][str(c.rid)]
                rec["top2"] = [first_gap[key].tolist()] + [
                    seg[SEQ + i] for i in range(len(rec["tokens"]) - 1)]
        results[name] = out
    Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_spec") / "runs.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_model(tiny):
    cfg, _, pp, _, _ = tiny
    return cfg, pp


def _within_tolerance(top2) -> bool:
    t1, t2 = top2
    return (t1 - t2) <= 2e-2 + 1.6e-2 * abs(t1)


def _run_port(name, port_model):
    from _runtime_scenario import run_scenario
    rt = _build("repro_torch", name, port_model, device="cpu")
    return rt, _result(rt, run_scenario(rt))


def _compare(name, got, want):
    """Per request: equal tokens up to a logged near-tie flip; equal pool
    hit, wire bytes, breakdown and tallies where no flip happened."""
    assert set(got["requests"]) == set(want["requests"])
    flips = []
    for rid, w in sorted(want["requests"].items(), key=lambda x: int(x[0])):
        g = got["requests"][rid]
        assert g["pool_hit"] == w["pool_hit"], rid
        assert g["wire_bytes"] == w["wire_bytes"], rid
        assert len(g["tokens"]) == len(w["tokens"]), rid
        flip = next((i for i, (a, b) in enumerate(zip(g["tokens"],
                                                      w["tokens"]))
                     if a != b), None)
        if flip is None:
            assert g["breakdown"] == w["breakdown"], rid
            assert {k: g[k] for k in TALLIES} == {k: w[k] for k in TALLIES}, \
                rid
            continue
        top2 = w["top2"][flip]
        print(f"[{name}] rid {rid} step {flip}: port "
              f"{g['tokens'][flip]} vs jax {w['tokens'][flip]}, JAX top-2 "
              f"logits {top2} (gap {top2[0] - top2[1]:.4g})")
        assert _within_tolerance(top2), (rid, flip, top2)
        flips.append(rid)
    return flips


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if not CONFIGS[n].get("spec_adaptive")])
def test_speculative_runtime_matches_jax(jax_runs, port_model, name):
    rt, got = _run_port(name, port_model)
    flips = _compare(name, got, jax_runs[name])
    reqs = rt.completed
    assert sum(r.verify_steps for r in reqs) > 0
    assert sum(r.drafts_offered for r in reqs) > 0
    if len(flips) < len(reqs):
        assert any(r.drafts_accepted > 0 for r in reqs)
    for r in reqs:
        assert sum(r.breakdown.values()) == pytest.approx(r.jct, abs=1e-9)
    if CONFIGS[name]["paged"]:
        for dw in rt.decode_workers:
            dw.page_table.check()
            assert dw.page_table.free_pages == dw.page_table.num_pages - 1


def test_adaptive_spec_k_flows_controller_to_slots(jax_runs, port_model):
    name = "adaptive-k3-paged-pd"
    rt, got = _run_port(name, port_model)
    want = jax_runs[name]
    flips = _compare(name, got, want)
    reqs = got["requests"]
    # the controller's k = 7 reached every non-hit slot capped at 3; hits
    # skip the controller and take the uniform cfg.spec_k, also 3
    assert all(r["spec_k"] == 3 for r in reqs.values())
    # one accept-rate observation per request that offered drafts, with
    # that request's realized rate, on both sides
    for res in (got, want):
        rates = sorted([r["workload"], r["route"],
                        r["drafts_accepted"] / r["drafts_offered"]]
                       for r in res["requests"].values()
                       if r["drafts_offered"] > 0)
        assert rates and sorted(res["accepts"]) == rates
    # _compare held every request's tallies, and so its rate, equal to
    # the JAX run's wherever no near-tie flip changed its drafts
    assert len(flips) < len(reqs)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _jax_reference(sys.argv[1])
