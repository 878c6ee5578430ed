"""Gemma-2 on the paged arena: the arena entries' softcap, sliding window
and empty rows against the JAX package, on the CPU.

The JAX runtime serves gemma2 on the paged arena through its gathered
dense view (``_blend_quant`` over ``_paged_view``), where
``multihead_attention`` caps each scaled score as tanh(s / cap) * cap and
masks a local layer's positions at or below the query's position minus
the window.  The port reads the pages in place through the two arena
entries, which take ``window`` and ``softcap``; on the CPU they run their
plain versions (``kernels/ref.py``).

1. Both plain versions against the JAX step's cache read
   (``multihead_attention(return_stats=True)``, compiled with excess
   precision off), at windows 1, 2, 16 and beyond the length, W 1 and 5,
   a cap with and without a window, and a slot at kv_len 0.  A row that
   sees no position (kv_len 0, or a verify token whose window ends before
   the prefix) gives m = -inf, l = 0, out = 0 in the port, where the JAX
   mask averages the whole view; every other row has m and l within rtol
   1e-5 (XLA divides by the cap through its reciprocal) and out within 2
   bf16 ulps, and the outputs merged with a new token in closed form, as
   the step merges them, agree within rtol 1e-5 / atol 1e-6 on every row.
2. Whole decode (S = 1) and verify (S = 3) steps of gemma2-9b-reduced
   with its window cut to 1 or 2, so that whole rows see nothing, and a
   slot at position 0 (kv_len 0): ``decode_step`` on the paged caches
   against the JAX ``decode_step`` over the gathered view, within
   ``test_torch_model.py``'s gate, with equal greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.core import quality as JQ  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    paged_attention_arena_op,
    paged_verify_attention_arena_op,
)
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import from_jax_arrays  # noqa: E402
from repro_torch.models.layers import PagedKV  # noqa: E402
from test_torch_cluster import one_thread  # noqa: E402
from test_torch_model import _close, _exact, _paged_case, _t, _tree_t  # noqa: E402
from test_torch_paged_split import _arena_case, _ulps  # noqa: E402


def _jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jax_read(args, w, window, cap):
    """The JAX step's read of the arena view: (out, m, l) shaped as the
    port's entry returns them."""
    q = args[0]
    b, hkv, gq, d = *q.shape[:3], q.shape[-1]

    def read(q, kp, vp, kc, ks, vc, vs, bt, ql, pos):
        kview = JQ._blend_quant(JQ._paged_view(kp, bt, True),
                                JQ._paged_view(kc, bt, True),
                                JQ._paged_view(ks, bt, True), ql, True)
        vview = JQ._blend_quant(JQ._paged_view(vp, bt, True),
                                JQ._paged_view(vc, bt, True),
                                JQ._paged_view(vs, bt, True), ql, True)
        qs = (q.reshape(b, 1, hkv * gq, d) if w == 1 else
              jnp.moveaxis(q, 3, 1).reshape(b, w, hkv * gq, d))
        return JL.multihead_attention(
            qs, kview, vview,
            q_positions=pos[:, None] + jnp.arange(w, dtype=jnp.int32),
            k_positions=jnp.arange(kview.shape[1], dtype=jnp.int32),
            causal=True, window=window, softcap=cap, kv_valid=pos,
            return_stats=True)

    _, *pools, kv_lens, quant_lens = args
    out, m, l = _exact(read, *map(_jnp, (q, *pools, quant_lens, kv_lens)))
    out, m, l = (np.asarray(out, np.float32), np.asarray(m), np.asarray(l))
    if w == 1:
        return out[:, :, :, 0], m[..., 0], l[..., 0]
    return out, m, l


def _merge(out, m, l, s_new, v_new):
    """The step's closed-form merge of one new score and value per row
    (``layers.apply_attention``, S = 1), in f32."""
    m_new = np.maximum(m, s_new)
    alpha = np.exp(m - m_new)
    p_new = np.exp(s_new - m_new)
    num = out * alpha[..., None] + p_new[..., None] * v_new
    return num / np.maximum(l * alpha + p_new, 1e-30)[..., None]


# (W, window, softcap): windows 1, 2, 16 and beyond every length, a cap
# with no window, a window with no cap; gemma-2's cap is 50, 2 makes tanh
# bend the test's scores
_READS = [(w, window, cap) for w in (1, 5)
          for window, cap in ((1, 2.0), (2, 2.0), (16, 2.0), (1000, 2.0),
                              (0, 2.0), (16, 0.0))] + [(3, 16, 50.0)]


@pytest.mark.parametrize("w,window,cap", _READS,
                         ids=[f"W{w}-window{wi}-cap{c:g}"
                              for w, wi, c in _READS])
def test_arena_plain_versions_match_jax_read(w, window, cap):
    # slots at kv_len 0, 17 and 150 over 160-position views; quant_lens
    # mid-page
    args = _arena_case(3 + w + window, 3, 2, 2, w, 64, 8, 20, [0, 17, 150],
                       [0, 9, 100])
    op = paged_attention_arena_op if w == 1 else \
        paged_verify_attention_arena_op
    with one_thread():
        out, m, l = op(*args, window=window, softcap=cap)
    j_out, j_m, j_l = _jax_read(args, w, window, cap)
    out, m, l = out.float().numpy(), m.numpy(), l.numpy()
    pos = np.arange(args[1].shape[1] * args[7].shape[1])
    lens = args[8].numpy()[:, None, None, None]
    j = np.arange(w)[None, None, None, :]
    sees = (pos < lens[..., None]) & (
        pos > lens[..., None] + j[..., None] - window if window else True)
    empty = np.broadcast_to(~sees.any(-1), (3, 2, 2, w)).reshape(m.shape)
    # window 1 hides every position from every row
    assert empty.any() and (window == 1) == empty.all()
    assert np.all(np.isneginf(m[empty])) and np.all(l[empty] == 0)
    assert np.all(out[empty] == 0)
    np.testing.assert_allclose(m[~empty], j_m[~empty], rtol=1e-5)
    np.testing.assert_allclose(l[~empty], j_l[~empty], rtol=1e-5)
    if window != 1:
        assert _ulps(torch.from_numpy(out[~empty]),
                     torch.from_numpy(j_out[~empty])).max() <= 2
    rng = np.random.default_rng(w * 100 + window)
    s_new = rng.uniform(-1.0, 1.0, m.shape).astype(np.float32)
    v_new = rng.standard_normal(out.shape).astype(np.float32)
    got = _merge(out, m, l, s_new, v_new)
    np.testing.assert_allclose(got, _merge(j_out, j_m, j_l, s_new, v_new),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[empty], v_new[empty])


B, SEQ, MAX_LEN, PS = 3, 40, 48, 8


def _paged_step_vs_jax(changes, s, pos, seed=0):
    """One ``decode_step`` of gemma2-9b-reduced (``changes`` replaced in
    its config) over B slots of paged caches at positions ``pos``, S new
    tokens each, in both packages on the same weights and pools; JAX over
    the gathered view.  Returns (port logits, JAX logits)."""
    cfg = dataclasses.replace(get_config("gemma2-9b-reduced"), **changes)
    pcfg = dataclasses.replace(port_config("gemma2-9b-reduced"), **changes)
    jp, _ = JT.init_params(cfg, seed=seed)
    pp = from_jax_arrays(jax.tree_util.tree_map(np.asarray, jp), pcfg,
                         device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    _, jc = _exact(lambda p, t: JT.prefill(cfg, p, {"tokens": t}, MAX_LEN),
                   jp, jnp.asarray(toks))
    pool, qc, qs, bt, quant_len = _paged_case(cfg, jc, B, SEQ, PS,
                                              seed=seed + 1)
    new = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    pos = np.asarray(pos, np.int32)

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
                jnp.asarray(bt), jnp.asarray(quant_len), jnp.asarray(new),
                jnp.asarray(pos))
    tpool, tqc, tqs = _tree_t(pool), _tree_t(qc), _tree_t(qs)
    caches = {"prefix": {}, "blocks": {
        name: PagedKV(c["k"], c["v"], tqc["blocks"][name]["k"],
                      tqs["blocks"][name]["k"], tqc["blocks"][name]["v"],
                      tqs["blocks"][name]["v"], _t(bt), _t(quant_len))
        for name, c in tpool["blocks"].items()}}
    with one_thread():
        pl, _ = PT.decode_step(pcfg, pp, caches, _t(new), _t(pos))
    return pl, jl


@pytest.mark.parametrize("window,s", [(1, 1), (2, 1), (1, 3), (2, 3)])
def test_empty_rows_merge_alike_in_decode_and_verify_steps(window, s):
    """Slot 1 sits at position 0 (kv_len 0: every cache row empty); under
    window 1 every local decode row is empty, and under windows 1 and 2
    the verify tokens past the first see none of the prefix.  The port's
    (-inf, 0, 0) and JAX's whole-view average both merge to the new
    tokens' own attention, so the steps agree."""
    pl, jl = _paged_step_vs_jax({"sliding_window": window}, s, [40, 0, 33])
    assert pl.shape == (B, s, get_config("gemma2-9b-reduced").vocab_size)
    _close(pl, jl, frac=None)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
