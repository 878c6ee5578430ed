"""The port's model (repro_torch.models) against the JAX package's.

The weight bridge maps the JAX parameter tree leaf for leaf by path, and
the port's digest of the converted weights is the JAX one.  Prefill and
arena-decode logits agree within rtol 1.6e-2 / atol 2e-2: both round to
bf16 at the same points but sum in another order.  The JAX side is
compiled with XLA's excess precision off (:func:`_exact`), so each
operation rounds at its written dtype as it does run op by op; decode
steps start from the same caches on both sides.  Two
models: ``tiny-lm`` with the cached trained weights, and
``reduce_config(llama3.1-8b)`` with random weights.

The tolerance is taken against each tensor's scale, |got - want| <=
atol + rtol * max|want|: a one-ulp bf16 flip in an operand of size M moves
a result by about M / 256 whatever the result's own size, and results
that cancel (a residual add) are small.  Such flips are rare but not
absent: XLA's CPU exp, logistic, rsqrt and cos/sin are not correctly
rounded and differ from PyTorch's in the last f32 place, which flips
about 1e-4 of the bf16 roundings per layer.  Within one layer (fed the
JAX layer's input) and one decode step (same caches) at most 0.1% of the
elements may exceed the element-wise tolerance; across a whole prefill
those flips spread, and only the scale bound and the argmax hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import quality as JQ  # noqa: E402
from repro.core.quantizers import group_quantize  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.core import quality as PQ  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten,
    from_jax_arrays,
    params_digest,
)
from repro_torch.models.layers import PagedKV  # noqa: E402

RTOL, ATOL = 1.6e-2, 2e-2


@pytest.fixture(scope="module", params=["tiny-lm", "llama3.1-8b-reduced"])
def models(request, reference_model):
    """(cfg, jax params, port params) on the CPU."""
    if request.param == "tiny-lm":
        cfg, jp = reference_model
    else:
        cfg = reduce_config(get_config("llama3.1-8b"))
        jp, _ = JT.init_params(cfg, seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jp, from_jax_arrays(tree, cfg, device="cpu")


B, SEQ, MAX_LEN = 3, 40, 48


@pytest.fixture(scope="module")
def prefilled(models):
    """JAX prefill of B seeded prompts: (tokens, logits, first, caches)."""
    cfg, jp, _ = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, min(cfg.vocab_size, 256), (B, SEQ)).astype(
        np.int32)
    logits, caches = _exact(
        lambda p, t: JT.prefill(cfg, p, {"tokens": t}, MAX_LEN), jp,
        jnp.asarray(toks))
    first = np.asarray(logits).argmax(-1).astype(np.int32)   # (B, 1)
    return toks, logits, first, caches


def _compile(fn, *args):
    """``fn`` jitted for ``args`` with ``xla_allow_excess_precision`` off:
    XLA's default keeps f32 inside fused CPU kernels where the JAX code
    rounds to bf16.  Equal, bit for bit, to running ``fn`` op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _exact(fn, *args):
    return _compile(fn, *args)(*args)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree_util.tree_map(_t, tree)


def _close(got: torch.Tensor, want, frac=1e-3) -> None:
    w = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - w)
    assert err.max() <= ATOL + RTOL * np.abs(w).max(), err.max()
    if frac is not None:
        assert (err > ATOL + RTOL * np.abs(w)).mean() <= frac



# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------
def test_bridge_maps_every_leaf_by_path(models):
    cfg, jp, pp = models
    want = {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(flatten(pp))
    assert list(got) == list(want)          # same paths, same flatten order
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr)


def test_bridge_digest_equals_jax(models):
    from _runtime_scenario import params_digest as jax_digest
    _, jp, pp = models
    assert params_digest(pp) == jax_digest(jp)


def test_reference_model_loads_from_cache(reference_model):
    cfg, jp = reference_model
    pcfg, pp = PQ.get_reference_model(device="cpu")
    assert pcfg.name == cfg.name
    from _runtime_scenario import params_digest as jax_digest
    assert params_digest(pp) == jax_digest(jp)


def test_init_params_shapes_and_scales():
    cfg = reduce_config(get_config("llama3.1-8b"))
    jp, _ = JT.init_params(cfg, seed=0)
    pp = PT.init_params(cfg, seed=0, device="cpu")
    for (path, a), (_, b) in zip(
            flatten(jax.tree_util.tree_map(np.asarray, jp)), flatten(pp)):
        assert tuple(b.shape) == a.shape, path
        assert b.float().std().item() == pytest.approx(float(a.std()),
                                                       rel=0.2), path


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def test_prefill_layers_match(models, prefilled):
    """Each layer on the JAX layer's input: outputs and K/V elementwise."""
    cfg, jp, pp = models
    toks = prefilled[0]
    spec = cfg.layer_specs()[0]
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None], (B, SEQ))
    x = _exact(lambda p, t: JT._embed_inputs(p, cfg, {"tokens": t}), jp,
               jnp.asarray(toks))
    layer = None
    for blk in range(PT.plan_stack(cfg).n_blocks):
        lj = jax.tree_util.tree_map(lambda a: a[blk], jp["blocks"]["layer0"])
        lp = PT._block(pp["blocks"], blk)["layer0"]
        got, kv = PT._apply_layer(lp, cfg, spec, _t(x), positions=_t(pos))
        args = (lj, x, jnp.asarray(pos))
        layer = layer or _compile(lambda p, h, ps: JT._apply_layer(
            p, cfg, spec, h, positions=ps, mode="prefill", max_len=SEQ)[:2],
            *args)
        x, want = layer(*args)
        _close(got, x)
        _close(kv["k"], want["k"])
        _close(kv["v"], want["v"])


def test_prefill_logits_match(models, prefilled):
    cfg, jp, pp = models
    toks, jl, _, jc = prefilled
    pl, pc = PT.prefill(cfg, pp, {"tokens": _t(toks)}, MAX_LEN)
    _close(pl, jl, frac=None)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    for key in ("k", "v"):
        _close(pc["blocks"]["layer0"][key], jc["blocks"]["layer0"][key],
               frac=None)


# ---------------------------------------------------------------------------
# arena decode: dense slot arena and paged arena, from the same caches
# ---------------------------------------------------------------------------
def test_dense_arena_decode_logits_match(models, prefilled):
    cfg, jp, pp = models
    _, _, first, jc = prefilled
    pos = np.asarray([40, 33, 47], np.int32)      # row 2 parked at max_len-1
    jl, jc2 = _exact(lambda p, c, t, ps: JT.decode_step(cfg, p, c, t, ps),
                     jp, jc, jnp.asarray(first), jnp.asarray(pos))
    pl, pc2 = PT.decode_step(cfg, pp, _tree_t(jc), _t(first), _t(pos))
    _close(pl, jl)
    _close(pc2["blocks"]["layer0"]["v"], jc2["blocks"]["layer0"]["v"])
    # only each slot's own position was written
    before = _t(jc["blocks"]["layer0"]["k"]).float()
    changed = (pc2["blocks"]["layer0"]["k"].float() != before).any(-1).any(-1)
    rows = changed.nonzero().tolist()
    assert {(b, s) for _, b, s in rows} <= {(0, 40), (1, 33), (2, 47)}


def _paged_case(cfg, jc, b, seq, ps, seed):
    """Pools (numpy, JAX layout) holding prefill KV in shuffled pages, with
    slot 1 quant-resident (per-token int8, group 16, as the runtime lands
    paged-eligible pool hits)."""
    rng = np.random.default_rng(seed)
    pps = -(-jc["blocks"]["layer0"]["k"].shape[2] // ps)
    n_pages = 1 + b * pps
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, pps).astype(
        np.int32)
    pool = {"prefix": {}, "blocks": {}}
    qc = {"prefix": {}, "blocks": {}}
    qs = {"prefix": {}, "blocks": {}}
    for name, c in jc["blocks"].items():
        pool["blocks"][name], qc["blocks"][name], qs["blocks"][name] = {}, {}, {}
        for key in ("k", "v"):
            x = np.asarray(c[key], np.float32)      # (n, B, S, H, D)
            n, _, s, h, d = x.shape
            fp = np.zeros((n, n_pages, ps, h, d), np.float32)
            codes = np.zeros((n, n_pages, ps, h, d), np.int8)
            scales = np.zeros((n, n_pages, ps, h, d), np.float32)
            for i in range(b):
                for p in range(pps):
                    fp[:, bt[i, p]] = x[:, i, p * ps:(p + 1) * ps]
            # slot 1's first `seq` positions also live in the quant pool
            xs = x[:, 1, :seq].transpose(0, 2, 1, 3).reshape(n * h, seq, d)
            u, sc, _ = group_quantize(xs, 8, "per_token", 16, True)
            signed = (u.astype(np.int16) - 128).astype(np.int8)
            full = np.repeat(sc.astype(np.float32)[..., 0], 16, axis=2)
            signed = signed.reshape(n, h, seq, d).transpose(0, 2, 1, 3)
            full = full.reshape(n, h, seq, d).transpose(0, 2, 1, 3)
            for p in range(seq // ps):
                codes[:, bt[1, p]] = signed[:, p * ps:(p + 1) * ps]
                scales[:, bt[1, p]] = full[:, p * ps:(p + 1) * ps]
            pool["blocks"][name][key] = np.asarray(
                jnp.asarray(fp, jnp.bfloat16))
            qc["blocks"][name][key], qs["blocks"][name][key] = codes, scales
    quant_len = np.asarray([0, seq, 0], np.int32)
    return pool, qc, qs, bt, quant_len


def test_paged_arena_decode_matches(models, prefilled):
    """The paged decode step (Hopper paged_attention_arena; its plain
    version on the CPU) against the JAX package's gather + _blend_quant +
    decode_step, then the arena step's page writes."""
    cfg, jp, pp = models
    ps, seq = 8, SEQ
    _, _, first, jc = prefilled
    pool, qc, qs, bt, quant_len = _paged_case(cfg, jc, B, seq, ps, seed=5)
    pos = np.asarray([40, 40, 33], np.int32)
    mask = np.asarray([True, True, False])
    view_len = bt.shape[1] * ps
    jpos = np.where(mask, pos, view_len - 1).astype(np.int32)
    jarr = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa

    def view_decode(p, pool, qc, qs, bt, ql, t, ps_):
        view = {"prefix": {}, "blocks": {
            name: {key: JQ._blend_quant(
                JQ._paged_view(pool["blocks"][name][key], bt, False),
                JQ._paged_view(qc["blocks"][name][key], bt, False),
                JQ._paged_view(qs["blocks"][name][key], bt, False),
                ql, False) for key in ("k", "v")}
            for name in pool["blocks"]}}
        return JT.decode_step(cfg, p, view, t, ps_)[0]

    jargs = (jp, jarr(pool), jarr(qc), jarr(qs), jnp.asarray(bt),
             jnp.asarray(quant_len), jnp.asarray(first))
    jl = _exact(view_decode, *jargs, jnp.asarray(jpos))
    arena, _ = JQ._paged_steps(cfg.name, ps)
    jtok, jpool = _exact(arena, *jargs, jnp.asarray(pos), jnp.asarray(mask))
    tpool, tqc, tqs = _tree_t(pool), _tree_t(qc), _tree_t(qs)
    caches = {"prefix": {}, "blocks": {
        name: PagedKV(c["k"], c["v"], tqc["blocks"][name]["k"],
                      tqs["blocks"][name]["k"], tqc["blocks"][name]["v"],
                      tqs["blocks"][name]["v"], _t(bt), _t(quant_len))
        for name, c in tpool["blocks"].items()}}
    pl, _ = PT.decode_step(cfg, pp, caches, _t(first), _t(jpos))
    _close(pl, jl)
    np.testing.assert_array_equal(pl.argmax(-1)[mask].numpy(),
                                  np.asarray(jl).argmax(-1)[mask])

    p_arena, _ = PQ._paged_steps(cfg.name, ps)
    ptok, ppool = p_arena(pp, tpool, tqc, tqs, _t(bt), _t(quant_len),
                          _t(first), _t(pos), _t(mask))
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for name in pool["blocks"]:
        for key in ("k", "v"):
            _close(ppool["blocks"][name][key], jpool["blocks"][name][key])
