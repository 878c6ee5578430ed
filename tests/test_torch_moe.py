"""The port's MoE layer (repro_torch.models.layers) against the JAX
package's, in both forms ("einsum": GShard one-hot dispatch, tokens
queued per batch row; "sort": capacity-sorted scatter, tokens queued over
the batch), plus the cases of ``tests/test_moe.py`` on the port.

Routing is held exactly: the top-k expert ids and which assignments the
capacity keeps, also where router logits tie (planted by duplicating a
router column: ``jax.lax.top_k`` puts the lower index first, and so must
the port, whose ``torch.topk`` promises no order among equal values).
Outputs and aux are held element-wise at the model tolerance (atol 2e-2 +
rtol 1.6e-2 of each element); on these inputs they are equal bit for bit,
which the test prints (``-s``).  The JAX side is compiled with XLA's excess
precision off, so each operation rounds at its written dtype.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import reduce_config  # noqa: E402
from repro.models.axes import Initializer, split_tree  # noqa: E402
from repro.models.layers import apply_moe as jax_moe  # noqa: E402
from repro.models.layers import init_moe  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models.convert import tree_map  # noqa: E402

RTOL, ATOL = 1.6e-2, 2e-2
IMPLS = ["einsum", "sort"]


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


@pytest.fixture(scope="module", params=["deepseek-moe-16b",
                                        "llama4-scout-17b-a16e"])
def moe_setup(request):
    """(JAX cfg, port cfg, JAX params, port params, x): reduced configs
    (deepseek: 8 experts top-2 with a shared expert; llama4-scout: top-1)
    with router columns 3 and 5 made equal, so their logits tie."""
    cfg = reduce_config(get_config(request.param))
    pcfg = port_config(request.param + "-reduced")
    params, _ = split_tree(init_moe(Initializer(seed=0), cfg))
    params = jax.tree_util.tree_map(np.array, params)   # writable copies
    params["router"][:, 5] = params["router"][:, 3]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    return cfg, pcfg, params, tree_map(_t, params), x


def _jax_routing(cfg, params, x):
    """The JAX package's routing and capacity, line for line from
    ``_apply_moe_einsum`` / ``_apply_moe_sort``: (top_ids (B, S, k),
    kept (B, S, k))."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = (x.astype(jnp.bfloat16)
              @ params["router"].astype(jnp.bfloat16)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_ids = jax.lax.top_k(probs, k)
    if cfg.moe_impl == "einsum":
        cap = min(max(int(np.ceil(s * k / e * cfg.capacity_factor)), 1), s)
        mask = jax.nn.one_hot(top_ids, e, dtype=jnp.float32).sum(axis=2)
        pos = jnp.cumsum(mask, axis=1) - mask
        keep = (pos < cap) & (mask > 0)
        return top_ids, jnp.take_along_axis(keep, top_ids, axis=-1)
    t = b * s
    cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 1)
    flat_ids = top_ids.reshape(-1)
    sort_idx = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[sort_idx]
    counts = jnp.bincount(flat_ids, length=e)
    starts = jnp.cumsum(counts) - counts
    keep_sorted = (jnp.arange(t * k) - starts[sorted_ids]) < cap
    keep = jnp.zeros((t * k,), bool).at[sort_idx].set(keep_sorted)
    return top_ids, keep.reshape(b, s, k)


def _both(cfg, pcfg, params, pparams, x, **over):
    cfg, pcfg = replace(cfg, **over), replace(pcfg, **over)
    want = _exact(lambda p, a: (jax_moe(p, cfg, a), _jax_routing(cfg, p, a)),
                  params, jnp.asarray(x))
    got_y, got_aux = PL.apply_moe(pparams, pcfg, torch.from_numpy(x))
    got_ids, got_kept = PL.moe_assignments(pparams, pcfg,
                                           torch.from_numpy(x))
    return (got_y, got_aux, got_ids, got_kept), want


def _close(got, want, what):
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy()
    err = np.abs(g - w)
    print(f"{what}: max |port - jax| {err.max():.3g}")
    assert (err <= ATOL + RTOL * np.abs(w)).all(), (what, err.max())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cf", [16.0, 1.25, 0.25])
def test_routing_output_and_aux_match_jax(moe_setup, impl, cf):
    """No drops (16), the default capacity (1.25), drops (0.25)."""
    cfg, pcfg, params, pparams, x = moe_setup
    (y, aux, ids, kept), ((jy, jaux), (jids, jkept)) = _both(
        cfg, pcfg, params, pparams, x, moe_impl=impl, capacity_factor=cf)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    if cf == 0.25:
        assert not kept.all()                 # capacity really drops
    _close(y, jy, f"{impl} cf {cf} output")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_planted_ties_break_to_the_lower_expert(moe_setup):
    """Router columns 3 and 5 are equal, so wherever both reach the top-k
    boundary their probabilities tie exactly; the lower index wins in
    both packages."""
    cfg, pcfg, params, pparams, x = moe_setup
    probs, _, ids = PL.moe_route(pparams, pcfg, torch.from_numpy(x))
    assert torch.equal(probs[..., 3], probs[..., 5])
    jids = np.asarray(_exact(lambda p, a: _jax_routing(cfg, p, a)[0],
                             params, jnp.asarray(x)))
    np.testing.assert_array_equal(ids.numpy(), jids)
    # where expert 3 is chosen and 5 ties with the next one, 3 comes first
    has3, has5 = (ids == 3).any(-1), (ids == 5).any(-1)
    assert has3.any()
    assert not (has5 & ~has3).any()


def test_ties_across_the_whole_router():
    """All logits equal (a zero router): every token's top-k is experts
    0..k-1 in order, and the sort form queues them identically."""
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    pcfg = port_config("deepseek-moe-16b-reduced")
    params, _ = split_tree(init_moe(Initializer(seed=1), cfg))
    params = jax.tree_util.tree_map(np.array, params)   # writable copies
    params["router"][:] = 0.0
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    for impl in IMPLS:
        (y, aux, ids, kept), ((jy, jaux), (jids, jkept)) = _both(
            cfg, pcfg, params, tree_map(_t, params), x, moe_impl=impl)
        assert (ids == torch.arange(cfg.experts_per_token)).all()
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
        _close(y, jy, f"{impl} zero router output")
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------
def test_einsum_matches_sort_without_drops(moe_setup):
    _, pcfg, _, pparams, x = moe_setup
    hi = replace(pcfg, capacity_factor=16.0)
    xt = torch.from_numpy(x)
    y_e, aux_e = PL.apply_moe(pparams, replace(hi, moe_impl="einsum"), xt)
    y_s, aux_s = PL.apply_moe(pparams, replace(hi, moe_impl="sort"), xt)
    assert float((y_e - y_s).abs().max()) < 0.02
    assert abs(float(aux_e) - float(aux_s)) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_capacity_drops_change_output(moe_setup, impl):
    _, pcfg, _, pparams, x = moe_setup
    xt = torch.from_numpy(x)
    y_hi, _ = PL.apply_moe(pparams, replace(pcfg, capacity_factor=16.0,
                                            moe_impl=impl), xt)
    y_lo, _ = PL.apply_moe(pparams, replace(pcfg, capacity_factor=0.25,
                                            moe_impl=impl), xt)
    assert bool(torch.isfinite(y_lo).all())
    assert float((y_hi - y_lo).abs().max()) > 1e-4


def test_shared_experts_always_active():
    pcfg = port_config("deepseek-moe-16b-reduced")
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    params, _ = split_tree(init_moe(Initializer(seed=0), cfg))
    pparams = tree_map(_t, jax.tree_util.tree_map(np.asarray, params))
    assert "shared" in pparams
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32) * 0.5)
    y, _ = PL.apply_moe(pparams, replace(pcfg, capacity_factor=0.01), x)
    assert float(y.abs().max()) > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_grad_flows_through_dispatch(moe_setup, impl):
    """The router gets gradient (aux loss and combine weights) through
    autograd, as through ``jax.grad`` in tests/test_moe.py."""
    _, pcfg, _, pparams, x = moe_setup
    live = tree_map(lambda p: p.clone().requires_grad_(), pparams)
    y, aux = PL.apply_moe(live, replace(pcfg, moe_impl=impl),
                          torch.from_numpy(x))
    loss = (y.float() ** 2).mean() + 0.01 * aux
    loss.backward()
    grads = [p.grad for p in jax.tree_util.tree_leaves(
        live, is_leaf=lambda v: isinstance(v, torch.Tensor))]
    total = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert np.isfinite(total) and total > 0
    assert float(live["router"].grad.abs().sum()) > 0
