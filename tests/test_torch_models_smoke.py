"""Every assigned architecture in the port (repro_torch.models) against the
JAX package, at reduced configs on the CPU: the counterpart of
``tests/test_models_smoke.py`` plus parity.

For each of the ten ``ASSIGNED_ARCHS`` the JAX parameters are bridged
with ``from_jax_arrays`` and both packages get the same inputs from
``make_inputs`` (equal bit for bit).  The JAX side is compiled with XLA's
excess precision off, as in ``test_torch_model.py``, so each operation
rounds at its written dtype.  Held:

  - ``forward``'s logits and aux, and the train step's loss;
  - ``prefill``'s last-token logits and every cache leaf (attention K/V,
    mamba states, whisper's cross-attention K/V);
  - one ``decode_step`` from those caches at a scalar position and at a
    (B,) one: logits and every updated cache leaf.

Tolerances are the Queue 3 convention: whole steps at |got - want| <=
atol + rtol * max|want| (atol 2e-2, rtol 1.6e-2) with equal argmax, the
loss within rtol 1e-5 and aux within rtol 1e-5.  Both packages round to
bf16 at the same points; XLA's CPU rsqrt, exp and f32 dot orders differ
from PyTorch's in the last f32 place, so a bf16 value now and then lands
one ulp apart.  Through an MoE router such a flip can move a token to
another expert; a whole step may then leave the tolerance, but only
where the first MoE layer whose routing differs chose between experts
whose router logits lie at most one bf16 ulp apart in the JAX run.  The
test finds that layer from both runs' router inputs, prints each flip
with its margin (``-s``) and requires it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro.configs.base import reduce_config  # noqa: E402
from repro.distribution import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.io import make_inputs as jax_inputs  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs.base import supported_shapes  # noqa: E402
from repro_torch.distribution import optimizer as PO  # noqa: E402
from repro_torch.distribution import steps as PS  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, prefill  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten,
    from_jax_arrays,
    leaves,
    tree_map,
)
from repro_torch.models.io import make_inputs  # noqa: E402

RTOL, ATOL = 1.6e-2, 2e-2
TRAIN_SEQ, PREFILL_SEQ, BATCH = 32, 24, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exact(fn, *args):
    """``fn(*args)`` jitted with ``xla_allow_excess_precision`` off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _err(got, want):
    """(max |got - want|, atol + rtol * max|want|)."""
    w = _np(want)
    return (float(np.abs(got.detach().float().numpy() - w).max()),
            ATOL + RTOL * float(np.abs(w).max()))


def _pairs(port_tree, jax_tree):
    """Leaves of both trees by path; the paths must be the same."""
    want = {tuple(k.key for k in p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = dict(flatten(port_tree))
    assert list(got) == list(want)
    return [(p, got[p], want[p]) for p in got]


def _ulps(a: float, b: float) -> float:
    """|a - b| in bf16 ulps of the larger magnitude."""
    m = max(abs(a), abs(b))
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 2.0 ** -133
    return abs(a - b) / ulp


# ---------------------------------------------------------------------------
# fixtures: bridged parameters, and each package's run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def arch_models(request):
    """(arch, JAX cfg, port cfg, JAX params, port params)."""
    arch = request.param
    cfg = reduce_config(get_config(arch))
    pcfg = port_config(arch + "-reduced")
    jp, _ = JT.init_params(cfg, seed=0)
    pp = from_jax_arrays(jax.tree_util.tree_map(np.asarray, jp), pcfg,
                         device="cpu")
    return arch, cfg, pcfg, jp, pp


def _train_batches(cfg, pcfg):
    jb = jax_inputs(cfg, "train", seq=TRAIN_SEQ, batch=BATCH,
                    abstract=False, seed=1)["batch"]
    pb = make_inputs(pcfg, "train", seq=TRAIN_SEQ, batch=BATCH, seed=1,
                     device="cpu")["batch"]
    return jb, pb


@pytest.fixture(scope="module")
def jax_train(arch_models):
    """JAX forward (on the shifted tokens), loss and parts, and the
    forward's trace: every sublayer's output (attention, mamba, MLP, MoE)
    and every MoE layer's router input, in execution order
    (``jax.debug.callback``)."""
    _, cfg, pcfg, jp, _ = arch_models
    jb, _ = _train_batches(cfg, pcfg)
    fb = dict(jb, tokens=jb["tokens"][:, :-1])
    trace = {"sub": [], "moe": []}
    names = (("L", "apply_attention"), ("L", "apply_mlp"), ("L", "apply_moe"),
             ("S", "apply_mamba"))
    real = {n: getattr(getattr(JT, m), n) for m, n in names}

    def record(kind, x):
        jax.debug.callback(lambda a: trace[kind].append(np.asarray(a)), x,
                           ordered=True)

    def wrap(name):
        def sublayer(*args, **kw):
            if name == "apply_moe":
                record("moe", args[2])
            out = real[name](*args, **kw)
            record("sub", out if name == "apply_mlp" else out[0])
            return out
        return sublayer

    for m, n in names:
        setattr(getattr(JT, m), n, wrap(n))
    try:
        (logits, aux), (loss, parts) = _exact(
            lambda p, b, f: (JT.forward(cfg, p, f), JS.loss_fn(cfg, p, b)),
            jp, jb, fb)
        jax.effects_barrier()
    finally:
        for m, n in names:
            setattr(getattr(JT, m), n, real[n])
    # the forward runs first; the loss repeats it
    trace = {k: v[:len(v) // 2] for k, v in trace.items()}
    return logits, aux, loss, parts, trace


@pytest.fixture(scope="module")
def port_train(arch_models):
    """The port's forward on the same inputs, and its trace."""
    _, cfg, pcfg, _, pp = arch_models
    _, pb = _train_batches(cfg, pcfg)
    trace = {"sub": [], "moe": []}
    names = (("L", "apply_attention"), ("L", "apply_mlp"), ("L", "apply_moe"),
             ("S", "apply_mamba"))
    real = {n: getattr(getattr(PT, m), n) for m, n in names}

    def wrap(name):
        def sublayer(*args, **kw):
            if name == "apply_moe":
                trace["moe"].append(args[2].detach().clone())
            out = real[name](*args, **kw)
            y = out if name == "apply_mlp" else out[0]
            trace["sub"].append(y.detach().clone())
            return out
        return sublayer

    for m, n in names:
        setattr(getattr(PT, m), n, wrap(n))
    try:
        logits, aux = forward(pcfg, pp, dict(pb, tokens=pb["tokens"][:, :-1]))
    finally:
        for m, n in names:
            setattr(getattr(PT, m), n, real[n])
    return logits, aux, trace


def _moe_params_of(cfg, params, n: int):
    """The parameters of the ``n``-th MoE layer in execution order."""
    plan = PT.plan_stack(cfg)
    order = [params["prefix"][f"layer{i}"]["mlp"]
             for i, s in enumerate(plan.prefix_specs) if s.moe]
    for blk in range(plan.n_blocks):
        order += [PT._block(params["blocks"], blk)[f"layer{j}"]["mlp"]
                  for j, s in enumerate(plan.period_specs) if s.moe]
    return order[n]


def _parted_by_rounding(arch_models, jax_train, port_train) -> bool:
    """Where a whole step leaves the tolerance: True when the two runs
    part at a last-place bf16 rounding and an MoE router then sends some
    token elsewhere; fails otherwise.  Required: the first sublayer output
    where the runs differ (its input, the residual stream, is still the
    same in both) holds the per-layer tolerance of ``test_torch_model.py``
    (the scale bound, and at most 0.1% of the elements beyond the
    element-wise one), and some MoE layer's routing differs.  Each flipped
    token is printed (``-s``) with its margin in the JAX run: the largest
    gap, in bf16 ulps, between the router logits of an expert only JAX
    chose and one only the port chose."""
    arch, _, pcfg, _, pp = arch_models
    jt, pt = jax_train[4], port_train[2]
    assert len(jt["sub"]) == len(pt["sub"])
    for n, (xj, xp) in enumerate(zip(jt["sub"], pt["sub"])):
        w, g = _np(xj), xp.float().numpy()
        if np.array_equal(w, g):
            continue
        err = np.abs(w - g)
        assert err.max() <= ATOL + RTOL * np.abs(w).max(), (arch, n)
        assert (err > ATOL + RTOL * np.abs(w)).mean() <= 1e-3, (arch, n)
        print(f"[{arch}] the runs first part at sublayer {n}: "
              f"{int((w != g).sum())} of {w.size} elements, by up to "
              f"{err.max():.3g}")
        break
    for n, (xj, xp) in enumerate(zip(jt["moe"], pt["moe"])):
        params = _moe_params_of(pcfg, pp, n)
        _, _, ids_j = PL.moe_route(params, pcfg, _t(xj))
        _, _, ids_p = PL.moe_route(params, pcfg, xp)
        bad = (torch.sort(ids_j, -1).values
               != torch.sort(ids_p, -1).values).any(-1).nonzero().tolist()
        if not bad:
            continue
        logits = PL._einsum_bf16("...d,de->...e", _t(xj),
                                 params["router"]).float()
        for idx in bad:
            a = set(ids_j[tuple(idx)].tolist())
            b = set(ids_p[tuple(idx)].tolist())
            row = logits[tuple(idx)]
            margin = max(_ulps(float(row[i]), float(row[j]))
                         for i in a - b for j in b - a)
            print(f"[{arch}] MoE layer {n} token {tuple(idx)}: JAX experts "
                  f"{sorted(a - b)} vs port {sorted(b - a)}, JAX router "
                  f"logit margin {margin:.3g} bf16 ulps")
        return True
    return False


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_inputs_equal_jax(arch_models, kind):
    _, cfg, pcfg, _, _ = arch_models
    want = jax_inputs(cfg, kind, seq=TRAIN_SEQ, batch=BATCH, abstract=False,
                      seed=3)
    got = make_inputs(pcfg, kind, seq=TRAIN_SEQ, batch=BATCH, seed=3,
                      device="cpu")
    for path, g, w in _pairs(got, want):
        if isinstance(w, int):                   # max_len
            assert g == w, path
            continue
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(), _np(w))


# ---------------------------------------------------------------------------
# forward and the train step (tests/test_models_smoke.py)
# ---------------------------------------------------------------------------
def test_forward_matches_jax(arch_models, jax_train, port_train):
    arch, cfg, _, _, _ = arch_models
    jl, jaux = jax_train[0], jax_train[1]
    pl, paux = port_train[0], port_train[1]
    assert pl.shape == jl.shape and pl.shape[-1] == cfg.vocab_size
    assert bool(torch.isfinite(pl).all()), f"{arch}: NaN/inf logits"
    err, tol = _err(pl, jl)
    same = np.array_equal(pl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    aux_ok = abs(float(paux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    if not (err <= tol and same and aux_ok):
        assert _parted_by_rounding(arch_models, jax_train, port_train), \
            (err, tol, float(paux), float(jaux))


def test_train_step_matches_jax(arch_models, jax_train, port_train):
    """One real optimizer step: its loss (on the step's parameters) is
    finite and positive, the parameters change, and the loss is JAX's
    within what the forward's logits allow: the cross-entropy of a token
    moves by at most twice the largest logit difference (logsumexp and
    the gold logit are each 1-Lipschitz in the max norm), the aux term by
    its weight times the aux difference."""
    arch, cfg, pcfg, _, pp = arch_models
    _, pb = _train_batches(cfg, pcfg)
    params = tree_map(lambda p: p.clone(), pp)
    oc = PO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = PS.make_train_step(pcfg, oc, remat=False)
    before = leaves(params)[1].clone()
    params, _, metrics = step(params, PO.init_opt_state(params), pb)
    loss, want = float(metrics["loss"]), float(jax_train[2])
    assert np.isfinite(loss) and loss > 0, f"{arch}: loss {loss}"
    assert float(metrics["aux"]) == float(port_train[1])
    logit_err, _ = _err(port_train[0], jax_train[0])
    aux_err = abs(float(port_train[1]) - float(jax_train[1]))
    bound = 2 * logit_err + PS.AUX_LOSS_WEIGHT * aux_err + 1e-6 * abs(want)
    assert abs(loss - want) <= bound, (loss, want, bound)
    assert not torch.equal(before, leaves(params)[1])


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_serve(arch_models):
    """JAX prefill of make_inputs' prompt, then one decode step from its
    caches at a scalar and at a (B,) position."""
    _, cfg, _, jp, _ = arch_models
    pin = jax_inputs(cfg, "prefill", seq=PREFILL_SEQ, batch=BATCH,
                     abstract=False, seed=2)
    max_len = pin["max_len"] + 4
    s0 = pin["batch"]["tokens"].shape[1] + (
        pin["batch"]["patch_embeds"].shape[1]
        if "patch_embeds" in pin["batch"] else 0)
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (BATCH, 1))
    tok = jnp.asarray(tok, jnp.int32)
    vec = jnp.asarray([s0, s0 - 3], jnp.int32)

    def run(p, b, t):
        logits, caches = JT.prefill(cfg, p, b, max_len=max_len)
        scalar = JT.decode_step(cfg, p, caches, t, jnp.asarray(s0, jnp.int32))
        per_slot = JT.decode_step(cfg, p, caches, t, vec)
        return logits, caches, scalar, per_slot

    return (max_len, s0, np.asarray(tok), np.asarray(vec),
            _exact(run, jp, pin["batch"], tok))


def _close_tree(port_tree, jax_tree, what):
    for path, g, w in _pairs(port_tree, jax_tree):
        assert tuple(g.shape) == tuple(w.shape), (what, path)
        err, tol = _err(g, w)
        assert err <= tol, (what, path, err, tol)


def test_prefill_matches_jax(arch_models, jax_serve):
    _, cfg, pcfg, _, pp = arch_models
    max_len, _, _, _, (jl, jc, _, _) = jax_serve
    pin = make_inputs(pcfg, "prefill", seq=PREFILL_SEQ, batch=BATCH, seed=2,
                      device="cpu")
    pl, pc = prefill(pcfg, pp, pin["batch"], max_len=max_len)
    assert pl.shape == (BATCH, 1, cfg.vocab_size)
    err, tol = _err(pl, jl)
    assert err <= tol
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _close_tree(pc, jc, "prefill caches")


@pytest.mark.parametrize("where", ["scalar", "per_slot"])
def test_decode_step_matches_jax(arch_models, jax_serve, where):
    """One decode step from the JAX prefill's caches (so both start from
    the same state): logits and every cache leaf after the step."""
    _, cfg, pcfg, _, pp = arch_models
    _, s0, tok, vec, (_, jc, scalar, per_slot) = jax_serve
    jl, jc2 = scalar if where == "scalar" else per_slot
    caches = jax.tree_util.tree_map(_t, jc)
    pos = s0 if where == "scalar" else torch.from_numpy(vec)
    pl, pc2 = decode_step(pcfg, pp, caches, torch.from_numpy(tok), pos)
    assert pl.shape == (BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(pl).all())
    err, tol = _err(pl, jl)
    assert err <= tol
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _close_tree(pc2, jc2, f"{where} decode caches")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-9b", "falcon-mamba-7b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "qwen2-vl-72b", "whisper-small"])
def test_decode_consistency_with_forward(arch):
    """Teacher-forced decode reproduces the full forward's logits, on the
    weights and tokens of tests/test_models_smoke.py (MoE at a no-drop
    capacity, as there), within that test's gate (atol 0.15, rtol 0.05,
    equal argmax).  That test runs JAX op by op, where XLA keeps f32
    inside each fused op; compiled with its cast points kept (excess
    precision off), the JAX package itself leaves the gate on a few
    elements for gemma2 and jamba.  So the port's forward and decode are
    each held to that JAX run (model tolerance, equal argmax), and the
    port may leave the gate only on elements where that run does
    (printed with ``-s``)."""
    jcfg = reduce_config(get_config(arch))
    cfg = port_config(arch + "-reduced")
    if cfg.moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=16.0)
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    jp, _ = JT.init_params(jcfg, seed=0)
    params = from_jax_arrays(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    T = 12
    tokens = rng.integers(0, cfg.vocab_size, (2, T + 1)).astype(np.int32)
    extra = {}
    if cfg.encoder_decoder:
        extra = {"frames": rng.standard_normal((2, 20, cfg.d_model)) * 0.02}

    def jax_run(p, tk, ex):
        ex = {k: v.astype(jnp.bfloat16) for k, v in ex.items()}
        full, _ = JT.forward(jcfg, p, {"tokens": tk, **ex})
        _, caches = JT.prefill(jcfg, p, {"tokens": tk[:, :T], **ex},
                               max_len=T + 1)
        dlog, _ = JT.decode_step(jcfg, p, caches, tk[:, T:T + 1],
                                 jnp.asarray(T, jnp.int32))
        return full[:, T], dlog[:, 0]

    ja, jb = map(_np, _exact(jax_run, jp, jnp.asarray(tokens),
                             {k: jnp.asarray(v, jnp.float32)
                              for k, v in extra.items()}))
    pex = {k: torch.as_tensor(v, dtype=torch.float32).to(torch.bfloat16)
           for k, v in extra.items()}
    pt = torch.from_numpy(tokens)
    full, _ = forward(cfg, params, {"tokens": pt, **pex})
    _, caches = prefill(cfg, params, {"tokens": pt[:, :T], **pex},
                        max_len=T + 1)
    dlog, _ = decode_step(cfg, params, caches, pt[:, T:T + 1], T)
    a, b = full[:, T], dlog[:, 0].float()
    for got, want in ((a, ja), (b, jb)):
        err, tol = _err(got, want)
        assert err <= tol
        assert got.argmax(-1).tolist() == np.argmax(want, -1).tolist()
    a, b = a.numpy(), b.numpy()
    assert np.argmax(a, -1).tolist() == np.argmax(b, -1).tolist()
    beyond = np.abs(a - b) > 0.15 + 0.05 * np.abs(b)
    ref_beyond = np.abs(ja - jb) > 0.15 + 0.05 * np.abs(jb)
    if beyond.any():
        print(f"[{arch}] decode vs forward beyond the gate at "
              f"{np.argwhere(beyond).tolist()}; the JAX run at "
              f"{np.argwhere(ref_beyond).tolist()}")
    assert not (beyond & ~ref_beyond).any()


# ---------------------------------------------------------------------------
# configs and structure (tests/test_models_smoke.py)
# ---------------------------------------------------------------------------
def test_param_counts_sane():
    expect = {
        "qwen3-4b": (3e9, 7e9), "gemma2-9b": (8e9, 13e9),
        "granite-20b": (15e9, 30e9), "minicpm-2b": (2e9, 3.5e9),
        "jamba-v0.1-52b": (40e9, 65e9), "whisper-small": (0.15e9, 0.45e9),
        "qwen2-vl-72b": (60e9, 85e9),
        "llama4-scout-17b-a16e": (85e9, 120e9),
        "deepseek-moe-16b": (14e9, 20e9), "falcon-mamba-7b": (6e9, 9e9),
    }
    for arch, (lo, hi) in expect.items():
        n = port_config(arch).param_count()
        assert lo <= n <= hi, arch
        assert n == get_config(arch).param_count()


def test_param_shapes_match_jax_at_full_width():
    """The port's parameter tree has the JAX package's leaves and shapes
    for every assigned architecture at its full configuration (abstract
    on the JAX side: nothing is allocated)."""
    from repro.models import init_params as jax_init
    for arch in ASSIGNED_ARCHS:
        want, _ = jax_init(get_config(arch), abstract=True)
        for path, got, w in _pairs(PT.param_shapes(port_config(arch)),
                                   want):
            assert got == tuple(w.shape), (arch, path)


def test_alias_modules_and_shapes():
    import importlib
    for arch in ASSIGNED_ARCHS:
        mod = arch.replace("-", "_").replace(".", "")
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        assert cfg == port_config(arch)
        assert "train_4k" in supported_shapes(cfg)
    assert "long_500k" in supported_shapes(port_config("falcon-mamba-7b"))
    assert "long_500k" not in supported_shapes(port_config("qwen3-4b"))


def test_scan_period_detection():
    assert port_config("jamba-v0.1-52b").scan_period() == 8
    plan = PT.plan_stack(port_config("deepseek-moe-16b"))
    assert len(plan.prefix_specs) == 1 and not plan.prefix_specs[0].moe
    assert plan.n_blocks == 27


def test_vision_prefix_is_sliced_off_the_loss():
    """The loss reads only the text positions of a VLM batch: logits over
    the patch prefix have no next-token targets (the JAX package's
    ``loss_fn`` slices them off, and so must the port's)."""
    pcfg = port_config("qwen2-vl-72b-reduced")
    params = init_params(pcfg, seed=1, device="cpu")
    b = make_inputs(pcfg, "train", seq=TRAIN_SEQ, batch=BATCH, seed=4,
                    device="cpu")["batch"]
    loss, parts = PS.loss_fn(pcfg, params, b)
    logits, _ = forward(pcfg, params, dict(b, tokens=b["tokens"][:, :-1]))
    s_vis = b["patch_embeds"].shape[1]
    want = PS.cross_entropy(logits[:, s_vis:], b["tokens"][:, 1:], b["mask"])
    assert float(parts["ce"]) == float(want)
