"""The port's training path (repro_torch.distribution, models.forward,
core.quality's trainer, launch.train) against the JAX package's.

Tolerances:
  - the optimizer (``schedule_lr``, ``adamw_update``) within rtol 1e-6 on
    identical inputs: the same f32 operations, with XLA's and PyTorch's
    ``cos`` / ``pow`` / sums of squares apart in the last f32 place;
  - ``cross_entropy`` within rtol 1e-6 (f32 ``logsumexp``, sums in
    another order);
  - ``forward``'s logits, the loss and each gradient leaf at
    |got - want| <= atol + rtol * max|want| with the model tolerance of
    ``test_torch_model.py`` (rtol 1.6e-2, atol 2e-2 for logits; rtol
    1.6e-2, atol 0 for gradients, the loss within rtol 1e-5): both sides
    round to bf16 at the same points, but XLA's backward rounds its
    cotangents where PyTorch's autograd does not, and sums in another
    order.  On bridged ``tiny-lm`` weights the gradients sit within 4e-3
    of each leaf's scale (about one bf16 ulp); the margins are printed;
  - ten train steps from the same init and batches: the first loss (same
    parameters) within rtol 1e-6, each later one within rtol 5e-3 of
    JAX's.  Adam divides each gradient element by its own magnitude, so
    where an element is near zero a last-place difference moves its
    update by up to the learning rate: at the default lr 3e-4 the
    trajectories part by up to 2.5e-3 in ten steps from JAX's seed-4
    init, at lr 3e-3 by up to 4e-2 (measured on the CPU);
  - ``remat=True`` against ``remat=False`` and a resumed launcher run
    against an uninterrupted one: bit for bit.

The JAX side is compiled with XLA's excess precision off, as in the
model tests, so each operation rounds at its written dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.distribution import optimizer as JO  # noqa: E402
from repro.distribution import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.distribution import optimizer as PO  # noqa: E402
from repro_torch.distribution import steps as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten,
    from_jax_arrays,
    leaves,
    tree_map,
)

GRAD_RTOL = 1.6e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch on one CPU thread: the suite runs several test processes
    at once, and these small ops gain nothing from threads that would only
    contend with them (and with XLA's) across the processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
LOGIT_RTOL, LOGIT_ATOL = 1.6e-2, 2e-2


def _exact(fn, *args):
    """``fn(*args)`` jitted with ``xla_allow_excess_precision`` off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batches(n, b=4, seq=64, seed=0):
    out = []
    for i in range(n):
        tokens, mask = make_batch("mixed", b, seq, seed=seed + i)
        out.append((tokens, mask[:, 1:]))
    return out


def _jb(tokens, mask):
    return {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}


def _pb(tokens, mask):
    return {"tokens": torch.as_tensor(tokens), "mask": torch.as_tensor(mask)}


@pytest.fixture(scope="module")
def tiny(reference_model):
    """(cfg, JAX params, the same weights bridged to the port) on the
    CPU: the trained reference model."""
    cfg, jp = reference_model
    return cfg, jp, from_jax_arrays(_np_tree(jp), cfg, device="cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_lr_matches_jax(schedule):
    oc = JO.OptConfig(lr=3e-3, warmup_steps=7, total_steps=50,
                      schedule=schedule)
    for step in (0, 1, 3, 7, 8, 25, 39, 40, 41, 49, 50, 60):
        want = float(JO.schedule_lr(oc, jnp.asarray(step, jnp.int32)))
        got = PO.schedule_lr(PO.OptConfig(**oc.__dict__),
                             torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"{schedule} step {step}")


def _opt_inputs(seed, step):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (6, 10), "b": (10,)}, "c": {"v": (3, 4, 5)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.7).astype(np.float32),
        params)
    mu = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
        params)
    nu = jax.tree_util.tree_map(
        lambda p: (rng.random(p.shape) * 0.05).astype(np.float32), params)
    return params, grads, {"mu": mu, "nu": nu,
                           "step": np.asarray(step, np.int32)}


@pytest.mark.parametrize("schedule,grad_clip,step", [
    ("cosine", 1.0, 0), ("cosine", 1.0, 9), ("wsd", 0.5, 17),
    ("constant", 0.0, 3), ("cosine", 100.0, 1)])
def test_adamw_update_matches_jax(schedule, grad_clip, step):
    params, grads, state = _opt_inputs(step + 11, step)
    oc = JO.OptConfig(lr=1e-2, warmup_steps=4, total_steps=20,
                      schedule=schedule, grad_clip=grad_clip,
                      weight_decay=0.1)
    jp, js, jm = JO.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, state), oc)
    pp, ps, pm = PO.adamw_update(
        _torch_tree(params), _torch_tree(grads), _torch_tree(state),
        PO.OptConfig(**oc.__dict__))
    for name, got, want in (("params", pp, jp), ("mu", ps["mu"], js["mu"]),
                            ("nu", ps["nu"], js["nu"])):
        for (path, g), w in zip(flatten(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {path}")
    assert int(ps["step"]) == int(js["step"]) == step + 1
    assert ps["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)


def test_init_opt_state_layout():
    params = {"b": torch.ones(3, dtype=torch.bfloat16),
              "a": {"w": torch.ones(2, 2)}, "e": {}}
    st = PO.init_opt_state(params)
    assert sorted(st) == ["mu", "nu", "step"]
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for tree in (st["mu"], st["nu"]):
        assert tree["e"] == {}
        assert [l.dtype for l in leaves(tree)] == [torch.float32] * 2
        assert all(float(l.abs().sum()) == 0 for l in leaves(tree))


# ---------------------------------------------------------------------------
# cross entropy, forward, loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                            None if mask is None else jnp.asarray(mask))
    got = PS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_empty_mask_is_zero():
    logits = torch.zeros(1, 2, 5)
    got = PS.cross_entropy(logits, torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(1, 2))
    assert float(got) == 0.0


def test_forward_logits_match_jax(tiny):
    cfg, jp, pp = tiny
    tokens, _ = make_batch("mixed", 3, 48, seed=21)
    want, jaux = _exact(lambda p, t: JT.forward(cfg, p, {"tokens": t}), jp,
                        jnp.asarray(tokens))
    got, aux = PT.forward(cfg, pp, {"tokens": torch.as_tensor(tokens)})
    w = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    err = np.abs(got.numpy() - w).max()
    assert err <= LOGIT_ATOL + LOGIT_RTOL * np.abs(w).max(), err
    assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32
    # the last position is prefill's logits (prefill stores the cache)
    last, _ = PT.prefill(cfg, pp, {"tokens": torch.as_tensor(tokens)}, 48)
    assert torch.equal(last, got[:, -1:])


def _port_grads(cfg, pp, batch, remat=False):
    live = tree_map(lambda p: p.detach().requires_grad_(), pp)
    loss, parts = PS.loss_fn(cfg, live, batch, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves(live))


def test_loss_and_grads_match_jax(tiny):
    cfg, jp, pp = tiny
    tokens, mask = make_batch("mixed", 4, 64, seed=5)
    (jl, _), jg = _exact(jax.value_and_grad(
        lambda p, b: JS.loss_fn(cfg, p, b), has_aux=True), jp,
        _jb(tokens, mask[:, 1:]))
    loss, grads = _port_grads(cfg, pp, _pb(tokens, mask[:, 1:]))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for (path, _), g, w in zip(flatten(pp), grads,
                               jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        err, scale = np.abs(g.numpy() - w).max(), np.abs(w).max()
        print(f"{'/'.join(path)}: max err {err:.3e} = "
              f"{err / scale:.2e} of max|g| {scale:.3e}")
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert err <= GRAD_RTOL * scale, path


def test_remat_gives_the_same_grads_bit_for_bit():
    from repro_torch.configs import get_config as port_config
    pcfg = port_config("llama3.1-8b-reduced")
    pp = PT.init_params(pcfg, seed=1, device="cpu")
    tokens, mask = make_batch("mixed", 2, 40, seed=2)
    batch = _pb(tokens, mask[:, 1:])
    l0, g0 = _port_grads(pcfg, pp, batch, remat=False)
    l1, g1 = _port_grads(pcfg, pp, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_ten_train_steps_track_jax():
    """Ten steps from the same (bridged) init on the same batches."""
    cfg = get_config("tiny-lm")
    jp, _ = JT.init_params(cfg, seed=4)
    pp = from_jax_arrays(_np_tree(jp), cfg, device="cpu")
    oc = JO.OptConfig(warmup_steps=2, total_steps=10, weight_decay=0.01)
    batches = _batches(10, seed=40)
    jstep = jax.jit(JS.make_train_step(cfg, oc, remat=False)).lower(
        jp, JO.init_opt_state(jp), _jb(*batches[0])).compile(
        compiler_options={"xla_allow_excess_precision": False})
    pstep = PS.make_train_step(cfg, PO.OptConfig(**oc.__dict__), remat=False)
    jo, po = JO.init_opt_state(jp), PO.init_opt_state(pp)
    first = None
    for i, (tokens, mask) in enumerate(batches):
        jp, jo, jm = jstep(jp, jo, _jb(tokens, mask))
        pp, po, pm = pstep(pp, po, _pb(tokens, mask))
        assert sorted(pm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        assert all(isinstance(v, torch.Tensor) for v in pm.values())
        print(f"step {i + 1}: loss jax {float(jm['loss']):.6f} port "
              f"{float(pm['loss']):.6f}")
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-6 if i == 0 else 5e-3)
        # near the cosine's end lr is 1 + cos(x) with cos(x) near -1, so
        # one f32 ulp of cos is a larger share of it: compare to the peak
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=0, atol=1e-6 * oc.lr)
        first = first if first is not None else float(pm["loss"])
    assert int(po["step"]) == 10
    assert float(pm["loss"]) < first


def test_eval_prefill_and_decode_steps(tiny):
    cfg, jp, pp = tiny
    tokens, mask = make_batch("mixed", 2, 32, seed=8)
    ev = PS.make_eval_step(cfg)(pp, _pb(tokens, mask[:, 1:]))
    want = _exact(JS.make_eval_step(cfg), jp, _jb(tokens, mask[:, 1:]))
    np.testing.assert_allclose(float(ev["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert not ev["loss"].requires_grad
    t = torch.as_tensor(tokens[:, :16])
    logits, caches = PS.make_prefill_step(cfg, 20)(pp, {"tokens": t})
    l2, _ = PT.prefill(cfg, pp, {"tokens": t}, 20)
    assert torch.equal(logits, l2)
    nxt = logits.argmax(-1).to(torch.int32)
    out, _ = PS.make_decode_step(cfg)(pp, caches, nxt,
                                      torch.full((2,), 16, dtype=torch.int32))
    assert out.shape == (2, 1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# the launcher: crash, resume, same bits
# ---------------------------------------------------------------------------
def test_launcher_resume_equals_uninterrupted_run(tmp_path, monkeypatch):
    from repro_torch.launch import train as PL

    kw = dict(steps=7, batch=2, seq=24, ckpt_every=3, grad_compress_bits=8,
              log_every=0, device="cpu")
    whole, _, losses = PL.train("llama3.1-8b-reduced",
                                ckpt_dir=str(tmp_path / "a"), **kw)

    real = PL.make_batch

    def crash_at_5(workload, batch, seq, seed):
        if seed == 5:
            raise KeyboardInterrupt("simulated crash")
        return real(workload, batch, seq, seed=seed)

    monkeypatch.setattr(PL, "make_batch", crash_at_5)
    with pytest.raises(KeyboardInterrupt):
        PL.train("llama3.1-8b-reduced", ckpt_dir=str(tmp_path / "b"), **kw)
    monkeypatch.setattr(PL, "make_batch", real)
    resumed, opt, tail = PL.train("llama3.1-8b-reduced",
                                  ckpt_dir=str(tmp_path / "b"), **kw)
    assert 1 <= len(tail) <= 4 and tail == losses[-len(tail):]
    for (path, a), (_, b) in zip(flatten(whole), flatten(resumed)):
        assert torch.equal(a, b), path
    assert int(opt["step"]) == 7 and "ef" in opt


def test_launcher_main_runs(tmp_path, capsys):
    from repro_torch.launch import train as PL

    assert PL.main(["--arch", "llama3.1-8b-reduced", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--remat", "--ckpt-dir", str(tmp_path)]) == 0
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# the reference model: trained on first use, loadable by the JAX package
# ---------------------------------------------------------------------------
def test_get_reference_model_trains_and_jax_loads_it(tmp_path, monkeypatch):
    from repro.core import quality as JQ
    from repro_torch.core import quality as PQ

    monkeypatch.setattr(PQ, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(JQ, "CACHE_DIR", tmp_path)
    cfg, pp = PQ.get_reference_model(steps=3, device="cpu")
    assert (tmp_path / "tiny_lm_s3.npz").exists()
    _, again = PQ.get_reference_model(steps=3, device="cpu")   # now loads
    for (path, a), (_, b) in zip(flatten(pp), flatten(again)):
        assert torch.equal(a, b), path
    jcfg, jp = JQ.get_reference_model(steps=3)
    assert jcfg.name == cfg.name == "tiny-lm"
    for (path, a), b in zip(flatten(pp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(path))
    tokens, _ = make_batch("mixed", 2, 40, seed=9)
    want, _ = _exact(lambda p, t: JT.forward(jcfg, p, {"tokens": t}), jp,
                     jnp.asarray(tokens))
    got, _ = PT.forward(cfg, pp, {"tokens": torch.as_tensor(tokens)})
    w = np.asarray(want)
    assert np.abs(got.numpy() - w).max() <= \
        LOGIT_ATOL + LOGIT_RTOL * np.abs(w).max()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("steps", [400, 30])
def test_reference_trainer_uses_the_jax_settings(steps, monkeypatch):
    """The port's reference trainer builds the JAX package's optimizer
    config (learning rate, warmup, schedule, weight decay, clipping) and
    step, and keeps f32 masters and moments.  Phase 7a's eval loss
    cannot be relied on to see a dropped weight decay, a lost clip or bf16
    masters: over 400 steps each moves it by about as much as the
    arithmetic does (on the CPU, less than the spread of runs at 1-8
    threads)."""
    from repro.core import quality as JQ
    from repro.distribution import steps as JSteps
    from repro_torch.core import quality as PQ

    seen = {}

    def spy(name):
        def make_train_step(cfg, oc, remat=False, grad_transform=None):
            seen[name] = (cfg.name, dataclasses.asdict(oc), remat,
                          grad_transform)
            raise _Stop
        return make_train_step

    monkeypatch.setattr(JSteps, "make_train_step", spy("jax"))
    monkeypatch.setattr(PS, "make_train_step", spy("port"))
    for train in (lambda: JQ.train_reference_model(steps=steps),
                  lambda: PQ.train_reference_model(steps=steps,
                                                   device="cpu")):
        with pytest.raises(_Stop):
            train()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["weight_decay"] == 0.01
    monkeypatch.undo()
    _, params, _, opt = PQ.train_reference_model(steps=1, batch=2, seq=16,
                                                 device="cpu")
    for path, x in flatten({"params": params, "mu": opt["mu"],
                            "nu": opt["nu"]}):
        assert x.dtype == torch.float32, path
