"""The port's CheckpointManager (repro_torch.checkpoint): the cases of
``test_checkpoint.py`` on the port, the restore onto another device, and
checkpoints that cross between the packages (the same on-disk layout,
leaves in the JAX tree's flatten order): arrays equal, bit for bit."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models.convert import flatten, leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch on one CPU thread: the suite runs several test processes
    at once, and these small ops gain nothing from threads that would only
    contend with them (and with XLA's) across the processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
                       rng.standard_normal((8, 16)).astype(np.float32)),
                   "b": torch.from_numpy(
                       rng.standard_normal((16,)).astype(np.float32))},
        "opt": {"mu": torch.zeros((8, 16)),
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def _equal(a, b) -> None:
    pa, pb = list(flatten(a)), list(flatten(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree(1)
    mgr.save(10, t, metadata={"loss": 1.5})
    out = mgr.restore(_tree(99))
    _equal(t, out)
    assert mgr.metadata() == {"loss": 1.5}


def test_latest_step_and_pruning(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (5, 10, 15, 20):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 20
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000015", "step_00000020"]


def test_incomplete_checkpoint_ignored(tmp_path):
    """A crash mid-write (no manifest) must not break restore."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(10, _tree(2))
    bad = Path(tmp_path) / "step_00000020"
    bad.mkdir()
    np.save(bad / "leaf_00000.npy", np.zeros(3))
    assert mgr.latest_step() == 10
    _equal(mgr.restore(_tree(0)), _tree(2))


def test_background_save_snapshots_before_in_place_updates(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree(3)
    want = {k: {n: x.clone() for n, x in v.items()} for k, v in t.items()}
    mgr.save(7, t, background=True)
    for x in leaves(t):          # training goes on, in place
        x.add_(1)
    mgr.wait()
    assert mgr.latest_step() == 7
    _equal(mgr.restore(_tree(0)), want)


def test_restore_errors(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(0))
    mgr.save(1, _tree(0))
    with pytest.raises(ValueError, match="leaf count"):
        mgr.restore({"w": torch.zeros(1)})


def test_manifest_layout_matches_jax(tmp_path):
    """Same leaf files, order, shapes and dtypes as the JAX package's."""
    t = _tree(4)
    CheckpointManager(tmp_path / "p").save(1, t)
    JaxManager(tmp_path / "j").save(
        1, jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t))
    mp, mj = (json.loads((tmp_path / d / "step_00000001" / "manifest.json")
                         .read_text()) for d in ("p", "j"))
    for key in ("step", "n_leaves", "shapes", "dtypes", "metadata"):
        assert mp[key] == mj[key], key


def test_restore_onto_another_device(tmp_path):
    """The port's form of the elastic restore: the template gives the
    structure, ``device`` the placement (an abstract template on the meta
    device restored onto the CPU, and back)."""
    mgr = CheckpointManager(tmp_path)
    t = _tree(5)
    mgr.save(2, t)
    abstract = {k: {n: torch.empty(x.shape, dtype=x.dtype, device="meta")
                    for n, x in v.items()} for k, v in t.items()}
    out = mgr.restore(abstract, device="cpu")
    _equal(out, t)
    assert all(x.device.type == "cpu" for x in leaves(out))
    meta = mgr.restore(t, device="meta")
    assert all(x.device.type == "meta" for x in leaves(meta))
    same = mgr.restore(abstract)     # device None: the template's places
    assert all(x.device.type == "meta" for x in leaves(same))


def _train_state(port: bool):
    """Params, AdamW state and error feedback of reduced llama, from the
    JAX init (bridged for the port): dicts whose keys sort ef, mu, nu,
    step and opt before params."""
    from repro.configs import get_config
    from repro.distribution.grad_compress import init_ef_state
    from repro.distribution.optimizer import init_opt_state
    from repro.models import init_params
    from repro_torch.configs import get_config as port_config
    from repro_torch.distribution.grad_compress import init_ef_state as p_ef
    from repro_torch.distribution.optimizer import init_opt_state as p_opt
    from repro_torch.models.convert import from_jax_arrays

    cfg = get_config("llama3.1-8b-reduced")
    jp, _ = init_params(cfg, seed=2)
    if not port:
        opt = init_opt_state(jp)
        opt["ef"] = init_ef_state(jp)
        return {"params": jp, "opt": opt}
    pp = from_jax_arrays(jax.tree_util.tree_map(np.asarray, jp),
                         port_config("llama3.1-8b-reduced"), device="cpu")
    opt = p_opt(pp)
    opt["ef"] = p_ef(pp)
    return {"params": pp, "opt": opt}


def _perturbed_jax(state):
    rng = np.random.default_rng(6)
    return jax.tree_util.tree_map(
        lambda x: (jnp.asarray(x + rng.standard_normal(x.shape).astype(
            np.float32)) if x.ndim else jnp.asarray(17, jnp.int32)), state)


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _perturbed_jax(_train_state(port=False))
    JaxManager(tmp_path).save(17, state, metadata={"by": "jax"})
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 17 and mgr.metadata() == {"by": "jax"}
    out = mgr.restore(_train_state(port=True))
    jl = jax.tree_util.tree_flatten_with_path(state)[0]
    pl = list(flatten(out))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in pl]
    for (path, want), (_, got) in zip(jl, pl):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      str(path))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _train_state(port=True)
    gen = torch.Generator().manual_seed(8)
    for x in leaves(state):
        x.add_(torch.randn(x.shape, generator=gen) if x.dim()
               else torch.tensor(5, dtype=torch.int32))
    CheckpointManager(tmp_path).save(5, state)
    out = JaxManager(tmp_path).restore(_train_state(port=False))
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(out)[0], leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy(),
                                      str(path))


def test_restore_resumes_training(tmp_path):
    """Crash/restart: the restored state continues bit-identically."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.models import init_params

    cfg = get_config("llama3.1-8b-reduced")   # the port runs dense GQA
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    step = make_train_step(cfg, oc, remat=False)

    def batch(i):
        tokens, mask = make_batch("mixed", 2, 16, seed=i)
        tokens = np.minimum(tokens, cfg.vocab_size - 1)
        return {"tokens": torch.as_tensor(tokens),
                "mask": torch.as_tensor(mask[:, 1:])}

    mgr = CheckpointManager(tmp_path)
    p = init_params(cfg, seed=0, device="cpu")
    o = init_opt_state(p)
    for i in range(4):
        p, o, m = step(p, o, batch(i))
        if i == 1:
            mgr.save(2, {"params": p, "opt": o})
    loss_direct = m["loss"]

    fresh = init_params(cfg, seed=0, device="cpu")
    st = mgr.restore({"params": fresh, "opt": init_opt_state(fresh)})
    p2, o2 = st["params"], st["opt"]
    for i in (2, 3):
        p2, o2, m2 = step(p2, o2, batch(i))
    assert torch.equal(m2["loss"], loss_direct)
    _equal(p2, p)
