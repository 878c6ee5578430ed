"""The port's mamba-1 block (repro_torch.models.ssm) against the JAX
package's ``models/ssm.py``, on falcon-mamba's and jamba's reduced mixers.

``apply_mamba`` is held with and without a carried state (outputs, the
f32 recurrence state and the bf16 conv window), and the causal depthwise
conv alone against XLA's grouped convolution.  The conv, the projections
and the gating round to bf16 where the JAX code does and are equal bit
for bit here; the selective scan is an f32 recurrence whose exp and
softplus differ from XLA's in the last f32 place, so outputs are held
element-wise at the model tolerance (atol 2e-2 + rtol 1.6e-2 of each
element) and the f32 state at rtol 1e-5 of its scale.  A token-by-token
decode from the carried state must reproduce the full scan, in the port
alone, within the same tolerances.  The JAX side is compiled with XLA's
excess precision off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import reduce_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.axes import Initializer, split_tree  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402

RTOL, ATOL = 1.6e-2, 2e-2


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    w = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - w)
    assert (err <= atol + rtol * np.abs(w)).all(), err.max()


def _state_close(got, want):
    for key in ("ssm", "conv"):
        w = np.asarray(want[key], np.float32)
        g = got[key].float().numpy()
        assert got[key].dtype == (torch.float32 if key == "ssm"
                                  else torch.bfloat16)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-30, key


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "jamba-v0.1-52b"])
def mixer(request):
    cfg = reduce_config(get_config(request.param))
    pcfg = port_config(request.param + "-reduced")
    params, _ = split_tree(JS.init_mamba(Initializer(seed=2), cfg))
    rng = np.random.default_rng(3)
    params["conv_b"] = jnp.asarray(rng.standard_normal(cfg.d_inner) * 0.1,
                                   jnp.float32)     # a bias that is not 0
    x = jnp.asarray(rng.standard_normal((2, 20, cfg.d_model)), jnp.bfloat16)
    state = {
        "ssm": jnp.asarray(rng.standard_normal(
            (2, cfg.d_inner, cfg.ssm_state)) * 0.3, jnp.float32),
        "conv": jnp.asarray(rng.standard_normal(
            (2, cfg.d_inner, cfg.ssm_conv - 1)), jnp.bfloat16),
    }
    pparams = jax.tree_util.tree_map(_t, params)
    state["x_in"] = jnp.asarray(rng.standard_normal((2, 20, cfg.d_inner)),
                                jnp.bfloat16)           # the conv's input
    return cfg, pcfg, params, pparams, x, state


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_xla(mixer, with_state):
    cfg, _, params, pparams, x, state = mixer
    xi = state["x_in"]
    st = state["conv"] if with_state else None
    want_y, want_s = _exact(
        lambda a, w, b, s: JS._causal_depthwise_conv(a, w, b, s),
        xi, params["conv_w"], params["conv_b"], st)
    y, s = PS._causal_depthwise_conv(_t(xi), pparams["conv_w"],
                                     pparams["conv_b"],
                                     None if st is None else _t(st))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(want_s, np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mamba_matches_jax(mixer, with_state):
    cfg, pcfg, params, pparams, x, state = mixer
    st = ({k: state[k] for k in ("ssm", "conv")} if with_state else None)
    want_y, want_state = _exact(
        lambda p, a, s: JS.apply_mamba(p, cfg, a, state=s), params, x, st)
    y, new_state = PS.apply_mamba(
        pparams, pcfg, _t(x),
        state=None if st is None else jax.tree_util.tree_map(_t, st))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    _close(y, want_y)
    _state_close(new_state, want_state)


def test_token_by_token_decode_equals_the_full_scan(mixer):
    """Feeding the sequence one token at a time from the carried state
    gives the full scan's outputs and final state."""
    _, pcfg, _, pparams, x, state = mixer
    xt = _t(x)
    full_y, full_state = PS.apply_mamba(pparams, pcfg, xt)
    st, ys = None, []
    for i in range(xt.shape[1]):
        y, st = PS.apply_mamba(pparams, pcfg, xt[:, i:i + 1], state=st)
        ys.append(y)
    _close(torch.cat(ys, dim=1), full_y.float().numpy())
    _state_close(st, {k: v.float().numpy() for k, v in full_state.items()})
    # and from a carried state: the first half's state decodes the rest
    half = xt.shape[1] // 2
    _, mid = PS.apply_mamba(pparams, pcfg, xt[:, :half])
    rest, end = PS.apply_mamba(pparams, pcfg, xt[:, half:], state=mid)
    _close(rest, full_y[:, half:].float().numpy())
    _state_close(end, {k: v.float().numpy() for k, v in full_state.items()})


def test_init_mamba_state_shapes():
    pcfg = port_config("falcon-mamba-7b-reduced")
    st = PS.init_mamba_state(pcfg, 3, device="cpu")
    assert st["ssm"].shape == (3, pcfg.d_inner, pcfg.ssm_state)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].shape == (3, pcfg.d_inner, pcfg.ssm_conv - 1)
    assert st["conv"].dtype == torch.bfloat16
    stacked = PS.init_mamba_state(pcfg, 3, device="cpu", n=4)
    assert stacked["ssm"].shape == (4, 3, pcfg.d_inner, pcfg.ssm_state)
