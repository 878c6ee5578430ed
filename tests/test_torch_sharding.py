"""The port's sharding rules (repro_torch.distribution.sharding) and logical
axes (repro_torch.models.axes) against the JAX package's.

The rules read only a mesh's axis names and sizes, so both sides get a
stand-in mesh, as ``tests/test_sharding.py`` does: the JAX side its
``FakeMesh``, the port side an object with ``mesh_dim_names`` and
``shape``.  The JAX side places abstract values; the port side meta
tensors.  Held:

  - ``test_sharding.py``'s eight cases, the same expectations as tuples;
  - ``param_axes(cfg)`` equal to JAX's ``init_params(cfg,
    abstract=True)[1]``, path for path, for tiny-lm and the ten assigned
    architectures at full width;
  - the parameter, input and cache specs of every one of those × each
    supported shape × (16x16, 2x16x16) equal to JAX's ``tree_pspecs``,
    ``inputs_pspecs`` and ``cache_pspecs``;
  - ``to_placements`` of a spec with a dimension over two mesh axes.
"""
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import SHAPES_BY_NAME as J_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.distribution import sharding as jsh  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import make_inputs_for_shape as jax_inputs  # noqa: E402
from repro_torch.configs import SHAPES_BY_NAME, get_config, supported_shapes  # noqa: E402
from repro_torch.distribution import sharding as sh  # noqa: E402
from repro_torch.models import init_params, make_inputs_for_shape  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402
from repro_torch.models.convert import flatten  # noqa: E402


@dataclass
class PortMesh:
    """What the rules read of a ``DeviceMesh``."""

    mesh_dim_names: tuple
    shape: tuple


@dataclass
class JaxMesh:
    """``tests/test_sharding.py``'s stand-in for a JAX mesh."""

    axis_names: tuple
    shape_tuple: tuple

    @property
    def devices(self):
        class _D:
            def __init__(self, s):
                self.shape = s
                self.size = int(np.prod(s))
        return _D(self.shape_tuple)


MESH1 = PortMesh(("data", "model"), (16, 16))
MESH2 = PortMesh(("pod", "data", "model"), (2, 16, 16))
MESHES = {"16x16": (MESH1, JaxMesh(("data", "model"), (16, 16))),
          "2x16x16": (MESH2, JaxMesh(("pod", "data", "model"), (2, 16, 16)))}


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases
# ---------------------------------------------------------------------------
def test_divisible_heads_shard():
    spec = sh.resolve_axes(("embed", "heads", "head_dim"), (2560, 32, 128),
                           MESH1)
    assert spec == (None, "model", None)


def test_indivisible_heads_replicate():
    # minicpm: 36 heads on a 16-way model axis -> fallback to replication
    spec = sh.resolve_axes(("embed", "heads", "head_dim"), (2304, 36, 64),
                           MESH1)
    assert spec == (None, None, None)


def test_batch_pod_data():
    spec = sh.resolve_axes(("batch", "seq"), (256, 4096), MESH2)
    assert spec == (("pod", "data"), None)


def test_batch_indivisible():
    spec = sh.resolve_axes(("batch", "seq"), (1, 4096), MESH2)
    assert spec == (None, None)


def test_vocab_odd_fallback():
    # minicpm vocab 122753 is odd -> replicated
    spec = sh.resolve_axes(("vocab", "embed"), (122753, 2304), MESH1)
    assert spec == (None, None)
    spec2 = sh.resolve_axes(("vocab", "embed"), (151936, 2560), MESH1)
    assert spec2 == ("model", None)


def test_mesh_axis_never_reused():
    spec = sh.resolve_axes(("heads", "mlp"), (32, 9728), MESH1)
    used = [s for s in spec if s is not None]
    assert len(used) == len(set(used)) == 1  # model used once


def test_kv_cache_pspec_heads_vs_seq():
    # kv=16 divisible -> heads sharded
    assert sh.kv_cache_pspec(MESH1, (128, 32768, 16, 128)) == \
        ("data", None, "model", None)
    # kv=8 not divisible by 16 -> sequence sharding (flash-decoding style)
    assert sh.kv_cache_pspec(MESH1, (128, 32768, 8, 128)) == \
        ("data", "model", None, None)
    # batch=1 (long_500k): no batch sharding
    assert sh.kv_cache_pspec(MESH1, (1, 524288, 8, 128)) == \
        (None, "model", None, None)


def test_mamba_state_pspec():
    assert sh.mamba_state_pspec(MESH1, (128, 8192, 16)) == \
        ("data", "model", None)
    assert sh.mamba_state_pspec(MESH1, (1, 8190, 16)) == (None, None, None)


# ---------------------------------------------------------------------------
# The port's trees against the JAX package's, every arch at full width
# ---------------------------------------------------------------------------
ARCHS = ["tiny-lm"] + list(ASSIGNED_ARCHS)


def _spec(s):
    """A JAX PartitionSpec (or None) as the port's tuple."""
    return None if s is None else tuple(s)


def _same_trees(got, want, conv=lambda x: x):
    g = dict(flatten(got))
    w = {p: conv(v) for p, v in flatten(want)}
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    bad = {p: (g[p], w[p]) for p in g if g[p] != w[p]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_jax(arch):
    _, want = jax_init(jax_config(arch), abstract=True)
    _same_trees(param_axes(get_config(arch)), want, tuple)


CELLS = [(arch, shape, mesh) for arch in ARCHS
         for shape in supported_shapes(get_config(arch))
         for mesh in MESHES]


def _jax_specs_tree(tree):
    """A JAX tree of PartitionSpecs and Nones as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _jax_specs_tree(v) for k, v in tree.items()}
    return _spec(tree)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_specs_equal_jax(arch, shape, mesh):
    port_mesh, jax_mesh = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    p_dtype = torch.bfloat16 if SHAPES_BY_NAME[shape].kind != "train" \
        else torch.float32
    # parameters
    params = init_params(cfg, dtype=p_dtype, device="meta")
    jparams, jaxes = jax_init(jcfg, abstract=True)
    _same_trees(sh.tree_pspecs(param_axes(cfg), params, port_mesh),
                _jax_specs_tree(jsh.tree_pspecs(jaxes, jparams, jax_mesh)))
    # inputs, caches included
    inputs = make_inputs_for_shape(cfg, SHAPES_BY_NAME[shape], device="meta")
    jinputs = jax_inputs(jcfg, J_SHAPES[shape], abstract=True)
    got = sh.inputs_pspecs(inputs, port_mesh)
    want = _jax_specs_tree(jsh.inputs_pspecs(jinputs, jax_mesh, jcfg))
    _same_trees(got, want)
    if "caches" in inputs:
        _same_trees(sh.cache_pspecs(inputs["caches"], port_mesh),
                    _jax_specs_tree(jsh.cache_pspecs(jinputs["caches"],
                                                     jax_mesh)))


def test_to_placements_nests_mesh_axes_in_order():
    from torch.distributed.tensor import Replicate, Shard
    assert sh.to_placements((("pod", "data"), None, "model"), MESH2) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.to_placements((None, "model"), MESH1) == (Replicate(), Shard(1))
    assert sh.to_placements((), MESH1) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        sh.to_placements((("data", "pod"),), MESH2)
