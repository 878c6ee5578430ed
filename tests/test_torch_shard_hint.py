"""shard_hint in the port (repro_torch.utils.shard_hint): the identity on
plain tensors, and on a fake 8-rank (2, 4) mesh the JAX package's rule
(``tests/test_shard_hint.py``): a DTensor goes to the divisible subset of
the named axes, and keeps its placement where nothing divides.  Also
``utils/dtensor_step.py::pin_batch``, the residual stream's layout over
DTensors, and the MoE sort form's hints leaving plain tensors bit for
bit."""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.launch.mesh import init_fake_world, make_test_mesh  # noqa: E402
from repro_torch.utils.dtensor_step import pin_batch  # noqa: E402
from repro_torch.utils.shard_hint import shard_hint  # noqa: E402


def test_identity_without_mesh():
    x = torch.randn(8, 4)
    y = shard_hint(x, "model", None)
    assert y is x
    assert pin_batch(x) is x


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(8)
    try:
        yield make_test_mesh(data=2, model=4, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _dt(mesh, shape, placements):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements, src_data_rank=None)


def test_constraint_under_mesh(mesh):
    x = _dt(mesh, (6, 16), [Replicate(), Replicate()])
    y = shard_hint(x * 2, None, "model")
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Replicate(), Shard(1))
    assert y.to_local().shape == (6, 4)


def test_indivisible_keeps_placement(mesh):
    x = _dt(mesh, (6, 16), [Replicate(), Shard(1)])
    y = shard_hint(x * 2, "model", None)      # 6 % 4 != 0: no constraint
    assert tuple(y.placements) == (Replicate(), Shard(1))


def test_divisible_subset_and_axis_used_once(mesh):
    x = _dt(mesh, (8, 12, 16), [Replicate(), Replicate()])
    # data divides 8; model would divide 16 but is named for dim 1 first,
    # where 12 % 4 == 0, so dim 2 stays whole
    y = shard_hint(x, "data", "model", "model")
    assert tuple(y.placements) == (Shard(0), Shard(1))
    y = shard_hint(x, ("data", "model"), None, None)   # 8 % 8 == 0
    assert tuple(y.placements) == (Shard(0), Shard(0))


def test_pin_batch_reduces_pending_sums(mesh):
    x = _dt(mesh, (8, 16), [Shard(0), Shard(1)])
    assert tuple(pin_batch(x).placements) == (Shard(0), Replicate())
    p = DTensor.from_local(torch.empty(4, 16, device="meta"), mesh,
                           [Shard(0), Partial()], run_check=False)
    assert tuple(pin_batch(p).placements) == (Shard(0), Replicate())
    odd = _dt(mesh, (3, 16), [Replicate(), Replicate()])
    assert tuple(pin_batch(odd).placements) == (Replicate(), Replicate())


def test_moe_sort_form_plain_bit_for_bit():
    """The sort form's hints are the identity off a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _block
    import dataclasses
    cfg = dataclasses.replace(reduce_config(get_config("deepseek-moe-16b")),
                              moe_impl="sort")
    params = init_params(cfg, device="cpu")
    lp = _block(params["blocks"], 0)["layer1"]["mlp"]     # an MoE layer
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, aux = L.apply_moe(lp, cfg, x)
    import repro_torch.models.layers as mod
    saved = mod.shard_hint
    mod.shard_hint = lambda t, *a: t
    try:
        y2, aux2 = L.apply_moe(lp, cfg, x)
    finally:
        mod.shard_hint = saved
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
