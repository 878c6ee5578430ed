"""The dry-run's multi-pod cells are counted on the flattening of the
three-axis mesh (``repro_torch.launch.dryrun.counting_mesh``: (pod, data,
model) -> (pod × data, model)).  Here, on PyTorch's fake process group of
8 ranks, small cells are counted both ways, on the (2, 2, 2) mesh itself
and on its (4, 2) flattening, op by op:

  - every op the step runs is the same, with the same FLOPs and bytes,
    except the ops of DTensor's redistributions over the batch axes;
  - the memory a device holds is the same, and so are the collective
    bytes along "model";
  - where they differ: on three axes DTensor splits a tensor over
    ("pod", "data") in two chunk-and-copy steps, one a mesh dimension,
    and reduces a pending sum over them in two sequential all-reduces,
    each of the whole operand (DTensor's own warning names this plan
    suboptimal and asks for the dimensions to be flattened); the
    flattening runs one of each, as XLA issues one all-reduce over its
    replica group.

So the flattening counts what a (2, 16, 16) deployment runs, less
DTensor's per-axis plan for the batch axes.  tiny-lm's train, prefill
and decode steps run, and deepseek-moe-16b-reduced's decode step with the
MoE hints (its train step takes minutes to trace on three axes).
"""
import dataclasses
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import SHAPES_BY_NAME, get_config  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_fake_world,
    make_test_mesh,
)

# the ops of DTensor's redistributions (split, copy, reduce, and the
# division of a replicated value into a pending sum)
REDISTRIBUTION = {"aten.chunk.default", "aten.clone.default",
                  "aten.div.Tensor", "_c10d_functional.all_reduce.default",
                  "_c10d_functional._wrap_tensor_autograd.default"}


@pytest.fixture(scope="module")
def mesh3():
    torch.set_num_threads(1)
    init_fake_world(8)
    try:
        yield make_test_mesh(data=2, model=2, pod=2)
    finally:
        dist.destroy_process_group()


def _count(cfg, shape, mesh, monkeypatch, flatten: bool):
    """(per-op [count, FLOPs, bytes], collective bytes by axis, bytes a
    device holds) of the cell counted on ``mesh`` or its flattening."""
    per = defaultdict(lambda: [0, 0.0, 0.0])
    base = op_cost.OpCounter._count

    def count(self, func, *rest):
        f0, b0 = self.cost.flops, self.cost.bytes
        base(self, func, *rest)
        row = per[str(func)]
        row[0] += 1
        row[1] += self.cost.flops - f0
        row[2] += self.cost.bytes - b0

    with monkeypatch.context() as m:
        m.setattr(op_cost.OpCounter, "_count", count)
        if not flatten:
            m.setattr(dryrun, "counting_mesh", lambda mesh: mesh)
        cost, mem = dryrun.run_cell(cfg, shape, mesh)
    return dict(per), dict(cost.coll_by_axis), mem


@pytest.mark.parametrize("arch,shape_name", [
    ("tiny-lm", "train_4k"), ("tiny-lm", "prefill_32k"),
    ("tiny-lm", "decode_32k"), ("deepseek-moe-16b-reduced", "decode_32k")])
def test_three_axis_mesh_counts_as_its_flattening(mesh3, monkeypatch, arch,
                                                  shape_name):
    cfg = get_config(arch)
    shape = dataclasses.replace(SHAPES_BY_NAME[shape_name], seq_len=64,
                                global_batch=8)
    flat, flat_coll, flat_mem = _count(cfg, shape, mesh3, monkeypatch, True)
    three, three_coll, three_mem = _count(cfg, shape, mesh3, monkeypatch,
                                          False)
    assert flat_mem == three_mem
    assert set(flat) == set(three)
    for op in flat:
        if op in REDISTRIBUTION:
            assert three[op][0] >= flat[op][0], op
        else:
            assert three[op] == flat[op], (op, flat[op], three[op])
    assert set(flat_coll) <= {"data", "model"}, flat_coll
    assert flat_coll.get("model", 0) == three_coll.get("model", 0)
    # a pending sum over the batch axes: one all-reduce over pod × data
    # on the flattening, one over each of them on three axes
    batch = flat_coll.get("data", 0)
    assert three_coll.get("pod", 0) == three_coll.get("data", 0) == batch
    if shape.kind == "train":
        assert batch > 0
