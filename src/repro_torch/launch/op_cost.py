"""Per-device FLOPs, bytes and collective bytes of a step, counted from the
ops it dispatches: the counterpart of the JAX package's ``launch/hlo_cost.py``.

PyTorch has no HLO.  ``count_ops`` runs a function under a
``TorchDispatchMode`` and counts every ATen op it dispatches, usually on
meta tensors (shapes only, nothing allocated).  The model's layer stack is
a Python loop, so every iteration dispatches its ops and trip counts come
out right by construction.

Under DTensor the mode declines the DTensor-level op (``NotImplemented``),
so DTensor's own dispatch runs with the mode still active and the mode
counts what one device runs: the local op on its shard, and the
``_c10d_functional`` collectives that redistribution issues.  Counts are
therefore per device.  The ops DTensor runs on fake tensors to propagate
global shapes are skipped.  An op dispatched under ``utils/scan.py``'s
``trip_scale(n)`` (a recurrence's one counted step) counts n times.

  FLOPs   matmuls, convolutions and attention by ``torch.utils.flop_counter``'s
          formulas; every other op one FLOP per output element (pointwise)
          or per input element (reductions and softmax-like ops); data
          movement none.
  bytes   each op's operand and result bytes.  Views cost 0.  An in-place
          update into a region (``copy_`` into a view, ``index_put_``,
          ``index_copy_``, ``slice_scatter``, the decode cache write) costs
          its update region, read and written, not the whole buffer.  The
          count is unfused: an intermediate that a fused kernel would keep
          in registers is charged a write and a read, so ``bytes`` is an
          upper bound on HBM traffic.
  coll    the operand bytes of every collective, by kind and by the mesh
          axis of its group.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.utils.scan import current_scale

aten = torch.ops.aten

COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast", "send", "recv")

# Ops that alias their input without being schema views.
_FREE = {aten._unsafe_view.default, aten._reshape_alias.default,
         aten.lift_fresh.default}
# Allocations that write nothing.
_EMPTY = {aten.empty.memory_format, aten.empty_strided.default,
          aten.new_empty.default, aten.new_empty_strided.default,
          aten.empty_like.default}
# Functional and in-place scatters: charged their update region.
_SCATTER = {
    aten.index_put.default, aten.index_put_.default,
    aten._index_put_impl_.default, aten.index_copy.default,
    aten.index_copy_.default, aten.index_add.default, aten.index_add_.default,
    aten.scatter.src, aten.scatter_.src, aten.scatter_add.default,
    aten.scatter_add_.default, aten.slice_scatter.default,
    aten.select_scatter.default,
}
# One pass of exp/max/sum/div over the input.
_SOFTMAX_LIKE = {aten._softmax.default, aten._log_softmax.default,
                 aten.logsumexp.default, aten._softmax_backward_data.default,
                 aten._log_softmax_backward_data.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> Iterable[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclass
class OpCost:
    """What one device runs, summed over a step's ops."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    coll_by_axis: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    n_ops: int = 0


def _is_fake(tensors) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched under it (see the module docstring).
    ``axis_of_group`` maps a process group's name to the mesh axis it
    runs along (``mesh_group_axes``)."""

    def __init__(self, axis_of_group: Optional[Dict[str, str]] = None):
        super().__init__()
        self.cost = OpCost()
        self.axis_of_group = axis_of_group or {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs the local ops under us
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not _is_fake(ins + outs):
            self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        k = current_scale()          # a scanned step's trip count
        if k == 0:
            return
        c = self.cost
        c.n_ops += k
        ns = getattr(func, "namespace", "")
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            if name in COLLECTIVES:
                nb = k * (_nbytes(ins[0]) if ins else 0)
                group = args[-1] if isinstance(args[-1], str) else ""
                c.coll_bytes += nb
                c.coll_breakdown[name] += nb
                c.coll_by_axis[self.axis_of_group.get(group, group)] += nb
            return
        if func.is_view or func in _FREE or func in _EMPTY:
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += k * flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
        elif torch.Tag.pointwise in func.tags:
            c.flops += k * sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags or func in _SOFTMAX_LIKE:
            c.flops += k * (ins[0].numel() if ins else 0)
        c.bytes += k * _op_bytes(func, args, kwargs, ins, outs)


def _op_bytes(func, args, kwargs, ins, outs) -> int:
    """An op's bytes (the module docstring's rule)."""
    if func in _SCATTER:
        # the update region: indices and values read, values (the last
        # tensor argument) written
        rest = _tensors((args[1:], kwargs))
        return sum(_nbytes(t) for t in rest) + _nbytes(rest[-1])
    if func is aten.copy_.default:   # the region written, the source read
        return _nbytes(args[0]) + _nbytes(args[1])
    total, seen = 0, set()
    for t in ins + outs:     # an in-place op's output is its input
        key = id(t)
        if key not in seen or func._schema.is_mutable:
            total += _nbytes(t)
        seen.add(key)
    return total


def mesh_group_axes(mesh) -> Dict[str, str]:
    """{process group name: mesh axis name} for each mesh dimension."""
    if mesh is None or mesh.ndim == 0:
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def count_ops(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``; returns (its
    result, the ``OpCost``)."""
    counter = OpCounter(mesh_group_axes(mesh))
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.cost
