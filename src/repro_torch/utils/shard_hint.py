"""Mesh-aware sharding constraints usable from model code, the counterpart
of the JAX package's ``utils/shard_hint.py``.

``shard_hint(x, *axes)`` redistributes a DTensor to the named mesh axes
where each dim is divisible by its axes, by the JAX package's rule (a mesh
axis used once, a dim that does not divide left unsharded, and no change at
all when nothing divides).  A plain tensor has no mesh, so it comes back
unchanged: model code stays the same single-device code on the CPU and
on one card.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

AxisName = Union[None, str, Tuple[str, ...]]


def shard_hint(x: torch.Tensor, *axes: AxisName) -> torch.Tensor:
    """Redistribute ``x`` to spec ``axes`` if valid on its mesh; identity
    otherwise.  len(axes) must equal x.ndim."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    placements = [Replicate()] * len(sizes)
    names = list(sizes)
    used = set()
    for d, (dim, name) in enumerate(zip(x.shape, axes)):
        cand = (name,) if isinstance(name, str) else (name or ())
        cand = tuple(a for a in cand if a in sizes and a not in used)
        if not cand:
            continue
        prod = math.prod(sizes[a] for a in cand)
        if prod > 1 and dim % prod == 0:
            # DTensor nests the mesh axes in mesh order, as
            # ``sharding.to_placements`` requires of a spec
            for a in cand:
                placements[names.index(a)] = Shard(d)
            used.update(cand)
    placements = tuple(placements)
    if not used or tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
