"""Logical-axis -> mesh sharding resolution with divisibility fallback, the
counterpart of the JAX package's ``distribution/sharding.py``.

Rules follow MaxText conventions: batch over (pod, data); heads / mlp /
vocab / experts over model (tensor / expert parallelism).  Every mapping is
validated for divisibility — when an axis doesn't divide (e.g. 8 KV heads on
a 16-way model axis, or minicpm's 36 heads), the rule falls back to the next
candidate or to replication, so every (arch × shape × mesh) cell places;
the roofline pass then shows where fallback cost lands.

A spec is a tuple with one entry per tensor dimension: None (replicated),
a mesh-axis name, or a tuple of names (the dimension split over several
mesh axes, major first) — ``PartitionSpec``'s counterpart.  Trees are the
port's nested dicts.  ``to_placements`` turns a spec into DTensor
placements on a ``DeviceMesh``; the rule functions read only the mesh's
axis names and sizes (``mesh_dim_names``, ``shape``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Any, ...]

# Ordered candidates per logical axis name.
LOGICAL_RULES: Dict[str, List[Tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "layers": [],
    "embed": [],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "mlp": [("model",)],
    "expert_mlp": [],
    "experts": [("model",)],
    "vocab": [("model",)],
    "state": [],
    "seq": [],
    "kv_seq": [("model",)],  # decode fallback: sequence-sharded KV
}


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_axes(axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh) -> Spec:
    """Map logical axes to a spec, enforcing divisibility and never using
    a mesh axis twice."""
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned = None
        for cand in LOGICAL_RULES.get(name or "", []):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(assigned)
    return tuple(out)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_pspecs(axes_tree, shapes_tree, mesh):
    """Spec tree from (axes tree, tree of tensors or shapes)."""
    return _map(lambda axes, val: resolve_axes(
        axes, tuple(getattr(val, "shape", val)), mesh),
        axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Input/cache specs (the step's boundary placements).
# ---------------------------------------------------------------------------
def batch_axes_for(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    sizes = mesh_axis_sizes(mesh)
    for cand in LOGICAL_RULES["batch"]:
        cand = tuple(a for a in cand if a in sizes)
        if not cand:
            continue
        prod = math.prod(sizes[a] for a in cand)
        if prod > 1 and batch % prod == 0:
            return cand
    return None


def _bspec(mesh, batch: int):
    b = batch_axes_for(mesh, batch)
    return b if b is None or len(b) > 1 else b[0]


def kv_cache_pspec(mesh, shape: Tuple[int, int, int, int]) -> Spec:
    """Cache (B, S, Hkv, D): prefer head sharding, fall back to sequence
    sharding (flash-decoding style partial attention)."""
    b, s, h, _ = shape
    model = mesh_axis_sizes(mesh).get("model", 1)
    bspec = _bspec(mesh, b)
    if model > 1 and h % model == 0:
        return (bspec, None, "model", None)
    if model > 1 and s % model == 0:
        return (bspec, "model", None, None)
    return (bspec, None, None, None)


def mamba_state_pspec(mesh, shape: Tuple[int, ...]) -> Spec:
    """SSM state (B, d_inner, n) / conv state (B, d_inner, k-1)."""
    b, di = shape[0], shape[1]
    model = mesh_axis_sizes(mesh).get("model", 1)
    rest = ["model" if (model > 1 and di % model == 0) else None]
    rest += [None] * (len(shape) - 2)
    return (_bspec(mesh, b), *rest)


def cache_pspecs(cache_tree, mesh):
    """Spec tree for a cache tree (leaves are 4D k/v buffers, stacked 5D
    block buffers, or 3D mamba states)."""
    def _one(path, x):
        shape = tuple(x.shape)
        stacked = "blocks" in path
        core = shape[1:] if stacked else shape
        if len(core) == 4:  # attention cache
            spec = kv_cache_pspec(mesh, core)
        elif len(core) in (2, 3):  # mamba ssm/conv state
            spec = mamba_state_pspec(mesh, core)
        else:
            spec = (None,) * len(core)
        return (None, *spec) if stacked else spec

    return _map_path(_one, cache_tree)


def inputs_pspecs(inputs_tree, mesh):
    """Specs for a step-input tree (tokens/mask/frames/patches/pos/caches);
    a leaf that is not a tensor (``max_len``) gets None."""
    def _one(path, x):
        if not hasattr(x, "shape"):
            return None  # static python value (e.g. max_len)
        shape = tuple(x.shape)
        if "caches" in path:
            return None  # handled by cache_pspecs
        if shape == ():
            return ()
        leaf = path[-1] if path else ""
        if leaf == "positions":  # (3, B, S)
            return (None, _bspec(mesh, shape[1]), *([None] * (len(shape) - 2)))
        return (_bspec(mesh, shape[0]), *([None] * (len(shape) - 1)))

    specs = _map_path(_one, inputs_tree)
    # Patch cache subtree (if present) with cache-aware specs.
    if isinstance(inputs_tree, dict) and "caches" in inputs_tree:
        specs["caches"] = cache_pspecs(inputs_tree["caches"], mesh)
    return specs


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """One placement per mesh dimension: ``Shard(d)`` where the spec puts
    tensor dimension d on that mesh axis, else ``Replicate()``.  A
    dimension split over several mesh axes (("pod", "data")) shards on each
    of them; DTensor splits it over the mesh dimensions in mesh order, so
    the names must come in that order, as they do in JAX's major-to-minor
    tiling (the rank at mesh coordinates (p, d) holds chunk p·D + d)."""
    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def to_named(specs_tree, mesh):
    """(mesh, placements) leaves from a spec tree; a None leaf (a static
    input) stays None."""
    if isinstance(specs_tree, dict):
        return {k: to_named(v, mesh) for k, v in specs_tree.items()}
    if specs_tree is None:
        return None
    return (mesh, to_placements(specs_tree, mesh))


def tree_shardings(axes_tree, shapes_tree, mesh):
    """(mesh, placements) leaves for a parameter tree (``CheckpointManager
    .restore``'s ``shardings``)."""
    return to_named(tree_pspecs(axes_tree, shapes_tree, mesh), mesh)
