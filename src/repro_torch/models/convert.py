"""The weight bridge from the JAX package's parameters to the port's.

The JAX package keeps parameters as a nested dict of arrays; the port
keeps the same tree of torch tensors.  Leaves pair up by path, and the
JAX tree's flatten order is its keys sorted at every level, which is also
the order of the cached ``tiny_lm_s{steps}.npz`` (``arr_i``).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import param_shapes

Path = Tuple[str, ...]


def flatten(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in the JAX tree's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _template(cfg: ModelConfig) -> List[Tuple[Path, Tuple[int, ...]]]:
    """(path, shape) of every leaf the port expects, in flatten order
    (empty subtrees such as a plan without prefix layers carry none)."""
    return [(p, s) for p, s in flatten(param_shapes(cfg))
            if isinstance(s, tuple)]


def from_jax_arrays(tree, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree, as nested dicts of numpy arrays,
    turned leaf for leaf by path into the port's parameters on ``device``
    (dtypes kept)."""
    src = dict(flatten(tree))
    want = _template(cfg)
    if set(src) != {p for p, _ in want}:
        raise ValueError(f"parameter paths differ: "
                         f"{sorted(set(src) ^ {p for p, _ in want})}")
    out = []
    for path, shape in want:
        arr = np.asarray(src[path])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        out.append((path, _to_tensor(arr, device)))
    return unflatten(out)


def from_flat_arrays(arrays, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """Parameters from leaves listed in flatten order (``arr_0``, ...)."""
    want = _template(cfg)
    arrays = list(arrays)
    if len(arrays) != len(want):
        raise ValueError(f"{len(arrays)} arrays for {len(want)} leaves")
    return from_jax_arrays(unflatten(zip((p for p, _ in want), arrays)),
                           cfg, device)


def params_digest(params) -> str:
    """Digest of the weights as f32 bytes in flatten order; equals the JAX
    package's test digest for the same weights."""
    h = hashlib.sha256()
    for _, leaf in flatten(params):
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
