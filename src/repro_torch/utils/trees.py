"""Tree helpers over the port's nested dicts (and lists / tuples) of
tensors or arrays."""
from __future__ import annotations

import math
from typing import Any, Iterator

import numpy as np
import torch


def _leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in _leaves(tree))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (respects dtype itemsize)."""
    return sum(math.prod(x.shape) * _itemsize(x.dtype) for x in _leaves(tree))
