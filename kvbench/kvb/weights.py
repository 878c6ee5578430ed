"""Seeded weights in the port's serving layout, made on the device in one
call a leaf (block leaves stacked), in the type they are served in.

Shapes come from the port's parameter tree; values are the benchmark's
own: normal(0, 1/sqrt(fan_in)) for products, normal(0, 1) for the token
table, and zeros for the RMSNorm scales, which the port's
``(1 + scale)`` form turns into the published unit gain."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

QKV = ("wq", "wk", "wv")


def _scale(path: Tuple[str, ...], shape: Tuple[int, ...]) -> float:
    name = path[-1]
    if name == "tok":
        return 1.0
    if name in ("scale", "q_norm", "k_norm"):
        return 0.0
    core = shape[1:] if path[0] == "blocks" else shape
    if "mlp" in path and name in ("wi_gate", "wi_up", "wo") \
            and len(core) == 3:
        core = core[1:]                     # a routed expert's matrix
    fan_in = core[0] if name in QKV else math.prod(core[:-1])
    return 1.0 / math.sqrt(fan_in)


def make_params(cfg, seed: int, device, dtype=torch.bfloat16
                ) -> Dict[str, Any]:
    """The tree ``repro_torch.models.transformer.param_shapes(cfg)`` names,
    drawn from ``seed`` by a generator on ``device``."""
    from repro_torch.models.transformer import param_shapes

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in sorted(tree.items())}
        shape = tuple(tree)
        s = _scale(path, shape)
        if s == 0.0:
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return out.mul_(s)

    return build(param_shapes(cfg), ())


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree
