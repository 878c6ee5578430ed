"""Seeded weights in the port's serving layout, made on the device in one
call a leaf (block leaves stacked), in the type they are served in.

Shapes come from the port's parameter tree; values are the benchmark's
own, each leaf drawn normal(0, s) with the standard deviation ``s`` the
configuration's module gives it (``init_scale``; 0: zeros)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def make_params(cfg, seed: int, device,
                init_scale: Callable[[Tuple[str, ...], Tuple[int, ...]],
                                     float],
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """The tree ``repro_torch.models.transformer.param_shapes(cfg)`` names,
    drawn from ``seed`` by a generator on ``device``."""
    from repro_torch.models.transformer import param_shapes

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in sorted(tree.items())}
        shape = tuple(tree)
        s = init_scale(path, shape)
        if s == 0.0:
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return out.mul_(s)

    return build(param_shapes(cfg), ())

