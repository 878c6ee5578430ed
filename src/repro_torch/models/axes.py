"""Logical axes of the parameter leaves (MaxText-style), the counterpart
of the JAX package's ``models/axes.py``.

Every parameter leaf names one logical axis (or None) per dimension; the
leaf specs of ``models/transformer.py`` carry them beside shape and init,
and ``distribution/sharding.py`` maps them to mesh axes with divisibility
fallback.  The JAX package tags leaves with ``Pm`` at init; the port has
no abstract init (shape-only work uses ``device="meta"``), so the axes are
a tree of their own, with the parameters' structure.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _map_specs, _param_specs


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's logical axes, with ``param_shapes(cfg)``'s
    structure: a tuple per leaf, stacked leaves led by "layers" (the JAX
    package's ``init_params(cfg, abstract=True)[1]``)."""
    return _map_specs(lambda shape, axes, init, n:
                      (("layers",) if n else ()) + axes, _param_specs(cfg))
