"""Domain-specific analysis of the PyTorch package.

Six repo-specific static checkers (DESIGN.md §13/§14), the port's copies
of the JAX package's, run over the source tree and fail CI on any
unsuppressed finding::

    python -m repro_torch.analysis [--format=json] [--baseline=prev.json] [paths...]

(default path: ``src/repro_torch``).  The JAX package's rules scan
``src/repro_torch`` too, but only four of them see it: ``clock``,
``units``, ``ownership`` and ``determinism`` pick files by directory
and check names, whereas the JAX ``host-sync`` rule knows only
``jnp``/``jax`` values and ``kernel-contract`` only the Pallas half of
the kernel contract.

Rules
-----
* ``host-sync``       — device->host syncs reachable from serving hot
                         loops, with a taint model of PyTorch values and
                         PyTorch's own syncs (copies without
                         ``non_blocking``, data-dependent shapes)
* ``clock-accounting``— unbilled/double-billed time components, clock
                         regressions in the virtual-clock runtime
* ``units``           — bytes / seconds / bytes-per-second / token mixing
* ``kernel-contract`` — kernel wrapper <-> ref.py oracle <-> parity test,
                         and the CUDA half: csrc/*.cu <-> build.SIGNATURES
                         <-> a ``gpu``-marked test; no ``interpret=True``
                         outside kernels/
* ``ownership``       — worker-local vs cluster-shared object discipline
* ``determinism``     — replay safety of the simulator + workloads,
                         PyTorch's global RNG included

:mod:`.sanitize` is the port's copy of the JAX package's KV sanitizer: it
patches this package's ``PageTable``, ``KVTier``, ``PrefixKVStore``,
``DecodeWorker`` and ``ClusterRuntime``.

Intentional patterns are documented (not silenced) inline with
``# lint: <token>(reason)`` — see repro_torch.analysis.core.
"""
from __future__ import annotations

from repro_torch.analysis import (
    clock,
    determinism,
    host_sync,
    kernel_contract,
    ownership,
    units,
)
from repro_torch.analysis.cli import main, run_paths
from repro_torch.analysis.core import Finding, Project, Rule, load_project

ALL_RULES = [
    Rule(host_sync.RULE_ID, host_sync.TOKEN,
         "device->host sync in a serving hot path", host_sync.check),
    Rule(clock.RULE_ID, clock.TOKEN,
         "virtual-clock billing invariant violation", clock.check),
    Rule(units.RULE_ID, units.TOKEN,
         "arithmetic mixing incompatible dimensions", units.check),
    Rule(kernel_contract.RULE_ID, kernel_contract.TOKEN,
         "kernel/oracle/parity-test drift", kernel_contract.check),
    Rule(ownership.RULE_ID, ownership.TOKEN,
         "cluster-shared object mutated/moved outside its owner",
         ownership.check),
    Rule(determinism.RULE_ID, determinism.TOKEN,
         "replay-unsafe construct in the simulator/workload path",
         determinism.check),
]

__all__ = ["ALL_RULES", "Finding", "Project", "Rule", "load_project",
           "main", "run_paths"]
