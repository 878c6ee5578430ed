"""Continuous-batching serving runtime in PyTorch: the 1x1 facade.

:class:`ServingRuntime` is a :class:`~repro_torch.serving.cluster.ClusterRuntime`
of one prefill worker, one decode arena and one (p0 -> d0) link, with the
single-engine surface (``submit`` / ``step`` / ``run`` / ``summary``,
``.wire``, ``.store``, ``.estimator``) of the JAX package's
``serving/engine.py``.  Both serving scenarios (``RuntimeConfig.mode``):
``"pool"`` (KV-disaggregated prefix caching) and ``"pd"`` (PD separation:
prefill -> compress -> serialized wire -> decompress -> decode on the
critical path).  The one-shot ``DisaggregatedEngine`` is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.controller import ServiceAwareController
from repro_torch.core.profiles import Profile
from repro_torch.serving.cluster import ClusterRuntime
from repro_torch.serving.network import BandwidthTrace
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workers import (  # noqa: F401
    RuntimeConfig,
    ServedRequest,
    Slot,
    compress_kvs,
    decompress_kvs,
    recompress_entry,
)


class ServingRuntime(ClusterRuntime):
    """Iteration-level (continuous-batching) serving — the single-engine
    deployment on ``device`` (CUDA unless the caller passes "cpu")."""

    def __init__(self, controller: Optional[ServiceAwareController] = None,
                 static_profile: Optional[Profile] = None,
                 config: Optional[RuntimeConfig] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 store: Optional[Any] = None,
                 trace: Optional[BandwidthTrace] = None,
                 device="cuda"):
        super().__init__(controller=controller,
                         static_profile=static_profile,
                         config=config, scheduler=scheduler, store=store,
                         trace=trace, n_prefill=1, n_decode=1,
                         device=device)
