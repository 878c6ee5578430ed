"""Real-execution disaggregated serving in PyTorch.

Two granularities, as in the JAX package's ``serving/engine.py``:

* :class:`DisaggregatedEngine` — the one-shot PD path: ``serve`` runs a
  single synchronous batch end to end (prefill -> compress -> wire ->
  decompress -> decode) on the device and reports a :class:`ServedBatch`
  breakdown.  It is a thin wrapper over the stage helpers
  (:func:`~repro_torch.serving.workers.compress_kvs`,
  :func:`~repro_torch.serving.workers.decompress_kvs`,
  :class:`~repro_torch.serving.network.KVWire`) that the continuous
  runtime pipelines per request.  Each timed stage waits for the device
  before it reads the clock.

* :class:`ServingRuntime` — a
  :class:`~repro_torch.serving.cluster.ClusterRuntime` of one prefill
  worker, one decode arena and one (p0 -> d0) link, with the
  single-engine surface (``submit`` / ``step`` / ``run`` / ``summary``,
  ``.wire``, ``.store``, ``.estimator``).  Both serving scenarios
  (``RuntimeConfig.mode``): ``"pool"`` (KV-disaggregated prefix caching)
  and ``"pd"`` (PD separation: prefill -> compress -> serialized wire ->
  decompress -> decode on the critical path).  Speculative decoding
  (``RuntimeConfig.spec_k``, ``spec_kind``, ``spec_adaptive``) runs in
  either.

Both run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.controller import ServiceAwareController, ServiceContext
from repro_torch.core.pipeline import _clock
from repro_torch.core.profiles import Profile
from repro_torch.core.quality import (
    _greedy_decode,
    _jitted_steps,
    _param_device,
    _prompts_for,
    extract_kv,
    get_reference_model,
    inject_kv,
)
from repro_torch.core.strategy import is_identity
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.cluster import ClusterRuntime
from repro_torch.serving.network import BandwidthTrace, GoodputEstimator, KVWire
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workers import (  # noqa: F401
    RuntimeConfig,
    ServedRequest,
    Slot,
    _select_profile,
    compress_kvs,
    decompress_kvs,
    recompress_entry,
)


@dataclass
class ServedBatch:
    workload: str
    text: List[str]
    tokens: np.ndarray
    profile: str
    kv_bytes: int
    wire_bytes: int
    t_prefill: float
    t_compress: float
    t_comm: float
    t_decompress: float
    t_decode: float
    agreement: float  # vs uncompressed decode

    @property
    def jct(self) -> float:
        return (self.t_prefill + self.t_compress + self.t_comm
                + self.t_decompress + self.t_decode)


class DisaggregatedEngine:
    """One-shot PD-separated serving of a model on ``device``: ``ref``
    ``(cfg, params)`` with its parameters there, or the cached
    ``tiny-lm`` reference model when None."""

    def __init__(self, controller: Optional[ServiceAwareController] = None,
                 static_profile: Optional[Profile] = None,
                 seq: int = 192, decode_tokens: int = 20, batch: int = 4,
                 ref=None, device="cuda"):
        self.device = torch.device(device)
        self.cfg, self.params = ref if ref is not None \
            else get_reference_model(device=self.device)
        got = _param_device(self.params)
        if got.type != self.device.type:
            raise ValueError(f"DisaggregatedEngine: parameters on {got}, "
                             f"device={self.device}")
        self.controller = controller
        self.static_profile = static_profile
        self.seq = seq
        self.decode_tokens = decode_tokens
        self.batch = batch
        self.estimator = GoodputEstimator()
        self._pre, self._dec, _ = _jitted_steps(
            self.cfg.name, seq, batch, seq + decode_tokens + 2)
        self.tok = ByteTokenizer()

    # ------------------------------------------------------------------
    def serve(self, workload: str, trace: BandwidthTrace, now: float = 0.0,
              t_slo: float = 0.0, q_min: float = 0.97, seed: int = 0
              ) -> ServedBatch:
        dev = self.device
        tokens, _ = _prompts_for(workload, self.batch, self.seq, seed)
        # Build the wire up front: attaching the (unseeded) estimator
        # seeds its initial from the link's configured trace, so the
        # controller decision below starts from THIS wire's bandwidth,
        # not a universal 10 Gb/s guess.
        wire = KVWire(trace, self.estimator)

        # ---- prefill worker ----
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                           device=dev)}
        t0 = _clock([dev])
        logits, caches = self._pre(self.params, batch)
        # lint: sync-ok(one-shot engine times real prefill wall-clock here)
        t_prefill = _clock([dev]) - t0
        first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            torch.int32)

        # reference decode for agreement scoring (it writes positions
        # >= seq only, which the served decode rewrites before reading)
        ref_toks = _greedy_decode(self._dec, self.params, caches, first,
                                  self.seq, self.decode_tokens)

        # ---- controller decision ----
        kvs = [extract_kv(self.cfg, caches, b, upto=self.seq)
               for b in range(self.batch)]
        v_bytes = sum(kv.nbytes_wire() for kv in kvs)
        ctx = ServiceContext(workload=workload,
                             bandwidth=self.estimator.estimate,
                             t_slo=t_slo, q_min=q_min, t_model=t_prefill,
                             kv_bytes=v_bytes, slo_metric="jct")
        profile, decision = _select_profile(self.controller,
                                            self.static_profile, ctx)

        # ---- compress -> wire -> decompress (shared PD stages) ----
        comps, wire_bytes, t_compress = compress_kvs(profile.strategy, kvs)
        t_comm = wire.send(now + t_prefill + t_compress, wire_bytes).t_comm
        restored, t_decompress = decompress_kvs(comps, device=dev)

        # ---- decode worker ----
        if not is_identity(profile.strategy):
            for b in range(self.batch):
                inject_kv(self.cfg, caches, b, restored[b])
        t0 = _clock([dev])
        test_toks = _greedy_decode(self._dec, self.params, caches, first,
                                   self.seq, self.decode_tokens)
        t_decode = _clock([dev]) - t0

        agreement = float((ref_toks == test_toks).mean())
        # One-shot PD: compress/comm/decompress ARE the critical path.
        observed = t_compress + t_comm + t_decompress + ctx.t_model
        if self.controller is not None and decision is not None:
            self.controller.observe(ctx, decision, observed)

        texts = [self.tok.decode(row[1:]) for row in test_toks]
        return ServedBatch(
            workload=workload, text=texts, tokens=test_toks,
            profile=profile.strategy.short_name(), kv_bytes=int(v_bytes),
            wire_bytes=int(wire_bytes), t_prefill=t_prefill,
            t_compress=t_compress, t_comm=t_comm,
            t_decompress=t_decompress, t_decode=t_decode,
            agreement=agreement)


# ===========================================================================
# Continuous-batching runtime: the 1x1 cluster facade
# ===========================================================================
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
