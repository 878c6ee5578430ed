"""Multi-worker disaggregated cluster runtime (DESIGN.md §10).

:class:`ClusterRuntime` composes N :class:`~repro.serving.workers.PrefillWorker`
x M :class:`~repro.serving.workers.DecodeWorker` under ONE shared
:class:`~repro.serving.scheduler.ContinuousScheduler` (admission control +
SLO-class priority queue) and a
:class:`~repro.serving.topology.NetworkTopology` of per-(src, dst)
serialized KV links.  Each ``step()`` is one iteration of the whole
cluster:

  1. **Admission + routing** — waiting requests are popped in priority
     order while an eligible route exists (prefill worker under its
     per-iteration admission cap, decode worker with a free arena slot);
     the :class:`Router` places each request on a (prefill -> decode)
     route.  Requests on the same prefill worker serialize within the
     iteration; distinct workers — and distinct links — overlap.
  2. **Decode streams** — every decode worker advances all of its
     previously-running slots one token with a single masked jitted arena
     decode.
  3. **Clocking** — the iteration costs ``max`` over every started
     request's start-of-life path and every decode worker's stream; the
     difference is charged per slot as ``stall`` so per-request breakdowns
     still sum exactly to JCT.

Routing policies:

* :class:`RoundRobinRouter` — the placement baseline: cycle the (src,
  dst) pairs in mesh order, skipping ineligible routes.
* :class:`LoadAwareRouter` — predicted-latency argmin over eligible
  routes, combining the controller's latency model (Eq. 1, evaluated at
  the route's own per-link goodput estimate), live queue depths (in-step
  prefill backlog, link reservations, decode occupancy) and decode-side
  prefix affinity (a worker already holding the request's prefix serves
  it without prefill or cold transfer).  FlowKV-style load awareness and
  compression become one placement decision.

A 1x1 ``ClusterRuntime`` IS the single-engine runtime: the
:class:`~repro_torch.serving.engine.ServingRuntime` facade subclasses it.

This is the PyTorch counterpart of the JAX package's ``serving/cluster.py``:
the same scheduling, routing and virtual-clock accounting over the
PyTorch workers, on ``device`` (CUDA unless the caller asks for the CPU).
The model loads lazily (:class:`~repro_torch.serving.workers.ModelHandle`),
so a caller that sets ``model_cfg``/``params`` never needs the cached
reference weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.controller import ServiceAwareController, ServiceContext, TierFetch
from repro_torch.controller.latency_model import (
    baseline_latency,
    predicted_latency,
)
from repro_torch.core.profiles import Profile
from repro_torch.core.quality import _prompts_for
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.kvstore import (
    KVTier,
    TierHit,
    TierSpec,
    TieredKVStore,
    default_tier_specs,
)
from repro_torch.serving.metrics import latency_summary, route_counts
from repro_torch.serving.network import (
    BandwidthTrace,
    GoodputEstimator,
    KVWire,
    seed_bandwidth,
)
from repro_torch.serving.request import Request, kv_bytes_for
from repro_torch.serving.scheduler import ContinuousScheduler, SchedulerConfig
from repro_torch.serving.topology import NetworkTopology, route_name
from repro_torch.serving.workers import (
    DecodeWorker,
    ModelHandle,
    PrefillWorker,
    RuntimeConfig,
    ServedRequest,
    Slot,
    codec_cost,
    decompress_kvs,
    recompress_entry,
)


@dataclass
class Route:
    """One (prefill worker -> decode worker) placement option."""

    index: int                    # position in the mesh-order route list
    prefill: PrefillWorker
    decode: DecodeWorker
    link: KVWire                  # the pair's serialized transfer wire
    estimator: GoodputEstimator   # the link's goodput view (controller B)
    name: str                     # "p0->d1"


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------
class Router:
    """Placement policy: pick one of the iteration's eligible routes."""

    name = "base"

    def choose(self, req: Request, eligible: List[Route], now: float,
               cluster: "ClusterRuntime") -> Route:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """The baseline: cycle the mesh-order route list, skipping routes that
    are ineligible this iteration (admission cap hit / no free slot)."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, req, eligible, now, cluster):
        n = max(len(cluster.routes), 1)
        choice = min(eligible, key=lambda r: (r.index - self._next) % n)
        self._next = (choice.index + 1) % n
        return choice


class LoadAwareRouter(Router):
    """Predicted-latency argmin over the eligible routes (ties broken by
    mesh order, so placement stays deterministic)."""

    name = "load_aware"

    def choose(self, req, eligible, now, cluster):
        return min(eligible,
                   key=lambda r: (cluster.route_cost(req, r, now), r.index))


ROUTERS = {"round_robin": RoundRobinRouter, "load_aware": LoadAwareRouter}


# ---------------------------------------------------------------------------
# The cluster runtime
# ---------------------------------------------------------------------------
class ClusterRuntime:
    """Iteration-level serving of the tiny reference model across N
    prefill x M decode workers joined by per-pair serialized KV links."""

    def __init__(self, controller: Optional[ServiceAwareController] = None,
                 static_profile: Optional[Profile] = None,
                 config: Optional[RuntimeConfig] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 store: Optional[Any] = None,
                 trace: Optional[BandwidthTrace] = None,
                 topology: Optional[NetworkTopology] = None,
                 n_prefill: Optional[int] = None,
                 n_decode: Optional[int] = None,
                 router: Union[str, Router] = "load_aware",
                 slots_per_worker: Optional[int] = None,
                 device="cuda"):
        self.cfg = config or RuntimeConfig()
        self.controller = controller
        self.static_profile = static_profile
        self.scheduler = ContinuousScheduler(scheduler or SchedulerConfig(),
                                             manage_slots=False)
        self.trace = trace or BandwidthTrace.constant(1e9)
        if topology is None:
            topology = NetworkTopology(n_prefill or 1, n_decode or 1,
                                       default_trace=self.trace)
        elif ((n_prefill is not None and n_prefill != topology.n_prefill)
              or (n_decode is not None and n_decode != topology.n_decode)):
            # Same contract as the Simulator: a topology's dimensions ARE
            # the cluster's — a conflicting explicit worker count is a
            # configuration error, not something to silently override.
            raise ValueError(
                f"topology is {topology.n_prefill}x{topology.n_decode} "
                f"but n_prefill={n_prefill}, n_decode={n_decode} were "
                f"requested")
        self.topology = topology
        self.n_prefill = self.topology.n_prefill
        self.n_decode = self.topology.n_decode
        self.router: Router = (ROUTERS[router]() if isinstance(router, str)
                               else router)
        self._model = ModelHandle(device=device)
        # Cluster-level estimator: the shared remote pool's goodput view
        # (pool mode feeds it through the store's observe_goodput tier).
        # PD contexts use each route's PER-LINK estimator instead; the
        # cluster-level one then aliases the primary link's so the 1x1
        # facade exposes the estimator its wire actually feeds.
        self.estimator = GoodputEstimator(initial=seed_bandwidth(self.trace))
        if self.cfg.mode == "pd":
            self.estimator = self.topology.estimator(0, 0)

        # ---- workers ----
        n_slots = (slots_per_worker if slots_per_worker is not None
                   else self.scheduler.cfg.max_slots)
        self.prefill_workers = [
            PrefillWorker(i, self._model, self.cfg, controller,
                          static_profile)
            for i in range(self.n_prefill)]
        self.decode_workers = [
            DecodeWorker(j, self._model, self.cfg, n_slots,
                         self._build_store(store, j))
            for j in range(self.n_decode)]
        if self.n_decode == 1 and n_slots == self.scheduler.cfg.max_slots:
            # Legacy introspection parity: with a single decode worker the
            # scheduler's free-slot list IS the worker's (same object), so
            # existing tooling that inspects scheduler._free_slots keeps
            # seeing the live pool.
            self.scheduler._free_slots = self.decode_workers[0].free_slots

        # ---- mesh-order route table ----
        self.routes: List[Route] = []
        for idx, (i, j) in enumerate(self.topology.pairs()):
            self.routes.append(Route(
                index=idx, prefill=self.prefill_workers[i],
                decode=self.decode_workers[j],
                link=self.topology.link(i, j),
                estimator=self.topology.estimator(i, j),
                name=route_name(i, j)))

        self.tok = ByteTokenizer()
        self.clock = 0.0
        self.steps = 0
        self.completed: List[ServedRequest] = []
        self.step_log: List[Dict[str, float]] = []
        self._prompts: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._step_busy: List[float] = [0.0] * self.n_prefill

    # ------------------------------------------------------------------
    # Store construction (per decode worker)
    # ------------------------------------------------------------------
    def _ingress(self, j: int) -> Tuple[int, int]:
        """Decode worker ``j``'s primary ingress link (its PD pool tier
        sits across this wire): the same-index prefill worker, wrapped."""
        return (j % self.n_prefill, j)

    def _build_store(self, store: Optional[Any], j: int) -> Any:
        cfg = self.cfg
        if store is not None:
            if self.n_decode != 1:
                raise ValueError("an explicit store requires a single "
                                 "decode worker (per-worker hierarchies "
                                 "are built from config.tiers)")
            if isinstance(store, TieredKVStore):
                if store.estimator is None:
                    store.estimator = self.estimator
                if store.recompress is None:
                    store.recompress = recompress_entry
                return store
            st = TieredKVStore.wrap_flat(
                store, self.trace,
                fetch_overhead=cfg.pool_fetch_overhead,
                estimator=self.estimator)
            st.recompress = recompress_entry
            return st

        if cfg.tiers is not None:
            specs = list(cfg.tiers)
        elif cfg.mode == "pd":
            src, dst = self._ingress(j)
            specs = [TierSpec(
                "remote", cfg.store_capacity,
                bandwidth=self.topology.trace(src, dst),
                fetch_overhead=cfg.pool_fetch_overhead,
                observe_goodput=True)]
        else:
            specs = default_tier_specs(
                cfg.store_capacity, self.trace,
                remote_overhead=cfg.pool_fetch_overhead,
                hot_bytes=cfg.hot_tier_bytes,
                dram_bytes=cfg.dram_tier_bytes)
            # HBM/DRAM are worker-local; the remote pool tier is ONE
            # cluster-wide disaggregated store (shared KVTier: shared
            # capacity, entries, and serialized link).
            if self.n_decode > 1:
                if not hasattr(self, "_shared_remote"):
                    self._shared_remote = KVTier(specs[-1], cfg.store_block)
                    # promotion out of the shared pool COPIES (the entry
                    # must stay visible to every other worker's hierarchy)
                    self._shared_remote.shared = True
                specs = list(specs[:-1]) + [self._shared_remote]
        st = TieredKVStore(specs, block=cfg.store_block,
                           estimator=self.estimator,
                           recompress=recompress_entry)
        if cfg.mode == "pd" and not isinstance(specs[-1], KVTier):
            # PD transfers and pool fetches/writes share ONE physical
            # link — the pool sits across the same wire the compressed
            # KV crosses into this worker.  This applies to explicit
            # cfg.tiers TierSpec lists too (same rule as the old
            # single-engine runtime); only a pre-built KVTier passed in
            # keeps its own wire (it may be shared across workers).
            st.tiers[-1].wire = self.topology.link(*self._ingress(j))
        return st

    # ------------------------------------------------------------------
    # Legacy 1x1 surface (the ServingRuntime facade, tests, benchmarks)
    # ------------------------------------------------------------------
    @property
    def model_cfg(self):
        return self._model.cfg

    @model_cfg.setter
    def model_cfg(self, value):
        # lint: own-ok(facade model swap is cluster-wide BY DESIGN - the shared handle is how it reaches every worker)
        self._model.cfg = value

    @property
    def params(self):
        return self._model.params

    @params.setter
    def params(self, value):
        # lint: own-ok(facade param swap is cluster-wide BY DESIGN - tests pin the reference model through it)
        self._model.params = value

    @property
    def store(self):
        """The decode-side store (single-decode-worker deployments)."""
        if self.n_decode == 1:
            return self.decode_workers[0].store
        raise AttributeError("a multi-worker cluster has per-worker "
                             "stores; use .decode_workers[j].store")

    @property
    def wire(self) -> KVWire:
        """The primary (p0 -> d0) transfer link — THE wire of a 1x1
        deployment."""
        return self.topology.link(0, 0)

    @property
    def n_slots(self) -> int:
        """Arena slots per decode worker."""
        return self.decode_workers[0].n_slots

    @property
    def _slots(self) -> Dict[int, Slot]:
        """Merged in-flight slot view across decode workers (read-only)."""
        out: Dict[int, Slot] = {}
        for dw in self.decode_workers:
            out.update(dw.slots)
        return out

    def _distinct_tiers(self) -> List[KVTier]:
        seen, out = set(), []
        for dw in self.decode_workers:
            for t in dw.store.tiers:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    # ------------------------------------------------------------------
    @property
    def slo_metric_default(self) -> str:
        """Scenario default for requests that don't pin one: the pool
        scenario's SLO is time-to-first-token, PD separation's is JCT."""
        return "jct" if self.cfg.mode == "pd" else "ttft"

    def submit(self, workload: str, t_slo: float = 0.0, q_min: float = 0.97,
               slo_class: str = "standard", out_tokens: Optional[int] = None,
               prompt_seed: int = 0,
               slo_metric: Optional[str] = None) -> Optional[int]:
        """Admit one request at the current virtual time.  Two submissions
        with the same (workload, prompt_seed) share a prompt, so the second
        can be served from the prefix pool.  Returns the request id, or
        None if admission control shed it."""
        if slo_metric not in (None, "ttft", "jct"):
            raise ValueError(f"slo_metric must be 'ttft' or 'jct', "
                             f"got {slo_metric!r}")
        rid = self._next_rid
        self._next_rid += 1
        tokens, _ = _prompts_for(workload, 1, self.cfg.seq, prompt_seed)
        tokens = np.asarray(tokens)[0]
        m = self.model_cfg
        req = Request(
            rid=rid, workload=workload, arrival=self.clock,
            ctx_tokens=self.cfg.seq,
            out_tokens=(self.cfg.decode_tokens if out_tokens is None
                        else min(out_tokens, self.cfg.decode_tokens)),
            kv_bytes=kv_bytes_for(self.cfg.seq, m.num_layers, m.kv_heads,
                                  m.resolved_head_dim),
            t_slo=t_slo, q_min=q_min, slo_class=slo_class,
            slo_metric=slo_metric,
            prefix_key=tuple(int(t) for t in tokens))
        if not self.scheduler.submit(req, self.clock):
            return None
        self._prompts[rid] = tokens
        return rid

    # ------------------------------------------------------------------
    # Load-aware route scoring
    # ------------------------------------------------------------------
    def route_cost(self, req: Request, route: Route, now: float) -> float:
        """Predicted completion-relevant latency of placing ``req`` on
        ``route``: the controller's latency model at the route's own
        bandwidth estimate, plus live queue depths (in-iteration prefill
        backlog, the link's outstanding reservation, decode occupancy) and
        decode-side prefix affinity."""
        cfg = self.cfg
        pw, dw = route.prefill, route.decode
        decode_est = (1.0 / cfg.decode_tok_s) if cfg.decode_tok_s else 0.0
        queue_term = dw.occupancy * decode_est
        key = req.prefix_key
        hit = (dw.store.peek(key, now=now) if key is not None else None)
        if hit is not None:
            # This worker already holds the prefix: no prefill, no cold
            # transfer — but the hit still pays the holding tier's
            # serialized fetch (overhead + outstanding reservation +
            # stored bytes over the tier link), so a prefix stuck behind
            # a slow wire does NOT blindly pin its repeats there.
            tier = hit.tier
            if tier.wire.estimator is not None:      # PD: the ingress link
                bw = tier.wire.estimator.estimate
            elif tier.spec.observe_goodput:          # pool: the remote tier
                bw = self.estimator.estimate
            else:                                    # local HBM/DRAM tier
                bw = tier.trace.at(now)
            return (tier.fetch_overhead
                    + max(tier.wire.free_at - now, 0.0)
                    + hit.entry.wire_bytes / max(bw, 1e-9)
                    + queue_term)
        t_model = (self._step_busy[pw.wid]
                   + pw.expected_prefill_s(req.ctx_tokens))
        if cfg.mode == "pd":
            bandwidth = route.estimator.estimate
            link_wait = max(route.link.free_at - now, 0.0)
            route_id = route.name
        else:
            bandwidth = self.estimator.estimate
            link_wait = 0.0
            route_id = ""
        ctx = ServiceContext(
            workload=req.workload, bandwidth=bandwidth, t_slo=req.t_slo,
            q_min=req.q_min, t_model=t_model, kv_bytes=req.kv_bytes,
            slo_metric=req.resolved_slo_metric(self.slo_metric_default),
            route=route_id, fused_dec=self.cfg.paged)
        predict = getattr(self.controller, "predict", None)
        if predict is not None:
            t = predict(ctx)
        elif self.static_profile is not None:
            t = predicted_latency(self.static_profile, ctx)
        else:
            t = baseline_latency(ctx)
        return t + link_wait + queue_term

    # ------------------------------------------------------------------
    # Start-of-life stages (per route)
    # ------------------------------------------------------------------
    def _maybe_refetch_smaller(self, req: Request, dw: DecodeWorker,
                               hit: TierHit, now: float) -> float:
        """Tier-aware fetch routing: ask the controller to trade fetching
        the stored encoding over the holding tier's link against
        re-encoding it with the pool tier's (most aggressive) demotion
        profile before the transfer — the "refetch smaller" route that
        pays encode time to cross a slow link with fewer bytes.  Returns
        the source-side re-encode time spent ON the request's critical
        path (0.0 when the stored route wins)."""
        import time as _time
        select_fetch = getattr(self.controller, "select_fetch", None)
        if select_fetch is None:
            return 0.0
        tier, e = hit.tier, hit.entry
        small = dw.store.tiers[-1].spec.profile
        if small is None or small.q(req.workload) < req.q_min:
            return 0.0
        bandwidth = (self.estimator.estimate if tier.spec.observe_goodput
                     else tier.trace.at(now))
        common = dict(tier=tier.name, kv_bytes=e.kv_bytes,
                      bandwidth=bandwidth, overhead=tier.fetch_overhead)

        # Under a paged decode arena, paged-eligible encodings land as
        # quantized pages and decode in the fused attention kernel — the
        # fetch option drops its V/s_dec term (DESIGN.md §12).
        def _fused(strategy) -> bool:
            if not self.cfg.paged:
                return False
            from repro_torch.core.strategy import paged_eligible
            comp = e.payload[0]
            head_dim = comp.shape[3] if hasattr(comp, "shape") else None
            return paged_eligible(strategy, head_dim=head_dim)

        stored = TierFetch(variant="stored", wire_bytes=e.wire_bytes,
                           s_dec=e.payload[2],
                           fused_dequant=_fused(e.payload[0].strategy),
                           **common)
        small_bytes = e.kv_bytes / max(small.cr, 1.0)
        if small_bytes >= e.wire_bytes:
            return 0.0
        reenc = TierFetch(variant="reencoded", wire_bytes=small_bytes,
                          s_enc=small.s_enc, s_dec=small.s_dec,
                          fused_dequant=_fused(small.strategy), **common)
        ctx = ServiceContext(
            workload=req.workload, bandwidth=bandwidth, t_slo=req.t_slo,
            q_min=req.q_min, kv_bytes=e.kv_bytes,
            slo_metric=req.resolved_slo_metric(self.slo_metric_default))
        decision = select_fetch(ctx, [stored, reenc])
        if decision is None or decision.option.variant != "reencoded":
            return 0.0
        t0 = _time.perf_counter()
        if not dw.store.reencode(hit, small):
            return 0.0
        # The re-encode happens before the bytes can cross the link: its
        # cost (the enc term of the fetch decision) is on the critical
        # path — measured wall-clock, or V/s_enc under the virtual clock.
        return codec_cost(self.cfg, _time.perf_counter() - t0, e.kv_bytes,
                          small.s_enc)

    def _start_request(self, req: Request, route: Route, now: float,
                       busy: float) -> Tuple[float, float]:
        """Pool-mode start: prefill-or-fetch one admitted request into its
        arena slot (``req.slot``, local to the route's decode worker).  A
        hit never touches the prefill worker — its fetch starts at ``now``
        and contends on the holding tier's serialized link; a miss
        serializes on the route's prefill worker (``busy``) and writes the
        compressed prefix back through the hot tier's link off the
        critical path.  Returns ``(end_offset, new_busy)`` relative to
        ``now``."""
        pw, dw = route.prefill, route.decode
        tokens = self._prompts[req.rid]
        key = req.prefix_key
        idx = req.slot
        dw.ensure_arena()
        # full=True: a partial (block-aligned) prefix hit would leave the
        # uncovered prompt suffix without KV — the runtime has no top-up
        # prefill, so only a full-coverage entry counts as a pool hit.
        hit = dw.store.lookup(key, now=now, full=True)
        bd: Dict[str, float] = {"queue": now - req.arrival}

        if hit is not None:
            # ---- pool hit: fetch real compressed bytes over the holding
            # tier's serialized link, decompress, inject into the slot
            entry = hit.entry
            req.state = "transferring"
            t_reencode = self._maybe_refetch_smaller(req, dw, hit, now)
            tr = dw.store.fetch(hit, ready=now + t_reencode)
            first, t_decompress = dw.fetch_entry(entry, idx)
            cost = (t_reencode + hit.tier.fetch_overhead + tr.t_wait
                    + tr.t_comm + t_decompress)
            bd.update(wire_wait=tr.t_wait,
                      comm=hit.tier.fetch_overhead + tr.t_comm,
                      decompress=t_decompress)
            if t_reencode > 0:
                bd["compress"] = t_reencode
            req.state = "decoding"
            slot = Slot(req=req, idx=idx, toks=[first],
                        pool_hit=True,
                        profile=entry.payload[0].strategy.short_name(),
                        wire_bytes=int(entry.wire_bytes), breakdown=bd,
                        ttft=(now + cost) - req.arrival, route=route.name)
            dw.occupy(slot, first)
            return cost, busy

        # ---- miss: real prefill into the slot (serialized on the route's
        # prefill worker), then write the compressed prefix back
        bd["queue"] += busy
        caches, first, t_prefill = pw.prefill(req, tokens)
        bd.update(prefill=t_prefill)
        dw.copy_from_caches(caches, idx)

        comp, ctx, decision, profile, t_compress = pw.select_and_compress(
            req, caches, t_prefill, bandwidth=self.estimator.estimate,
            slo_default=self.slo_metric_default)
        wire = comp.total_bytes()
        # The pool write crosses the hot tier's link off the request's
        # critical path (it still contends with fetches there); its cost
        # is booked to pool_write, and the controller observes the
        # request's critical-path latency at _finish instead.
        wr = dw.store.write(
            key, (comp, first, profile.s_dec), wire, kv_bytes=ctx.kv_bytes,
            workload=req.workload, slo_class=req.slo_class,
            ready=now + busy + t_prefill + t_compress, tier=0)
        req.state = "decoding"
        end = busy + t_prefill
        slot = Slot(req=req, idx=idx, toks=[first], pool_hit=False,
                    profile=profile.strategy.short_name(),
                    wire_bytes=int(wire), breakdown=bd,
                    ttft=(now + end) - req.arrival, route=route.name,
                    pool_write=t_compress + wr.t_wait + wr.t_comm,
                    ctx=ctx, decision=decision)
        dw.occupy(slot, first)
        return end, end

    def _start_request_pd(self, req: Request, route: Route, now: float,
                          busy: float) -> Tuple[float, float]:
        """PD-mode start: run one admitted request through its critical
        path — prefill (on the route's prefill worker, serialized at
        ``busy``) -> controller-selected compress (at the ROUTE's link
        bandwidth estimate) -> serialized transfer on the route's link ->
        decompress -> inject into the route's decode arena.  A decode-side
        pool hit skips the whole cold path (the prefix's bytes crossed
        that worker's ingress wire earlier).  Returns ``(end_offset,
        new_busy)`` relative to ``now``."""
        pw, dw = route.prefill, route.decode
        tokens = self._prompts[req.rid]
        key = req.prefix_key
        idx = req.slot
        bd: Dict[str, float] = {"queue": now - req.arrival}

        hit = dw.store.lookup(key, now=now, full=True)
        if hit is not None:
            # ---- decode-side prefix hit: the compressed prefix already
            # crossed the wire for an earlier request; fetch it from the
            # pool tier (contending for the same wire) instead of
            # re-prefilling.
            entry = hit.entry
            req.state = "transferring"
            tr = dw.store.fetch(hit, ready=now)
            first, t_decompress = dw.fetch_entry(entry, idx)
            end = (hit.tier.fetch_overhead + tr.t_wait + tr.t_comm
                   + t_decompress)
            bd.update(wire_wait=tr.t_wait,
                      comm=hit.tier.fetch_overhead + tr.t_comm,
                      decompress=t_decompress)
            req.state = "decoding"
            slot = Slot(req=req, idx=idx, toks=[first], pool_hit=True,
                        profile=entry.payload[0].strategy.short_name(),
                        wire_bytes=int(entry.wire_bytes), breakdown=bd,
                        ttft=(now + end) - req.arrival, route=route.name)
            dw.occupy(slot, first)
            return end, busy

        # ---- cold request: the full PD critical path.  The prefill
        # worker serializes within the iteration (``busy``); the route's
        # link serializes across ALL of its transfers.
        bd["queue"] += busy
        caches, first, t_prefill = pw.prefill(req, tokens)
        comp, ctx, decision, profile, t_compress = pw.select_and_compress(
            req, caches, t_prefill, bandwidth=route.estimator.estimate,
            slo_default=self.slo_metric_default, route=route.name)
        busy = busy + t_prefill + t_compress
        wire_bytes = comp.total_bytes()
        req.state = "transferring"
        tr = route.link.send(now + busy, wire_bytes)
        # The arena row comes from the restored bytes or (default) from
        # the prefill cache — see RuntimeConfig.pd_inject_restored.  The
        # real decompress only runs when its output or its measured time
        # is actually consumed (virtual-clock default models the cost from
        # profile.s_dec, so running it would be pure benchmark tax).
        if self.cfg.pd_inject_restored or self.cfg.prefill_tok_s is None:
            restored, t_wall = decompress_kvs([comp],
                                              device=dw.model.device)
        else:
            restored, t_wall = None, 0.0
        t_decompress = codec_cost(self.cfg, t_wall, ctx.kv_bytes,
                                  profile.s_dec)
        if self.cfg.pd_inject_restored:
            dw.inject_restored(restored[0], idx)
        else:
            dw.copy_from_caches(caches, idx)
        # The bytes that just crossed the wire seed THIS decode worker's
        # pool tier (no extra transfer): later identical prompts routed
        # here hit it.
        dw.store.put(key, (comp, first, profile.s_dec), wire_bytes,
                     kv_bytes=ctx.kv_bytes, workload=req.workload,
                     slo_class=req.slo_class, now=tr.end,
                     tier=len(dw.store.tiers) - 1)
        end = busy + tr.t_wait + tr.t_comm + t_decompress
        bd.update(prefill=t_prefill, compress=t_compress,
                  wire_wait=tr.t_wait, comm=tr.t_comm,
                  decompress=t_decompress)
        req.state = "decoding"
        slot = Slot(req=req, idx=idx, toks=[first], pool_hit=False,
                    profile=profile.strategy.short_name(),
                    wire_bytes=int(wire_bytes), breakdown=bd,
                    ttft=(now + end) - req.arrival, route=route.name,
                    ctx=ctx, decision=decision)
        dw.occupy(slot, first)
        return end, busy

    # ------------------------------------------------------------------
    def _finish(self, dw: DecodeWorker, slot: Slot, now: float) -> None:
        req = slot.req
        toks = np.asarray(slot.toks, dtype=np.int32)
        req.ttft = slot.ttft
        req.done = now
        req.chosen = slot.profile
        req.breakdown = slot.breakdown
        # One SLO metric end to end: the same latency (ttft or jct,
        # request-pinned or scenario default) is compared to t_slo here
        # AND fed to the bandit, so its violation cooldown fires on the
        # metric the runtime reports — not a different one.
        metric = req.resolved_slo_metric(self.slo_metric_default)
        observed = (slot.ttft if metric == "ttft"
                    else sum(slot.breakdown.values()))
        req.slo_violated = req.t_slo > 0 and observed > req.t_slo
        if self.controller is not None and slot.decision is not None:
            # Residual-bandit feedback: the realized critical-path latency
            # of the SLO metric, landing on the slot's ROUTE bandit (the
            # Slot.ctx carries the route), so each link's drift is learned
            # separately.
            self.controller.observe(slot.ctx, slot.decision, observed)
        self.completed.append(ServedRequest(
            rid=req.rid, workload=req.workload, slo_class=req.slo_class,
            text=self.tok.decode(toks), tokens=toks, profile=slot.profile,
            pool_hit=slot.pool_hit, kv_bytes=int(req.kv_bytes),
            wire_bytes=slot.wire_bytes, arrival=req.arrival, done=now,
            ttft=slot.ttft, slot=slot.idx, route=slot.route,
            breakdown=slot.breakdown, t_pool_write=slot.pool_write,
            slo_metric=metric, t_slo=req.t_slo,
            slo_violated=req.slo_violated))
        self.scheduler.finish(req.rid)
        dw.release(slot)             # returns the local arena slot id
        self._prompts.pop(req.rid, None)

    # ------------------------------------------------------------------
    def _admit_and_start(self, now: float) -> List[Tuple[Slot, float]]:
        """The iteration's admission + routing: pop waiting requests in
        priority order while an eligible route exists (prefill worker
        under its per-iteration cap of ``max_prefills_per_step``, decode
        worker with a free slot) and run each through its start-of-life
        stages on the routed pair.  Returns ``(slot, end_offset)`` pairs;
        the stream's cost is the max end offset."""
        started: List[Tuple[Slot, float]] = []
        cap = self.scheduler.cfg.max_prefills_per_step
        admitted = [0] * self.n_prefill
        self._step_busy = [0.0] * self.n_prefill
        while self.scheduler.queue_depth > 0:
            eligible = [r for r in self.routes
                        if admitted[r.prefill.wid] < cap
                        and r.decode.free_slots]
            if not eligible:
                break
            req = self.scheduler.admit(now)
            route = self.router.choose(req, eligible, now, self)
            admitted[route.prefill.wid] += 1
            req.route = route.name
            req.slot = route.decode.free_slots.pop()
            pwid = route.prefill.wid
            if self.cfg.mode == "pd":
                end, self._step_busy[pwid] = self._start_request_pd(
                    req, route, now, self._step_busy[pwid])
            else:
                end, self._step_busy[pwid] = self._start_request(
                    req, route, now, self._step_busy[pwid])
            started.append((route.decode.slots[req.rid], end))
        return started

    def step(self) -> Dict[str, float]:
        """One iteration of the whole cluster: the admission/routing
        stream starts new requests across the mesh, and every decode
        worker advances its previously-running slots one token (one
        masked batched decode per worker).  The iteration costs ``max``
        over all streams; the difference is charged as stall."""
        now = self.clock
        started = self._admit_and_start(now)
        prefill_cost = max((end for _, end in started), default=0.0)
        new_rids = {s.req.rid for s, _ in started}

        # Decode streams: each worker one masked jitted arena call.
        decode_streams: List[Tuple[float, List[Slot]]] = []
        active_total = 0
        for dw in self.decode_workers:
            active = [s for rid, s in dw.slots.items()
                      if rid not in new_rids]
            if not active:
                continue
            wall = dw.decode_iteration(active)
            cost = (1.0 / self.cfg.decode_tok_s
                    if self.cfg.decode_tok_s else wall)
            decode_streams.append((cost, active))
            active_total += len(active)

        # The iteration costs the slowest stream (PD-separated workers run
        # concurrently); the difference is charged to each slot as
        # "stall" so breakdowns sum exactly to jct.
        iter_cost = max([prefill_cost]
                        + [cost for cost, _ in decode_streams])
        for cost, active in decode_streams:
            for slot in active:
                slot.breakdown["decode"] = \
                    slot.breakdown.get("decode", 0.0) + cost
                slot.breakdown["stall"] = \
                    slot.breakdown.get("stall", 0.0) + iter_cost - cost
        for slot, end_offset in started:
            slot.breakdown["stall"] = \
                slot.breakdown.get("stall", 0.0) + iter_cost - end_offset
        self.clock = now + iter_cost
        self.steps += 1
        for dw in self.decode_workers:
            for slot in list(dw.slots.values()):
                if len(slot.toks) > slot.req.out_tokens:
                    self._finish(dw, slot, self.clock)

        stats = {"step": float(self.steps), "clock": self.clock,
                 "in_flight": float(active_total + len(started)),
                 "queue_depth": float(self.scheduler.queue_depth),
                 "completed": float(len(self.completed)),
                 "store_used": float(sum(t.store.used_bytes
                                         for t in self._distinct_tiers()))}
        self.step_log.append(stats)
        return stats

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10_000) -> List[ServedRequest]:
        """Step until every admitted request completed, or until
        ``max_steps`` iterations *from this call* — the budget is relative,
        so a second ``run()`` on a long-lived runtime keeps making
        progress instead of returning against the cumulative counter."""
        start = self.steps
        while not self.scheduler.idle and self.steps - start < max_steps:
            self.step()
        return self.completed

    # ------------------------------------------------------------------
    def max_in_flight(self) -> int:
        return int(max((s["in_flight"] for s in self.step_log), default=0))

    def _store_summary(self) -> Dict[str, float]:
        stores = [dw.store for dw in self.decode_workers]
        if len(stores) == 1:
            return stores[0].summary()
        tiers = self._distinct_tiers()
        out: Dict[str, float] = {
            "entries": sum(len(t.store) for t in tiers),
            "used_bytes": sum(t.store.used_bytes for t in tiers),
            "capacity_bytes": sum(t.store.capacity_bytes for t in tiers),
        }
        for k in ("hits", "misses", "partial_misses", "evictions",
                  "rejected_puts", "promotions", "demotions",
                  "slo_protected"):
            out[k] = sum(getattr(s.stats, k, 0) for s in stores)
        n = out["hits"] + out["misses"] + out["partial_misses"]
        out["hit_rate"] = out["hits"] / n if n else 0.0
        return out

    def summary(self) -> Dict[str, float]:
        hits = [r for r in self.completed if r.pool_hit]
        cold = [r for r in self.completed if not r.pool_hit]
        out = {
            "completed": len(self.completed),
            "rejected": self.scheduler.admission.rejected,
            "max_in_flight": self.max_in_flight(),
            "pool_hits": len(hits),
            "pool_hit_rate": len(hits) / max(len(self.completed), 1),
            "wire_transfers": float(self.topology.transfers),
            "wire_bytes_moved": float(self.topology.bytes_moved),
            "n_prefill_workers": float(self.n_prefill),
            "n_decode_workers": float(self.n_decode),
            "router": self.router.name,
        }
        if self.completed:
            out["mean_jct"] = float(np.mean([r.jct for r in self.completed]))
            out["mean_ttft"] = float(np.mean([r.ttft
                                              for r in self.completed]))
            out["throughput_rps"] = (len(self.completed) / self.clock
                                     if self.clock > 0 else 0.0)
        if hits:
            out["mean_ttft_hit"] = float(np.mean([r.ttft for r in hits]))
        if cold:
            out["mean_ttft_cold"] = float(np.mean([r.ttft for r in cold]))
        # Tail latencies + per-SLO-class violation rates (shared metric
        # block — directly comparable with the simulator's summary()).
        out.update(latency_summary(self.completed))
        if self.n_prefill * self.n_decode > 1:
            out.update(route_counts(self.completed))
        out.update({f"store_{k}": v
                    for k, v in self._store_summary().items()})
        return out
