"""Event-driven simulator for disaggregated serving.

Two scenarios (Sec. 7.2):
  - "pd":   prefill cluster -> [compress -> transfer -> decompress] -> decode
            cluster; metric = JCT.
  - "pool": decode node fetches reusable KV from a remote pool (prefix
            caching) or recomputes prefill locally; metric = TTFT.

Fault model (large-scale runnability): persistent stragglers (per-node speed
factors), transient slowdowns, node failures with re-queue + retry, and
hedged pool fetches (duplicate read to a replica when the first read
exceeds its deadline estimate).

The policy object decides the compression profile per request from the
*estimated* goodput (EWMA over observed transfers), reproducing the
offline→online drift the residual bandit corrects.

Replay invariant: a run is a pure function of (config, seed) — no wall
clock, no global RNG state, no identity-based ordering.  The
``determinism`` static rule (DESIGN.md §13) enforces this mechanically
over this module, ``network.py`` and ``workloads/``.
"""
from __future__ import annotations

import gc
import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.controller import Decision, ServiceAwareController, ServiceContext
from repro_torch.controller.latency_model import (
    expected_tokens_per_step,
    predicted_latency,
)
from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
from repro_torch.core.strategy import paged_eligible
from repro_torch.serving.kvstore import PrefixKVStore, StoreEntry, TieredKVStore
from repro_torch.serving.network import (
    BandwidthTrace,
    GoodputEstimator,
    seed_bandwidth,
)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousScheduler, SchedulerConfig
from repro_torch.serving.topology import NetworkTopology


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------
class Policy:
    name = "base"
    # Whether ``choose``/``feedback`` read the ServiceContext.  Policies
    # that ignore it (fixed-profile baselines) set this False so the hot
    # path can skip building a context per request — at a million requests
    # the allocation alone dominates the simulated cluster.  ``choose``
    # then receives ``ctx=None``.
    needs_ctx = True

    def choose(self, req: Request, ctx: Optional[ServiceContext]
               ) -> Tuple[Profile, Optional[Decision]]:
        raise NotImplementedError

    def feedback(self, ctx: Optional[ServiceContext],
                 decision: Optional[Decision], observed: float) -> None:
        pass


class NoCompressionPolicy(Policy):
    name = "default"
    needs_ctx = False

    def choose(self, req, ctx):
        return IDENTITY_PROFILE, None


class StaticPolicy(Policy):
    """A fixed profile regardless of service state (CacheGen/KIVI/Duo...)."""

    def __init__(self, profile: Profile, name: str,
                 slo_fallback_recompute: bool = False):
        self.profile = profile
        self.name = name
        # CacheGen's behaviour in Fig. 14: fall back to recomputation when
        # it cannot meet the target SLO.  Only that fallback reads the
        # service context (predicted_latency needs B and V).
        self.slo_fallback_recompute = slo_fallback_recompute
        self.needs_ctx = slo_fallback_recompute

    def choose(self, req, ctx):
        return self.profile, None


class KVServePolicy(Policy):
    name = "kvserve"

    def __init__(self, controller: ServiceAwareController):
        self.controller = controller

    def choose(self, req, ctx):
        decision = self.controller.select(ctx)
        return decision.profile, decision

    def feedback(self, ctx, decision, observed):
        if decision is not None:
            self.controller.observe(ctx, decision, observed)


# ---------------------------------------------------------------------------
# Cluster / fault model
# ---------------------------------------------------------------------------
@dataclass
class NodePool:
    """Idle-node tracker with O(log n) acquire/release.

    ``node_free`` is authoritative: per-node free time, ``None`` while the
    node is acquired.  ``heap`` carries (free_time, nid) reservations with
    LAZY deletion — an entry is valid only while it still matches
    ``node_free[nid]``; stale entries (from ``acquire_node`` pulls or
    superseded releases) are skipped on pop.  The previous implementation
    re-``heapify``-ed the whole heap on every routed acquire, which was
    the simulator's top hot spot on million-request traces.
    """

    n: int
    speed: List[float]          # persistent per-node speed factor
    node_free: List[Optional[float]] = field(default_factory=list)
    heap: List[Tuple[float, int]] = field(default_factory=list)

    @staticmethod
    def make(n: int, straggler_sigma: float, rng: np.random.Generator
             ) -> "NodePool":
        speed = np.exp(rng.normal(0.0, straggler_sigma, size=n))
        # Stragglers only slow down; plain floats keep every downstream
        # duration off numpy scalar arithmetic.
        speed = np.minimum(speed, 1.0).tolist()
        pool = NodePool(n=n, speed=speed)
        pool.node_free = [0.0] * n
        pool.heap = [(0.0, i) for i in range(n)]  # already heap-ordered
        return pool

    def acquire(self, now: float) -> Tuple[float, int]:
        """Earliest-free node: pops (skipping stale entries) and marks it
        acquired.  Ties break by node id, matching the old heap order."""
        heap = self.heap
        node_free = self.node_free
        while True:
            free, nid = heapq.heappop(heap)
            if node_free[nid] == free:
                node_free[nid] = None
                return (free if free > now else now), nid

    def acquire_node(self, nid: int, now: float) -> float:
        """Reserve a SPECIFIC node (the topology-routed decode target):
        returns its start time (>= now, after the node frees up)."""
        free = self.node_free[nid]
        if free is None:
            raise KeyError(f"node {nid} is not idle-tracked")
        self.node_free[nid] = None  # its heap entry goes stale in place
        return free if free > now else now

    def free_times(self) -> Dict[int, float]:
        """Current per-node free times (the router's decode queue view)."""
        return {nid: free for nid, free in enumerate(self.node_free)
                if free is not None}

    def next_free(self) -> Optional[float]:
        """Earliest free time among idle-tracked nodes (dispatch clock)."""
        best: Optional[float] = None
        for free in self.node_free:
            if free is not None and (best is None or free < best):
                best = free
        return best

    def release(self, nid: int, until: float) -> None:
        self.node_free[nid] = until
        heap = self.heap
        heapq.heappush(heap, (until, nid))
        if len(heap) > 2 * self.n + 32:
            # Routed (acquire_node) traffic never pops, so stale entries
            # accumulate; compact before the heap outgrows the pool.
            live = [(free, nid) for nid, free in enumerate(self.node_free)
                    if free is not None]
            heapq.heapify(live)
            self.heap = live


@dataclass
class SimConfig:
    scenario: str = "pd"            # pd | pool
    n_prefill: int = 4
    n_decode: int = 2
    prefill_tok_s: float = 20000.0  # tokens/s per prefill node
    decode_tok_s: float = 120.0     # tokens/s per decode node
    straggler_sigma: float = 0.0
    transient_slow_p: float = 0.0   # per-task transient slowdown prob
    transient_slow_factor: float = 3.0
    fail_rate: float = 0.0          # failures per node-second of busy time
    max_retries: int = 2
    hedge_factor: float = 0.0       # >0: hedged pool fetch at factor×estimate
    pool_fetch_overhead: float = 0.002
    estimator_alpha: float = 0.3
    # Decode side runs the paged arena with fused dequant-attention
    # (DESIGN.md §12): paged-eligible profiles skip the materialized
    # decompress, so their V/s_dec term leaves the critical path.
    paged: bool = False
    # Speculative decode on the decode fleet (DESIGN.md §15): spec_k > 0
    # divides each request's decode time by its committed-tokens-per-
    # verify-step, derived from spec_accept via the controller's
    # geometric model.  Per-request acceptance is a pure hash of
    # (seed, rid) — no rng state is consumed, so replays stay a pure
    # function of (config, seed) and spec_k = 0 is bit-identical to
    # runs that predate the field.
    spec_k: int = 0
    spec_accept: float = 0.0
    seed: int = 0


def spec_tokens_per_step(cfg: SimConfig, rid: int) -> float:
    """Committed tokens per verify step for request ``rid`` under
    ``cfg``'s speculation settings — the simulator's acceptance model.

    The per-request accept rate is ``cfg.spec_accept`` jittered by a
    Weyl-style integer hash of (seed, rid): requests repeat themselves
    to different degrees, but which ones do must not depend on run
    order, so the jitter is a pure function of the request identity and
    consumes NO rng state (the replay invariant in the module
    docstring).  The accept rate then feeds the controller's own
    geometric model (:func:`expected_tokens_per_step`), so what the
    simulator bills and what the controller predicts agree by
    construction.  ``spec_k <= 0`` returns exactly 1.0."""
    if cfg.spec_k <= 0:
        return 1.0
    u = ((rid * 2654435761 + cfg.seed * 97) % 1000) / 1000.0
    r = min(max(cfg.spec_accept + 0.1 * (u - 0.5), 0.0), 1.0)
    return expected_tokens_per_step(cfg.spec_k, r)


@dataclass
class SimResult:
    requests: List[Request]
    policy: str

    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.chosen != "rejected"]

    def rejected(self) -> List[Request]:
        """Requests shed by admission control (scheduled dispatch only)."""
        return [r for r in self.requests if r.chosen == "rejected"]

    def jct(self) -> np.ndarray:
        return np.asarray([r.jct for r in self.completed()])

    def ttft(self) -> np.ndarray:
        return np.asarray([r.ttft for r in self.completed()])

    def mean_jct(self) -> float:
        """0.0 when nothing completed (never NaN, never a crash)."""
        vals = self.jct()
        return float(vals.mean()) if vals.size else 0.0

    def p95_jct(self) -> float:
        vals = self.jct()
        return float(np.percentile(vals, 95)) if vals.size else 0.0

    def mean_ttft(self) -> float:
        vals = self.ttft()
        return float(vals.mean()) if vals.size else 0.0

    def slo_attainment(self) -> float:
        with_slo = [r for r in self.requests if r.t_slo > 0]
        if not with_slo:
            return 1.0
        return float(np.mean([not r.slo_violated for r in with_slo]))

    def breakdown(self) -> Dict[str, float]:
        keys = ("prefill", "compress", "comm", "decompress", "decode",
                "queue", "retry")
        out = {k: 0.0 for k in keys}
        for r in self.requests:
            for k in keys:
                out[k] += r.breakdown.get(k, 0.0)
        n = max(len(self.requests), 1)
        return {k: v / n for k, v in out.items()}

    def summary(self) -> Dict[str, float]:
        """Distribution summary of the run: means, p50/p95/p99 TTFT and
        JCT tails, and per-SLO-class violation rates — the same metric
        block the real-execution runtimes emit, so simulator sweeps are
        directly comparable with engine runs."""
        from repro_torch.serving.metrics import latency_summary, route_counts
        done = self.completed()
        out: Dict[str, float] = {
            "completed": float(len(done)),
            "rejected": float(len(self.rejected())),
            "slo_attainment": self.slo_attainment(),
        }
        if done:
            out["mean_jct"] = self.mean_jct()
            out["mean_ttft"] = self.mean_ttft()
            makespan = max(r.done for r in done)
            out["throughput_rps"] = (len(done) / makespan
                                     if makespan > 0 else 0.0)
        # Per-class blocks cover every class SUBMITTED (not just the
        # completed ones): a class whose requests were all shed still
        # appears — completed 0, percentiles None, violation rate 0.
        classes = sorted({r.slo_class for r in self.requests})
        out.update(latency_summary(done, classes=classes))
        out.update(route_counts(done))
        return out


def _sim_recompress(entry: StoreEntry, profile: Profile
                    ) -> Optional[Tuple[Profile, int]]:
    """Byte-accounting demotion re-compression for simulator payloads
    (the stored payload IS the profile it was compressed with)."""
    if entry.kv_bytes <= 0:
        return None
    wire = int(entry.kv_bytes / max(profile.cr, 1.0))
    if wire >= entry.wire_bytes:
        return None
    return profile, wire


class Simulator:
    """Event-driven serving simulator.

    Optional serving-runtime integrations (shared with the real-execution
    engine, see DESIGN.md §9):

    * ``store`` — a :class:`PrefixKVStore` (flat pool) or a
      :class:`TieredKVStore` (HBM/DRAM/remote hierarchy); the pool
      scenario then resolves hits/misses (and capacity eviction /
      demotion / promotion) through the store via each request's
      ``prefix_key`` instead of the static ``prefix_hit`` flag.  With a
      tiered store, fetches and write-backs are routed through the
      holding tier's serialized link, so concurrent pool traffic
      contends.  ``hedge_factor`` hedges slow fetches on the flat path
      and on the tiered store's REMOTE tier (the replicated pool);
      local HBM/DRAM tiers are never hedged — there is no replica of a
      worker's own memory to race.
    * ``scheduler`` — a :class:`SchedulerConfig`; requests are then
      dispatched through :class:`ContinuousScheduler` (admission control +
      SLO-class priority order) rather than strict arrival order.
    * ``topology`` + ``routing`` — a
      :class:`~repro_torch.serving.topology.NetworkTopology` of per-(prefill
      node, decode node) serialized links; the pd scenario then routes
      every transfer over its pair's own wire ("round_robin" baseline or
      "load_aware" predicted-latency argmin), which is the event-driven
      twin of :class:`~repro_torch.serving.cluster.ClusterRuntime` for
      large-scale sweeps.
    """

    def __init__(self, config: SimConfig, policy: Policy,
                 trace: BandwidthTrace, requests: Sequence[Request],
                 store: Optional[object] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 topology: Optional[NetworkTopology] = None,
                 routing: str = "load_aware"):
        self.cfg = config
        self.policy = policy
        self.trace = trace
        self.requests = list(requests)
        self.store = store
        self.scheduler_cfg = scheduler
        # Per-(prefill node, decode node) link topology: the pd
        # scenario then routes every transfer over the pair's own
        # serialized KVWire — the same NetworkTopology object the
        # real-execution ClusterRuntime drives, at event-driven scale.
        self.topology = topology
        if routing not in ("load_aware", "round_robin"):
            # validated with or without a topology: a typo'd policy name
            # should fail at construction, not when a topology is later
            # added to the sweep
            raise ValueError(f"unknown routing policy {routing!r}")
        if topology is not None:
            if (topology.n_prefill != config.n_prefill
                    or topology.n_decode != config.n_decode):
                raise ValueError(
                    f"topology is {topology.n_prefill}x{topology.n_decode} "
                    f"but the cluster has {config.n_prefill} prefill x "
                    f"{config.n_decode} decode nodes")
        self.routing = routing
        self._rr_next = 0
        self.rng = np.random.default_rng(config.seed)
        # Hot-path caches: profile -> display name (short_name() rebuilds
        # its string per call), the scenario's default SLO metric, and
        # whether the pool path needs the CacheGen-style SLO fallback.
        self._names: Dict[int, Tuple[Profile, str]] = {}
        self._default_metric = "jct" if config.scenario == "pd" else "ttft"
        self._static_fallback = (isinstance(policy, StaticPolicy)
                                 and policy.slo_fallback_recompute)
        self.estimator = GoodputEstimator(alpha=config.estimator_alpha,
                                          initial=seed_bandwidth(trace))
        self._tiered = isinstance(store, TieredKVStore)
        if self._tiered:
            if store.estimator is None:
                store.estimator = self.estimator
            if store.recompress is None:
                store.recompress = _sim_recompress
        self.prefill = NodePool.make(config.n_prefill,
                                     config.straggler_sigma, self.rng)
        self.decode = NodePool.make(config.n_decode, config.straggler_sigma,
                                    self.rng)

    # ------------------------------------------------------------------
    def _task_time(self, base: float, pool: NodePool, nid: int) -> float:
        t = base / pool.speed[nid]
        if self.cfg.transient_slow_p > 0 and \
                self.rng.random() < self.cfg.transient_slow_p:
            t *= self.cfg.transient_slow_factor
        return t

    def _maybe_fail(self, duration: float) -> Optional[float]:
        """Returns time-until-failure if the node dies mid-task."""
        if self.cfg.fail_rate <= 0:
            return None
        u = self.rng.random()
        p_fail = 1.0 - math.exp(-self.cfg.fail_rate * duration)
        if u < p_fail:
            return float(self.rng.uniform(0.1, 0.9)) * duration
        return None

    def _run_on_pool(self, pool: NodePool, now: float, base_time: float,
                     req: Request) -> Tuple[float, float, int]:
        """Execute a compute task with failure/straggler handling.
        Returns (finish_time, queue_wait, node_id)."""
        attempts = 0
        t = now
        queue_wait = 0.0
        while True:
            start, nid = pool.acquire(t)
            queue_wait += start - t
            dur = self._task_time(base_time, pool, nid)
            fail_at = self._maybe_fail(dur) if attempts < self.cfg.max_retries \
                else None
            if fail_at is None:
                pool.release(nid, start + dur)
                return start + dur, queue_wait, nid
            # node died mid-task: lose partial work, re-queue elsewhere
            pool.release(nid, start + fail_at + 1.0)  # node recovers later
            req.retries += 1
            req.breakdown["retry"] = req.breakdown.get("retry", 0.0) + fail_at
            attempts += 1
            t = start + fail_at

    def _run_on_node(self, pool: NodePool, nid: int, now: float,
                     base_time: float, req: Request) -> Tuple[float, float]:
        """Execute on a SPECIFIC node (topology-routed placement): the
        full straggler/transient/failure model applies, but a mid-task
        failure RETRIES ON THE PINNED NODE after it recovers instead of
        re-routing (the route decided the placement).  Returns
        (finish_time, queue_wait)."""
        start = pool.acquire_node(nid, now)
        queue_wait = start - now
        t = start
        attempts = 0
        while True:
            dur = self._task_time(base_time, pool, nid)
            fail_at = self._maybe_fail(dur) \
                if attempts < self.cfg.max_retries else None
            if fail_at is None:
                pool.release(nid, t + dur)
                return t + dur, queue_wait
            req.retries += 1
            req.breakdown["retry"] = req.breakdown.get("retry", 0.0) + fail_at
            attempts += 1
            t = t + fail_at + 1.0     # pinned node recovers, then retry

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        # The replay loop allocates millions of small ACYCLIC objects
        # (per-request breakdown dicts, heap tuples) that all stay
        # reachable from self.requests, so generational GC finds nothing
        # yet rescans the growing heap over and over — ~4x the entire
        # replay cost at a million requests.  Defer collection for the
        # duration; re-enable (and let the caller's thresholds catch up)
        # on the way out.
        was_enabled = gc.isenabled()
        if was_enabled:
            gc.disable()
        try:
            if self.scheduler_cfg is not None:
                self._run_scheduled()
                return SimResult(self.requests, self.policy.name)
            if self.cfg.scenario == "pd":
                if self._fast_pd_eligible():
                    self._run_fast_pd()
                else:
                    for req in self.requests:
                        self._run_pd(req)
            else:
                for req in self.requests:
                    self._run_pool(req)
            return SimResult(self.requests, self.policy.name)
        finally:
            if was_enabled:
                gc.enable()

    # ------------------------------------------------------------------
    # Bulk pd replay (the million-request hot path)
    # ------------------------------------------------------------------
    def _fast_pd_eligible(self) -> bool:
        """The inlined pd loop applies when per-request dispatch has no
        data-dependent branching to honor: no per-link topology, no fault
        injection (those draw from the rng mid-request), and a
        fixed-profile policy that ignores the service context.  Every
        other configuration takes the general per-request path."""
        cfg = self.cfg
        policy = self.policy
        return (self.topology is None
                and cfg.fail_rate <= 0
                and cfg.transient_slow_p <= 0
                and not policy.needs_ctx
                and type(policy).choose in (StaticPolicy.choose,
                                            NoCompressionPolicy.choose)
                and type(policy).feedback is Policy.feedback)

    def _run_fast_pd(self) -> None:
        """Inlined twin of :meth:`_run_pd` for the eligible configuration.
        Every float expression mirrors the general path op-for-op, so the
        two produce bit-identical requests (the sim_speed benchmark
        asserts it); what is removed is per-request call and allocation
        overhead — ServiceContext construction, pool/transfer/estimator
        method dispatch, dict re-writes — which dominated replay time on
        million-request traces."""
        requests = self.requests
        if not requests:
            return
        cfg = self.cfg
        profile, _ = self.policy.choose(requests[0], None)
        name = self._profile_name(profile)
        pre_tok = cfg.prefill_tok_s
        dec_tok = cfg.decode_tok_s
        s_enc, s_dec, cr = profile.s_enc, profile.s_dec, profile.cr
        enc_inf = s_enc == float("inf")
        # fixed profile -> the fused-dequant gate is loop-invariant
        dec_inf = (s_dec == float("inf")
                   or (cfg.paged and paged_eligible(profile.strategy)))
        trace = self.trace
        const = (trace.jitter <= 0 and len(trace.times) == 1
                 and trace.values[0] > 0.0)
        rate = trace.values[0] if const else 0.0
        est = self.estimator
        alpha = est.alpha
        one_m_alpha = 1 - alpha
        e = est._est
        prefill, decode = self.prefill, self.decode
        pheap, dheap = prefill.heap, decode.heap
        pspeed, dspeed = prefill.speed, decode.speed
        heappush, heappop = heapq.heappush, heapq.heappop
        isfinite = math.isfinite
        default_metric = self._default_metric
        spec_on = cfg.spec_k > 0

        for req in requests:
            arrival = req.arrival
            # prefill on the earliest-free node (no stale heap entries
            # without acquire_node traffic)
            free, nid = heappop(pheap)
            s0 = free if free > arrival else arrival
            t = s0 + (req.ctx_tokens / pre_tok) / pspeed[nid]
            heappush(pheap, (t, nid))
            q_wait = s0 - arrival

            # compress -> transfer -> decompress
            v = req.kv_bytes
            t_c = 0.0 if enc_inf else v / s_enc
            payload = v / cr
            t_comm = payload / rate if const \
                else trace.transfer_time(t + t_c, payload)
            if t_comm > 0 and payload > 0 and isfinite(t_comm):
                goodput = payload / t_comm
                e = goodput if e is None \
                    else one_m_alpha * e + alpha * goodput
            t_d = 0.0 if dec_inf else v / s_dec
            bd_prefill = t - arrival - q_wait - 0.0
            t = t + t_c + t_comm + t_d
            ttft = t - arrival
            req.ttft = ttft

            # decode on the earliest-free node (same two-step arithmetic
            # as _run_pd: divide-then-divide, never a fused expression,
            # so the floats match bit-for-bit)
            t_dec_base = req.out_tokens / dec_tok
            if spec_on:
                t_dec_base /= spec_tokens_per_step(cfg, req.rid)
            free2, nid2 = heappop(dheap)
            s1 = free2 if free2 > t else t
            t_end = s1 + t_dec_base / dspeed[nid2]
            heappush(dheap, (t_end, nid2))

            # mirror the general path op-for-op: q_wait2 accumulates from
            # 0.0, decode is ACTUAL elapsed minus queue (straggler-aware),
            # retry delta is identically 0.0 here (no faults when eligible)
            q2 = 0.0 + (s1 - t)
            req.breakdown = {
                "prefill": bd_prefill,
                "queue": (q_wait + 0.0) + q2,
                "compress": t_c, "comm": t_comm, "decompress": t_d,
                "decode": t_end - t - q2 - 0.0,
            }
            req.done = t_end
            req.chosen = name
            metric = req.slo_metric
            if metric is None:
                metric = default_metric
            observed = ttft if metric == "ttft" else t_end - arrival
            t_slo = req.t_slo
            req.slo_violated = t_slo > 0 and observed > t_slo

        est._est = e
        for free, nid in pheap:
            prefill.node_free[nid] = free
        for free, nid in dheap:
            decode.node_free[nid] = free

    def _run_scheduled(self) -> None:
        """Dispatch through the shared ContinuousScheduler: admission
        control sheds load beyond the queue bound, and waiting requests are
        served in priority (not arrival) order.  The dispatch clock advances
        to the next prefill-node free time, so under overload a backlog
        accumulates and SLO-class ordering becomes visible."""
        sched = ContinuousScheduler(self.scheduler_cfg)
        pending = sorted(self.requests, key=lambda r: r.arrival)
        idx, n = 0, len(pending)
        now = 0.0
        while idx < n or sched.queue_depth:
            while idx < n and pending[idx].arrival <= now:
                sched.submit(pending[idx], now)
                idx += 1
            if sched.queue_depth == 0:
                if idx >= n:   # everything left was shed by admission
                    break
                now = pending[idx].arrival
                continue
            req = sched.pop_next(now)
            start = max(now, req.arrival)
            if self.cfg.scenario == "pd":
                self._run_pd(req, start)
            else:
                self._run_pool(req, start)
            nxt = self.prefill.next_free()
            if nxt is not None:
                now = max(now, nxt)

    # ------------------------------------------------------------------
    def _slo_metric(self, req: Request) -> str:
        """Scenario default (pd -> jct, pool -> ttft) unless the request
        pins one — the same resolution rule as the real runtime."""
        m = req.slo_metric
        return m if m is not None else self._default_metric

    def _profile_name(self, profile: Profile) -> str:
        # Keyed by id with the profile pinned in the entry, so a recycled
        # id (GC'd temporary) can never alias onto a stale name.
        hit = self._names.get(id(profile))
        if hit is not None and hit[0] is profile:
            return hit[1]
        name = profile.strategy.short_name()
        self._names[id(profile)] = (profile, name)
        return name

    def _service_context(self, req: Request, t_model: float) -> ServiceContext:
        return ServiceContext(
            workload=req.workload, bandwidth=self.estimator.estimate,
            t_slo=req.t_slo, q_min=req.q_min, t_model=t_model,
            kv_bytes=req.kv_bytes, slo_metric=self._slo_metric(req),
            fused_dec=self.cfg.paged)

    def _decompress_time(self, profile: Profile, v: float) -> float:
        """V/s_dec — except under the paged arena (``cfg.paged``), where a
        paged-eligible profile's pages feed the fused dequant-attention
        kernel directly and the materialized decompress vanishes."""
        if self.cfg.paged and paged_eligible(profile.strategy):
            return 0.0
        return 0.0 if profile.s_dec == float("inf") else v / profile.s_dec

    def _transfer(self, start: float, nbytes: float) -> float:
        dt = self.trace.transfer_time(start, nbytes)
        self.estimator.observe(nbytes, dt)
        return dt

    # ------------------------------------------------------------------
    def _choose_decode(self, src: int, ready: float, payload_hint: float
                       ) -> int:
        """Pick the decode node for a transfer leaving prefill node
        ``src``: round-robin cycles the decode nodes; load-aware takes the
        argmin of (link reservation backlog + estimated transfer at the
        link's own goodput estimate + decode node busy time) — predicted
        completion over live queue depths, per-link estimators included.
        """
        topo = self.topology
        if self.routing == "round_robin":
            d = self._rr_next % topo.n_decode
            self._rr_next += 1
            return d
        free = self.decode.free_times()

        def cost(d: int) -> float:
            link = topo.link(src, d)
            t_link = (max(link.free_at - ready, 0.0)
                      + payload_hint / max(link.estimator.estimate, 1e-9))
            return t_link + max(free.get(d, 0.0) - ready, 0.0)

        return min(range(topo.n_decode), key=lambda d: (cost(d), d))

    def _run_pd(self, req: Request, start: Optional[float] = None) -> None:
        if self.topology is not None:
            return self._run_pd_topology(req, start)
        cfg = self.cfg
        start = req.arrival if start is None else start
        t_prefill_base = req.ctx_tokens / cfg.prefill_tok_s
        t_decode_base = req.out_tokens / cfg.decode_tok_s
        if cfg.spec_k > 0:
            t_decode_base /= spec_tokens_per_step(cfg, req.rid)
        ctx = self._service_context(req, t_prefill_base + t_decode_base) \
            if self.policy.needs_ctx else None
        profile, decision = self.policy.choose(req, ctx)
        req.chosen = self._profile_name(profile)

        # prefill
        t, q_wait, pid = self._run_on_pool(self.prefill, start,
                                           t_prefill_base, req)
        req.breakdown["prefill"] = t - start - q_wait \
            - req.breakdown.get("retry", 0.0)
        req.breakdown["queue"] = q_wait + (start - req.arrival)

        # compress -> transfer -> decompress
        v = req.kv_bytes
        t_c = 0.0 if profile.s_enc == float("inf") else v / profile.s_enc
        payload = v / profile.cr
        t_comm = self._transfer(t + t_c, payload)
        t_d = self._decompress_time(profile, v)
        req.breakdown["compress"] = t_c
        req.breakdown["comm"] = t_comm
        req.breakdown["decompress"] = t_d
        t = t + t_c + t_comm + t_d
        req.ttft = t - req.arrival  # first decode token comes right after

        # decode — billed at ACTUAL elapsed time (straggler/transient
        # slowdowns included), not the base estimate, so the breakdown
        # terms always sum to JCT
        retry0 = req.breakdown.get("retry", 0.0)
        t_dec = t
        t, q_wait2, _ = self._run_on_pool(self.decode, t, t_decode_base, req)
        req.breakdown["decode"] = t - t_dec - q_wait2 \
            - (req.breakdown.get("retry", 0.0) - retry0)
        req.breakdown["queue"] += q_wait2
        req.done = t
        # Metric-matched feedback (same rule as the runtime's _finish):
        # the bandit's violation cooldown fires on the latency reported as
        # slo_violated, never a different quantity.
        metric = self._slo_metric(req)
        observed = req.ttft if metric == "ttft" else req.jct
        req.slo_violated = req.t_slo > 0 and observed > req.t_slo
        self.policy.feedback(ctx, decision, observed)

    def _run_pd_topology(self, req: Request,
                         start: Optional[float] = None) -> None:
        """PD over the per-link topology: prefill on whichever node frees
        first (node ``src``), route the transfer to a decode node
        (round-robin or load-aware), bill it on the (src, dst) pair's OWN
        serialized :class:`~repro_torch.serving.network.KVWire` (concurrent
        transfers on the same link queue — ``wire_wait``; different links
        overlap), then decode pinned on ``dst``.  The profile decision is
        made AFTER the route is known, from the route's per-link goodput
        estimate, and the context carries the route id so the residual
        bandit learns each link's drift separately."""
        from repro_torch.serving.topology import route_name
        cfg = self.cfg
        start = req.arrival if start is None else start
        t_prefill_base = req.ctx_tokens / cfg.prefill_tok_s
        t_decode_base = req.out_tokens / cfg.decode_tok_s
        if cfg.spec_k > 0:
            t_decode_base /= spec_tokens_per_step(cfg, req.rid)

        # prefill
        t, q_wait, src = self._run_on_pool(self.prefill, start,
                                           t_prefill_base, req)
        req.breakdown["prefill"] = t - start - q_wait \
            - req.breakdown.get("retry", 0.0)
        req.breakdown["queue"] = q_wait + (start - req.arrival)

        # route + profile decision at the route's own bandwidth view
        dst = self._choose_decode(src, t, req.kv_bytes)
        link = self.topology.link(src, dst)
        req.route = route_name(src, dst)
        ctx = None
        if self.policy.needs_ctx:
            ctx = ServiceContext(
                workload=req.workload, bandwidth=link.estimator.estimate,
                t_slo=req.t_slo, q_min=req.q_min,
                t_model=t_prefill_base + t_decode_base,
                kv_bytes=req.kv_bytes,
                slo_metric=self._slo_metric(req), route=req.route)
        profile, decision = self.policy.choose(req, ctx)
        req.chosen = self._profile_name(profile)

        # compress -> per-link serialized transfer -> decompress
        v = req.kv_bytes
        t_c = 0.0 if profile.s_enc == float("inf") else v / profile.s_enc
        payload = v / profile.cr
        tr = link.send(t + t_c, payload)
        t_d = self._decompress_time(profile, v)
        req.breakdown["compress"] = t_c
        req.breakdown["wire_wait"] = tr.t_wait
        req.breakdown["comm"] = tr.t_comm
        req.breakdown["decompress"] = t_d
        t = t + t_c + tr.t_wait + tr.t_comm + t_d
        req.ttft = t - req.arrival  # first decode token comes right after

        # decode, pinned on the routed node — billed at ACTUAL elapsed
        # time (stragglers/retries included) so breakdowns sum to JCT
        retry0 = req.breakdown.get("retry", 0.0)
        t_end, q_wait2 = self._run_on_node(self.decode, dst, t,
                                           t_decode_base, req)
        req.breakdown["decode"] = t_end - t - q_wait2 \
            - (req.breakdown.get("retry", 0.0) - retry0)
        req.breakdown["queue"] += q_wait2
        req.done = t_end
        metric = self._slo_metric(req)
        observed = req.ttft if metric == "ttft" else req.jct
        req.slo_violated = req.t_slo > 0 and observed > req.t_slo
        self.policy.feedback(ctx, decision, observed)

    # ------------------------------------------------------------------
    def _run_pool(self, req: Request, start: Optional[float] = None) -> None:
        """Prefix-caching: fetch compressed KV from the remote pool or
        recompute prefill.  TTFT is the metric.

        With a :class:`PrefixKVStore` attached, hits/misses come from real
        store state (prefix matching + capacity eviction): a miss recomputes
        and writes the compressed KV back (off the critical path), a hit
        fetches the *stored* entry's bytes.  Without a store, the request's
        static ``prefix_hit`` flag decides, and the fetch is billed at the
        policy-chosen profile."""
        cfg = self.cfg
        start = req.arrival if start is None else start
        sched_wait = start - req.arrival
        t_prefill_base = req.ctx_tokens / cfg.prefill_tok_s
        ctx = self._service_context(req, cfg.pool_fetch_overhead) \
            if self.policy.needs_ctx else None
        profile, decision = self.policy.choose(req, ctx)
        req.chosen = self._profile_name(profile)

        entry = None
        hit = None      # TierHit when the store is a TieredKVStore
        tiered = self._tiered
        if self.store is not None:
            key = req.prefix_key if req.prefix_key is not None else (req.rid,)
            if tiered:
                hit = self.store.lookup(key, now=start)
                entry = hit.entry if hit is not None else None
            else:
                entry = self.store.lookup(key, now=start)
            recompute = entry is None
        else:
            recompute = not req.prefix_hit
        if not recompute and self._static_fallback and req.t_slo > 0:
            # CacheGen-style: if the static profile cannot meet SLO, degrade
            # to full recomputation (Fig. 14).
            pred = predicted_latency(profile, ctx)
            if pred > req.t_slo:
                recompute = True

        if recompute:
            t, q_wait, _ = self._run_on_pool(self.prefill, start,
                                             t_prefill_base, req)
            req.breakdown["prefill"] = t - start - q_wait \
                - req.breakdown.get("retry", 0.0)
            req.breakdown["queue"] = q_wait + sched_wait
            req.ttft = t - req.arrival
            req.done = t
            req.slo_violated = req.t_slo > 0 and req.ttft > req.t_slo
            if self.store is not None:
                # Write the freshly compressed prefix back to the pool (off
                # the critical path).  The entry is stamped with the write's
                # *completion* time (compress + wire) so lookups can't hit
                # bytes still in flight — same rule as the engine path.
                payload = req.kv_bytes / profile.cr
                t_c = 0.0 if profile.s_enc == float("inf") \
                    else req.kv_bytes / profile.s_enc
                if tiered:
                    # Routed through the hot tier's serialized link:
                    # write-backs contend with concurrent fetches.
                    self.store.write(key, profile, int(payload),
                                     kv_bytes=req.kv_bytes,
                                     workload=req.workload,
                                     slo_class=req.slo_class,
                                     ready=t + t_c, tier=0)
                else:
                    t_w = self._transfer(t + t_c, payload)
                    self.store.put(key, profile, int(payload),
                                   kv_bytes=req.kv_bytes,
                                   workload=req.workload,
                                   slo_class=req.slo_class,
                                   now=t + t_c + t_w)
            self.policy.feedback(ctx, decision, req.ttft)
            return

        # fetch compressed KV from the pool (with optional hedging)
        if entry is not None:
            # Physically coherent: the wire carries what the pool stored.
            stored: Profile = entry.payload
            v = entry.kv_bytes
            payload = float(entry.wire_bytes)
            t_d = self._decompress_time(stored, v)
            req.chosen = self._profile_name(stored)
        else:
            v = req.kv_bytes
            payload = v / profile.cr
            t_d = self._decompress_time(profile, v)
        if hit is not None:
            # Tiered fetch: the holding tier's serialized link (concurrent
            # fetches queue — wire_wait is on the critical path); the
            # fetched entry promotes to the hot tier.  Hedging models a
            # replicated pool, so it applies to the REMOTE tier only (the
            # shared pool has replicas; a worker's own HBM/DRAM does not):
            # the duplicate fetch races on the replica's own wire, not the
            # primary's serialized queue.
            overhead = hit.tier.fetch_overhead
            tr = self.store.fetch(hit, ready=start)
            t_comm = tr.t_comm
            if cfg.hedge_factor > 0 and hit.tier.spec.observe_goodput:
                expected = payload / self.estimator.estimate
                if t_comm > cfg.hedge_factor * expected:
                    t_comm2 = (hit.tier.fetch_overhead
                               + hit.tier.trace.transfer_time(
                                   start + cfg.hedge_factor * expected,
                                   payload))
                    t_comm = min(t_comm,
                                 cfg.hedge_factor * expected + t_comm2)
                    req.retries += 1
            req.breakdown["wire_wait"] = tr.t_wait
            fetch_start = overhead + tr.t_wait
        else:
            overhead = cfg.pool_fetch_overhead
            t0 = start + overhead
            t_comm = self._transfer(t0, payload)
            if cfg.hedge_factor > 0:
                expected = payload / self.estimator.estimate
                if t_comm > cfg.hedge_factor * expected:
                    # hedged duplicate fetch from a replica
                    t_comm2 = cfg.pool_fetch_overhead + self._transfer(
                        t0 + cfg.hedge_factor * expected, payload)
                    t_comm = min(t_comm,
                                 cfg.hedge_factor * expected + t_comm2)
                    req.retries += 1
            fetch_start = overhead
        req.breakdown["queue"] = sched_wait
        req.breakdown["comm"] = t_comm
        req.breakdown["decompress"] = t_d
        fetch_done = start + fetch_start + t_comm + t_d
        # Coverage of this request's prompt by the stored prefix: by token
        # count for real prefix keys, by KV bytes for synthetic (opaque)
        # keys where the writer's context may be shorter than ours.
        frac = 1.0
        if entry is not None:
            if req.prefix_key is not None \
                    and len(entry.tokens) < len(req.prefix_key):
                frac = len(entry.tokens) / len(req.prefix_key)
            elif entry.kv_bytes > 0 and req.kv_bytes > entry.kv_bytes:
                frac = entry.kv_bytes / req.kv_bytes
        if frac < 1.0:
            # Partial prefix hit: the uncovered prompt suffix still needs
            # a top-up prefill on the prefill pool.
            t_end, q_wait, _ = self._run_on_pool(
                self.prefill, fetch_done, (1.0 - frac) * t_prefill_base, req)
            req.breakdown["queue"] += q_wait
            req.breakdown["prefill"] = t_end - fetch_done - q_wait \
                - req.breakdown.get("retry", 0.0)
            req.ttft = t_end - req.arrival
        else:
            req.ttft = fetch_done - req.arrival
        req.done = req.arrival + req.ttft
        req.slo_violated = req.t_slo > 0 and req.ttft > req.t_slo
        if entry is None:
            # Feedback only when the policy's own choice was exercised —
            # store hits are served at the stored profile.
            self.policy.feedback(ctx, decision, req.ttft)
