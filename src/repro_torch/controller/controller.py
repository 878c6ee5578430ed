"""The Service-Aware Online Controller (Sec. 6) — ties together:

  1. quality bucketing (restrict to profiles meeting the request's q_min),
  2. Theorem 6.1 benefit filter (drop non-beneficial profiles at current B),
  3. Theorem 6.2 lower-envelope O(1) lookup + neighbour candidate set,
  4. the residual-corrected ε-greedy bandit with SLO guardrails.

``select`` is the <1 ms control-plane decision made at each KV-movement
boundary; ``observe`` feeds runtime JCT back for residual correction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
from repro_torch.controller.bandit import BanditConfig, ResidualBandit
from repro_torch.controller.envelope import LowerEnvelope, build_envelope
from repro_torch.controller.latency_model import (
    ServiceContext,
    TierFetch,
    bandwidth_threshold,
    baseline_latency,
    is_beneficial,
    predicted_latency,
    speculative_decode_latency,
    tier_fetch_latency,
)

# Quality buckets by *relative accuracy loss* (Sec. 6.1: "bucket profiles by
# accuracy loss and restrict selection to the matching bucket").  A request
# with budget q_min maps to the coarsest bucket whose floor still covers it.
DEFAULT_BUCKETS: Tuple[float, ...] = (0.99, 0.97, 0.95, 0.90, 0.80, 0.70,
                                      0.50, 0.0)


@dataclass
class Decision:
    profile: Profile
    interval: int
    bucket: int
    predicted: float
    candidates: List[Profile] = field(default_factory=list)
    # Speculation length for the request's decode (DESIGN.md §15): the
    # draft budget k minimizing the modelled decode-stream time at the
    # (workload, route) accept-rate estimate.  0 = plain decode; the
    # runtime caps it at its own cfg.spec_k.
    spec_k: int = 0


@dataclass
class FetchDecision:
    """Outcome of :meth:`ServiceAwareController.select_fetch`."""

    option: TierFetch
    predicted: float
    candidates: List[TierFetch] = field(default_factory=list)


class ServiceAwareController:
    def __init__(
        self,
        profiles_by_workload: Dict[str, Sequence[Profile]],
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
        bandit_config: BanditConfig = BanditConfig(),
        use_bandit: bool = True,
        use_envelope: bool = True,
        spec_candidates: Sequence[int] = (0,),
        spec_accept_prior: float = 0.5,
        spec_accept_alpha: float = 0.2,
    ):
        self.buckets = buckets
        self.use_bandit = use_bandit
        self.use_envelope = use_envelope
        self._bandit_config = bandit_config
        # Adaptive speculation length (DESIGN.md §15).  The candidate set
        # defaults to (0,) — zero behavioural change for existing
        # deployments; a runtime enabling spec_adaptive passes e.g.
        # (0, 2, 4).  Accept rates are tracked per (workload, route) as an
        # EWMA residual around the optimistic prior: routes drift
        # independently (different hardware mixes repeat differently),
        # exactly like the latency bandits above.
        self.spec_candidates = tuple(spec_candidates)
        self._spec_prior = spec_accept_prior
        self._spec_alpha = spec_accept_alpha
        self._accept_rates: Dict[Tuple[str, str], float] = {}
        # Per (workload, bucket): lower envelope built offline.  Envelopes
        # are route-independent (profiles are an offline property); bandit
        # state is NOT — see _bandit_for.
        self._envelopes: Dict[Tuple[str, int], LowerEnvelope] = {}
        self._bandits: Dict[Tuple[str, int, str], ResidualBandit] = {}
        self._profiles = profiles_by_workload
        for w, profs in profiles_by_workload.items():
            for bi, q_floor in enumerate(buckets):
                eligible = [p for p in profs if p.q(w) >= q_floor]
                self._envelopes[(w, bi)] = build_envelope(eligible)
                self._bandits[(w, bi, "")] = ResidualBandit(bandit_config)

    # ------------------------------------------------------------------
    def _bandit_for(self, workload: str, bucket: int,
                    route: str) -> ResidualBandit:
        """Per-(workload, bucket, route) residual bandit, created lazily
        for routes first seen online: each link of a multi-worker cluster
        drifts independently (congestion, outages), so its residual
        corrections must not be polluted by other links' observations.
        Route "" (single-link deployments) keeps the offline-built state.
        """
        key = (workload, bucket, route)
        bandit = self._bandits.get(key)
        if bandit is None:
            bandit = ResidualBandit(self._bandit_config)
            self._bandits[key] = bandit
        return bandit

    # ------------------------------------------------------------------
    def _bucket_of(self, q_min: float) -> int:
        """Strictest bucket whose floor covers ``q_min`` (bucket 0 when
        ``q_min`` exceeds every floor — the strictest available; ``select``
        then filters candidates by ``q_min`` itself, so a budget above the
        top floor never silently admits profiles below it)."""
        best = 0
        for bi, floor in enumerate(self.buckets):
            if floor >= q_min:
                best = bi       # floors descend: keep the coarsest cover
            else:
                break
        return best

    # ------------------------------------------------------------------
    @staticmethod
    def _eligible_candidates(env: LowerEnvelope, x: float,
                             ctx: ServiceContext) -> List[Profile]:
        """The envelope's neighbour candidate set, filtered by Theorem 6.1
        (drop non-beneficial profiles at the current bandwidth) and by the
        request's OWN q_min (not just the bucket floor: a q_min above the
        top floor must not admit profiles below it).  Shared by ``select``
        and ``predict`` so routing scores the same candidate set selection
        draws from."""
        candidates = [p for p in env.candidates(x, n_neighbors=1)
                      if (p.cr <= 1.0 or is_beneficial(p, ctx.bandwidth))
                      and (p.cr <= 1.0 or p.q(ctx.workload) >= ctx.q_min)]
        return candidates or [IDENTITY_PROFILE]

    def select(self, ctx: ServiceContext) -> Decision:
        bucket = self._bucket_of(ctx.q_min)
        spec_k = self._choose_spec_k(ctx)
        env = self._envelopes.get((ctx.workload, bucket))
        if env is None or not env.lines:
            # Identity fallback: predicted must be comparable with the
            # other branches' predicted_latency (t_model included), or the
            # bandit's residuals for this arm absorb the whole model time.
            return Decision(IDENTITY_PROFILE, 0, bucket,
                            baseline_latency(ctx), spec_k=spec_k)

        x = 1.0 / max(ctx.bandwidth, 1e-9)
        if not self.use_envelope:
            # ablation: pick max-CR profile regardless of service state
            profs = [l.profile for l in env.lines]
            p = max(profs, key=lambda q: q.cr)
            return Decision(p, 0, bucket, predicted_latency(p, ctx), [p],
                            spec_k=spec_k)

        interval = env.optimal_index(x)
        candidates = self._eligible_candidates(env, x, ctx)

        if self.use_bandit:
            bandit = self._bandit_for(ctx.workload, bucket, ctx.route)
            p = bandit.select(interval, candidates, ctx)
        else:
            p = min(candidates, key=lambda q: predicted_latency(q, ctx))

        return Decision(p, interval, bucket, predicted_latency(p, ctx),
                        candidates, spec_k=spec_k)

    # ------------------------------------------------------------------
    # Adaptive speculation length (DESIGN.md §15)
    # ------------------------------------------------------------------
    def accept_rate(self, workload: str, route: str) -> float:
        """The controller's per-draft acceptance estimate for
        (workload, route): the optimistic prior until the first
        observation, then an EWMA of realized per-request accept rates."""
        return self._accept_rates.get((workload, route), self._spec_prior)

    def observe_accept(self, workload: str, route: str,
                       rate: float) -> None:
        """Feed one finished request's realized per-draft accept rate
        (drafts_accepted / drafts_offered) back into the (workload,
        route) EWMA — the accept-rate analogue of the latency bandit's
        residual update.  The latency residuals themselves also see
        speculative requests' realized JCTs per route, so systematic
        accept mis-estimates are additionally absorbed there."""
        rate = min(max(rate, 0.0), 1.0)
        key = (workload, route)
        prev = self._accept_rates.get(key)
        self._accept_rates[key] = (rate if prev is None else
                                   (1 - self._spec_alpha) * prev
                                   + self._spec_alpha * rate)

    def _choose_spec_k(self, ctx: ServiceContext) -> int:
        """Pick the draft budget minimizing the modelled decode-stream
        time over ``spec_candidates`` at the (workload, route) accept
        estimate.  Ties break toward smaller k — at accept rate 0 the
        model collapses every candidate to the baseline and k = 0 wins,
        the required fall-back-to-plain-decode behaviour.  ``decode_time``
        only scales the objective, so an unknown (0) decode time still
        ranks candidates correctly — substitute 1s."""
        cands = self.spec_candidates
        if len(cands) <= 1:
            return cands[0] if cands else 0
        r = self.accept_rate(ctx.workload, ctx.route)
        d = ctx.decode_time if ctx.decode_time > 0 else 1.0
        return min(cands,
                   key=lambda k: (speculative_decode_latency(d, k, r), k))

    # ------------------------------------------------------------------
    def select_fetch(self, ctx: ServiceContext,
                     options: Sequence[TierFetch]
                     ) -> Optional[FetchDecision]:
        """Tier-aware fetch routing (ISSUE 4): pick the materialization
        route with the smallest tier-aware fetch term — e.g. trade
        "fetch the stored encoding from DRAM" against "refetch a smaller
        re-encoding" that pays encode time to cross a slow link with
        fewer bytes.  (Min-latency choice also maximizes SLO feasibility:
        if the argmin misses the deadline, every route does.)"""
        opts = list(options)
        if not opts:
            return None
        scored = [(tier_fetch_latency(o), o) for o in opts]
        t, o = min(scored, key=lambda pair: pair[0])
        return FetchDecision(o, t, opts)

    # ------------------------------------------------------------------
    def observe(self, ctx: ServiceContext, decision: Decision,
                observed_latency: float) -> None:
        if not self.use_bandit:
            return
        # Residuals correct the prediction that was ACTED ON: the
        # select-time Decision.predicted, not a recomputation from the
        # observe-time context (whose bandwidth estimate may have
        # drifted since the decision).  The feedback lands on the SAME
        # per-route bandit select() consulted (ctx carries the route).
        bandit = self._bandit_for(ctx.workload, decision.bucket, ctx.route)
        bandit.update(decision.interval, decision.profile, ctx,
                      observed_latency, predicted=decision.predicted)

    # ------------------------------------------------------------------
    def predict(self, ctx: ServiceContext) -> float:
        """Side-effect-free predicted latency of the profile the envelope
        would choose for ``ctx`` — the routing layer's view of a route's
        KV-movement cost.  Touches neither the bandit state nor its RNG
        (``select`` advances both), so probing every candidate route per
        request is safe."""
        bucket = self._bucket_of(ctx.q_min)
        env = self._envelopes.get((ctx.workload, bucket))
        if env is None or not env.lines:
            return baseline_latency(ctx)
        x = 1.0 / max(ctx.bandwidth, 1e-9)
        if not self.use_envelope:
            # mirror select()'s ablation: the router must score the
            # profile the controller will actually pick (max CR)
            p = max((l.profile for l in env.lines), key=lambda q: q.cr)
            return predicted_latency(p, ctx)
        candidates = self._eligible_candidates(env, x, ctx)
        return min(predicted_latency(p, ctx) for p in candidates)
