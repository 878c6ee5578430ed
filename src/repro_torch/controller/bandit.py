"""Residual-Corrected Bandit (Sec. 6.2).

Per (quality-bucket b, envelope-interval i) environment:
  - EWMA residual  δ̄ ← (1-α)δ̄ + α(T_obs - T̂_p)        (Eq. 7)
  - corrected latency  T_eff = T̂_p + δ̄                 (Eq. 8)
  - ε-greedy over the 2-3 profile candidate set
  - safety guardrails: conservative feasibility filter T̂_p ≤ T_SLO with a
    conservative fallback, and a violation cooldown (K violations in the
    last M uses -> quarantined for a cooldown window).
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
from repro_torch.controller.latency_model import ServiceContext, predicted_latency


@dataclass
class BanditConfig:
    alpha: float = 0.2          # EWMA tracking speed
    epsilon: float = 0.08       # exploration probability
    violation_k: int = 3        # K violations ...
    violation_m: int = 10       # ... in the last M uses
    cooldown_steps: int = 25    # quarantine window
    seed: int = 0


@dataclass
class _ArmState:
    residual: float = 0.0
    count: int = 0
    recent_violations: Deque[bool] = field(default_factory=lambda: deque(maxlen=10))
    cooldown_until: int = -1


class ResidualBandit:
    """One instance per (workload, quality bucket); environments keyed by
    envelope interval."""

    def __init__(self, config: BanditConfig = BanditConfig()):
        self.config = config
        self._arms: Dict[Tuple[int, str], _ArmState] = {}
        self._step = 0
        self._rng = random.Random(config.seed)

    def _arm(self, interval: int, p: Profile) -> _ArmState:
        key = (interval, p.strategy.key())
        if key not in self._arms:
            self._arms[key] = _ArmState(
                recent_violations=deque(maxlen=self.config.violation_m))
        return self._arms[key]

    # ------------------------------------------------------------------
    def select(self, interval: int, candidates: List[Profile],
               ctx: ServiceContext) -> Profile:
        """ε-greedy over corrected latencies with safety guardrails."""
        self._step += 1
        usable = []
        best_effort = []
        for p in candidates:
            arm = self._arm(interval, p)
            if arm.cooldown_until >= self._step:
                continue  # quarantined after repeated SLO violations
            t_hat = predicted_latency(p, ctx)
            best_effort.append((p, t_hat + arm.residual))
            if ctx.t_slo > 0 and t_hat > ctx.t_slo:
                continue  # conservative feasibility filter
            usable.append((p, t_hat + arm.residual))

        if not usable:
            # Paper Sec 6.2: empty feasible set -> fall back to a default
            # conservative *compression* configuration (best-effort minimum
            # predicted latency), never to shipping raw KV.
            if best_effort:
                return min(best_effort, key=lambda pt: pt[1])[0]
            return IDENTITY_PROFILE

        greedy = min(usable, key=lambda pt: pt[1])
        if self._rng.random() < self.config.epsilon and len(usable) > 1:
            # Explore a non-greedy arm: exclude the corrected-latency argmin
            # (usable is in candidate order, so usable[1:] would exclude an
            # arbitrary arm instead).
            return self._rng.choice(
                [pt for pt in usable if pt is not greedy])[0]
        return greedy[0]

    # ------------------------------------------------------------------
    def update(self, interval: int, p: Profile, ctx: ServiceContext,
               observed_latency: float,
               predicted: Optional[float] = None) -> None:
        """EWMA-track the residual of the prediction that was *acted on*:
        pass ``predicted`` (the select-time ``Decision.predicted``) so a
        bandwidth estimate that drifted between select and observe cannot
        make the residual correct a prediction nobody acted on; without it
        the prediction is recomputed from ``ctx`` (legacy behaviour)."""
        arm = self._arm(interval, p)
        t_hat = predicted if predicted is not None \
            else predicted_latency(p, ctx)
        delta = observed_latency - t_hat
        a = self.config.alpha
        arm.residual = (1 - a) * arm.residual + a * delta
        arm.count += 1

        violated = ctx.t_slo > 0 and observed_latency > ctx.t_slo
        arm.recent_violations.append(violated)
        if (sum(arm.recent_violations) >= self.config.violation_k
                and len(arm.recent_violations) >= self.config.violation_k):
            arm.cooldown_until = self._step + self.config.cooldown_steps
            arm.recent_violations.clear()

    # ------------------------------------------------------------------
    def residual_of(self, interval: int, p: Profile) -> float:
        return self._arm(interval, p).residual
