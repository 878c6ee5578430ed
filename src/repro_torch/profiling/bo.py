"""Algorithm 1: Constraint-Aware Bayesian Optimization with Gaussian
Processes (Sec. 5.2).

    max_c CR(c)   s.t.  Acc(c) >= Acc_threshold

over the heterogeneous strategy space, with the paper's four engine
optimizations: heterogeneous-parameter encoding, decaying
exploration-exploitation weight λ_t, bi-directional pruning on the monotone
CR–Acc trade-off, and early stopping.  ``evaluate_fn`` runs the expensive
end-to-end profiling (sampled-subset accuracy + measured CR); the engine
minimises how often it is called.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.strategy import StrategyConfig, estimate_cr
from repro_torch.profiling.encoding import encode_batch
from repro_torch.profiling.gp import GaussianProcess


@dataclass
class BOConfig:
    acc_threshold: float = 0.97      # relative accuracy constraint
    prune_eps: float = 0.25          # ε pruning buffer (in CR units)
    max_iters: int = 300
    max_consecutive_failures: int = 25
    lambda0: float = 1.0             # initial exploration weight
    lambda_decay: float = 0.97       # λ_t = λ0 * decay^t
    hard_fail_margin: float = 0.10   # "Acc << thres" margin for pruning
    seed: int = 0
    # ablations (Sec. 7.4)
    use_encoding: bool = True
    use_exploration: bool = True
    use_pruning: bool = True
    use_early_stop: bool = True


@dataclass
class Observation:
    cfg: StrategyConfig
    acc: float
    cr: float
    feasible: bool


@dataclass
class BOResult:
    feasible: List[Observation]
    history: List[Observation]
    iterations: int
    best: Optional[Observation]
    evaluations: int

    def best_cr(self) -> float:
        return self.best.cr if self.best else 0.0


def run_bo(
    space: Sequence[StrategyConfig],
    evaluate_fn: Callable[[StrategyConfig], Tuple[float, float]],
    config: BOConfig = BOConfig(),
) -> BOResult:
    """evaluate_fn(cfg) -> (acc, cr): the expensive end-to-end profiling."""
    rng = np.random.default_rng(config.seed)
    space = list(space)
    n = len(space)

    if config.use_encoding:
        emb = encode_batch(space)
    else:
        # ablation: naive integer indexing (no structural similarity)
        emb = np.arange(n, dtype=np.float64)[:, None] / max(n - 1, 1)

    est_cr = np.asarray([estimate_cr(c) for c in space])
    est_cr_norm = est_cr / max(est_cr.max(), 1e-9)

    alive = np.ones(n, dtype=bool)
    evaluated = np.zeros(n, dtype=bool)

    gp = GaussianProcess(length_scale=math.sqrt(emb.shape[1]) * 0.5)
    xs: List[np.ndarray] = []
    ys: List[float] = []

    history: List[Observation] = []
    feasible: List[Observation] = []
    k_fail = 0
    it = 0

    for it in range(1, config.max_iters + 1):
        cand_idx = np.nonzero(alive & ~evaluated)[0]
        if len(cand_idx) == 0:
            break

        lam = config.lambda0 * (config.lambda_decay ** it) \
            if config.use_exploration else 0.0

        if xs:
            gp.fit(np.stack(xs), np.asarray(ys))
            p_feas = gp.prob_greater(emb[cand_idx], config.acc_threshold)
            _, std = gp.predict(emb[cand_idx])
            std_norm = std / max(std.max(), 1e-9)
        else:
            p_feas = np.full(len(cand_idx), 0.5)
            std_norm = np.ones(len(cand_idx))

        # Acquisition (Eq. 4): exploitation = CR * P(feasible); exploration
        # = λ_t * normalized posterior std.
        af = est_cr_norm[cand_idx] * p_feas + lam * std_norm
        pick = cand_idx[int(np.argmax(af + rng.normal(0, 1e-9, len(af))))]

        acc, cr = evaluate_fn(space[pick])
        evaluated[pick] = True
        obs = Observation(space[pick], acc, cr, acc >= config.acc_threshold)
        history.append(obs)
        xs.append(emb[pick])
        ys.append(acc)

        if obs.feasible:
            feasible.append(obs)
            k_fail = 0
            if config.use_pruning:
                # discard lower-CR candidates: they cannot beat this one
                alive &= ~((est_cr < cr - config.prune_eps) & ~evaluated)
        else:
            k_fail += 1
            if config.use_pruning and \
                    acc < config.acc_threshold - config.hard_fail_margin:
                # Acc << thres: higher-CR candidates are hopeless too
                alive &= ~((est_cr > cr + config.prune_eps) & ~evaluated)

        if config.use_early_stop:
            if k_fail >= config.max_consecutive_failures:
                break
            if not (alive & ~evaluated).any():
                break

    best = max(feasible, key=lambda o: o.cr) if feasible else None
    return BOResult(feasible=feasible, history=history, iterations=it,
                    best=best, evaluations=len(history))


def run_random_search(
    space: Sequence[StrategyConfig],
    evaluate_fn: Callable[[StrategyConfig], Tuple[float, float]],
    config: BOConfig = BOConfig(),
) -> BOResult:
    """Baseline for the ablation: uniform random sampling, same budget."""
    rng = np.random.default_rng(config.seed)
    order = rng.permutation(len(space))[: config.max_iters]
    history, feasible = [], []
    for i, idx in enumerate(order, start=1):
        acc, cr = evaluate_fn(space[idx])
        obs = Observation(space[idx], acc, cr, acc >= config.acc_threshold)
        history.append(obs)
        if obs.feasible:
            feasible.append(obs)
    best = max(feasible, key=lambda o: o.cr) if feasible else None
    return BOResult(feasible=feasible, history=history,
                    iterations=len(history), best=best,
                    evaluations=len(history))
