"""Offline profiling entry point: searches the strategy space with the
Bayesian Profiling Engine, measures (CR, s_enc, s_dec, quality) per
candidate, and distils the 3D Pareto frontier used by the online
controller.

``python -m repro_torch.launch.profile_offline --level module --out profiles.jsonl``

This is the "Offline Profiling" stage of KVServe's three-stage operation
(Fig. 6); the result feeds ``repro_torch.controller.ServiceAwareController``.
It runs on CUDA unless the caller passes ``device="cpu"`` (``--device
cpu``): the quality model, and the KV samples the pipeline is timed on,
live there.  ``ref`` and ``kv_samples`` let a caller profile on a model
and on KV other than the cached ``tiny-lm`` and random samples.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    IDENTITY_PROFILE,
    KVCache,
    Profile,
    StrategyConfig,
    enumerate_space,
    measure_profile,
)
from repro_torch.core.pipeline import DeviceKVCache
from repro_torch.core.profiles import save_profiles
from repro_torch.core.quality import calibrate_head_scores, evaluate_quality, get_reference_model
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.profiling import BOConfig, pareto_frontier, run_bo
from repro_torch.profiling.pareto import ParetoPoint, profile_latency


def default_kv_samples(device="cuda") -> List[KVCache]:
    """The JAX package's two seeded random sample caches, on ``device``."""
    return [DeviceKVCache.from_host(KVCache.random(4, 2, 192, 32, seed=s),
                                    device) for s in range(2)]


def build_profiles(
    strategies: Sequence[StrategyConfig],
    workloads: Sequence[str] = tuple(WORKLOADS),
    kv_samples: Optional[List[KVCache]] = None,
    with_quality: bool = True,
    quality_kwargs: Optional[Dict] = None,
    head_scores=None,
    verbose: bool = False,
    ref=None,
    device="cuda",
) -> List[Profile]:
    """Measure the full profile triple for a set of strategies."""
    if kv_samples is None:
        kv_samples = default_kv_samples(device)
    if with_quality and ref is None:
        ref = get_reference_model(device=device)
    out: List[Profile] = [IDENTITY_PROFILE]
    qk = quality_kwargs or {}
    for i, s in enumerate(strategies):
        qf = (lambda cfg: evaluate_quality(cfg, workloads=workloads, ref=ref,
                                           head_scores=head_scores, **qk)) \
            if with_quality else None
        p = measure_profile(s, kv_samples, quality_fn=qf,
                            head_scores=head_scores)
        out.append(p)
        if verbose:
            q = min(p.quality.values()) if p.quality else 1.0
            print(f"[{i+1}/{len(strategies)}] {s.short_name():42s} "
                  f"cr={p.cr:5.2f} s={p.s_eff/1e6:8.1f}MB/s minq={q:.3f}")
    return out


def search_and_build(
    level: str = "module",
    workload: str = "qalike",
    acc_threshold: float = 0.97,
    max_iters: int = 60,
    seed: int = 0,
    unified: bool = False,
    verbose: bool = False,
    ref=None,
    device="cuda",
    kv_samples: Optional[List[KVCache]] = None,
    quality_kwargs: Optional[Dict] = None,
) -> Tuple[List[Profile], List[ParetoPoint]]:
    """BO search (Alg. 1) on one workload (KVServe-Aware) or the workload
    mix (KVServe-Unified), then Pareto distillation.  ``quality_kwargs``
    (passed to ``evaluate_quality``) size the quality runs."""
    if ref is None:
        ref = get_reference_model(device=device)
    head_scores = calibrate_head_scores(ref=ref)
    space = enumerate_space(level)
    if kv_samples is None:
        kv_samples = default_kv_samples(device)
    workloads = tuple(WORKLOADS) if unified else (workload,)
    qk = quality_kwargs or {}

    cache: Dict[str, Tuple[float, float]] = {}

    def evaluate(cfg: StrategyConfig) -> Tuple[float, float]:
        key = cfg.key()
        if key in cache:
            return cache[key]
        q = evaluate_quality(cfg, workloads=workloads, ref=ref,
                             head_scores=head_scores, **qk)
        p = measure_profile(cfg, kv_samples, head_scores=head_scores)
        acc = float(np.mean(list(q.values())))
        cache[key] = (acc, p.cr)
        if verbose:
            print(f"  eval {cfg.short_name():42s} acc={acc:.3f} cr={p.cr:.2f}")
        return cache[key]

    bo = run_bo(space, evaluate,
                BOConfig(acc_threshold=acc_threshold, max_iters=max_iters,
                         seed=seed))
    feas_cfgs = [o.cfg for o in bo.feasible]
    profiles = build_profiles(feas_cfgs, workloads=workloads,
                              kv_samples=kv_samples, quality_kwargs=qk,
                              head_scores=head_scores, verbose=verbose,
                              ref=ref)
    pts = [ParetoPoint(acc=p.q(workload), cr=p.cr,
                       lat=profile_latency(p, 1e9), profile=p)
           for p in profiles]
    frontier = pareto_frontier(pts)
    return profiles, frontier


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", default="module",
                    choices=["pipeline", "module", "hybrid"])
    ap.add_argument("--workload", default="qalike")
    ap.add_argument("--unified", action="store_true")
    ap.add_argument("--acc-threshold", type=float, default=0.97)
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--out", default="profiles.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t0 = time.time()
    profiles, frontier = search_and_build(
        level=args.level, workload=args.workload, unified=args.unified,
        acc_threshold=args.acc_threshold, max_iters=args.max_iters,
        seed=args.seed, verbose=True, device=args.device)
    save_profiles(profiles, args.out)
    print(f"\n{len(profiles)} profiles ({len(frontier)} on the 3D Pareto "
          f"frontier) -> {args.out} in {time.time()-t0:.1f}s")
    for pt in sorted(frontier, key=lambda p: -p.cr)[:10]:
        print(f"  acc={pt.acc:.3f} cr={pt.cr:5.2f} lat/B={pt.lat:.3e} "
              f"{pt.profile.strategy.short_name()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
