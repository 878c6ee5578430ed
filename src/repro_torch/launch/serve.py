"""Serving launcher: drives the real-execution disaggregated engine with
the Service-Aware Controller over a bandwidth trace.

``python -m repro_torch.launch.serve --requests 12 --bandwidth-gbps 1``

Runs on CUDA unless the caller passes ``--device cpu``; ``main``'s
``ref`` and ``kv_samples`` serve and profile a model and KV other than
the cached ``tiny-lm`` and random samples.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.controller import ServiceAwareController
from repro_torch.core.profiles import load_profiles
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.serving.engine import DisaggregatedEngine
from repro_torch.serving.network import GBPS, BandwidthTrace


def main(argv=None, ref=None, kv_samples=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", default="",
                    help="profiles.jsonl from profile_offline (else built-in)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--bandwidth-gbps", type=float, default=1.0)
    ap.add_argument("--slo", type=float, default=0.0)
    ap.add_argument("--q-min", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.profiles:
        profiles = load_profiles(args.profiles)
    else:
        from repro_torch.launch.profile_offline import build_profiles
        from repro_torch.core.strategy import BASELINES
        profiles = build_profiles(list(BASELINES.values()),
                                  quality_kwargs={"n_prompts": 4,
                                                  "decode_tokens": 12},
                                  ref=ref, device=args.device,
                                  kv_samples=kv_samples)

    controller = ServiceAwareController(
        {w: profiles for w in WORKLOADS})
    engine = DisaggregatedEngine(controller=controller, ref=ref,
                                 device=args.device)
    trace = BandwidthTrace.constant(args.bandwidth_gbps * GBPS)

    rng = np.random.default_rng(args.seed)
    names = list(WORKLOADS)
    print(f"{'workload':10s} {'profile':40s} {'jct':>8s} {'comm':>8s} "
          f"{'agree':>6s} {'wire':>10s}")
    for i in range(args.requests):
        w = names[int(rng.integers(0, len(names)))]
        res = engine.serve(w, trace, t_slo=args.slo, q_min=args.q_min,
                           seed=args.seed * 1000 + i)
        print(f"{w:10s} {res.profile:40s} {res.jct:8.3f} {res.t_comm:8.3f} "
              f"{res.agreement:6.3f} {res.wire_bytes:10d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
