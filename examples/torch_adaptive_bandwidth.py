"""Fig-16-right style demo on the PyTorch port: the online controller +
residual bandit under a fluctuating bandwidth trace, vs static baselines
(``examples/adaptive_bandwidth.py`` on ``repro_torch``; simulator-based,
fast).

    PYTHONPATH=src python examples/torch_adaptive_bandwidth.py [--device cpu]

The simulator and the controller run on the host, so ``--device`` has
nothing to place: the script runs no model and no kernel.
"""
import argparse

import numpy as np

from repro_torch.controller import ServiceAwareController
from repro_torch.core.profiles import Profile
from repro_torch.core.strategy import StrategyConfig
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.serving import (
    GBPS,
    BandwidthTrace,
    KVServePolicy,
    NoCompressionPolicy,
    SimConfig,
    Simulator,
    StaticPolicy,
    WorkloadMix,
)


def synthetic_profiles():
    rng = np.random.default_rng(7)
    out = []
    for i in range(16):
        cr = float(rng.uniform(1.5, 9.0))
        s = float(rng.uniform(5e8, 2e10))
        q = {w: float(np.clip(1.0 - 0.005 * cr**1.5, 0, 1)) for w in WORKLOADS}
        out.append(Profile(StrategyConfig(key_bits=2 + (i % 7),
                                          group_size=(32, 64, 128)[i % 3]),
                           cr=cr, s_enc=2 * s, s_dec=2 * s, quality=q))
    return out


def main(argv=None):
    """Prints the policy table; returns {policy: SimResult}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.parse_args(argv)

    profiles = synthetic_profiles()
    trace = lambda: BandwidthTrace.steps(
        [(0.0, 2 * GBPS), (20.0, 0.05 * GBPS), (40.0, 2 * GBPS)],
        jitter=0.2, seed=3)
    reqs = lambda: WorkloadMix(rate=1.5, seed=0, q_min=0.0).generate(80)

    rows = {}
    rows["default"] = Simulator(SimConfig(), NoCompressionPolicy(), trace(),
                                reqs()).run()
    best_static = max(profiles, key=lambda p: p.cr)
    rows["static-maxcr"] = Simulator(SimConfig(),
                                     StaticPolicy(best_static, "s"),
                                     trace(), reqs()).run()
    for name, kw in [("kvserve", {}),
                     ("kvserve(no bandit)", dict(use_bandit=False)),
                     ("kvserve(no controller)", dict(use_bandit=False,
                                                     use_envelope=False))]:
        c = ServiceAwareController({w: profiles for w in WORKLOADS}, **kw)
        rows[name] = Simulator(SimConfig(estimator_alpha=0.5),
                               KVServePolicy(c), trace(), reqs()).run()

    print(f"{'policy':24s} {'mean JCT':>9s} {'p95':>9s}")
    for name, res in rows.items():
        print(f"{name:24s} {res.mean_jct():9.2f} {res.p95_jct():9.2f}")
    return rows


if __name__ == "__main__":
    main()
