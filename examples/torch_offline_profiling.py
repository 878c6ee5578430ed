"""The Offline Profiling stage end-to-end on the PyTorch port: Bayesian
search over the module space on one workload, Pareto distillation, and
the per-bucket policy table (lower envelopes) the online controller uses
(``examples/offline_profiling.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_offline_profiling.py [--device cpu] [--max-iters 30]

The quality model and the KV samples the pipeline is timed on live on
``--device`` (CUDA by default): each candidate's compression runs on the
device where the port has a kernel for it (``hadamard`` for a Hadamard
transform, ``quant_pack`` and ``dequant_unpack`` for per-token uniform
quantization), on the host otherwise.
"""
import argparse

from repro_torch.controller import build_envelope
from repro_torch.launch.profile_offline import search_and_build
from repro_torch.serving.network import GBPS


def main(argv=None, ref=None):
    """Prints the frontier and the piecewise policy; returns ``profiles``,
    ``frontier`` and ``policy`` (per envelope segment: the bandwidth
    range in Gbps and the profile's short name).  ``ref`` is the (cfg,
    params) to profile on in place of the cached reference model."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-iters", type=int, default=30)
    args = ap.parse_args(argv)

    # summlike tolerates compression well; qalike (needle retrieval) is the
    # adversarial case: try workload="qalike", acc_threshold=0.6 to see the
    # constraint bite.
    profiles, frontier = search_and_build(
        level="module", workload="summlike", acc_threshold=0.85,
        max_iters=args.max_iters, verbose=True, ref=ref,
        device=args.device)

    print(f"\n{len(profiles)} measured profiles; "
          f"{len(frontier)} on the 3D Pareto frontier:")
    for pt in sorted(frontier, key=lambda p: -p.cr):
        print(f"  acc={pt.acc:.3f} cr={pt.cr:5.2f} lat/B={pt.lat:.3e}  "
              f"{pt.profile.strategy.short_name()}")

    env = build_envelope([pt.profile for pt in frontier])
    print(f"\npiecewise policy (lower envelope, {len(env.lines)} segments):")
    policy, prev = [], 0.0
    for i, line in enumerate(env.lines):
        hi = env.breaks[i] if i < len(env.breaks) else float("inf")
        lo_b = (1.0 / hi) / GBPS if hi > 0 else float("inf")
        hi_b = (1.0 / prev) / GBPS if prev > 0 else float("inf")
        policy.append((lo_b, hi_b, line.profile.strategy.short_name()))
        print(f"  B in ({lo_b:8.3f}, {hi_b:8.3f}] Gbps -> "
              f"{line.profile.strategy.short_name()}")
        prev = hi
    return {"profiles": profiles, "frontier": frontier, "policy": policy}


if __name__ == "__main__":
    main()
