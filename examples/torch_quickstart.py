"""Quickstart on the PyTorch port: compress a KV cache with the unified
pipeline, inspect CR and error, and pick a profile with the analytical
controller (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The KV cache lives on ``--device`` (CUDA by default): the Hadamard stage
of ``mixhq`` and of ``hadamard+4bit+zstd`` runs there as the port's
``hadamard`` kernel, forward and inverse.  Every strategy here quantizes
on the host: ``hadamard+4bit+zstd`` is asymmetric (zero points, as in
the JAX script), and the port's ``quant_pack`` is the symmetric Pallas
kernel's counterpart.
"""
import argparse

import numpy as np

from repro_torch.controller import (
    ServiceContext,
    bandwidth_threshold,
    build_envelope,
    predicted_latency,
)
from repro_torch.core import (
    BASELINES,
    CompressionPipeline,
    KVCache,
    StrategyConfig,
    measure_profile,
)
from repro_torch.core.pipeline import DeviceKVCache
from repro_torch.serving.network import GBPS

STRATEGIES = {
    "kivi-2bit": BASELINES["kivi"],
    "cachegen": BASELINES["cachegen"],
    "mixhq": BASELINES["mixhq"],
    "hadamard+4bit+zstd": StrategyConfig(
        transform="hadamard", quantizer="uniform", key_bits=4,
        value_bits=4, granularity="per_token", codec="zstd3"),
}
BANDWIDTHS_GBPS = (0.02, 0.2, 2.0)


def _host(kv) -> np.ndarray:
    k = kv.k
    return k if isinstance(k, np.ndarray) else k.float().cpu().numpy()


def main(argv=None):
    """Prints the tables; returns them as data: ``rows`` (per strategy:
    cr, wire bytes, mean |K error|, encode and decode seconds),
    ``profiles``, ``thresholds`` (B* per profile, bytes/s) and
    ``choices`` (per bandwidth: the optimal profile and its predicted
    seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- 1. a KV cache (use your own (L, H, S, D) tensors in practice) ---
    host = KVCache.random(num_layers=8, kv_heads=4, seq=512, head_dim=64,
                          seed=0)
    kv = DeviceKVCache.from_host(host, args.device)
    print(f"KV cache: {tuple(kv.shape)}, {kv.nbytes_wire()/1e6:.1f} MB on the "
          f"wire, on {args.device}")

    # --- 2. compress with a few strategies from the modular pool ---
    rows, profiles = [], []
    for name, cfg in STRATEGIES.items():
        pipe = CompressionPipeline(cfg, device=args.device)
        restored, comp, t_enc, t_dec = pipe.roundtrip(kv)
        err = float(np.abs(_host(restored) - host.k).mean())
        rows.append({"name": name, "cr": comp.compression_ratio(),
                     "wire_bytes": comp.total_bytes(), "mae": err,
                     "t_enc": t_enc, "t_dec": t_dec})
        print(f"{name:22s} cr={comp.compression_ratio():5.2f}x "
              f"wire={comp.total_bytes()/1e6:6.2f}MB mae={err:.4f} "
              f"enc={t_enc*1e3:.0f}ms dec={t_dec*1e3:.0f}ms")
        profiles.append(measure_profile(cfg, [kv]))

    # --- 3. the service-aware selection (Theorems 6.1/6.2) ---
    env = build_envelope(profiles)
    thresholds = []
    print("\nbandwidth thresholds B* (compression helps only below):")
    for p in profiles:
        thresholds.append(bandwidth_threshold(p))
        print(f"  {p.strategy.short_name():40s} "
              f"B*={thresholds[-1]/GBPS:.3f} Gbps(scaled)")
    choices = []
    for gbps in BANDWIDTHS_GBPS:
        ctx = ServiceContext("qalike", gbps * GBPS, t_slo=0.0, q_min=0.0,
                             kv_bytes=kv.nbytes_wire())
        best = env.optimal(1.0 / ctx.bandwidth)
        choices.append({"gbps": gbps, "profile": best.strategy.short_name(),
                        "t_pred": predicted_latency(best, ctx)})
        print(f"B={gbps:5.2f} Gbps -> optimal: "
              f"{best.strategy.short_name():40s} "
              f"T_pred={choices[-1]['t_pred']*1e3:.1f} ms")
    return {"rows": rows, "profiles": profiles, "thresholds": thresholds,
            "choices": choices}


if __name__ == "__main__":
    main()
