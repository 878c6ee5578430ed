"""End-to-end driver on the PyTorch port: serve the (trained) tiny
reference model through the REAL PD-disaggregated *continuous* runtime, a
prefill stream and a decode stream joined by a serialized compressed-KV
wire, with the full KVServe stack (offline profiles -> service-aware
controller -> bandit feedback) (``examples/pd_serving_e2e.py`` on
``repro_torch``).

Each cold request's critical path is prefill -> controller-selected
compress -> wire transfer -> decompress -> decode arena; repeated prompts
hit the decode-side prefix pool instead.  A mid-run bandwidth drop shows
the controller switching profiles on the live goodput estimate.

    PYTHONPATH=src python examples/torch_pd_serving_e2e.py [--device cpu]

The model, its KV and the profiling samples live on ``--device`` (CUDA
by default).  The runtime serves on the dense arena and the profiles are
per-channel, as in the JAX script: no port kernel is on this path.
"""
import argparse

import numpy as np

from repro_torch.controller import ServiceAwareController
from repro_torch.core.strategy import BASELINES, StrategyConfig
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.profile_offline import build_profiles
from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

STRATEGIES = [
    BASELINES["kivi"], BASELINES["cachegen"], BASELINES["mixhq"],
    StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                   granularity="per_channel"),
    StrategyConfig(quantizer="uniform", key_bits=4, value_bits=4,
                   granularity="per_channel", codec="zstd3"),
]


def main(argv=None, ref=None):
    """Prints the profiling lines, the per-request table, the summary and
    a generated sample; returns ``profiles``, ``runtime`` (the served
    :class:`ServingRuntime`), ``requests`` (the table's rows) and
    ``summary``.  ``ref`` is the (cfg, params) to profile and serve in
    place of the cached reference model."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--quality-prompts", type=int, default=4)
    args = ap.parse_args(argv)

    print("== offline profiling (measured CR/throughput/quality) ==")
    profiles = build_profiles(
        STRATEGIES, quality_kwargs={"n_prompts": args.quality_prompts,
                                    "decode_tokens": 12},
        verbose=True, ref=ref, device=args.device)

    controller = ServiceAwareController({w: profiles for w in WORKLOADS})
    # bandwidth drops mid-run (virtual-clock seconds): watch the
    # controller switch profiles once the goodput estimate catches up
    trace = BandwidthTrace.steps(
        [(0.0, 0.2 * GBPS), (0.15, 0.002 * GBPS), (1.4, 0.2 * GBPS)],
        jitter=0.1, seed=0)
    rt = ServingRuntime(
        controller=controller,
        config=RuntimeConfig(seq=96, decode_tokens=16,
                             prefill_tok_s=2000.0, decode_tok_s=500.0,
                             mode="pd"),
        trace=trace,
        scheduler=SchedulerConfig(max_slots=6, max_prefills_per_step=2,
                                  max_queue=64),
        device=args.device)
    if ref is not None:
        rt.model_cfg, rt.params = ref

    print("\n== continuous PD serving across the bandwidth drop ==")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        w = list(WORKLOADS)[int(rng.integers(0, 4))]
        # a few repeated prompt seeds => decode-side prefix-pool hits
        rt.submit(w, q_min=0.3, prompt_seed=int(rng.integers(0, 12)))
        rt.step()
    done = rt.run()

    rows = []
    print(f"{'arr':>5s} {'workload':10s} {'chosen profile':42s} {'hit':>3s} "
          f"{'jct':>7s} {'comm':>7s} {'ttft':>7s}")
    for r in sorted(done, key=lambda r: r.arrival):
        rows.append({"rid": r.rid, "arrival": r.arrival,
                     "workload": r.workload, "profile": r.profile,
                     "pool_hit": bool(r.pool_hit), "jct": r.jct,
                     "comm": r.breakdown.get("comm", 0.0), "ttft": r.ttft})
        print(f"{r.arrival:5.1f} {r.workload:10s} {r.profile:42s} "
              f"{'y' if r.pool_hit else 'n':>3s} {r.jct:7.3f} "
              f"{r.breakdown.get('comm', 0.0):7.3f} {r.ttft:7.3f}")

    s = rt.summary()
    print(f"\nsummary: completed={s['completed']:.0f} "
          f"pool_hit_rate={s['pool_hit_rate']:.2f} "
          f"mean_jct={s['mean_jct']:.3f}s "
          f"wire={s['wire_bytes_moved']/1e6:.2f}MB over "
          f"{s['wire_transfers']:.0f} transfers")
    print("\ngenerated sample (decode-stream output):")
    print(" ", repr(done[-1].text[:60]))
    return {"profiles": profiles, "runtime": rt, "requests": rows,
            "summary": s}


if __name__ == "__main__":
    main()
