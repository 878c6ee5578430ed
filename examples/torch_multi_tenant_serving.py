"""Multi-tenant continuous-batching serving with a compressed prefix-KV
pool on the PyTorch port (``examples/multi_tenant_serving.py`` on
``repro_torch``; DESIGN.md §9).

Two tenants share one runtime: an *interactive* tenant (chat-style, tight
TTFT expectations) and a *batch* tenant (offline summarization).  The
scheduler orders admissions by SLO class, the Service-Aware Controller
picks a compression profile per pool write, and repeated prompts are
served straight from the compressed prefix pool: real bytes, real
decompression, real decode on the tiny reference model, on ``--device``
(CUDA by default).

    PYTHONPATH=src python examples/torch_multi_tenant_serving.py [--device cpu]

The runtime serves on the dense arena, as the JAX script's does, and its
profiles are per-channel: no port kernel is on this path (the paged arena
and the per-token profiles carry ``paged_attention``, ``quant_pack`` and
``dequant_unpack``).  Loads the tiny reference LM from its cache, or
trains it on first use (~15 s on an H100).
"""
import argparse

from repro_torch.controller import ServiceAwareController
from repro_torch.core.kvcache import KVCache
from repro_torch.core.pipeline import DeviceKVCache
from repro_torch.core.profiles import measure_profile
from repro_torch.core.strategy import BASELINES, IDENTITY_STRATEGY, StrategyConfig
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

STRATEGIES = [
    IDENTITY_STRATEGY,
    BASELINES["kivi"],
    StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                   granularity="per_channel", codec="zstd3"),
    StrategyConfig(quantizer="uniform", key_bits=4, value_bits=4,
                   granularity="per_channel", codec="zstd3"),
]
# (workload, tenant, prompt seed): the interactive tenant's few prompts,
# heavily repeated (chat prefixes), then the batch tenant's all-distinct
# long-tail prompts
ARRIVALS = ([("qalike", "interactive", i % 2) for i in range(8)]
            + [("summlike", "batch", 100 + i) for i in range(6)])


def build_controller(device) -> ServiceAwareController:
    """Profiles measured on sample KV on ``device`` (no quality runs: keep
    startup fast; q defaults to 1.0 so every profile is eligible)."""
    samples = [DeviceKVCache.from_host(
        KVCache.random(num_layers=4, kv_heads=2, seq=96, head_dim=32,
                       seed=s), device) for s in range(2)]
    profiles = [measure_profile(s, samples) for s in STRATEGIES]
    return ServiceAwareController({w: profiles for w in WORKLOADS})


def main(argv=None, ref=None):
    """Prints the per-request table and the summary; returns ``runtime``
    (the served :class:`ServingRuntime`), ``requests`` (the table's rows)
    and ``summary``.  ``ref`` is the (cfg, params) to serve in place of
    the cached reference model."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rt = ServingRuntime(
        controller=build_controller(args.device),
        config=RuntimeConfig(seq=96, decode_tokens=10,
                             prefill_tok_s=2000.0, decode_tok_s=400.0),
        # Constrained cross-node link (the paper's regime): slow enough
        # that the controller picks real compression for pool writes.
        trace=BandwidthTrace.constant(0.01 * GBPS),
        scheduler=SchedulerConfig(max_slots=6, max_prefills_per_step=2,
                                  max_queue=32),
        device=args.device)
    if ref is not None:
        rt.model_cfg, rt.params = ref

    for workload, tenant, seed in ARRIVALS:
        rt.submit(workload, slo_class=tenant, prompt_seed=seed)
        rt.step()
    rt.run()

    rows = []
    print(f"{'rid':>3} {'tenant':<12} {'workload':<9} {'src':<5} "
          f"{'profile':<28} {'ttft(ms)':>9} {'jct(ms)':>9} {'wire(KB)':>9}")
    for r in sorted(rt.completed, key=lambda r: r.rid):
        rows.append({"rid": r.rid, "tenant": r.slo_class,
                     "workload": r.workload, "pool_hit": bool(r.pool_hit),
                     "profile": r.profile, "ttft": r.ttft, "jct": r.jct,
                     "wire_bytes": r.wire_bytes})
        print(f"{r.rid:>3} {r.slo_class:<12} {r.workload:<9} "
              f"{'pool' if r.pool_hit else 'cold':<5} {r.profile:<28} "
              f"{r.ttft*1e3:>9.1f} {r.jct*1e3:>9.1f} "
              f"{r.wire_bytes/1e3:>9.1f}")

    s = rt.summary()
    print(f"\ncompleted={s['completed']} rejected={s['rejected']} "
          f"max_in_flight={s['max_in_flight']} "
          f"pool_hit_rate={s['pool_hit_rate']:.2f}")
    print(f"mean TTFT: pool hits {s.get('mean_ttft_hit', 0)*1e3:.1f} ms vs "
          f"cold prefill {s.get('mean_ttft_cold', 0)*1e3:.1f} ms")
    print(f"store: {int(s['store_entries'])} prefixes, "
          f"{s['store_used_bytes']/1e3:.0f} KB of "
          f"{s['store_capacity_bytes']/1e6:.0f} MB, "
          f"hit_rate={s['store_hit_rate']:.2f}")
    return {"runtime": rt, "requests": rows, "summary": s}


if __name__ == "__main__":
    main()
