"""A tiny benchmark root for the CPU tests: the port's reduced
deepseek-moe-16b (2 layers, d_model 64, 8 experts top-2), 64-token
prompts, a made-up set of an int8 and an int4 profile, the real metric
readers and reference module."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
LIMITS = {"gap_mean": 0.05, "kv_rel_err": 0.05}


def build(root: Path, closed: bool = False, rate: float = 20.0,
          d_model=None) -> Path:
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig

    for d in ("configs", "cells", "traffic", "profiles"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "reference"):
        if not (root / d).exists():
            shutil.copytree(HERE / d, root / d,
                            ignore=shutil.ignore_patterns("__pycache__"))
    c = get_config("deepseek-moe-16b-reduced")
    cfg = {"name": "tiny", "source": "test", "registry": c.name,
           "reference": "reference/decoder.py",
           "num_layers": c.num_layers,
           "d_model": c.d_model if d_model is None else d_model,
           "num_heads": c.num_heads, "kv_heads": c.kv_heads,
           "head_dim": c.resolved_head_dim, "d_ff": c.d_ff,
           "vocab_size": c.vocab_size, "num_experts": c.num_experts,
           "experts_per_token": c.experts_per_token,
           "num_shared_experts": c.num_shared_experts,
           "moe_dense_prefix": c.moe_dense_prefix,
           "capacity_factor": c.capacity_factor, "qk_norm": c.qk_norm,
           "tie_embeddings": c.tie_embeddings, "rope_theta": c.rope_theta,
           "rmsnorm_eps": c.rmsnorm_eps}
    (root / "configs/tiny.json").write_text(json.dumps(cfg))
    traffic = {"arrivals": "closed" if closed else "stratified", "clients": 4,
               "prompt_tokens": 64,
               "workloads": ["qalike", "codelike", "mathlike"],
               "out_tokens": {"dist": "lognormal", "median": 8,
                              "sigma": 0.5, "min": 4, "max": 16}}
    (root / "traffic/tiny.json").write_text(json.dumps(traffic))
    cell = {"mode": "pd", "paged": True, "page_size": 16,
            "pd_inject_restored": True, "store_capacity": 1 << 26,
            "q_min": 0.97, "sample": 4, "slots": 4,
            "bandwidth_gbps": 0.001, "rate_per_s": rate,
            "max_prefills_per_step": 1, "profiles": "tiny",
            "limits": LIMITS}
    (root / "cells/tiny.pd.json").write_text(json.dumps(cell))
    # quantizing profiles only, so that every sampled request's KV
    # carries the codec's rounding the control is read against
    profs = [Profile(StrategyConfig(
        quantizer="uniform", key_bits=b, value_bits=b,
        granularity="per_token", symmetric=True, group_size=16),
        cr=cr, s_enc=5e8, s_dec=5e8,
        quality={"qalike": 0.99, "codelike": 0.99, "mathlike": 0.99})
        for b, cr in ((8, 1.9), (4, 3.6))]
    (root / "profiles/tiny.jsonl").write_text(
        "".join(p.to_json() + "\n" for p in profs))
    e2e = [{"name": n, "unit": u} for n, u in (
        ("ttft_p50_ms", "ms"), ("jct_p50_ms", "ms"), ("tpot_p50_ms", "ms"),
        ("setup_s", "s"), ("out_tok_per_s", "tokens/s"))]
    layers = [{"name": p.stem, "unit": "x"}
              for p in sorted((root / "metrics").glob("*.py"))]
    bench = {"workloads": [{"name": "tiny.pd", "config": "tiny",
                            "traffic": "tiny", "chips": 1}],
             "end_to_end": e2e, "per_layer": layers}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
