"""Make a configuration's frozen profile set on the card, once, with the
port's offline profiling on that model's own KV at full width:

    python3 kvbench/make_profiles.py <config> <out_dir>

Writes ``<out_dir>/<config>.jsonl`` (``core/profiles.py`` lines: the
per-token symmetric strategies the reference carries, without the
identity, which the controller keeps as its fallback,
each measured for compression ratio, encode and decode throughput on two
1,024-token prompts' KV, and quality by teacher-forced agreement on the
three workloads; each strategy runs once before it is measured) and ``<out_dir>/<config>.meta.json`` (command, card,
power limit, date, versions).  The benchmark reads the copy kept in
``kvbench/profiles/``."""
import json
import subprocess
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "kvbench"), str(ROOT / "src")]

WORKLOADS = ("qalike", "codelike", "mathlike")
# (bits, group): per-token symmetric uniform, no transform, no codec.
STRATEGIES = ((8, 64), (8, 128), (4, 64), (4, 32))
SAMPLE_SEQ = 1024
WEIGHT_SEED = 0


def main(name: str, out_dir: str) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quality import extract_kv
    from repro_torch.core.profiles import save_profiles
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.profile_offline import build_profiles
    from repro_torch.models.transformer import prefill
    from kvb.spec import BENCH_DIR, check_registry, load_model
    from kvb.weights import make_params
    from reference.prompts import prompt_ids

    config = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    check_registry(config)
    cfg = get_config(config["registry"])
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = make_params(cfg, WEIGHT_SEED, dev,
                         load_model(BENCH_DIR, config).init_scale)
    samples = []
    for i, w in enumerate(WORKLOADS[:2]):
        ids = torch.as_tensor(prompt_ids(w, 1000 + i, SAMPLE_SEQ)[None],
                              dtype=torch.int32, device=dev)
        _, caches = prefill(cfg, params, {"tokens": ids}, SAMPLE_SEQ)
        samples.append(extract_kv(cfg, caches, 0, upto=SAMPLE_SEQ))
        del caches
    strategies = [StrategyConfig(quantizer="uniform", key_bits=b,
                                 value_bits=b, granularity="per_token",
                                 symmetric=True, group_size=g, codec="none")
                  for b, g in STRATEGIES]
    # every strategy once before measuring: the kernels' first call
    # builds and loads them, which is not the codec's throughput
    from repro_torch.core.pipeline import CompressionPipeline
    for st in strategies:
        CompressionPipeline(st, device=dev).roundtrip(samples[0])
    profiles = build_profiles(strategies, workloads=WORKLOADS,
                              kv_samples=samples, ref=(cfg, params),
                              verbose=True, device=dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # the controller falls back to the identity by itself; the set holds
    # the strategies it chooses among
    profiles = [p for p in profiles if p.strategy.key_bits < 16]
    save_profiles(profiles, str(out / f"{name}.jsonl"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    meta = {
        "command": f"python3 kvbench/make_profiles.py {name} {out_dir}",
        "card": smi.strip(),
        "date": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "weights": f"kvbench/kvb/weights.py, seed {WEIGHT_SEED}",
        "kv_samples": f"{len(samples)} prompts of {SAMPLE_SEQ} tokens "
                      f"({', '.join(WORKLOADS[:2])}, prompt seeds 1000-1001)",
        "seconds": round(time.perf_counter() - t0, 1),
    }
    (out / f"{name}.meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    for p in profiles:
        print(p.strategy.short_name(), f"g{p.strategy.group_size}",
              f"cr={p.cr:.4f} s_enc={p.s_enc:.4g} s_dec={p.s_dec:.4g}",
              json.dumps(p.quality))
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
