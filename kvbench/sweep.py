"""The knee of an open-loop cell, by one sweep on the card:

    python3 kvbench/sweep.py <workload> <seconds> <seed> <rate> [<rate> ...]

One process, one set of weights; for each offered rate (requests a
second of cluster clock) a fresh runtime, warmed, drives a window of
``seconds`` and reports the backlog (requests due with no first token
yet) at each quarter of the window's cluster time, with TTFT p90.  The
knee is the highest rate whose backlog does not grow over the window."""
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "kvbench"), str(ROOT / "src")]


def main(workload, seconds, seed, rates) -> int:
    import torch
    from repro_torch.configs import get_config
    from kvb import spec
    from kvb.harness import build_runtime, warm_up
    from kvb.traffic import Traffic
    from kvb.weights import make_params
    from kvb.window import Window, quantile

    cell = spec.load_cell(workload, ROOT / "BENCHMARK.json")
    model_cfg = get_config(cell.config["registry"])
    dev = torch.device("cuda")
    params = make_params(model_cfg, seed, dev, cell.model.init_scale)
    for rate in rates:
        c = dataclasses.replace(cell, cell=dict(cell.cell, rate_per_s=rate))
        rt, profiles = build_runtime(c, model_cfg, params, dev)
        warm_up(torch, c, rt, profiles, dev)
        w = Window(rt, Traffic(c.traffic, c.cell, seed), seconds,
                   c.cell["q_min"], c.cell.get("slo_metric"))
        w.run()
        recs = w.due_in_window()
        span = w.c_end - w.c0
        backlog = []
        for q in (0.25, 0.5, 0.75, 1.0):
            t = w.c0 + q * span
            backlog.append(sum(
                1 for r in recs if r.due <= t and (
                    r.ttft is None or r.due + r.ttft > t)))
        print(json.dumps({
            "rate_per_s": rate, "due": len(recs), "cluster_s": span,
            "wall_s": w.wall, "steps": w.steps, "backlog": backlog,
            "ttft_p90_ms": quantile(w.ttfts(), 0.9) * 1e3,
            "tpot_p90_ms": (quantile(w.tpots(), 0.9) * 1e3
                            if w.tpots() else None),
            "profiles": sorted({r.profile for r in recs if r.profile})}),
            flush=True)
        for dw in rt.decode_workers:
            dw._arena = dw._qcodes = dw._qscales = None
        del rt, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], float(sys.argv[2]), int(sys.argv[3]),
                  [float(r) for r in sys.argv[4:]]))
