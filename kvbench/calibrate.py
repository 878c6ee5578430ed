"""Readings for the correctness limits, many seeds in one process:

    python3 kvbench/calibrate.py <workload> <seconds> <seed> [<seed> ...]

For each seed, one whole run of the cell (its set-up, a window of
``seconds``, the check) with the fp8 control read beside the program,
one JSON line a seed: the program's readings and verdict, the control's
readings and its verdict under the cell's limits (``check.control_verdict``),
and the end-to-end numbers.  Exits 1 if the control came out correct on
any seed.  Not part of a benchmark run."""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "kvbench"), str(ROOT / "src")]


def main(workload: str, seconds: float, seeds) -> int:
    from kvb.harness import run_cell
    passed = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run_cell(workload, seed, seconds, False, "cuda", t0,
                       ROOT / "BENCHMARK.json", lowp=True,
                       log=lambda s: print(s, file=sys.stderr))
        line = {"seed": seed, "correct": res["correct"],
                "checks": res["checks"], "readings": res["readings"],
                "control": res["control"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if res["control"]["correct"]:
            passed.append(seed)
    if passed:
        print(f"the control came out correct on seeds {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], float(sys.argv[2]),
                  [int(s) for s in sys.argv[3:]]))
