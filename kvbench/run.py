"""Run one cell of the port's benchmark once:

    python3 kvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output, and each compared number beside its limit as the last
lines of standard error."""
import time

T_PROC0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches of the build at fixed paths inside the checkout: only a cell's
# first run there builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "kvbench"), str(ROOT / "src")]

from kvb.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_proc0=T_PROC0))
