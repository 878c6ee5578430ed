"""Run one cell once, as ``kvbench/run.py`` does, with the port's tracer
(``repro_torch.utils.timing``) installed:

    python3 kvbench/traced.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--tracer <0|1>]

The tracer is installed before set-up, cleared when the window opens and
removed where the probe is.  A ``--trace 1`` run adds to its result line
``program_spans`` (every reader of ``kvb.spans``), ``span_ms`` (each
span's median per start and mean per decode iteration), ``agreement``
(the spans beside the probe's and the breakdown's numbers) and
``alignment`` (the device trace's clock against the host's), and names
its idle gaps by program span.  Every run adds ``pace``, the window's
steps and wall ms a step, by which runs at one host pace can be told
apart.  ``--tracer 0`` runs without the tracer, so that runs in turns
show what it costs.  Not part of a benchmark run: the benchmark's
harness does not install the tracer; a run whose harness no longer
calls what this script patches fails rather than reading nothing."""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "kvbench"), str(ROOT / "src")]


def traced_run(workload: str, seed: int, seconds: float, trace: bool,
               with_tracer: bool, device: str = "cuda", log=print,
               bench_json: Optional[Path] = None,
               root: Path = ROOT / "kvbench") -> dict:
    """One run of ``workload`` (``kvb.harness.run_cell``), with the tracer
    installed if ``with_tracer``; ``bench_json`` defaults to the working
    directory's ``BENCHMARK.json``."""
    from repro_torch.utils import timing
    from kvb import harness, spans, tracing
    from kvb.probe import Probe
    from kvb.window import Window

    saved, made, extra, called, windows = [], [], {}, set(), []

    def patch(owner, attr, make):
        real = getattr(owner, attr)
        saved.append((owner, attr, real))
        setattr(owner, attr, make(real))

    tracer = timing.Tracer() if with_tracer else None

    def window_run(real):
        def run(w):
            called.add("Window.run")
            windows.append(w)
            if tracer is not None:
                tracer.clear()
            return real(w)
        return run

    def uninstall(real):
        def wrapped(probe):
            called.add("Probe.uninstall")
            timing.uninstall()
            return real(probe)
        return wrapped

    def device_trace(real):
        def make(torch):
            called.add("DeviceTrace")
            made.append(spans.ProgramTrace(torch, tracer))
            return made[-1]
        return make

    def per_layer(real):
        def wrapped(run):
            called.add("per_layer")
            run.spans = tracer
            extra["program_spans"] = {n: r(run) for n, r
                                      in spans.READERS.items()}
            extra["agreement"] = spans.agreement(run)
            extra["span_ms"] = spans.span_ms(run)
            return real(run)
        return wrapped

    patch(Window, "run", window_run)
    want = {"Window.run"}
    if tracer is not None:
        patch(Probe, "uninstall", uninstall)
        patch(tracing, "DeviceTrace", device_trace)
        patch(harness, "per_layer", per_layer)
        want |= {"Probe.uninstall"} | (
            {"DeviceTrace", "per_layer"} if trace else set())
        timing.install(tracer)
    try:
        result = harness.run_cell(
            workload, seed, seconds, trace, device, T_PROC0,
            bench_json or Path.cwd() / "BENCHMARK.json", root, log=log)
    finally:
        timing.uninstall()
        while saved:
            owner, attr, real = saved.pop()
            setattr(owner, attr, real)
    if want - called:
        raise RuntimeError(
            f"the harness never called {sorted(want - called)}: the "
            "tracer's patches no longer reach it")
    result.update(extra)
    if made:
        result["alignment"] = made[0].alignment
    result["tracer"] = with_tracer
    w = windows[0]
    result["pace"] = {"steps": w.steps,
                      "ms_per_step": w.wall / max(w.steps, 1) * 1e3}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kvbench: needs a CUDA device", file=sys.stderr)
        return 2
    result = traced_run(args.workload, args.seed, args.seconds,
                        bool(args.trace), bool(args.tracer),
                        log=lambda s: print(s, file=sys.stderr))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
