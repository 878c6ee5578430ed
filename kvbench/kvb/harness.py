"""One run of one cell: set-up, the measured window, the readings, the
check against the reference, and the result line.

``python3 kvbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from kvb import spec
from kvb.probe import Probe
from kvb.traffic import Traffic
from kvb.window import Window, quantile

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_AT, TRACE_SECONDS = 0.35, 4.0
CANDIDATES = 48


@dataclass
class Run:
    """What the metric readers see."""

    cell: spec.Cell
    window: Window
    probe: Probe
    trace: Optional[object] = None      # the device trace's summary
    spans: Optional[object] = None      # the port's tracer (kvb.spans)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def build_runtime(cell: spec.Cell, model_cfg, params, device):
    from repro_torch.controller import ServiceAwareController
    from repro_torch.core.profiles import load_profiles
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

    c, t = cell.cell, cell.traffic
    profiles = load_profiles(str(spec.profile_path(cell.root,
                                                   c["profiles"])))
    for p in profiles:
        if not cell.model.supported(json.loads(p.strategy.to_json())):
            raise ValueError(f"profile {p.strategy.short_name()} has no "
                             f"plain arithmetic in the reference")
    controller = ServiceAwareController(
        {w: profiles for w in t["workloads"]})
    rt = ServingRuntime(
        controller=controller,
        config=RuntimeConfig(
            seq=t["prompt_tokens"], decode_tokens=t["out_tokens"]["max"],
            mode=c["mode"], paged=c["paged"], page_size=c["page_size"],
            pd_inject_restored=c["pd_inject_restored"],
            store_capacity=c["store_capacity"]),
        trace=BandwidthTrace.constant(c["bandwidth_gbps"] * GBPS),
        scheduler=SchedulerConfig(
            max_slots=c["slots"],
            max_prefills_per_step=c["max_prefills_per_step"],
            admission="always"),
        device=device)
    rt.model_cfg, rt.params = model_cfg, params
    return rt, profiles


def warm_up(torch, cell: spec.Cell, rt, profiles, device) -> None:
    """Every shape the cell's traffic uses, before the window: one request
    through the runtime (prefill at the prompt length, the controller's
    pick, the wire, landing, the decode step at the arena's width) and
    each profile's compress and decompress of a request-sized cache (the
    configuration's module's ``warm_cache``)."""
    from repro_torch.core import pipeline

    rt.submit("qalike", prompt_seed=(1 << 40) + 1, out_tokens=2)
    rt.run()
    kv = cell.model.warm_cache(cell.config, rt.cfg.seq, device, pipeline)
    for p in profiles:
        pipe = pipeline.CompressionPipeline(p.strategy, device=device)
        pipe.decompress(pipe.compress(kv))
    del kv
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def candidates(traffic: Traffic, rid0: int) -> set:
    """Requests whose payloads are kept for the check: the first
    CANDIDATES, and of the first 2 x CANDIDATES the longest quarter."""
    reqs = [traffic.request(i) for i in range(2 * CANDIDATES)]
    cut = sorted(r.out_tokens for r in reqs)[-len(reqs) // 4]
    return {rid0 + r.index for r in reqs
            if r.index < CANDIDATES or r.out_tokens >= cut}


def _p90(vals) -> str:
    return f"{quantile(vals, 0.9) * 1e3:.1f}" if vals else "-"


def _p50(vals) -> str:
    return f"{quantile(vals, 0.5) * 1e3:.1f}" if vals else "-"


def end_to_end(cell: spec.Cell, w: Window, setup_s: float) -> Dict:
    values = {"setup_s": setup_s}
    ttft, jct, tpot = w.ttfts(), w.jcts(), w.tpots()
    if ttft:
        values["ttft_p50_ms"] = quantile(ttft, 0.5) * 1e3
        values["jct_p50_ms"] = quantile(jct, 0.5) * 1e3
    if tpot:
        values["tpot_p50_ms"] = quantile(tpot, 0.5) * 1e3
    values["out_tok_per_s"] = w.tokens / w.wall
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(run: Run) -> Dict:
    out = {}
    for m in run.cell.per_layer:
        v = spec.metric_reader(run.cell.root, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


@contextlib.contextmanager
def port_tracer(on: bool):
    """The port's tracer (``repro_torch.utils.timing.Tracer``) installed
    for the block where ``on`` (a ``--trace 1`` run): yields it, or None
    with nothing installed, and removes it when the block ends."""
    if not on:
        yield None
        return
    from repro_torch.utils import timing
    tracer = timing.Tracer()
    timing.install(tracer)
    try:
        yield tracer
    finally:
        timing.uninstall()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_proc0: float, bench_json: Path,
             root: Path = spec.BENCH_DIR, lowp: bool = False,
             log=print) -> Dict:
    """The whole run; returns the result object (``correct`` and all).

    A ``--trace 1`` run installs the port's tracer before set-up, clears
    it when the window opens and removes it with the probe, so its spans
    and counters are the window's; a device trace on the host's clock
    (``kvb.spans.ProgramTrace``) covers a sub-window.  A ``--trace 0``
    run installs neither."""
    import torch
    from repro_torch.configs import get_config
    from kvb import check, spans
    from kvb.weights import make_params

    cell = spec.load_cell(workload, bench_json, root)
    spec.check_registry(cell.config)
    model_cfg = get_config(cell.config["registry"])
    device = torch.device(device)
    with port_tracer(trace) as tracer:
        params = make_params(model_cfg, seed, device, cell.model.init_scale)
        rt, profiles = build_runtime(cell, model_cfg, params, device)
        warm_up(torch, cell, rt, profiles, device)
        traffic = Traffic(cell.traffic, cell.cell, seed)
        probe = Probe(cell.config, cell.model,
                      candidates(traffic, rt._next_rid))
        probe.install()
        dev_trace = None
        try:
            on_wall = None
            if trace:
                dev_trace = spans.ProgramTrace(torch, tracer)
                state = {"on": False, "done": False, "t": 0.0}

                def on_wall(frac):
                    if not state["on"] and not state["done"] \
                            and frac >= TRACE_AT:
                        dev_trace.start()
                        probe.profiling = True
                        state.update(on=True, t=time.perf_counter())
                    elif state["on"] and (time.perf_counter() - state["t"]
                                          >= TRACE_SECONDS or frac >= 0.95):
                        dev_trace.stop()
                        probe.profiling = False
                        state.update(on=False, done=True)

            w = Window(rt, traffic, seconds, cell.cell["q_min"],
                       cell.cell.get("slo_metric"), on_wall=on_wall)
            if traffic.closed:
                w.ramp()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            setup_s = time.perf_counter() - t_proc0
            if tracer is not None:
                tracer.clear()
            w.run()
            if trace and probe.profiling:
                dev_trace.stop()
                probe.profiling = False
        finally:
            probe.uninstall()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell, w, probe, spans=tracer)
    extra = {"pace": {"steps": w.steps,
                      "ms_per_step": w.wall / max(w.steps, 1) * 1e3}}
    if trace:
        run.trace = dev_trace.summary(probe.host_spans)
        extra.update(
            program_spans={n: r(run) for n, r in spans.READERS.items()},
            agreement=spans.agreement(run), span_ms=spans.span_ms(run),
            alignment=dev_trace.alignment)
        log(f"spans beside the probe and the breakdown: "
            f"{json.dumps(extra['agreement'])}")
    metrics = per_layer(run) if trace else end_to_end(cell, w, setup_s)
    served = {r.rid: r.tokens for r in rt.completed}
    due = w.due_in_window()
    log(f"setup {setup_s:.3f} s; window: {w.wall:.3f} s wall, cluster clock {w.c_end - w.c0:.3f} s, "
        f"{w.steps} steps, {len(due)} requests due, "
        f"{sum(1 for r in due if r.censored)} censored, "
        f"{len(w.completed())} finished, {w.tokens} tokens; "
        f"ttft samples {len(w.ttfts())}, tpot samples {len(w.tpots())}; "
        f"p90 ttft {_p90(w.ttfts())} jct {_p90(w.jcts())} tpot "
        f"{_p90(w.tpots())} ms; p50 jct of the finished alone "
        f"{_p50([r.jct for r in due if r.jct is not None])} ms; "
        f"profiles {dict(Counter(r.profile for r in due if r.profile))}")
    # the program's state goes before the reference runs
    for dw in rt.decode_workers:
        dw._arena = dw._qcodes = dw._qscales = None
    del rt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.readings(cell, w, probe, params, served, seed, device,
                            lowp=lowp)
    log(f"check: {time.perf_counter() - t_check:.3f} s, "
        f"{values['sampled_tokens']:.0f} served tokens of "
        f"{values['sampled']:.0f} requests")
    limits = dict(cell.cell.get("limits", {}))
    limits.update(wire_mismatch=0.0, prompt_mismatch=0.0,
                  landed_mismatch=0.0)
    correct, shown = check.verdict(values, limits)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")
    result = {
        "correct": bool(correct),
        "attempted": len(due),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    if lowp:
        c_ok, c_shown = check.control_verdict(values, limits)
        result["control"] = {
            "correct": bool(c_ok),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in c_shown.items()}}
    result.update(extra)
    result["readings"] = {k: v for k, v in values.items()
                          if k not in limits}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in shown.items()}
    return result


def main(argv: Optional[List[str]] = None, t_proc0: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_json = Path.cwd() / "BENCHMARK.json"
    import torch
    entry = {w["name"]: w for w in
             json.loads(bench_json.read_text())["workloads"]}.get(
                 args.workload)
    chips = entry["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kvbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_proc0, bench_json,
                      log=lambda s: print(s, file=sys.stderr))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
