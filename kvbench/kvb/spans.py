"""Readings of the port's own spans and counters in a traced run, and the
device trace on the same clock, its idle gaps named by those spans.

While a ``repro_torch.utils.timing.Tracer`` is installed the port records
a ``step`` span a runtime iteration; in it a ``start`` span a cold start
(with the request id), whose children are ``prefill``, ``extract``,
``select``, ``compress`` (``to_host``, ``encode``), ``decompress``
(``unpack``, ``to_device``) and ``inject`` (``to_device`` where host
arrays land), and a ``decode_iteration`` span whose children ``prepare``,
``launch``, ``pull`` and ``commit`` tile it; and the counters
``to_host_bytes``, ``to_device_bytes`` and ``decode_slots``.

The harness installs the tracer in ``--trace 1`` runs alone, clears it
when the window opens and removes it after (``kvb.harness.port_tracer``).
A reader takes the harness's ``Run`` and finds the tracer at
``run.spans``; where there is none (a ``--trace 0`` run) it returns
None, and so does a reader whose spans the program never recorded."""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from statistics import mean
from typing import Dict, Iterable, List, Optional, Tuple

from kvb.layers import started
from kvb.tracing import DEVICE_CATS, MARKER, TraceSummary, short_name
from kvb.window import quantile

CODEC_HOST = ("to_host", "encode")
LANDING_HOST = ("unpack", "to_device")
STEP_HOST = ("prepare", "launch")


def _tracer(run):
    return getattr(run, "spans", None)


def _rids(run) -> set:
    return {r.rid for r in started(run)}


def _owners(tracer, name: str) -> List[int]:
    """For each span, the index of the span named ``name`` it lies in
    (itself included; -1: none).  A parent is entered before its
    children, so one pass in order of entry finds every owner."""
    out: List[int] = []
    for s in tracer.spans:
        if s.name == name:
            out.append(len(out))
        else:
            out.append(out[s.parent] if s.parent >= 0 else -1)
    return out


def per_start(tracer, rids: Iterable[int], names: Iterable[str]
              ) -> Dict[int, float]:
    """Seconds of the spans named ``names`` inside the start of each
    request of ``rids`` that started (0.0 for a start without one)."""
    names, rids = set(names), set(rids)
    out = {s.rid: 0.0 for s in tracer.spans
           if s.name == "start" and s.rid in rids}
    owner = _owners(tracer, "start")
    for i, s in enumerate(tracer.spans):
        o = owner[i]
        if s.name in names and 0 <= o != i and tracer.spans[o].rid in out:
            out[tracer.spans[o].rid] += s.seconds
    return out


def per_iteration(tracer, names: Iterable[str]) -> List[float]:
    """Seconds of the children named ``names`` of each
    ``decode_iteration`` span."""
    names = set(names)
    its = {i: 0.0 for i, s in enumerate(tracer.spans)
           if s.name == "decode_iteration"}
    for s in tracer.spans:
        if s.parent in its and s.name in names:
            its[s.parent] += s.seconds
    return list(its.values())


def start_ms_p50(run, names: Iterable[str]) -> Optional[float]:
    """Median over the starts due in the window of the milliseconds
    their spans named ``names`` took."""
    t = _tracer(run)
    if t is None:
        return None
    vals = list(per_start(t, _rids(run), names).values())
    return quantile(vals, 0.5) * 1e3 if vals else None


def iteration_ms(run, names: Iterable[str]) -> Optional[float]:
    """Mean per decode iteration of the milliseconds its children named
    ``names`` took."""
    t = _tracer(run)
    vals = per_iteration(t, names) if t is not None else []
    return mean(vals) * 1e3 if vals else None


# -- the readers -----------------------------------------------------------
def select_ms_p50(run):
    return start_ms_p50(run, ("select",))


def codec_host_ms_p50(run):
    return start_ms_p50(run, CODEC_HOST)


def landing_host_ms_p50(run):
    return start_ms_p50(run, LANDING_HOST)


def mb_per_start(run, counter: str) -> Optional[float]:
    """Mean over the starts due in the window of the MB (1e6 B) that
    ``counter`` recorded in each."""
    t = _tracer(run)
    if t is None:
        return None
    per = {s.rid: 0.0 for s in t.spans
           if s.name == "start" and s.rid in _rids(run)}
    for c in t.counts:
        if c.name == counter and c.rid in per:
            per[c.rid] += c.value
    return mean(per.values()) / 1e6 if per else None


def to_host_mb_per_start(run):
    return mb_per_start(run, "to_host_bytes")


def to_device_mb_per_start(run):
    return mb_per_start(run, "to_device_bytes")


def decode_host_ms(run):
    return iteration_ms(run, STEP_HOST)


def decode_pull_ms(run):
    return iteration_ms(run, ("pull",))


def decode_live_slots(run):
    t = _tracer(run)
    vals = [c.value for c in t.counts
            if c.name == "decode_slots"] if t is not None else []
    return mean(vals) if vals else None


READERS = {
    "select_ms_p50": select_ms_p50,
    "codec_host_ms_p50": codec_host_ms_p50,
    "landing_host_ms_p50": landing_host_ms_p50,
    "codec_host_ms_p50.decode": codec_host_ms_p50,
    "to_host_mb_per_start.decode": to_host_mb_per_start,
    "decode_host_ms": decode_host_ms,
    "decode_pull_ms": decode_pull_ms,
    "decode_live_slots": decode_live_slots,
    # the landing's bytes, beside the compress path's: no metric yet
    "to_device_mb_per_start": to_device_mb_per_start,
}


def agreement(run) -> Dict[str, Optional[float]]:
    """The spans beside the older sources of the same run: the mean
    ``decode_iteration`` against the probe's, the median ``compress`` and
    ``prefill`` against the breakdown's, and the least share of a decode
    iteration that its four children cover."""
    t = _tracer(run)
    if t is None:
        return {}
    its = [s.seconds for s in t.spans if s.name == "decode_iteration"]
    kids = per_iteration(t, STEP_HOST + ("pull", "commit"))
    probe = run.probe.spans.get("decode_iteration", [])
    out = {
        "decode_iteration_ms": mean(its) * 1e3 if its else None,
        "probe_decode_iter_ms": mean(probe) * 1e3 if probe else None,
        "iteration_cover_min": (min(k / p for k, p in zip(kids, its)
                                    if p > 0) if its else None),
    }
    for stage in ("compress", "prefill"):
        out[f"{stage}_span_ms_p50"] = start_ms_p50(run, (stage,))
        vals = [r.breakdown[stage] for r in started(run)
                if stage in r.breakdown]
        out[f"{stage}_breakdown_ms_p50"] = (quantile(vals, 0.5) * 1e3
                                            if vals else None)
    return out


def span_ms(run) -> Dict[str, float]:
    """Every span below ``start`` by its path from there, as the median
    per start due in the window (ms; 0 for a start without it), and each
    child of ``decode_iteration`` as the mean per iteration (ms)."""
    t = _tracer(run)
    if t is None:
        return {}
    rids = _rids(run)
    owner = _owners(t, "start")
    per: Dict[str, Dict[int, float]] = defaultdict(dict)
    for i, s in enumerate(t.spans):
        o = owner[i]
        if o < 0 or t.spans[o].rid not in rids:
            continue
        names, j = [], i
        while j != o:
            names.append(t.spans[j].name)
            j = t.spans[j].parent
        key = "/".join(["start"] + names[::-1])
        rid = t.spans[o].rid
        per[key][rid] = per[key].get(rid, 0.0) + s.seconds
    started_rids = {t.spans[i].rid for i in set(owner) if i >= 0} & rids
    out = {k: quantile([v.get(r, 0.0) for r in started_rids], 0.5) * 1e3
           for k, v in sorted(per.items())}
    for name in STEP_HOST + ("pull", "commit"):
        vals = per_iteration(t, (name,))
        if vals:
            out[f"decode_iteration/{name}"] = mean(vals) * 1e3
    return out


# -- the device trace on the host's clock ----------------------------------
class ProgramTrace:
    """The traced sub-window: ``torch.profiler`` with CUDA activity only,
    so the host pays for no operator records, started and stopped around
    part of a window (``summary`` after the stop).  It is bracketed by two
    marker kernels, each launched right after a ``perf_counter_ns`` read,
    so the trace's clock can be put on the host's; its idle gaps are
    named by the program span open at each gap's start."""

    def __init__(self, torch, tracer):
        self.torch = torch
        self.prof = None
        self.tracer = tracer
        self.marks: List[Tuple[int, int]] = []  # (ns before, ns after)
        self.t_stop_ns = 0
        self.alignment: Dict[str, object] = {}

    def _mark(self) -> None:
        t0 = time.perf_counter_ns()
        self.torch.cuda._sleep(1000)
        self.marks.append((t0, time.perf_counter_ns()))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.torch.cuda.synchronize()
        self.marks = []
        self._mark()

    def stop(self) -> None:
        self._mark()
        self.torch.cuda.synchronize()
        self.t_stop_ns = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def summary(self, host_spans) -> TraceSummary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        out, self.alignment = summarize(events, self.marks, self.t_stop_ns,
                                        self.tracer, host_spans)
        return out


def align(events, marks: List[Tuple[int, int]]) -> Dict[str, object]:
    """The trace's clock against the host's, from the two markers.

    With the host-side launch records (``cuda_runtime``, tied to the
    marker kernels by ``correlation``), trace time = host time + offset
    where the first marker's launch record starts at the host read just
    before it; without them, where the marker's kernel starts, which
    lags the read by the launch latency.  ``error_us`` is, at each end,
    how far that end's marker lies from where the offset puts its read:
    0 at the first by construction, the drift and jitter at the second;
    ``bracket_us`` the host's time across each launch call, within which
    a launch record must start."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if len(dev) < len(marks):
        raise RuntimeError(f"{len(dev)} marker kernel(s) in the trace, "
                           f"{len(marks)} launched")
    dev = dev[:1] + dev[-1:] if len(marks) == 2 else dev[:1]
    launches = {e.get("args", {}).get("correlation"): e for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"}
    recs = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
    source = "launch" if all(r is not None for r in recs) else "marker"
    ts = [float((r if source == "launch" else e)["ts"])
          for r, e in zip(recs, dev)]
    offset_us = ts[0] - marks[0][0] / 1e3
    return {"source": source, "offset_us": offset_us,
            "error_us": [t - (m[0] / 1e3 + offset_us)
                         for t, m in zip(ts, marks)],
            "bracket_us": [(b - a) / 1e3 for a, b in marks]}


def summarize(events, marks, t_stop_ns: int, tracer, host_spans
              ) -> Tuple[TraceSummary, Dict[str, object]]:
    """The sub-window from the first marker's host read to the stop, on
    the host's clock: device busy time, kernel time by name, and each
    idle gap named by the innermost program span open at its start (a
    path below ``step``), else by the probe's innermost host span, else
    ``harness``.  Returns the summary and the alignment, with the idle
    seconds no program span covers (``unlabeled_s``)."""
    al = align(events, marks)
    t0_us = marks[0][0] / 1e3 + al["offset_us"]
    window_us = (t_stop_ns - marks[0][0]) / 1e3
    spans = sorted(((e["ts"] - t0_us, e["ts"] - t0_us + e["dur"],
                     short_name(e["name"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                    and MARKER not in e["name"]), key=lambda s: s[0])
    if not spans:
        raise RuntimeError("the profiler's trace holds no device operation "
                           "besides the markers")
    kernel_s: Dict[str, float] = defaultdict(float)
    merged: List[List[float]] = []
    for a, b, name in spans:
        a, b = max(a, 0.0), min(b, window_us)
        if b <= a:
            continue
        kernel_s[name] += (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    probe = sorted(host_spans, key=lambda s: s[1])
    gaps, prev, unlabeled = [], 0.0, 0.0
    for a, b in merged + [[window_us, window_us]]:
        if a > prev:
            label, named = _label(tracer, probe,
                                  marks[0][0] + int(prev * 1e3))
            gaps.append((label, (a - prev) * 1e-6))
            unlabeled += 0.0 if named else (a - prev) * 1e-6
        prev = max(prev, b)
    al["unlabeled_s"] = unlabeled
    return TraceSummary(window_s=window_us * 1e-6, busy_s=busy,
                        kernel_s=dict(kernel_s), gaps=gaps,
                        n_events=len(spans)), al


def _label(tracer, probe, t_ns: int) -> Tuple[str, bool]:
    """The innermost program span open at host time ``t_ns`` as a path
    below ``step`` (True), else the probe's innermost span (False)."""
    i = tracer.innermost_at(t_ns) if tracer is not None else -1
    if i >= 0:
        path = tracer.path(i)
        return (path[len("step/"):] if path.startswith("step/") else path,
                True)
    t = t_ns * 1e-9
    inside = [(t1 - t0, name) for name, t0, t1 in probe if t0 <= t <= t1]
    return (min(inside)[1] if inside else "harness"), False
