"""The traced sub-window: ``torch.profiler`` with CUDA activity only, so
the host pays for no operator records, over a few seconds in the middle
of a ``--trace 1`` run.  Its chrome trace gives every kernel, copy and
set on the device with start and length; the host spans the probe took
meanwhile name what the host was doing in each idle gap."""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"<.*", "", name.split("(")[0])
    return name.split("::")[-1].split()[-1] if name.strip() else name


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    n_events: int = 0

    def kernel_time(self, *names: str) -> float:
        return sum(t for k, t in self.kernel_s.items()
                   if any(n in k for n in names))

    def device_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for label, dt in self.gaps:
            by[label] += dt
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]


class DeviceTrace:
    """Start and stop around part of a window; ``summary`` after stop."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_start = self.t_stop = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
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
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        if not dev:
            raise RuntimeError("the profiler's trace holds no device "
                               "operation")
        marker = [e for e in dev if MARKER in e["name"]]
        t0_us = (min(e["ts"] for e in marker) if marker
                 else min(e["ts"] for e in dev))
        window_us = (self.t_stop - self.t_start) * 1e6
        spans = sorted(((e["ts"] - t0_us, e["ts"] - t0_us + e["dur"],
                         short_name(e["name"])) for e in dev
                        if MARKER not in e["name"]), key=lambda s: s[0])
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
        gaps = []
        prev = 0.0
        for a, b in merged + [[window_us, window_us]]:
            if a > prev:
                gaps.append((self._label(host_spans, prev), (a - prev) * 1e-6))
            prev = max(prev, b)
        return TraceSummary(window_s=window_us * 1e-6, busy_s=busy,
                            kernel_s=dict(kernel_s), gaps=gaps,
                            n_events=len(spans))

    def _label(self, host_spans, t_us: float) -> str:
        """The innermost host span around trace time ``t_us``."""
        t = self.t_start + t_us * 1e-6
        inside = [(t1 - t0, name) for name, t0, t1 in host_spans
                  if t0 <= t <= t1]
        return min(inside)[1] if inside else "harness"
