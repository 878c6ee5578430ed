"""Driving the runtime through a measured window and reading its
end-to-end numbers.

Clocks.  Latencies (TTFT, JCT, time per output token) are read on the
runtime's cluster clock: measured device work (each stage ends in a
synchronise), plus the wire at the cell's bandwidth, with the prefill and
decode workers overlapped as on separate cards.  Arrivals are due on that
clock; a request is submitted at the first step boundary at or past its
due time, and its TTFT is timed from its due time (the runtime's, from
submission, plus the difference).  A request due in the window with no
first token when it closes counts at its elapsed time, as does its JCT
when it has not finished.  Throughput is read on the wall clock of the
window: every output token produced over the window's seconds."""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kvb.traffic import Req, Traffic


@dataclass
class Record:
    """One request due in (or started by) the window."""

    rid: int
    req: Req
    due: float                    # cluster clock
    submitted: Optional[float] = None
    ttft: Optional[float] = None  # from due; None until a first token
    jct: Optional[float] = None   # from due; None until done
    tokens: int = 0
    breakdown: Dict[str, float] = field(default_factory=dict)
    profile: str = ""
    wire_bytes: int = 0
    censored: bool = False
    in_window: bool = True


def quantile(values: List[float], q: float) -> float:
    """The q-quantile (0 < q < 1) by Python's inclusive method (linear between order statistics)."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return float(cuts[round(q * 100) - 1])


class Window:
    def __init__(self, rt, traffic: Traffic, seconds: float,
                 q_min: float, slo_metric=None, on_wall=None):
        self.rt = rt
        self.q_min = q_min
        self.slo_metric = slo_metric  # the latency the controller learns on
        self.traffic = traffic
        self.seconds = seconds
        self.on_wall = on_wall        # callback(fraction of the window)
        self.records: Dict[int, Record] = {}
        self.next_index = 0
        self.c0 = self.c_end = 0.0
        self.wall = 0.0
        self.tokens = 0
        self.steps = 0
        self._seen_done = 0         # completions a closed loop has answered

    # ------------------------------------------------------------------
    def _submit(self, due: float) -> None:
        req = self.traffic.request(self.next_index)
        self.next_index += 1
        rid = self.rt.submit(req.workload, prompt_seed=req.prompt_seed,
                             out_tokens=req.out_tokens, q_min=self.q_min,
                             slo_metric=self.slo_metric)
        if rid is None:
            raise RuntimeError("the runtime shed a request: the cell's "
                               "scheduler must admit every arrival")
        self.records[rid] = Record(rid=rid, req=req, due=due,
                                   submitted=self.rt.clock)

    def _produced(self) -> int:
        rt = self.rt
        return (sum(len(s.toks) for s in rt._slots.values())
                + sum(len(r.tokens) for r in rt.completed))

    def ramp(self) -> None:
        """Closed loop: every client's first request, stepped until each
        holds a slot (set-up, before the window opens)."""
        self._seen_done = len(self.rt.completed)
        for _ in range(self.traffic.clients):
            self._submit(self.rt.clock)
        first = set(self.records)
        guard = 0
        while True:
            done = {r.rid for r in self.rt.completed}
            if first <= set(self.rt._slots) | done:
                break
            self.rt.step()
            self._refill()
            guard += 1
            if guard > 10 * self.traffic.clients:
                raise RuntimeError("closed loop never filled its slots")
        for rec in self.records.values():
            rec.in_window = False

    def _refill(self) -> None:
        done = len(self.rt.completed) - self._seen_done
        self._seen_done = len(self.rt.completed)
        for _ in range(done):
            self._submit(self.rt.clock)

    def run(self) -> None:
        rt, tr = self.rt, self.traffic
        self.c0 = rt.clock
        produced0 = self._produced()
        if not tr.closed:
            self._seen_done = len(rt.completed)
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= self.seconds:
                break
            if self.on_wall is not None:
                self.on_wall(elapsed / self.seconds)
            if tr.closed:
                self._refill()
            else:
                while self.c0 + tr.due(self.next_index) <= rt.clock:
                    self._submit(self.c0 + tr.due(self.next_index))
                if rt.scheduler.idle:
                    rt.clock = max(rt.clock, self.c0 + tr.due(self.next_index))
                    continue
            rt.step()
            self.steps += 1
        self.wall = time.perf_counter() - t0
        self.c_end = rt.clock
        self.tokens = self._produced() - produced0
        self._close()

    def _close(self) -> None:
        """Read each record at the close: TTFT and JCT from due, censored
        at the close's clock where the request had not got that far."""
        rt = self.rt
        done = {r.rid: r for r in rt.completed}
        live = rt._slots
        for rid, rec in self.records.items():
            lag = rec.submitted - rec.due
            r = done.get(rid)
            if r is not None:
                rec.ttft, rec.jct = r.ttft + lag, r.jct + lag
                rec.tokens = len(r.tokens)
                rec.breakdown, rec.profile = dict(r.breakdown), r.profile
                rec.wire_bytes = r.wire_bytes
                continue
            slot = live.get(rid)
            if slot is not None:
                rec.ttft = slot.ttft + lag
                rec.tokens = len(slot.toks)
                rec.breakdown, rec.profile = dict(slot.breakdown), \
                    slot.profile
                rec.wire_bytes = slot.wire_bytes
            rec.censored = True
        # not-yet-submitted requests due before the close
        if not self.traffic.closed:
            i = self.next_index
            while self.c0 + self.traffic.due(i) <= self.c_end:
                req = self.traffic.request(i)
                self.records[-1 - i] = Record(
                    rid=-1 - i, req=req, due=self.c0 + self.traffic.due(i),
                    censored=True)
                i += 1

    # ------------------------------------------------------------------
    def due_in_window(self) -> List[Record]:
        return [r for r in self.records.values()
                if r.in_window and r.due <= self.c_end]

    def ttfts(self) -> List[float]:
        return [r.ttft if r.ttft is not None else self.c_end - r.due
                for r in self.due_in_window()]

    def jcts(self) -> List[float]:
        return [r.jct if r.jct is not None else self.c_end - r.due
                for r in self.due_in_window()]

    def completed(self) -> List[Record]:
        return [r for r in self.records.values() if r.jct is not None]

    def tpots(self) -> List[float]:
        return [(r.jct - r.ttft) / (r.tokens - 1) for r in self.completed()
                if r.tokens > 1]
