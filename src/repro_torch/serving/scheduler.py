"""Continuous-batching request scheduler with admission control and
SLO-class priorities.

One policy layer, two execution backends (DESIGN.md §9): the
real-execution :class:`~repro.serving.engine.ServingRuntime` drives
:class:`ContinuousScheduler` at iteration granularity (each ``step()``
admits up to ``max_prefills_per_step`` prefill slots and advances every
in-flight decode slot by one token), and the event-driven
:class:`~repro.serving.simulator.Simulator` uses the same
:func:`priority_key` / :class:`AdmissionController` to order and gate its
dispatch loop.  Keeping the policy functions pure (request, clock, config)
is what lets both backends share them.

Priority model: requests carry an SLO class (``interactive`` < ``standard``
< ``batch``; see :data:`repro.serving.kvstore.SLO_CLASSES`).  Within a
class, tighter-deadline-first (slack), then FIFO.  Waiting requests age
one class per ``aging_s`` seconds so batch traffic cannot starve.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.kvstore import SLO_CLASSES, slo_rank
from repro_torch.serving.request import Request


@dataclass
class SchedulerConfig:
    max_slots: int = 8            # in-flight (decode) slots
    max_prefills_per_step: int = 1  # iteration-level prefill admission
    max_queue: int = 64           # admission: bound on waiting requests
    admission: str = "reject"     # "reject" | "always" (no queue bound)
    aging_s: float = 10.0         # waiting this long promotes one SLO class


def priority_key(req: Request, now: float,
                 cfg: Optional[SchedulerConfig] = None
                 ) -> Tuple[float, float, float]:
    """Total order over waiting requests; lower sorts first.

    ``(effective_class, slo_slack, arrival)`` — effective class is the SLO
    class rank minus aging promotions; slack is seconds until the request's
    deadline (infinite without an SLO).
    """
    aging = cfg.aging_s if cfg is not None else 0.0
    rank = float(slo_rank(req.slo_class))
    waited = max(now - req.arrival, 0.0)
    if aging > 0:
        rank -= int(waited // aging)
    slack = (req.arrival + req.t_slo - now) if req.t_slo > 0 else math.inf
    return (rank, slack, req.arrival)


class AdmissionController:
    """Bounded-queue admission shared by engine and simulator."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.admitted = 0
        self.rejected = 0

    def admit(self, req: Request, queue_depth: int, now: float) -> bool:
        if self.cfg.admission != "always" and queue_depth >= self.cfg.max_queue:
            self.rejected += 1
            return False
        self.admitted += 1
        return True


class ContinuousScheduler:
    """Iteration-level scheduler: a priority queue of waiting requests plus
    a bounded set of in-flight slots."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None,
                 manage_slots: bool = True):
        self.cfg = cfg or SchedulerConfig()
        self.admission = AdmissionController(self.cfg)
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []
        # Physical arena slot ids, recycled LIFO so a hot slot's cache row
        # is reused first.  len(running) <= max_slots keeps this non-empty
        # whenever next_prefills admits.  A multi-worker cluster passes
        # manage_slots=False: slots are then owned by each DecodeWorker's
        # local arena (the scheduler keeps only admission + priority), and
        # requests are admitted through :meth:`admit` instead of
        # :meth:`next_prefills`.
        self.manage_slots = manage_slots
        self._free_slots: List[int] = list(range(self.cfg.max_slots))[::-1]

    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def in_flight(self) -> int:
        return len(self.running)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Admission-controlled enqueue.  False = rejected (load shed)."""
        if not self.admission.admit(req, len(self.waiting), now):
            req.chosen = "rejected"
            req.state = "rejected"
            req.slo_violated = req.t_slo > 0
            req.done = req.arrival
            return False
        req.state = "waiting"
        self.waiting.append(req)
        return True

    def pop_next(self, now: float) -> Optional[Request]:
        """Highest-priority waiting request (None if queue empty).

        Re-sorts per pop because priority_key is time-varying (aging,
        slack), which a static heap can't express; the queue is bounded by
        max_queue, so the cost stays small."""
        if not self.waiting:
            return None
        self.waiting.sort(key=lambda r: priority_key(r, now, self.cfg))
        return self.waiting.pop(0)

    def peek_order(self, now: float) -> List[Request]:
        return sorted(self.waiting, key=lambda r: priority_key(r, now, self.cfg))

    # ------------------------------------------------------------------
    def next_prefills(self, now: float) -> List[Request]:
        """The iteration's prefill admissions: up to ``max_prefills_per_step``
        waiting requests, bounded by free slots.  Each returned request is
        moved into a running slot and carries its arena slot id in
        ``req.slot``."""
        free = self.cfg.max_slots - len(self.running)
        n = min(self.cfg.max_prefills_per_step, free, len(self.waiting))
        out: List[Request] = []
        for _ in range(max(n, 0)):
            req = self.pop_next(now)
            if req is None:
                break
            req.slot = self._free_slots.pop()
            req.state = "prefilling"
            self.running[req.rid] = req
            out.append(req)
        return out

    def admit(self, now: float) -> Optional[Request]:
        """Move the highest-priority waiting request into ``running``
        WITHOUT assigning an arena slot — the multi-worker path: the
        caller routes the request to a worker, which assigns a slot from
        its own local pool.  Returns None when the queue is empty."""
        req = self.pop_next(now)
        if req is None:
            return None
        req.state = "prefilling"
        self.running[req.rid] = req
        return req

    def finish(self, rid: int) -> None:
        req = self.running.pop(rid, None)
        if req is not None:
            if self.manage_slots and req.slot is not None:
                self._free_slots.append(req.slot)
            req.state = "done"
            self.finished.append(req)

    # ------------------------------------------------------------------
    def state_counts(self) -> Dict[str, int]:
        """Lifecycle census over non-terminal requests (waiting ->
        prefilling -> transferring -> decoding; see
        :data:`repro.serving.request.LIFECYCLE`)."""
        counts: Dict[str, int] = {}
        for req in list(self.waiting) + list(self.running.values()):
            counts[req.state] = counts.get(req.state, 0) + 1
        return counts
