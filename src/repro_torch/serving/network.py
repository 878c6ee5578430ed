"""Network model: time-varying effective bandwidth + the controller's
goodput estimator.

The realized communication cost is governed by effective goodput under
contention, not nominal link speed (Sec. 3.1) — traces are piecewise
constant with optional per-transfer jitter; the estimator only sees
observed transfers (EWMA), which creates the offline→online drift the
bandit corrects.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

GBPS = 1e9 / 8  # 1 Gbps in bytes/s


@dataclass
class BandwidthTrace:
    """Piecewise-constant B(t) in bytes/s."""

    times: List[float]   # segment start times, times[0] == 0
    values: List[float]  # bytes/s per segment
    jitter: float = 0.0  # multiplicative lognormal sigma per transfer
    seed: int = 0

    def __post_init__(self):
        assert self.times[0] == 0.0 and len(self.times) == len(self.values)

    @staticmethod
    def constant(bandwidth: float) -> "BandwidthTrace":
        return BandwidthTrace([0.0], [bandwidth])

    @staticmethod
    def steps(segments: Sequence[Tuple[float, float]],
              jitter: float = 0.0, seed: int = 0) -> "BandwidthTrace":
        ts, vs = zip(*segments)
        return BandwidthTrace(list(ts), list(vs), jitter=jitter, seed=seed)

    def at(self, t: float) -> float:
        i = bisect_right(self.times, t) - 1
        return self.values[max(i, 0)]

    def _jitter_mult(self, start: float, nbytes: float) -> float:
        """Per-transfer multiplier derived deterministically from
        (seed, start, nbytes): identical transfers get identical times
        across calls and replays, and a trace shared between the runtime
        and the simulator cannot cross-contaminate either's stream."""
        if self.jitter <= 0:
            return 1.0
        key = (self.seed,
               int(np.float64(start).view(np.uint64)),
               int(np.float64(nbytes).view(np.uint64)))
        rng = np.random.default_rng(key)
        return float(np.exp(rng.normal(0.0, self.jitter)))

    def transfer_time(self, start: float, nbytes: float) -> float:
        """Time to push nbytes starting at `start`, integrating over the
        trace (with optional per-transfer jitter).  Zero-rate segments
        model link outages: the transfer waits them out (nothing moves,
        time passes); a trailing outage that never recovers yields inf
        rather than a division by zero."""
        if nbytes <= 0:
            return 0.0
        if self.jitter <= 0:
            times = self.times
            n = len(times)
            if n == 1:
                # Constant trace — by far the common sweep configuration.
                # The general loop below re-scans segments per transfer,
                # which dominated million-request replays.
                rate = self.values[0]
                return nbytes / rate if rate > 0.0 else float("inf")
            i = bisect_right(times, start) - 1
            if i >= n - 1:
                # Past the last change point: one unbounded segment.
                rate = self.values[n - 1]
                return nbytes / rate if rate > 0.0 else float("inf")
            mult = 1.0
        else:
            mult = self._jitter_mult(start, nbytes)
            i = bisect_right(self.times, start) - 1
        remaining = nbytes
        t = start
        while True:
            rate = self.values[max(i, 0)] * mult
            seg_end = self.times[i + 1] if i + 1 < len(self.times) else float("inf")
            if rate <= 0.0:
                if seg_end == float("inf"):
                    return float("inf")  # outage never ends: bytes never land
                t = seg_end             # wait out the outage segment
                i += 1
                continue
            dt_seg = seg_end - t
            can = rate * dt_seg
            if can >= remaining or seg_end == float("inf"):
                return (t + remaining / rate) - start
            remaining -= can
            t = seg_end
            i += 1


@dataclass
class WireTransfer:
    """Outcome of one serialized wire send."""

    t_wait: float    # queueing behind earlier transfers (wire busy)
    t_comm: float    # on-wire time once started
    start: float     # absolute start time (after queueing)

    @property
    def total(self) -> float:
        return self.t_wait + self.t_comm

    @property
    def end(self) -> float:
        return self.start + self.t_comm


class KVWire:
    """The PD transfer link as a serialized queue: one transfer occupies the
    wire at a time, so concurrent senders contend (a request admitted while
    another's KV is in flight waits for the wire before its bytes move).
    The wire is granted in ``send`` order — a later sender whose bytes are
    ready earlier still queues behind an already-granted reservation
    (admission order is priority order, so earlier senders keep the link).
    Every send is billed from the :class:`BandwidthTrace` and reported to
    the goodput estimator as ON-WIRE goodput (``nbytes / t_comm``, the B
    of the latency model's transfer term); queueing delay is deliberately
    excluded — it reaches the controller through the residual bandit's
    observed latency (``wire_wait`` is on the critical path), not by
    deflating the bandwidth estimate, which would double-count it."""

    def __init__(self, trace: BandwidthTrace,
                 estimator: Optional["GoodputEstimator"] = None):
        self.trace = trace
        self.estimator = estimator
        if estimator is not None and estimator.initial is None:
            # An unseeded estimator attached to a link starts from the
            # link's *configured* trace, not a universal guess: on a
            # 50 Mbps wire the controller's first selections would
            # otherwise assume a ~1600x faster network until the first
            # observations arrive.
            estimator.initial = seed_bandwidth(trace)
        self.free_at = 0.0
        self.transfers = 0
        self.bytes_moved = 0

    def send(self, ready: float, nbytes: float) -> WireTransfer:
        """Push ``nbytes`` onto the wire no earlier than ``ready``; returns
        the queueing wait and on-wire time (both on the sender's critical
        path)."""
        start = max(ready, self.free_at)
        t_comm = self.trace.transfer_time(start, nbytes)
        self.free_at = start + t_comm
        self.transfers += 1
        self.bytes_moved += int(nbytes)
        if self.estimator is not None:
            self.estimator.observe(nbytes, t_comm)
        return WireTransfer(t_wait=start - ready, t_comm=t_comm, start=start)


def seed_bandwidth(trace: BandwidthTrace) -> float:
    """The estimator prior a link's configured trace implies: its rate at
    t=0, or — for a trace that STARTS in an outage segment (rate 0, legal
    since the outage fix) — the first positive segment's rate, so a zero
    prior can never reach the latency model's divisions.  A trace with no
    positive segment at all falls back to the detached prior."""
    b0 = trace.at(0.0)
    if b0 > 0:
        return b0
    return next((v for v in trace.values if v > 0),
                GoodputEstimator.DETACHED_INITIAL)


@dataclass
class GoodputEstimator:
    """EWMA over observed transfer goodputs — the controller's view of B.

    ``initial`` is the pre-observation prior.  Leave it None to have the
    first :class:`KVWire` the estimator is attached to seed it from the
    link's configured :class:`BandwidthTrace` (``trace.at(0.0)``) — the
    per-link default everywhere in the serving stack.  Only a completely
    detached estimator falls back to the legacy 10 Gb/s guess."""

    alpha: float = 0.3
    initial: Optional[float] = None
    _est: Optional[float] = None

    DETACHED_INITIAL = 10 * GBPS  # last-resort prior (no link to seed from)

    def observe(self, nbytes: float, seconds: float) -> None:
        # math.isfinite beats np.isfinite ~20x on scalars — this runs once
        # per simulated transfer.
        if seconds <= 0 or nbytes <= 0 or not math.isfinite(seconds):
            return  # outage transfers (inf) carry no goodput signal
        goodput = nbytes / seconds
        self._est = goodput if self._est is None else \
            (1 - self.alpha) * self._est + self.alpha * goodput

    @property
    def estimate(self) -> float:
        if self._est is not None:
            return self._est
        return self.initial if self.initial is not None \
            else self.DETACHED_INITIAL
