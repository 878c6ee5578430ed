"""Composable arrival processes for trace generation.

Production traffic is neither stationary nor Poisson: request rates swing
with the day (diurnal load curves), burst on short timescales (on-off
sources), and the aggregate is a superposition of many tenants doing both
at once.  Three generators cover those shapes:

* :class:`Poisson` — the stationary baseline.
* :class:`DiurnalGammaPoisson` — a doubly-stochastic (Cox) process: a
  sinusoidal diurnal rate envelope modulated per time-bin by a
  Gamma(k, 1/k) multiplier (mean 1, CV 1/sqrt(k)), arrivals Poisson
  within each bin.  Small ``gamma_shape`` ⇒ heavy rate turbulence on top
  of the daily curve.
* :class:`OnOffMMPP` — a 2-state Markov-modulated Poisson process:
  exponentially-distributed ON/OFF dwell times, arrivals at ``rate_on``
  during ON bursts (and ``rate_off``, default 0, between them).

All generators are pure functions of ``(params, rng)`` — replaying with
the same seeded ``numpy`` Generator reproduces the same arrival vector
bit-for-bit — and return float64 arrays of sorted arrival times in
``[0, duration)``.  Superposition of tenants happens at the trace level
(:meth:`repro_torch.workloads.trace.Trace.merge`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

Rng = np.random.Generator


class ArrivalProcess:
    """Interface: ``times(duration, rng) -> sorted float64 array``."""

    def times(self, duration: float, rng: Rng) -> np.ndarray:
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run average arrivals/s (used to size traces)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Poisson(ArrivalProcess):
    """Stationary Poisson arrivals at ``rate``/s."""

    rate: float

    def times(self, duration: float, rng: Rng) -> np.ndarray:
        if self.rate <= 0 or duration <= 0:
            return np.empty(0)
        # Draw in vectorized batches of exponential gaps until the
        # horizon is covered (amortized one rng call per ~n arrivals).
        expect = self.rate * duration
        n = max(int(expect + 6.0 * math.sqrt(expect) + 16), 16)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        t = np.cumsum(gaps)
        while t[-1] < duration:
            gaps = rng.exponential(1.0 / self.rate, size=n)
            t = np.concatenate([t, t[-1] + np.cumsum(gaps)])
        return t[t < duration]

    def mean_rate(self) -> float:
        return self.rate


def _binned_poisson(edges: np.ndarray, rates: np.ndarray, rng: Rng
                    ) -> np.ndarray:
    """Arrivals of a piecewise-constant-rate Poisson process: per-bin
    counts are Poisson(rate * width), positions uniform within the bin.
    One vectorized pass regardless of bin count."""
    widths = np.diff(edges)
    counts = rng.poisson(np.maximum(rates, 0.0) * widths)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0)
    u = rng.random(total)
    starts = np.repeat(edges[:-1], counts)
    spans = np.repeat(widths, counts)
    return np.sort(starts + u * spans)


@dataclass(frozen=True)
class DiurnalGammaPoisson(ArrivalProcess):
    """Diurnal sinusoid × per-bin Gamma turbulence × Poisson thinning.

    ``rate(t) = base_rate * (1 + amplitude*sin(2π(t/period + phase)))``
    scaled per bin by an iid Gamma(shape, 1/shape) draw (mean 1).
    ``period`` defaults to 240 s — a compressed "day" so short simulated
    horizons still sweep through peak and trough.
    """

    base_rate: float
    period: float = 240.0
    amplitude: float = 0.6
    gamma_shape: float = 4.0
    phase: float = 0.0
    bins_per_period: int = 48

    def times(self, duration: float, rng: Rng) -> np.ndarray:
        if self.base_rate <= 0 or duration <= 0:
            return np.empty(0)
        bin_s = self.period / self.bins_per_period
        n_bins = max(int(math.ceil(duration / bin_s)), 1)
        edges = np.minimum(np.arange(n_bins + 1) * bin_s, duration)
        centers = (edges[:-1] + edges[1:]) / 2.0
        envelope = 1.0 + self.amplitude * np.sin(
            2.0 * math.pi * (centers / self.period + self.phase))
        turb = rng.gamma(self.gamma_shape, 1.0 / self.gamma_shape,
                         size=n_bins)
        return _binned_poisson(edges, self.base_rate * envelope * turb, rng)

    def mean_rate(self) -> float:
        return self.base_rate


@dataclass(frozen=True)
class OnOffMMPP(ArrivalProcess):
    """Bursty on-off Markov-modulated Poisson process (2-state MMPP)."""

    rate_on: float
    mean_on: float = 5.0      # mean ON dwell (s)
    mean_off: float = 15.0    # mean OFF dwell (s)
    rate_off: float = 0.0     # background rate between bursts
    start_on: bool = False

    def times(self, duration: float, rng: Rng) -> np.ndarray:
        if duration <= 0:
            return np.empty(0)
        out: List[np.ndarray] = []
        t = 0.0
        on = self.start_on
        while t < duration:
            mean = self.mean_on if on else self.mean_off
            dwell = float(rng.exponential(mean)) if mean > 0 else 0.0
            end = min(t + dwell, duration)
            rate = self.rate_on if on else self.rate_off
            if rate > 0 and end > t:
                lam = rate * (end - t)
                k = int(rng.poisson(lam))
                if k:
                    out.append(t + np.sort(rng.random(k)) * (end - t))
            t = end
            on = not on
        if not out:
            return np.empty(0)
        return np.concatenate(out)

    def mean_rate(self) -> float:
        cycle = self.mean_on + self.mean_off
        if cycle <= 0:
            return self.rate_on
        return (self.rate_on * self.mean_on
                + self.rate_off * self.mean_off) / cycle


ARRIVALS = {
    "poisson": Poisson,
    "diurnal": DiurnalGammaPoisson,
    "mmpp": OnOffMMPP,
}


def make_arrivals(kind: str, rate: float, **kw) -> ArrivalProcess:
    """Factory keyed by name; ``rate`` maps onto each process's primary
    rate parameter."""
    if kind == "poisson":
        return Poisson(rate=rate, **kw)
    if kind == "diurnal":
        return DiurnalGammaPoisson(base_rate=rate, **kw)
    if kind == "mmpp":
        return OnOffMMPP(rate_on=rate, **kw)
    raise ValueError(f"unknown arrival process {kind!r} "
                     f"(have {sorted(ARRIVALS)})")
