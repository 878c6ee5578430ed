"""Timing helpers: ``Timer`` / ``timed``, and the serving path's tracer.

The tracer records where the serving path spends its host time: named
spans (``with span("compress"):``) nested as the calls nest, and counters
(``count_bytes("to_host_bytes", codes, scales)``) taken at the same
boundaries.  Both are off unless a :class:`Tracer` is installed: then
each site costs one read of a module global and hands back the shared
:data:`NO_SPAN`, with no clock read, allocation or device synchronise.
Installed, a span reads ``time.perf_counter_ns()`` at entry and exit; a
counter's bytes come from shapes and dtypes on the host, so no site adds
a synchronise or a copy either way.  Records stay in memory, for a
reader in the same process; nothing is written out."""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class Timer:
    """Accumulating wall-clock timer (seconds)."""

    total: float = 0.0
    count: int = 0
    _start: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


@contextmanager
def timed(timer: Timer):
    timer.start()
    try:
        yield timer
    finally:
        timer.stop()


# ---------------------------------------------------------------------------
# The serving path's tracer
# ---------------------------------------------------------------------------
@dataclass
class Span:
    """One traced call: ``t1_ns`` is 0 while it is open; ``parent`` the
    index of the innermost span open at its entry (-1: a root); ``rid``
    the request it works for, inherited from the parent if not given."""

    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    rid: Optional[int]

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


@dataclass
class Count:
    """One counter record: ``value`` for request ``rid``, the innermost
    open span's."""

    name: str
    rid: Optional[int]
    value: float


class _NoSpan:
    """What every site gets while no tracer is installed."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()
_active: Optional["Tracer"] = None


class Tracer:
    """Spans and counters in memory, in the order they were entered.
    :func:`install` it to record; it is its own context manager for the
    span :func:`span` just named (spans nest, so the span to close is
    always the innermost open one)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counts: List[Count] = []
        self._open: List[int] = []
        self._next: tuple = ("", None)

    def clear(self) -> None:
        """Forget every record; only between spans."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} span(s) still open")
        self.spans.clear()
        self.counts.clear()

    def __enter__(self) -> None:
        name, rid = self._next
        parent = self._open[-1] if self._open else -1
        if rid is None and parent >= 0:
            rid = self.spans[parent].rid
        t0 = time.perf_counter_ns()
        self._open.append(len(self.spans))
        self.spans.append(Span(name, t0, 0, parent, rid))

    def __exit__(self, *exc) -> bool:
        self.spans[self._open.pop()].t1_ns = time.perf_counter_ns()
        return False

    def _count(self, name: str, value: float) -> None:
        rid = self.spans[self._open[-1]].rid if self._open else None
        self.counts.append(Count(name, rid, value))

    # -- reading --------------------------------------------------------
    def path(self, i: int) -> str:
        """Span ``i``'s name after its ancestors', root first:
        ``"step/start/compress/encode"``."""
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))

    def innermost_at(self, t_ns: int) -> int:
        """Index of the innermost span open at ``t_ns`` (-1: none).  Spans
        nest and are kept in order of entry, so every span open at
        ``t_ns`` is the last one entered by then or an ancestor of it: a
        bisection and a walk up its parents."""
        i = bisect.bisect_right(self.spans, t_ns, key=lambda s: s.t0_ns) - 1
        while i >= 0 and not self.spans[i].t0_ns <= t_ns <= (
                self.spans[i].t1_ns or t_ns):
            i = self.spans[i].parent
        return i


def install(tracer: Tracer) -> None:
    """Record into ``tracer`` from now on."""
    global _active
    if _active is not None and _active is not tracer:
        raise RuntimeError("another tracer is installed")
    _active = tracer


def uninstall() -> None:
    """Stop recording (the records stay on the tracer)."""
    global _active
    _active = None


def installed() -> Optional[Tracer]:
    return _active


def span(name: str, rid: Optional[int] = None):
    """``with span("compress"):`` times the block into the installed
    tracer; without one, it is :data:`NO_SPAN` and costs nothing more."""
    t = _active
    if t is None:
        return NO_SPAN
    t._next = (name, rid)
    return t


def count(name: str, value: float) -> None:
    """Record ``value`` under ``name`` in the innermost open span."""
    t = _active
    if t is not None:
        t._count(name, value)


def _nbytes(a: Any) -> int:
    """Bytes of a tensor or array, from its shape and dtype."""
    if hasattr(a, "element_size"):
        return a.numel() * a.element_size()
    return a.nbytes


def count_bytes(name: str, a: Any, b: Any = None) -> None:
    """Record the bytes of one or two tensors or arrays under ``name``."""
    t = _active
    if t is not None:
        t._count(name, _nbytes(a) + (0 if b is None else _nbytes(b)))
