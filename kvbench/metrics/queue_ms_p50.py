"""Scheduler: the median of each request's wait from its due time
to its start (submission lag plus the scheduler's queue), the requests
still waiting at the close counted at their elapsed wait."""
from kvb.window import quantile


def read(run):
    w = run.window
    vals = [(r.submitted - r.due) + r.breakdown["queue"] if r.breakdown
            else w.c_end - r.due for r in w.due_in_window()]
    return quantile(vals, 0.5) * 1e3 if vals else None
