"""Decode worker: the mean over the window's decode iterations of the
port's ``prepare`` and ``launch`` spans under ``decode_iteration``, in ms: the
host's side of a step (staging and the graph's replay)."""
from kvb.spans import READERS


def read(run):
    return READERS["decode_host_ms"](run)
