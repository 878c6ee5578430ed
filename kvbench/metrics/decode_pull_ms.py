"""Decode worker: the mean over the window's decode iterations of the
port's ``pull`` span under ``decode_iteration``, in ms: the wait for the
step's tokens, the device finishing the step."""
from kvb.spans import READERS


def read(run):
    return READERS["decode_pull_ms"](run)
