"""Decode worker: the mean over the window's decode iterations of the
port's ``decode_slots`` counter, the live slots a step advances."""
from kvb.spans import READERS


def read(run):
    return READERS["decode_live_slots"](run)
