"""The median compress stage of the requests the closed loop started in
the window (the runtime's per-request breakdown, a measured, synchronised
stage): each start's codec runs on the one host thread that also drives
the decode steps, so its time comes out of the window's throughput."""
from kvb.layers import stage_ms


def read(run):
    return stage_ms(run, "compress", 0.5)
