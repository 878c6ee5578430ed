"""Pipeline: the median over the closed loop's starts in the window of the
host part of the port's ``compress`` span (``to_host`` and ``encode``), in ms:
it runs on the one host thread that also drives the decode steps."""
from kvb.spans import READERS


def read(run):
    return READERS["codec_host_ms_p50.decode"](run)
