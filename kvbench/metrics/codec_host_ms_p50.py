"""Pipeline: the median over the cold starts due in the window of the
host part of the port's ``compress`` span, its ``to_host`` copies and ``encode``
codec, in ms."""
from kvb.spans import READERS


def read(run):
    return READERS["codec_host_ms_p50"](run)
