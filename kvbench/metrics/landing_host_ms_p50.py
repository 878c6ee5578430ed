"""Pipeline: the median over the cold starts due in the window of the
host part of the landing, the port's ``unpack`` and ``to_device`` spans under
``decompress`` and ``inject``, in ms."""
from kvb.spans import READERS


def read(run):
    return READERS["landing_host_ms_p50"](run)
