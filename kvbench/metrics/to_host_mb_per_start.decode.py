"""Pipeline: the mean over the closed loop's starts in the window of the
port's ``to_host_bytes`` counter (device-to-host copies, from shapes and
dtypes), in MB (1e6 B) a start."""
from kvb.spans import READERS


def read(run):
    return READERS["to_host_mb_per_start.decode"](run)
