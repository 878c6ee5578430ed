"""Kernel ``paged_attention`` (``split_scores`` and ``split_values``): the
least time its bytes need at 3.35 TB/s (each live position's K and V read
once, the scratch page once, queries and tables read, outputs written;
``kvb.counts``) over the device time of its kernels in the traced
sub-window, as a share (%)."""
from kvb import counts


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_time("split_scores", "split_values")
    nbytes = run.probe.traced_bytes.get("paged_attention", 0.0)
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_S / t
