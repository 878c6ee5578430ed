"""Kernel ``paged_mla_attention`` (``mla_decode_partial`` and
``mla_decode_combine``): the least time its bytes need at 3.35 TB/s (each
live position's latent and rope key read once, the scratch page once,
queries and tables read, outputs written: the probe's count for the paged
step through the configuration module's ``sizes``, ``kvb.counts``) over
the device time of its kernels in the traced sub-window, as a share (%).
A program without the kernel gives no reading."""
from kvb import counts


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_time("mla_decode_partial", "mla_decode_combine")
    nbytes = run.probe.traced_bytes.get("paged_attention", 0.0)
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_S / t
