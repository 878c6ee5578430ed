"""Kernel ``quant_pack``: the least time its bytes need at 3.35 TB/s (the
input read once, codes and f32 scales written) over the device time of
its kernels in the traced sub-window, as a share (%)."""
from kvb import counts


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_time("quant_pack")
    nbytes = run.probe.traced_bytes.get("quant_pack", 0.0)
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_S / t
