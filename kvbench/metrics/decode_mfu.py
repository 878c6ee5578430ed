"""Model: the decode steps' share (%) of the card's bf16 peak: the
benchmark's count of their algorithmic operations (2 x the weights each
live slot's token multiplies by, QK and PV over its context) over the
summed wall time of the decode iterations."""
from kvb import counts


def read(run):
    spans = run.probe.spans.get("decode_iteration", [])
    if not spans or run.probe.decode_flops <= 0:
        return None
    return (100.0 * run.probe.decode_flops / sum(spans)
            / counts.PEAK_BF16_FLOP_S)
