"""Model: the prefills' share (%) of the card's bf16 peak: the
benchmark's count of a prompt's algorithmic operations over the summed
wall time of the prefill calls."""
from kvb import counts


def read(run):
    spans = run.probe.spans.get("prefill", [])
    if not spans or run.probe.prefill_flops <= 0:
        return None
    return (100.0 * run.probe.prefill_flops / sum(spans)
            / counts.PEAK_BF16_FLOP_S)
