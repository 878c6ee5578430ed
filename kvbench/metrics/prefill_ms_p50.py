"""The median prefill stage of the cold requests started in the window, from
the runtime's per-request breakdown (a measured, synchronised stage)."""
from kvb.layers import stage_ms


def read(run):
    return stage_ms(run, "prefill", 0.5)
