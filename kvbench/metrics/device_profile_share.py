"""Controller: the share (%) of cold requests started in the window whose
chosen profile quantizes on the device (``quant_pack`` / ``dequant_unpack``)
rather than passing the KV through at 16 bits."""
from kvb.layers import started


def read(run):
    profs = [run.probe.landed[r.rid].profile for r in started(run)
             if r.rid in run.probe.landed
             and run.probe.landed[r.rid].profile is not None]
    if not profs:
        return None
    dev = sum(1 for p in profs if p.strategy.key_bits < 16)
    return 100.0 * dev / len(profs)
