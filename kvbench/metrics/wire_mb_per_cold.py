"""Controller and wire: mean megabytes (1e6 B) on the wire per cold request
started in the window, by the harness's own count of each payload (held
equal to what the runtime sent and billed by the ``wire_mismatch``
check)."""
from kvb.layers import started


def read(run):
    own = [run.probe.landed[r.rid].own_bytes for r in started(run)
           if r.rid in run.probe.landed
           and run.probe.landed[r.rid].own_bytes is not None]
    return sum(own) / len(own) / 1e6 if own else None
