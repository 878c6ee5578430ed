"""Controller and wire: the KB (1e3 B) of cache a cold start extracts for
the wire, per prompt token, from the port's ``kv_part_bytes.<part>``
counters (each part's bf16 bytes, counted in ``start/extract``: K and V,
or MLA's latent and rope key), summed over the parts, averaged over the
starts due in the window.  A latent expanded to per-head K/V before the
wire reads as that.  A program without the counters gives no reading."""
from statistics import mean

from kvb.layers import started

PREFIX = "kv_part_bytes."


def read(run):
    t = getattr(run, "spans", None)
    if t is None:
        return None
    rids = {r.rid for r in started(run)}
    per = {}
    for c in t.counts:
        if c.name.startswith(PREFIX) and c.rid in rids:
            per[c.rid] = per.get(c.rid, 0.0) + c.value
    if not per:
        return None
    return mean(per.values()) / run.cell.traffic["prompt_tokens"] / 1e3
