"""``chip_smoke.py``'s phase 6 (the trace-driven 2x2 pool cluster) under the
card's clock, emulated at tiny-lm size, across timings.

On the card, phase 6's runtime keeps the wall clock.  Its router then has
no queue term (``ClusterRuntime.route_cost`` estimates decode at 0 without
``decode_tok_s``): a request whose prefix a worker holds locally goes to
that worker, and every other request goes to decode worker 0 until its
slots are full.  Which tier a repeat hits then turns on the card's timing.
Here each stage takes the time phase 6 measured on an H100 (prefill 76 ms
and compress 58 ms under the virtual clock; a hit's landing 490 ms and a
decode iteration 75 ms, charged by wrapping ``DecodeWorker.fetch_entry``
and ``DecodeWorker.decode_iteration`` while ``decode_tok_s`` stays unset,
as on the card), each scaled by 0.8 to 1.2.  Phase 6's gate must hold at
every timing: a hit in a worker-local tier and one in the shared remote
tier.

The second pass's remote hits do not depend on timing.  Every prompt's
first request is a miss that writes it into a worker's tiers.  The two
workers' local tiers hold four entries each, fewer than the trace's eleven
prompts, and the remote tier never evicts here.  So when the first pass
has drained, at least three prompts live only in the shared tier.  Until
its next request, nothing can bring such a prompt back into a local tier:
only a fetch promotes, and no miss can rewrite a prompt every worker sees.
Every prompt comes again in the second pass, so each of those three is a
remote hit there.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import (  # noqa: E402,F401
    GBPS,
    Pkg,
    _cluster,
    one_thread,
    port_model,
)
from test_torch_workloads import phase6_events  # noqa: E402

# Phase 6's stage times on the card (seconds); tiers hold as many entries
# as its 256 and 128 MiB do of its 69.2 MB prefixes.
PREFILL_S, COMPRESS_S, LANDING_S, DECODE_S = 0.076, 0.058, 0.490, 0.075
HOT_ENTRIES, DRAM_ENTRIES, PROMPTS = 3.88, 1.94, 11
STAGES = ("prefill", "compress", "landing", "decode")
# each stage alone at 0.8-1.2, and the corners of the three that set the
# cluster's clock (a pool write leaves the critical path)
TIMINGS = ([dict.fromkeys(STAGES, 1.0)]
           + [dict(dict.fromkeys(STAGES, 1.0), **{s: f})
              for s in STAGES for f in (0.8, 0.9, 1.1, 1.2)]
           + [dict(prefill=p, compress=1.0, landing=l, decode=d)
              for p in (0.8, 1.2) for l in (0.8, 1.2) for d in (0.8, 1.2)])


def _id(t):
    return "-".join(f"{s}{t[s]:g}" for s in STAGES)


def _tier_hits(rt):
    tiers = rt.decode_workers[0].store.tiers
    hits = dict.fromkeys((t.name for t in tiers), 0)
    for dw in rt.decode_workers:
        s = dw.store.summary()
        for i, t in enumerate(tiers):
            hits[t.name] += s[f"tier{i}_{t.name}_hits"]
    return hits


@pytest.mark.parametrize("timing", TIMINGS, ids=_id)
def test_phase6_hits_both_tier_kinds_across_timings(timing, port_model,
                                                    monkeypatch):
    p = Pkg("repro_torch", port_model, device="cpu")
    workers = p.m("serving.workers")
    iterate = workers.DecodeWorker.decode_iteration
    land = workers.DecodeWorker.fetch_entry

    def decode_iteration(self, active):
        iterate(self, active)
        return DECODE_S * timing["decode"]

    def fetch_entry(self, entry, idx):
        first, _ = land(self, entry, idx)
        return first, LANDING_S * timing["landing"]

    monkeypatch.setattr(workers.DecodeWorker, "decode_iteration",
                        decode_iteration)
    monkeypatch.setattr(workers.DecodeWorker, "fetch_entry", fetch_entry)

    seq = 128
    kv = p.m("core.kvcache").KVCache.random(num_layers=4, kv_heads=2,
                                            seq=seq, head_dim=32, seed=0)
    prof = p.profile(s=kv.nbytes_wire() / (COMPRESS_S * timing["compress"]),
                     granularity="per_token", symmetric=True, group_size=32)
    entry = p.m("core.pipeline").CompressionPipeline(
        prof.strategy).compress(kv).total_bytes()
    rt = _cluster(p, mode="pool", n_prefill=2, n_decode=2,
                  router="load_aware", static_profile=prof,
                  bandwidth=100 * GBPS, max_prefills=2, max_slots=4,
                  config=p.config(
                      seq=seq, decode_tokens=20,
                      prefill_tok_s=seq / (PREFILL_S * timing["prefill"]),
                      decode_tok_s=None, mode="pool", paged=True,
                      page_size=16, hot_tier_bytes=int(HOT_ENTRIES * entry),
                      dram_tier_bytes=int(DRAM_ENTRIES * entry),
                      store_capacity=60 * entry))
    W = p.m("workloads")
    trace, events = phase6_events(W)
    per_pass = []
    with one_thread():
        for _ in range(2):
            W.replay_runtime(rt, trace, events=[
                dataclasses.replace(e, t=e.t + rt.clock) for e in events])
            per_pass.append(_tier_hits(rt))
    first, both = per_pass
    print(f"{_id(timing)}: first pass {first}, both passes {both}")
    assert len(rt.completed) == 2 * len(events)
    assert len({(e.workload, e.prefix_group) for e in events}) == PROMPTS
    local_slots = 2 * (int(HOT_ENTRIES) + int(DRAM_ENTRIES))
    assert both["remote"] - first["remote"] >= PROMPTS - local_slots
    assert both["hbm"] + both["dram"] > 0 and both["remote"] > 0
