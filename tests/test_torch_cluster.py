"""The port's multi-worker, tiered serving (``repro_torch.serving.cluster``)
against the JAX package's, live, on the same weights.

Each ``case_*`` below builds runtimes through the same code in either
package: the runtime cases of ``tests/test_cluster.py``,
``test_tiered_runtime.py``, ``test_pd_runtime.py`` and
``test_engine_runtime.py``, plus 2x2 clusters in pool and pd mode under
both routers.  :func:`record` takes, per request, the route, the pool hit
and the tier that served it, the wire bytes, every breakdown entry, TTFT,
JCT, the slot and the tokens, and per runtime ``summary()``, each decode
worker's store summary, the topology's summary and the clock.  Everything
but the tokens must be equal.  Greedy tokens must be equal up to a step
where the JAX top-2 logit gap lies within
``test_torch_runtime._within_tolerance``; the test prints each such flip.
Where the reference test asserts a property (2x2 scales, load-aware beats
round-robin on heterogeneous links, worker-local PD pools, the
cluster-shared remote tier, affinity, aging), ``check_*`` asserts it on
the port's run too.

The JAX side runs in a subprocess with ``--xla_allow_excess_precision=false``
(``python tests/test_torch_cluster.py OUT_DIR MODULE CASE...``), which
writes one JSON file per case as it finishes, so the port runs its cases
meanwhile.  That process records every JAX logit row's top two, per
request, by wrapping ``DecodeWorker.decode_iteration``.
``tests/test_torch_workloads.py`` drives its replay cases through the same
harness.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
GBPS = 1e9 / 8
WORKLOAD_CYCLE = ("qalike", "codelike", "mathlike", "summlike")


# ---------------------------------------------------------------------------
# One package's serving surface, so a case runs unchanged on either
# ---------------------------------------------------------------------------
class Pkg:
    def __init__(self, name, model, **runtime_kw):
        self.name, self.model, self.runtime_kw = name, model, runtime_kw

    def m(self, path):
        return importlib.import_module(f"{self.name}.{path}")

    def profile(self, cr=2.0, bits=8, codec=None, s=5e8, **strategy):
        kw = dict(quantizer="uniform", key_bits=bits, value_bits=bits,
                  granularity="per_channel")
        if codec:
            kw["codec"] = codec
        kw.update(strategy)
        return self.m("core.profiles").Profile(
            self.m("core.strategy").StrategyConfig(**kw), cr=cr, s_enc=s,
            s_dec=s)

    def config(self, **kw):
        return self.m("serving.workers").RuntimeConfig(**kw)

    def sched(self, **kw):
        return self.m("serving").SchedulerConfig(**kw)

    def trace(self, bandwidth):
        return self.m("serving").BandwidthTrace.constant(bandwidth)

    def _pin(self, rt):
        rt.model_cfg, rt.params = self.model
        return rt

    def cluster(self, **kw):
        return self._pin(self.m("serving.cluster").ClusterRuntime(
            **kw, **self.runtime_kw))

    def serving(self, **kw):
        return self._pin(self.m("serving.engine").ServingRuntime(
            **kw, **self.runtime_kw))


def _cluster(p, *, mode="pool", seq=48, decode_tokens=4, prefill_tok_s=2000.0,
             decode_tok_s=500.0, bandwidth=1 * GBPS, max_prefills=1,
             max_slots=4, n_prefill=1, n_decode=1, **kw):
    """``tests/test_cluster.py::_cluster`` on package ``p``."""
    defaults = dict(
        static_profile=p.profile(),
        config=p.config(seq=seq, decode_tokens=decode_tokens,
                        prefill_tok_s=prefill_tok_s,
                        decode_tok_s=decode_tok_s, mode=mode),
        trace=p.trace(bandwidth),
        scheduler=p.sched(max_slots=max_slots,
                          max_prefills_per_step=max_prefills, max_queue=256),
        n_prefill=n_prefill, n_decode=n_decode)
    defaults.update(kw)
    return p.cluster(**defaults)


def _serving(p, *, mode="pool", seq=48, decode_tokens=4, prefill_tok_s=2000.0,
             decode_tok_s=500.0, bandwidth=1 * GBPS, max_prefills=2,
             max_slots=6, tiers=None, **kw):
    """The reference runtime tests' ``ServingRuntime`` set-ups."""
    defaults = dict(
        static_profile=p.profile(),
        config=p.config(seq=seq, decode_tokens=decode_tokens,
                        prefill_tok_s=prefill_tok_s,
                        decode_tok_s=decode_tok_s, mode=mode, tiers=tiers),
        trace=p.trace(bandwidth),
        scheduler=p.sched(max_slots=max_slots,
                          max_prefills_per_step=max_prefills, max_queue=32))
    defaults.update(kw)
    return p.serving(**defaults)


class _Spy:
    """Static-profile controller that records every observe() call."""

    def __init__(self, p, profile):
        self._decision = p.m("controller").Decision
        self.profile, self.observed = profile, []

    def select(self, ctx):
        return self._decision(self.profile, 0, 0, 0.0)

    def observe(self, ctx, decision, latency):
        self.observed.append([ctx.slo_metric, float(latency)])


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------
def _pinned(p, mode):
    from _runtime_scenario import run_scenario
    rt = _cluster(p, mode=mode, seq=64, decode_tokens=6, bandwidth=1 * GBPS,
                  max_prefills=2, max_slots=6,
                  scheduler=p.sched(max_slots=6, max_prefills_per_step=2,
                                    max_queue=32))
    run_scenario(rt)
    return {"runtimes": {"rt": rt}}


def case_1x1_pool(p):
    return _pinned(p, "pool")


def case_1x1_pd(p):
    return _pinned(p, "pd")


def check_1x1_pool(res):
    assert all(r["route"] == "p0->d0"
               for r in res["runtimes"]["rt"]["requests"].values())


check_1x1_pd = check_1x1_pool


def case_2x2_throughput(p):
    out = {}
    for n in (1, 2):
        rt = _cluster(p, mode="pd", decode_tokens=3, prefill_tok_s=200.0,
                      n_prefill=n, n_decode=n)
        for i in range(16):
            rt.submit(WORKLOAD_CYCLE[i % 4], prompt_seed=500 + 11 * i,
                      out_tokens=1)
        rt.run()
        out[f"{n}x{n}"] = rt
    return {"runtimes": out}


def check_2x2_throughput(res):
    rts = res["runtimes"]
    t11 = len(rts["1x1"]["requests"]) / rts["1x1"]["clock"]
    t22 = len(rts["2x2"]["requests"]) / rts["2x2"]["clock"]
    assert len(rts["2x2"]["requests"]) == 16
    assert t22 >= 1.8 * t11, (t11, t22)
    by_pw = {}
    for r in rts["2x2"]["requests"].values():
        pw = r["route"].split("->")[0]
        by_pw[pw] = by_pw.get(pw, 0) + 1
    assert set(by_pw) == {"p0", "p1"} and min(by_pw.values()) >= 4
    s = rts["2x2"]["summary"]
    assert s["n_prefill_workers"] == 2.0 and s["n_decode_workers"] == 2.0
    assert "jct_p95" in s and "ttft_p99" in s


def case_hetero_links(p):
    out = {}
    for router in ("round_robin", "load_aware"):
        topo = p.m("serving").NetworkTopology.full_mesh(
            1, 2, p.trace(1 * GBPS), links={(0, 1): p.trace(0.002 * GBPS)})
        rt = _cluster(p, mode="pd", decode_tokens=3, prefill_tok_s=400.0,
                      n_prefill=1, n_decode=2, topology=topo, router=router,
                      max_slots=6)
        for i in range(6):
            rt.submit(WORKLOAD_CYCLE[i % 4], prompt_seed=900 + 7 * i,
                      out_tokens=1)
            rt.step()
        rt.run()
        out[router] = rt
    return {"runtimes": out}


def check_hetero_links(res):
    def outcome(rec):
        done = list(rec["requests"].values())
        assert len(done) == 6 and not any(r["pool_hit"] for r in done)
        return (float(np.mean([r["jct"] for r in done])),
                sum(r["route"] == "p0->d1" for r in done))
    jct_rr, slow_rr = outcome(res["runtimes"]["round_robin"])
    jct_la, slow_la = outcome(res["runtimes"]["load_aware"])
    assert jct_la < jct_rr and slow_la < slow_rr and slow_rr == 3


def case_pd_pools_worker_local(p):
    rt = _cluster(p, mode="pd", n_prefill=1, n_decode=2,
                  router="round_robin", max_prefills=1)
    for _ in range(3):
        rt.submit("qalike", prompt_seed=5)
        rt.run()
    return {"runtimes": {"rt": rt}}


def check_pd_pools_worker_local(res):
    a, b, c = (res["runtimes"]["rt"]["requests"][k] for k in "012")
    assert a["route"] == "p0->d0" and not a["pool_hit"]
    assert b["route"] == "p0->d1" and not b["pool_hit"]
    assert c["route"] == "p0->d0" and c["pool_hit"]
    assert c["wire_bytes"] == a["wire_bytes"]


def case_pool_remote_tier_shared(p):
    rt = _cluster(p, mode="pool", n_prefill=1, n_decode=2,
                  router="round_robin", prefill_tok_s=150.0,
                  decode_tok_s=20.0, bandwidth=0.05 * GBPS,
                  config=p.config(seq=48, decode_tokens=4,
                                  prefill_tok_s=150.0, decode_tok_s=20.0,
                                  hot_tier_bytes=0, dram_tier_bytes=0))
    for _ in range(2):
        rt.submit("qalike", prompt_seed=7)
        rt.run()
    d0, d1 = (dw.store.tiers for dw in rt.decode_workers)
    return {"runtimes": {"rt": rt},
            "facts": {"remote_shared": d0[-1] is d1[-1],
                      "hot_local": d0[0] is not d1[0]}}


def check_pool_remote_tier_shared(res):
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert cold["route"] == "p0->d0" and not cold["pool_hit"]
    assert hit["route"] == "p0->d1" and hit["pool_hit"]
    assert hit["tier"] == "remote" and hit["wire_bytes"] == cold["wire_bytes"]
    assert res["facts"] == {"remote_shared": True, "hot_local": True}


def case_affinity_slow_wire(p):
    topo = p.m("serving").NetworkTopology.full_mesh(
        1, 2, p.trace(1 * GBPS), links={(0, 1): p.trace(0.0002 * GBPS)})
    rt = _cluster(p, mode="pd", n_prefill=1, n_decode=2,
                  router="round_robin", prefill_tok_s=400.0, topology=topo)
    rt.submit("codelike", prompt_seed=1)
    rt.run()
    rt.submit("qalike", prompt_seed=5)
    rt.run()
    rt.router = p.m("serving.cluster").LoadAwareRouter()
    rt.submit("qalike", prompt_seed=5)
    rt.run()
    return {"runtimes": {"rt": rt}}


def check_affinity_slow_wire(res):
    reqs = res["runtimes"]["rt"]["requests"]
    assert reqs["1"]["route"] == "p0->d1"
    assert reqs["2"]["route"] == "p0->d0" and not reqs["2"]["pool_hit"]


def case_prefix_affinity(p):
    rt = _cluster(p, mode="pd", n_prefill=1, n_decode=2, router="load_aware")
    for _ in range(2):
        rt.submit("qalike", prompt_seed=5)
        rt.run()
    return {"runtimes": {"rt": rt}}


def check_prefix_affinity(res):
    a, b = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert b["route"] == a["route"] and b["pool_hit"]


def case_aging(p):
    out = {}
    for aging_s in (0.5, 0.0):
        rt = _cluster(p, mode="pool", prefill_tok_s=150.0, decode_tok_s=20.0,
                      max_prefills=1, max_slots=3,
                      scheduler=p.sched(max_slots=3, max_prefills_per_step=1,
                                        max_queue=256, aging_s=aging_s))
        rt.submit("qalike", slo_class="batch", prompt_seed=0, out_tokens=1)
        for k in range(14):
            rt.submit("codelike", slo_class="interactive",
                      prompt_seed=100 + k, out_tokens=1)
            rt.step()
        out[f"aging_{aging_s}"] = rt
    return {"runtimes": out}


def check_aging(res):
    def outcome(rec):
        return (any(r["slo_class"] == "batch"
                    for r in rec["requests"].values()),
                any(w[1] == "interactive" for w in rec["waiting"]))
    done, flooded = outcome(res["runtimes"]["aging_0.5"])
    assert done and flooded
    starved, _ = outcome(res["runtimes"]["aging_0.0"])
    assert not starved


def _two_by_two(p, mode, router):
    """A 2x2 cluster under 12 requests over six prompts: cold requests,
    pool hits and contention on every worker."""
    rt = _cluster(p, mode=mode, n_prefill=2, n_decode=2, router=router,
                  max_prefills=2, max_slots=4, bandwidth=0.2 * GBPS)
    for i in range(12):
        k = i % 6
        rt.submit(WORKLOAD_CYCLE[k % 4], prompt_seed=k,
                  slo_class=("interactive", "standard", "batch")[i % 3])
        if i % 3 == 2:
            rt.step()
    rt.run()
    return {"runtimes": {"rt": rt}}


def case_2x2_pool_load_aware(p):
    return _two_by_two(p, "pool", "load_aware")


def case_2x2_pool_round_robin(p):
    return _two_by_two(p, "pool", "round_robin")


def case_2x2_pd_load_aware(p):
    return _two_by_two(p, "pd", "load_aware")


def case_2x2_pd_round_robin(p):
    return _two_by_two(p, "pd", "round_robin")


def _check_two_by_two(res):
    rec = res["runtimes"]["rt"]
    assert len(rec["requests"]) == 12
    assert any(r["pool_hit"] for r in rec["requests"].values())
    assert {r["route"].split("->")[1] for r in rec["requests"].values()} \
        == {"d0", "d1"}


check_2x2_pool_load_aware = check_2x2_pool_round_robin = _check_two_by_two
check_2x2_pd_load_aware = check_2x2_pd_round_robin = _check_two_by_two


# ---------------------------------------------------------------------------
# tests/test_tiered_runtime.py (runtime cases)
# ---------------------------------------------------------------------------
def _remote_only(p, bandwidth, capacity=64 << 20, overhead=0.002,
                 profile=None):
    return [p.m("serving").TierSpec("remote", capacity, bandwidth=bandwidth,
                                    fetch_overhead=overhead, profile=profile,
                                    observe_goodput=True)]


def _tiered(p, **kw):
    defaults = dict(prefill_tok_s=150.0, decode_tok_s=20.0,
                    bandwidth=0.05 * GBPS, max_slots=6, max_prefills=2)
    defaults.update(kw)
    return _serving(p, **defaults)


def case_pool_fetches_contend(p):
    rt = _tiered(p, tiers=_remote_only(p, 0.002 * GBPS))
    rt.submit("qalike", prompt_seed=0)
    rt.run()
    rt.submit("codelike", prompt_seed=1)
    rt.run()
    rt.submit("qalike", prompt_seed=0)
    rt.submit("codelike", prompt_seed=1)
    rt.step()
    rt.run()
    return {"runtimes": {"rt": rt}}


def check_pool_fetches_contend(res):
    reqs = res["runtimes"]["rt"]["requests"]
    hits = [reqs["2"], reqs["3"]]
    assert all(r["pool_hit"] for r in hits)
    waits = sorted(r["breakdown"].get("wire_wait", 0.0) for r in hits)
    assert waits[0] == 0.0 and waits[1] > 0.0
    first = min(hits, key=lambda r: r["breakdown"].get("wire_wait", 0.0))
    assert waits[1] == pytest.approx(first["breakdown"]["comm"] - 0.002,
                                     rel=1e-6)


def case_hot_vs_remote_tier(p):
    TierSpec = p.m("serving").TierSpec
    out = {}
    for label, tiers in (
            ("hot", None),
            ("remote", [TierSpec("hbm", 0, bandwidth=64e9),
                        TierSpec("dram", 0, bandwidth=8e9,
                                 fetch_overhead=5e-4),
                        TierSpec("remote", 64 << 20, bandwidth=0.05 * GBPS,
                                 fetch_overhead=0.002,
                                 observe_goodput=True)])):
        rt = _tiered(p, tiers=tiers)
        for _ in range(2):
            rt.submit("qalike", prompt_seed=7)
            rt.run()
        out[label] = rt
    return {"runtimes": out}


def check_hot_vs_remote_tier(res):
    hot, rem = (res["runtimes"][k]["requests"] for k in ("hot", "remote"))
    assert not hot["0"]["pool_hit"] and hot["1"]["pool_hit"]
    assert hot["1"]["tier"] == "hbm" and rem["1"]["tier"] == "remote"
    assert hot["1"]["ttft"] < rem["1"]["ttft"] < rem["0"]["ttft"]


def case_refetch_smaller(p):
    q8 = p.profile(cr=2.0, bits=8)
    q4z = p.profile(cr=6.0, bits=4, codec="zstd3")
    workloads = p.m("data.synthetic").WORKLOADS
    controller = p.m("controller").ServiceAwareController(
        {w: [q8] for w in workloads})
    rt = _tiered(p, static_profile=None, controller=controller,
                 tiers=_remote_only(p, 0.002 * GBPS, profile=q4z))
    for _ in range(2):
        rt.submit("qalike", prompt_seed=3, q_min=0.5)
        rt.run()
    return {"runtimes": {"rt": rt},
            "facts": {"q4z": q4z.strategy.short_name(),
                      "used_bytes": int(rt.store.used_bytes)}}


def check_refetch_smaller(res):
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert hit["pool_hit"] and hit["wire_bytes"] < cold["wire_bytes"]
    assert hit["profile"] == res["facts"]["q4z"]
    assert res["facts"]["used_bytes"] == hit["wire_bytes"]
    assert hit["breakdown"].get("compress", 0.0) > 0.0


def case_pd_single_pool_tier(p):
    rt = _serving(p, mode="pd", max_slots=4)
    facts = {"n_tiers": len(rt.store.tiers),
             "shares_wire": rt.store.tiers[0].wire is rt.wire}
    for _ in range(2):
        rt.submit("qalike", prompt_seed=5)
        rt.run()
    facts["transfers"] = rt.wire.transfers
    return {"runtimes": {"rt": rt}, "facts": facts}


def check_pd_single_pool_tier(res):
    assert res["facts"] == {"n_tiers": 1, "shares_wire": True,
                            "transfers": 2}
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert not cold["pool_hit"] and hit["pool_hit"]


def case_pd_explicit_tiers(p):
    rt = _serving(p, mode="pd", max_slots=4, bandwidth=0.05 * GBPS,
                  tiers=_remote_only(p, 0.05 * GBPS))
    facts = {"shares_wire": rt.store.tiers[-1].wire is rt.wire}
    for _ in range(2):
        rt.submit("qalike", prompt_seed=5)
        rt.run()
    facts["transfers"] = rt.wire.transfers
    return {"runtimes": {"rt": rt}, "facts": facts}


def check_pd_explicit_tiers(res):
    assert res["facts"] == {"shares_wire": True, "transfers": 2}
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert not cold["pool_hit"] and hit["pool_hit"]


# ---------------------------------------------------------------------------
# tests/test_pd_runtime.py
# ---------------------------------------------------------------------------
def _pd(p, **kw):
    defaults = dict(mode="pd", seq=64, decode_tokens=6)
    defaults.update(kw)
    return _serving(p, **defaults)


def case_pd_cold_critical_path(p):
    rt = _pd(p)
    rt.submit("qalike", prompt_seed=3)
    rt.run()
    return {"runtimes": {"rt": rt}}


def check_pd_cold_critical_path(res):
    r = res["runtimes"]["rt"]["requests"]["0"]
    bd = r["breakdown"]
    assert not r["pool_hit"] and r["t_pool_write"] == 0.0
    assert all(bd.get(k, 0.0) > 0.0
               for k in ("prefill", "compress", "comm", "decompress"))
    stages = (bd["queue"] + bd["prefill"] + bd["compress"]
              + bd.get("wire_wait", 0.0) + bd["comm"] + bd["decompress"])
    assert r["ttft"] == pytest.approx(stages, abs=1e-9)
    assert 0 < r["wire_bytes"] < r["kv_bytes"]


def case_pd_prefix_hit(p):
    rt = _pd(p)
    for _ in range(2):
        rt.submit("qalike", prompt_seed=9)
        rt.run()
    return {"runtimes": {"rt": rt}}


def check_pd_prefix_hit(res):
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert not cold["pool_hit"] and hit["pool_hit"]
    assert hit["breakdown"].get("prefill", 0.0) == 0.0
    assert hit["wire_bytes"] == cold["wire_bytes"]
    assert hit["ttft"] < cold["ttft"]
    assert len(hit["tokens"]) == len(cold["tokens"]) == 7


def case_pd_wire_serializes(p):
    rt = _pd(p, bandwidth=0.002 * GBPS)
    rt.submit("qalike", prompt_seed=0)
    rt.submit("codelike", prompt_seed=1)
    rt.step()
    rt.run()
    return {"runtimes": {"rt": rt}}


def check_pd_wire_serializes(res):
    first, second = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    assert first["breakdown"].get("wire_wait", 0.0) == 0.0
    assert second["breakdown"].get("wire_wait", 0.0) > 0.0


def case_pd_streams_overlap(p):
    rt = _pd(p, max_prefills=1)
    rt.submit("qalike", prompt_seed=0)
    rt.step()
    rt.submit("codelike", prompt_seed=1)
    stats = rt.step()
    step_cost = rt.step_log[-1]["clock"] - rt.step_log[-2]["clock"]
    start = dict(rt._slots[1].breakdown)
    facts = {"in_flight": stats["in_flight"], "step_cost": step_cost,
             "start": start, "decode_cost": 1.0 / rt.cfg.decode_tok_s}
    rt.run()
    return {"runtimes": {"rt": rt}, "facts": facts}


def check_pd_streams_overlap(res):
    f = res["facts"]
    s = f["start"]
    work = (s["prefill"] + s["compress"] + s.get("wire_wait", 0.0)
            + s["comm"] + s["decompress"])
    assert f["in_flight"] == 2.0
    assert f["step_cost"] == pytest.approx(max(work, f["decode_cost"]),
                                           rel=1e-9)


def case_pd_lifecycle(p):
    rt = _pd(p, max_prefills=1, max_slots=2,
             scheduler=p.sched(max_slots=2, max_prefills_per_step=1,
                               max_queue=3))
    for i, w in enumerate(("qalike", "codelike", "mathlike")):
        rt.submit(w, prompt_seed=i)
    facts = {"shed": rt.submit("summlike", prompt_seed=3),
             "rejected": rt.scheduler.admission.rejected,
             "counts": [rt.scheduler.state_counts()]}
    rt.step()
    facts["counts"].append(rt.scheduler.state_counts())
    rt.run()
    facts["finished"] = [q.state for q in rt.scheduler.finished]
    return {"runtimes": {"rt": rt}, "facts": facts}


def check_pd_lifecycle(res):
    f = res["facts"]
    assert f["shed"] is None and f["rejected"] == 1
    assert f["counts"][0] == {"waiting": 3}
    assert f["counts"][1].get("decoding") == 1
    assert f["counts"][1].get("waiting") == 2
    assert f["finished"] and all(s == "done" for s in f["finished"])


def case_pd_slo_metric_jct(p):
    spy = _Spy(p, p.profile())
    rt = _pd(p, controller=spy, static_profile=None)
    rt.submit("qalike", prompt_seed=5, t_slo=1e-6)
    rt.run()
    return {"runtimes": {"rt": rt}, "facts": {"observed": spy.observed}}


def check_pd_slo_metric_jct(res):
    r = res["runtimes"]["rt"]["requests"]["0"]
    assert r["slo_metric"] == "jct" and r["slo_violated"]
    ((metric, obs),) = res["facts"]["observed"]
    assert metric == "jct"
    assert obs == pytest.approx(r["jct"], abs=1e-9)


def case_pd_compression_crossover(p):
    identity = p.m("core.profiles").IDENTITY_PROFILE
    comp = p.profile(cr=6.0, bits=4, codec="zstd3")
    out = {}
    for label, prof in (("comp", comp), ("identity", identity)):
        for bw_label, bw in (("low", 50e6 / 8), ("high", 100 * GBPS)):
            rt = _pd(p, static_profile=prof, bandwidth=bw)
            for i, w in enumerate(WORKLOAD_CYCLE):
                rt.submit(w, prompt_seed=10 + i)
                rt.step()
            rt.run()
            out[f"{label}_{bw_label}"] = rt
    return {"runtimes": out}


def check_pd_compression_crossover(res):
    def mean_jct(label):
        reqs = res["runtimes"][label]["requests"].values()
        assert not any(r["pool_hit"] for r in reqs)
        return float(np.mean([r["jct"] for r in reqs]))
    assert mean_jct("comp_low") < mean_jct("identity_low")
    assert mean_jct("identity_high") < mean_jct("comp_high")


# ---------------------------------------------------------------------------
# tests/test_engine_runtime.py (runtime cases)
# ---------------------------------------------------------------------------
def _engine(p, **kw):
    defaults = dict(seq=64, decode_tokens=6)
    defaults.update(kw)
    return _serving(p, **defaults)


def case_pool_hit_beats_cold(p):
    rt = _engine(p)
    for _ in range(2):
        rt.submit("qalike", prompt_seed=42)
        rt.run()
    return {"runtimes": {"rt": rt}}


def check_pool_hit_beats_cold(res):
    rec = res["runtimes"]["rt"]
    cold, hit = (rec["requests"][k] for k in "01")
    assert not cold["pool_hit"] and hit["pool_hit"]
    assert hit["ttft"] < cold["ttft"]
    assert hit["breakdown"]["comm"] > 0
    assert hit["breakdown"].get("prefill", 0) == 0
    assert cold["t_pool_write"] > 0 and hit["t_pool_write"] == 0
    assert hit["wire_bytes"] == cold["wire_bytes"] > 0
    assert hit["wire_bytes"] < cold["kv_bytes"]
    assert len(hit["tokens"]) == len(cold["tokens"]) == 7
    assert rec["summary"]["store_hits"] == 1


def case_concurrent_in_flight(p):
    rt = _engine(p)
    for i, w in enumerate(WORKLOAD_CYCLE + ("qalike", "codelike")):
        rt.submit(w, prompt_seed=i)
    rt.run()
    return {"runtimes": {"rt": rt}}


def check_concurrent_in_flight(res):
    rec = res["runtimes"]["rt"]
    assert len(rec["requests"]) == 6
    assert rec["summary"]["max_in_flight"] >= 4


def case_admission_slo_priority(p):
    rt = _engine(p, scheduler=p.sched(max_slots=2, max_prefills_per_step=1,
                                      max_queue=4, aging_s=0.0))
    rids = [rt.submit("qalike", slo_class=c, prompt_seed=i)
            for i, c in enumerate(("batch", "batch", "batch", "interactive",
                                   "batch"))]
    rt.run()
    return {"runtimes": {"rt": rt}, "facts": {"rids": rids}}


def check_admission_slo_priority(res):
    assert res["facts"]["rids"] == [0, 1, 2, 3, None]
    reqs = res["runtimes"]["rt"]["requests"].values()
    inter = [r["ttft"] for r in reqs if r["slo_class"] == "interactive"]
    batch = [r["ttft"] for r in reqs if r["slo_class"] == "batch"]
    assert len(inter) == 1 and inter[0] <= min(batch)


def case_store_eviction_tiny(p):
    store = p.m("serving").PrefixKVStore(capacity_bytes=40_000, block=16)
    rt = _engine(p, store=store)
    for i in range(4):
        rt.submit("codelike", prompt_seed=100 + i)
        rt.run()
    return {"runtimes": {"rt": rt},
            "facts": {"used": store.used_bytes, "cap": store.capacity_bytes,
                      "evictions": store.stats.evictions,
                      "rejected": store.stats.rejected_puts}}


def check_store_eviction_tiny(res):
    f = res["facts"]
    assert f["used"] <= f["cap"]
    assert f["evictions"] > 0 or f["rejected"] > 0


def case_observes_critical_path(p):
    spy = _Spy(p, p.profile())
    rt = _engine(p, controller=spy, static_profile=None)
    rt.submit("qalike", prompt_seed=7, slo_metric="jct")
    rt.run()
    rt.submit("qalike", prompt_seed=7)
    rt.run()
    return {"runtimes": {"rt": rt}, "facts": {"observed": spy.observed}}


def check_observes_critical_path(res):
    cold, hit = (res["runtimes"]["rt"]["requests"][k] for k in "01")
    ((_, obs),) = res["facts"]["observed"]
    assert not cold["pool_hit"] and hit["pool_hit"]
    assert obs == pytest.approx(sum(cold["breakdown"].values()), abs=1e-9)
    assert obs == pytest.approx(cold["jct"], abs=1e-9)
    assert cold["t_pool_write"] > 0


def case_slo_metric_observation(p):
    out, facts = {}, {}
    for label, kw in (("ttft", {}), ("tight", {"t_slo": 1e-6})):
        spy = _Spy(p, p.profile())
        rt = _engine(p, controller=spy, static_profile=None)
        rt.submit("qalike", prompt_seed=11 if label == "ttft" else 12, **kw)
        rt.run()
        out[label], facts[label] = rt, spy.observed
    return {"runtimes": out, "facts": facts}


def check_slo_metric_observation(res):
    r = res["runtimes"]["ttft"]["requests"]["0"]
    ((_, obs),) = res["facts"]["ttft"]
    assert obs == pytest.approx(r["ttft"], abs=1e-9) and obs < r["jct"]
    r2 = res["runtimes"]["tight"]["requests"]["0"]
    ((_, obs2),) = res["facts"]["tight"]
    assert r2["slo_violated"] and obs2 == pytest.approx(r2["ttft"], abs=1e-9)


def case_run_budget(p):
    rt = _engine(p)
    rt.submit("qalike", prompt_seed=0)
    facts = {}
    rt.run(max_steps=3)
    facts["first"] = [rt.steps, rt.scheduler.idle]
    rt.run(max_steps=3)
    facts["second"] = rt.steps
    rt.run()
    facts["last"] = rt.scheduler.idle
    return {"runtimes": {"rt": rt}, "facts": facts}


def check_run_budget(res):
    assert res["facts"] == {"first": [3, False], "second": 6, "last": True}


def case_slot_recycling(p):
    rt = _engine(p)
    for i, w in enumerate(WORKLOAD_CYCLE * 2):
        rt.submit(w, prompt_seed=i)
    rt.run()
    return {"runtimes": {"rt": rt},
            "facts": {"n_slots": rt.n_slots,
                      "free": sorted(rt.scheduler._free_slots)}}


def check_slot_recycling(res):
    n = res["facts"]["n_slots"]
    slots = [r["slot"] for r in res["runtimes"]["rt"]["requests"].values()]
    assert len(slots) == 8 and all(0 <= s < n for s in slots)
    assert len(set(slots)) <= n < len(slots)
    assert res["facts"]["free"] == list(range(n))


# An entropy codec's output size follows the KV's values, and the port's
# prefill KV differs from JAX's in the last bf16 place on some prompts
# (summlike seed 13 at seq 64: 2,283 of 16,384 K elements; zstd3, zlib
# without zstandard, then packs 16,739 bytes against 16,737).  Cases whose
# profiles carry a codec compare numbers within CODEC_REL and print each
# difference; every other case compares them exactly.
CODEC_CASES = {"pd_compression_crossover", "refetch_smaller"}
CODEC_REL = 1e-3

CASES = {n[5:]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}
CHECKS = {n[6:]: f for n, f in globals().items() if n.startswith("check_")}


# ---------------------------------------------------------------------------
# Recording (the same in both packages)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def instrumented(pkg):
    """Tag each pool hit with the tier that served it: the cluster's two
    admission paths set the request being started, and the tiered store's
    ``fetch`` stamps ``hit.tier``'s name on the runtime."""
    cluster = importlib.import_module(f"{pkg}.serving.cluster")
    kvstore = importlib.import_module(f"{pkg}.serving.kvstore")
    cur = {}
    saved = {n: getattr(cluster.ClusterRuntime, n)
             for n in ("_start_request", "_start_request_pd")}
    saved_fetch = kvstore.TieredKVStore.fetch

    def starter(orig):
        def start(self, req, *args, **kw):
            cur["rt"], cur["rid"] = self, req.rid
            try:
                return orig(self, req, *args, **kw)
            finally:
                cur.clear()
        return start

    def fetch(self, hit, *args, **kw):
        if cur:
            cur["rt"].__dict__.setdefault("_hit_tiers", {})[cur["rid"]] = \
                hit.tier.name
        return saved_fetch(self, hit, *args, **kw)

    for n, f in saved.items():
        setattr(cluster.ClusterRuntime, n, starter(f))
    kvstore.TieredKVStore.fetch = fetch
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(cluster.ClusterRuntime, n, f)
        kvstore.TieredKVStore.fetch = saved_fetch


def record(rt) -> dict:
    tiers = rt.__dict__.get("_hit_tiers", {})
    reqs = {}
    for r in rt.completed:
        reqs[str(r.rid)] = dict(
            workload=r.workload, slo_class=r.slo_class, route=r.route,
            pool_hit=bool(r.pool_hit), tier=tiers.get(r.rid),
            profile=r.profile, kv_bytes=int(r.kv_bytes),
            wire_bytes=int(r.wire_bytes), breakdown=dict(r.breakdown),
            arrival=r.arrival, done=r.done, ttft=r.ttft, jct=r.jct,
            slot=int(r.slot), t_pool_write=r.t_pool_write,
            slo_metric=r.slo_metric, slo_violated=bool(r.slo_violated),
            tokens=[int(t) for t in r.tokens])
    return {"requests": reqs, "order": [r.rid for r in rt.completed],
            "summary": rt.summary(),
            "stores": [dw.store.summary() for dw in rt.decode_workers],
            "topology": rt.topology.summary(), "clock": rt.clock,
            "steps": rt.steps,
            "waiting": [[q.rid, q.slo_class, q.state]
                        for q in rt.scheduler.waiting]}


def _jsonable(obj):
    return json.loads(json.dumps(
        obj, default=lambda o: o.item() if hasattr(o, "item") else str(o)))


@contextlib.contextmanager
def one_thread():
    """Run torch on one CPU thread: the suite runs several test processes
    at once, and tiny-lm's small ops gain nothing from threads that would
    only contend with them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def run_case(fn, p) -> dict:
    with instrumented(p.name), one_thread():
        out = fn(p)
    return _jsonable({"runtimes": {k: record(rt)
                                   for k, rt in out["runtimes"].items()},
                      "facts": out.get("facts", {})})


def _same(a, b, path="", rel=0.0) -> None:
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}", rel)
        return
    if isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", rel)
        return
    if a != b and rel and isinstance(a, (int, float)) \
            and not isinstance(a, bool):
        print(f"[{path}] port {a} vs jax {b}")
        assert a == pytest.approx(b, rel=rel, abs=1e-12), (path, a, b)
        return
    assert a == b, (path, a, b)


def assert_matches_jax(name, got, want) -> None:
    """Everything equal but the tokens, which are equal up to a JAX near
    tie (printed); numbers of ``CODEC_CASES`` within ``CODEC_REL``."""
    from test_torch_runtime import _within_tolerance
    rel = CODEC_REL if name in CODEC_CASES else 0.0
    assert sorted(got["runtimes"]) == sorted(want["runtimes"]), name
    for label, g in got["runtimes"].items():
        w = want["runtimes"][label]
        g_tok = {rid: r.pop("tokens") for rid, r in g["requests"].items()}
        w_tok = {rid: r.pop("tokens") for rid, r in w["requests"].items()}
        top2 = {rid: r.pop("top2") for rid, r in w["requests"].items()}
        _same(g, w, f"{name}/{label}", rel)
        for rid, wt in w_tok.items():
            gt = g_tok[rid]
            assert len(gt) == len(wt), (name, label, rid)
            for i, (a, b) in enumerate(zip(gt, wt)):
                if a == b:
                    continue
                t2 = top2[rid][i]
                print(f"[{name}/{label}] rid {rid} step {i}: port {a} vs "
                      f"jax {b}, JAX top-2 logits {t2} "
                      f"(gap {t2[0] - t2[1]:.4g})")
                assert _within_tolerance(t2), (name, label, rid, i, t2)
                break
    _same(got["facts"], want["facts"], f"{name}/facts", rel)


# ---------------------------------------------------------------------------
# The JAX side: ``python tests/test_torch_cluster.py OUT_DIR MODULE CASE...``
# ---------------------------------------------------------------------------
def _jax_main(out_dir: str, module: str, names) -> None:
    import jax
    import jax.numpy as jnp

    import repro.models as M
    from repro.core.quality import get_reference_model
    from repro.serving import cluster as C
    from repro.serving import workers as W

    real_pre, real_dec = M.prefill, M.decode_step
    real_iter, real_submit = W.DecodeWorker.decode_iteration, \
        C.ClusterRuntime.submit
    prefill_top2, decode_top2 = {}, []

    def top2(logits):
        return jax.lax.top_k(logits.astype(jnp.float32), 2)[0]

    def prefill(cfg, params, batch, max_len):
        logits, caches = real_pre(cfg, params, batch, max_len)
        jax.debug.callback(
            lambda t, g: prefill_top2.__setitem__(
                np.asarray(t, np.int32).tobytes(), np.asarray(g).tolist()),
            batch["tokens"][0], top2(logits[0, -1]), ordered=True)
        return logits, caches

    def decode_step(cfg, params, caches, tokens, pos):
        logits, caches = real_dec(cfg, params, caches, tokens, pos)
        jax.debug.callback(lambda g: decode_top2.append(np.asarray(g)),
                           top2(logits[:, -1]), ordered=True)
        return logits, caches

    def decode_iteration(self, active):
        n = len(decode_top2)
        wall = real_iter(self, active)
        jax.effects_barrier()
        assert len(decode_top2) == n + 1
        rows = self.__dict__.setdefault("_top2", {})
        for s in active:
            rows.setdefault(s.req.rid, []).append(
                decode_top2[-1][s.idx].tolist())
        return wall

    def submit(self, workload, *args, **kw):
        rid = real_submit(self, workload, *args, **kw)
        if rid is not None:
            self.__dict__.setdefault("_prompt_keys", {})[rid] = np.asarray(
                self._prompts[rid], np.int32).tobytes()
        return rid

    M.prefill, M.decode_step = prefill, decode_step
    W.DecodeWorker.decode_iteration = decode_iteration
    C.ClusterRuntime.submit = submit
    cases = importlib.import_module(module).CASES
    p = Pkg("repro", get_reference_model())
    for name in names:
        with instrumented("repro"):
            out = cases[name](p)
        jax.effects_barrier()
        runtimes = {}
        for label, rt in out["runtimes"].items():
            rec = record(rt)
            for r in rt.completed:
                dw = rt.decode_workers[int(r.route.split("->d")[1])]
                rec["requests"][str(r.rid)]["top2"] = (
                    [prefill_top2[rt._prompt_keys[r.rid]]]
                    + dw.__dict__.get("_top2", {}).get(r.rid, []))
            runtimes[label] = rec
        tmp = Path(out_dir) / f"{name}.tmp"
        tmp.write_text(json.dumps(_jsonable(
            {"runtimes": runtimes, "facts": out.get("facts", {})})))
        tmp.rename(Path(out_dir) / f"{name}.json")


class JaxRuns:
    """The JAX subprocess, started at once; ``get(name)`` waits for that
    case's file."""

    def __init__(self, out_dir: Path, module: str, names, timeout=900):
        self.out_dir, self.timeout = out_dir, timeout
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO / "src"), str(REPO / "tests"),
             env.get("PYTHONPATH", "")])
        env["JAX_PLATFORMS"] = "cpu"
        env["OMP_NUM_THREADS"] = "1"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_allow_excess_precision=false"
                            + " --xla_cpu_multi_thread_eigen=false").strip()
        self.err = open(out_dir / "stderr.txt", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "test_torch_cluster.py"),
             str(out_dir), module, *names],
            env=env, stdout=self.err, stderr=subprocess.STDOUT)
        self.start = time.monotonic()

    def get(self, name: str) -> dict:
        path = self.out_dir / f"{name}.json"
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                self.err.seek(0)
                pytest.fail(f"JAX run ended ({self.proc.returncode}) "
                            f"without {name}:\n{self.err.read()[-4000:]}")
            assert time.monotonic() - self.start < self.timeout, name
            time.sleep(0.1)
        return json.loads(path.read_text())

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


@pytest.fixture(scope="module", autouse=True)
def port_kv_sanitizer():
    """``REPRO_SANITIZE=1`` installs the port's KV sanitizer for the
    module, as ``tests/conftest.py`` installs the JAX package's for the
    session (which leaves the port's classes alone)."""
    from repro_torch.analysis import sanitize
    installed = sanitize.install_from_env()
    yield
    if installed:
        sanitize.uninstall()


@pytest.fixture(scope="module")
def port_model(reference_model):
    import jax
    from repro_torch.models.convert import from_jax_arrays
    cfg, params = reference_model
    return cfg, from_jax_arrays(jax.tree_util.tree_map(np.asarray, params),
                                cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, reference_model):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_cluster"),
                   "test_torch_cluster", sorted(CASES))
    yield runs
    runs.close()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_case_matches_jax(name, jax_runs, port_model):
    got = run_case(CASES[name], Pkg("repro_torch", port_model, device="cpu"))
    if name in CHECKS:
        CHECKS[name](got)
    for rec in got["runtimes"].values():
        for r in rec["requests"].values():
            assert sum(r["breakdown"].values()) == pytest.approx(
                r["jct"], abs=1e-9)
    assert_matches_jax(name, got, jax_runs.get(name))


def test_cluster_rejects_conflicting_topology_dimensions(port_model):
    p = Pkg("repro_torch", port_model, device="cpu")
    topo = p.m("serving").NetworkTopology.full_mesh(1, 2, p.trace(1e9))
    with pytest.raises(ValueError):
        _cluster(p, n_prefill=2, n_decode=3, topology=topo)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), mode=st.sampled_from(["pool", "pd"]),
       max_prefills=st.sampled_from([2, 3]))
def test_breakdowns_sum_to_jct_property(seed, mode, max_prefills):
    """``test_pd_runtime.py::test_breakdowns_sum_to_jct_property`` on the
    port: per-request breakdowns sum exactly to JCT under mixed
    hit/miss/PD traffic, and TTFT never exceeds JCT."""
    p = Pkg("repro_torch", _cached_port_model(), device="cpu")
    rng = np.random.default_rng(seed)
    with one_thread():
        _mixed_traffic(p, rng, mode, max_prefills)


def _mixed_traffic(p, rng, mode, max_prefills):
    rt = _serving(p, mode=mode, decode_tokens=5, bandwidth=0.2 * GBPS,
                  max_slots=4, max_prefills=max_prefills)
    n = int(rng.integers(4, 9))
    for _ in range(n):
        rt.submit(WORKLOAD_CYCLE[int(rng.integers(4))],
                  prompt_seed=int(rng.integers(3)),
                  out_tokens=int(rng.integers(2, 6)),
                  slo_class=("interactive", "standard",
                             "batch")[int(rng.integers(3))])
        for _ in range(int(rng.integers(3))):
            rt.step()
    done = rt.run()
    assert len(done) == n
    for r in done:
        assert sum(r.breakdown.values()) == pytest.approx(r.jct, abs=1e-9), \
            (mode, r.rid, r.breakdown, r.jct)
        assert 0 < r.ttft <= r.jct + 1e-12
        assert all(v >= -1e-12 for v in r.breakdown.values()), r.breakdown


_PORT_MODEL = None


def _cached_port_model():
    global _PORT_MODEL
    if _PORT_MODEL is None:
        import jax
        from repro.core.quality import get_reference_model
        from repro_torch.models.convert import from_jax_arrays
        cfg, params = get_reference_model()
        _PORT_MODEL = cfg, from_jax_arrays(
            jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return _PORT_MODEL


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])
