"""The port's workloads, simulator and trace replay
(``repro_torch.workloads``, ``repro_torch.serving.simulator``) against the
JAX package's.

* Workloads: both packages build byte-identical traces (equal digests and
  JSONL) for the same (tenants, duration, seed), for every arrival kind
  and archetype, and equal arrival times.
* The simulator: ``SimResult``s are equal bit for bit (every field of
  every request, ``summary()``) on the cases of
  ``tests/test_serving_sim.py``, ``test_trace_replay.py`` and the
  simulator cases of ``test_tiered_runtime.py``.  Neither package's
  simulator imports JAX, so both run in this process.
* Replay through the runtime: ``replay_runtime`` drives each package's
  ``ClusterRuntime`` over the same trace, through
  ``test_torch_cluster.py``'s harness (a live JAX subprocess), and routes,
  hits and their tiers, wire bytes and breakdowns must be equal.  One case
  is the card's phase 6 cluster and trace at tiny-lm size: 2x2, pool,
  load-aware, paged, int8 per-token, with tiers holding as many entries as
  phase 6's do, on the virtual clock (``test_torch_phase6_timing.py``
  emulates the card's).
* ``tests/test_trace_parity.py``'s case on the port alone: its runtime
  against its simulator within ``REL_TOL``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import (  # noqa: E402
    GBPS,
    JaxRuns,
    Pkg,
    _cluster,
    _serving,
    assert_matches_jax,
    port_kv_sanitizer,
    port_model,
    run_case,
)

PKGS = ("repro", "repro_torch")
ARRIVAL_KINDS = ("poisson", "diurnal", "mmpp")
WORKLOADS = ("mathlike", "codelike", "qalike", "summlike")
REL_TOL = 0.05          # tests/test_trace_parity.py
PARITY_WORKLOADS = ("qalike", "codelike", "mathlike", "summlike")


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------
def _both(fn):
    return [fn(_m(pkg, "workloads")) for pkg in PKGS]


@pytest.mark.parametrize("arrival", ARRIVAL_KINDS)
@pytest.mark.parametrize("scenario", ["agentic", "chat", "classify", "rag"])
def test_single_tenant_traces_match(scenario, arrival):
    for seed in (0, 7, 2**31 - 1):
        a, b = _both(lambda W: W.build_trace(
            [W.TenantSpec("t0", scenario, 2.0, arrival)], duration=20.0,
            seed=seed))
        assert len(a) == len(b) > 0
        assert a.digest() == b.digest()
        assert a.to_jsonl() == b.to_jsonl()


def test_archetypes_cover_the_reference():
    a, b = _both(lambda W: sorted(W.ARCHETYPES))
    assert a == b == ["agentic", "chat", "classify", "rag"]


@pytest.mark.parametrize("rate_scale", [0.5, 1.0, 2.0])
def test_default_tenants_traces_match(rate_scale):
    for seed in (1, 2, 42):
        a, b = _both(lambda W: W.build_trace(
            W.default_tenants(rate_scale=rate_scale), duration=15.0,
            seed=seed))
        assert a.digest() == b.digest()
        assert a.to_jsonl() == b.to_jsonl()
        # the JAX package's JSONL read back by the port keeps its digest
        back = _m("repro_torch", "workloads").Trace.from_jsonl(a.to_jsonl())
        assert back.digest() == a.digest()


def test_scaled_traces_match():
    for target in (200, 1000):
        a, b = _both(lambda W: W.scaled_trace(target, seed=5))
        assert a.digest() == b.digest()


@pytest.mark.parametrize("kind", ARRIVAL_KINDS)
def test_arrival_times_match(kind):
    for seed, rate in ((0, 0.5), (3, 4.0), (9, 20.0)):
        a, b = _both(lambda W: W.make_arrivals(kind, rate).times(
            40.0, np.random.default_rng(seed)))
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_trace_requests_match():
    def reqs(W):
        return [dataclasses.asdict(r) for r in W.trace_requests(
            W.build_trace(W.default_tenants(2.0), duration=20.0, seed=11))]
    a, b = _both(reqs)
    assert a == b and any(r["prefix_hit"] for r in a)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------
def _profiles(pkg):
    """``tests/conftest.py::synthetic_profiles`` in package ``pkg``."""
    Profile = _m(pkg, "core.profiles").Profile
    StrategyConfig = _m(pkg, "core.strategy").StrategyConfig
    rng = np.random.default_rng(7)
    out = []
    for i in range(24):
        cr = float(rng.uniform(1.5, 9.0))
        s = float(rng.uniform(2e8, 2e10))
        q = {w: float(np.clip(1.02 - 0.006 * cr**1.5 + rng.normal(0, 0.01),
                              0, 1.0))
             for w in ("mathlike", "codelike", "qalike", "summlike")}
        out.append(Profile(
            StrategyConfig(key_bits=2 + (i % 7), value_bits=2 + ((i + 3) % 7),
                           group_size=(32, 64, 128)[i % 3]),
            cr=cr, s_enc=2 * s, s_dec=2 * s, quality=q))
    return out


class _Sim:
    """One package's simulator surface."""

    def __init__(self, pkg):
        self.pkg, self.S = pkg, _m(pkg, "serving")
        self.profiles = _profiles(pkg)

    def requests(self, n=40, seed=0, slo=0.0, prefix=0.0, q_min=0.5):
        return self.S.WorkloadMix(rate=2.0, seed=seed, slo=slo, q_min=q_min,
                                  prefix_hit_rate=prefix).generate(n)

    def run(self, cfg, policy, trace, reqs, **kw):
        return self.S.Simulator(cfg, policy, trace, reqs, **kw).run()

    def kvserve(self):
        ctl = _m(self.pkg, "controller").ServiceAwareController(
            {w: self.profiles for w in WORKLOADS})
        return self.S.KVServePolicy(ctl)

    def profile(self, cr=2.0, s=1e9, **strategy):
        return _m(self.pkg, "core.profiles").Profile(
            _m(self.pkg, "core.strategy").StrategyConfig(**strategy),
            cr=cr, s_enc=s, s_dec=s)


def sim_low_and_high_bandwidth(s):
    S, trace = s.S, s.S.BandwidthTrace.constant
    best = max(s.profiles, key=lambda p: p.cr)
    slow = min(s.profiles, key=lambda p: p.s_eff)
    return [s.run(S.SimConfig(), S.NoCompressionPolicy(),
                  trace(0.5 * GBPS), s.requests()),
            s.run(S.SimConfig(), S.StaticPolicy(best, "static"),
                  trace(0.5 * GBPS), s.requests()),
            s.run(S.SimConfig(), S.NoCompressionPolicy(),
                  trace(500 * GBPS), s.requests()),
            s.run(S.SimConfig(), S.StaticPolicy(slow, "slow"),
                  trace(500 * GBPS), s.requests())]


def sim_kvserve_across_bandwidths(s):
    S, out = s.S, []
    for bw in (0.2 * GBPS, 2 * GBPS, 100 * GBPS):
        trace = S.BandwidthTrace.constant(bw)
        out += [s.run(S.SimConfig(), S.StaticPolicy(p, f"s{i}"), trace,
                      s.requests()) for i, p in enumerate(s.profiles[:6])]
        out.append(s.run(S.SimConfig(), S.NoCompressionPolicy(), trace,
                         s.requests()))
        out.append(s.run(S.SimConfig(), s.kvserve(), trace, s.requests()))
    return out


def sim_pool_cachegen_fallback(s):
    S, trace = s.S, s.S.BandwidthTrace.constant(0.6 * GBPS)
    static = S.StaticPolicy(max(s.profiles, key=lambda p: p.cr),
                            "cachegen-like", slo_fallback_recompute=True)
    cfg = S.SimConfig(scenario="pool", prefill_tok_s=3000)
    return [s.run(cfg, static, trace,
                  s.requests(30, seed=3, slo=0.35, prefix=1.0)),
            s.run(cfg, s.kvserve(), trace,
                  s.requests(30, seed=3, slo=0.35, prefix=1.0))]


def sim_fault_injection(s):
    S = s.S
    cfg = S.SimConfig(fail_rate=0.5, straggler_sigma=0.5,
                      transient_slow_p=0.2, seed=11)
    return [s.run(cfg, S.StaticPolicy(s.profiles[0], "s"),
                  S.BandwidthTrace.constant(1 * GBPS),
                  s.requests(30, seed=5))]


def sim_hedged_fetch(s):
    S = s.S
    out = []
    for hf in (0.0, 2.0):
        out.append(s.run(
            S.SimConfig(scenario="pool", hedge_factor=hf, seed=1),
            S.StaticPolicy(s.profiles[0], "s"),
            S.BandwidthTrace([0.0], [1 * GBPS], jitter=1.2, seed=4),
            s.requests(60, seed=9, prefix=1.0)))
    return out


def sim_hedged_tiered_remote(s):
    S, prof = s.S, s.profile(key_bits=8, value_bits=8)
    out = []
    for hf in (0.0, 2.0):
        store = S.TieredKVStore(
            [S.TierSpec("remote", 64 << 20,
                        bandwidth=S.BandwidthTrace([0.0], [1e6], jitter=1.2,
                                                   seed=4),
                        fetch_overhead=1e-3, observe_goodput=True)], block=8)
        for i in range(20):
            store.put((i,), prof, 100_000, kv_bytes=2e5, now=0.0)
        reqs = [S.Request(rid=i, workload="qalike", arrival=1.0 + 0.5 * i,
                          ctx_tokens=100, out_tokens=2, kv_bytes=2e5,
                          q_min=0.0, prefix_key=(i,)) for i in range(20)]
        out.append(s.run(S.SimConfig(scenario="pool", hedge_factor=hf,
                                     seed=1),
                         S.StaticPolicy(prof, "s"),
                         S.BandwidthTrace.constant(1e6), reqs, store=store))
    return out


def sim_paged_decompress(s):
    S, out = s.S, []
    eligible = s.profile(s=1e9, key_bits=8, value_bits=8,
                         granularity="per_token", symmetric=True,
                         group_size=32)
    eligible = dataclasses.replace(eligible, s_dec=1e5)
    ineligible = dataclasses.replace(s.profile(key_bits=8, value_bits=8),
                                     s_dec=1e5)
    for prof, paged in ((eligible, False), (eligible, True),
                        (ineligible, True)):
        out.append(s.run(S.SimConfig(paged=paged), S.StaticPolicy(prof, "s"),
                         S.BandwidthTrace.constant(1 * GBPS),
                         s.requests(10, seed=2, prefix=1.0)))
    return out


def sim_tiered_store_code_path(s):
    S, prof = s.S, s.profile(key_bits=8, value_bits=8)
    out = []
    for hot in (4 << 20, 0):
        store = S.TieredKVStore(
            [S.TierSpec("hbm", hot, bandwidth=64e9),
             S.TierSpec("remote", 64 << 20, bandwidth=1e6,
                        fetch_overhead=2e-3, observe_goodput=True)], block=8)
        reqs = [S.Request(rid=i, workload="qalike",
                          arrival=10.0 * i if i < 3 else 60.0 + 10.0 * (i - 3),
                          ctx_tokens=1000, out_tokens=4, kv_bytes=1e6,
                          q_min=0.0, prefix_key=(i % 3,)) for i in range(6)]
        out.append(s.run(S.SimConfig(scenario="pool", prefill_tok_s=500.0),
                         S.StaticPolicy(prof, "s"),
                         S.BandwidthTrace.constant(1e6), reqs, store=store))
        out.append(dict(store.stats.tier_hits))
    return out


def sim_tiered_fetches_contend(s):
    S, prof = s.S, s.profile(key_bits=8, value_bits=8)
    store = S.TieredKVStore(
        [S.TierSpec("remote", 64 << 20, bandwidth=1e5, fetch_overhead=1e-3,
                    observe_goodput=True)], block=8)
    store.put((0,), prof, 100_000, kv_bytes=2e5, now=0.0)
    store.put((1,), prof, 100_000, kv_bytes=2e5, now=0.0)
    reqs = [S.Request(rid=i, workload="qalike", arrival=10.0, ctx_tokens=100,
                      out_tokens=2, kv_bytes=2e5, q_min=0.0, prefix_key=(i,))
            for i in range(2)]
    return [s.run(S.SimConfig(scenario="pool", prefill_tok_s=1e4),
                  S.StaticPolicy(prof, "s"), S.BandwidthTrace.constant(1e5),
                  reqs, store=store)]


def _bursty(W, duration=25.0, seed=42):
    """``tests/test_trace_replay.py::_bursty_trace``."""
    return W.build_trace([
        W.TenantSpec("chat", "chat", 3.0, "diurnal", {"amplitude": 0.7}),
        W.TenantSpec("agents", "agentic", 0.8, "mmpp",
                     {"mean_on": 3.0, "mean_off": 6.0}),
    ], duration=duration, seed=seed)


def _u8(s, cr=3.5):
    return _m(s.pkg, "core.profiles").Profile(
        _m(s.pkg, "core.strategy").StrategyConfig(
            quantizer="uniform", key_bits=8, value_bits=8,
            granularity="per_channel"),
        cr=cr, s_enc=60.0 * GBPS, s_dec=80.0 * GBPS, quality=0.995)


def sim_replay_topology(s):
    S, W, out = s.S, _m(s.pkg, "workloads"), []
    for routing in ("round_robin", "load_aware"):
        topo = S.NetworkTopology.full_mesh(
            2, 2, S.BandwidthTrace.constant(2 * GBPS),
            links={(0, 1): S.BandwidthTrace.constant(0.5 * GBPS)})
        out.append(W.replay_simulator(
            _bursty(W), S.StaticPolicy(_u8(s), "u8"),
            S.BandwidthTrace.constant(2 * GBPS),
            S.SimConfig(scenario="pd", n_prefill=2, n_decode=2, seed=0),
            topology=topo, routing=routing))
    out.append(W.replay_simulator(
        _bursty(W), S.StaticPolicy(_u8(s), "u8"),
        S.BandwidthTrace.constant(2 * GBPS),
        S.SimConfig(scenario="pd", n_prefill=2, n_decode=2, seed=0)))
    return out


def sim_fast_pd_vs_general_loop(s):
    """The fast PD path and the general loop, with bandwidth steps; the
    same again across an outage (a zero-rate segment)."""
    S, W, out = s.S, _m(s.pkg, "workloads"), []
    cfg = S.SimConfig(scenario="pd", n_prefill=3, n_decode=2,
                      straggler_sigma=0.15, seed=0)
    for steps in ([(0.0, 2 * GBPS), (10.0, 0.6 * GBPS), (20.0, 4 * GBPS)],
                  [(0.0, 2 * GBPS), (8.0, 0.0), (11.0, 1 * GBPS)]):
        for general in (False, True):
            pol = S.StaticPolicy(_u8(s), "u8")
            pol.needs_ctx = general
            sim = S.Simulator(cfg, pol, S.BandwidthTrace.steps(steps),
                              W.trace_requests(_bursty(W, 40.0, 9)))
            assert sim._fast_pd_eligible() is not general
            out += [sim.run(), {"estimate": sim.estimator._est}]
    return out


SIM_CASES = {n[4:]: f for n, f in sorted(globals().items())
             if n.startswith("sim_")}


def _sim_record(obj):
    if isinstance(obj, dict):
        return obj
    return {"policy": obj.policy, "summary": obj.summary(),
            "requests": [[(f.name, getattr(r, f.name))
                          for f in dataclasses.fields(r)]
                         for r in obj.requests]}


def _sim_equal(a, b):
    """Bit-for-bit, NaN equal to NaN (summaries of empty classes)."""
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return sorted(a) == sorted(b) and all(_sim_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_sim_equal(x, y)
                                        for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_simulator_results_match_bit_for_bit(name):
    a, b = ([_sim_record(r) for r in SIM_CASES[name](_Sim(pkg))]
            for pkg in PKGS)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert _sim_equal(x, y), (name, i)


def test_simulator_properties_on_the_port():
    """The reference's assertions on the port's simulator."""
    s = _Sim("repro_torch")
    base_lo, comp_lo, base_hi, slow_hi = sim_low_and_high_bandwidth(s)
    assert comp_lo.mean_jct() < base_lo.mean_jct()
    assert slow_hi.mean_jct() > base_hi.mean_jct()
    (faulty,) = sim_fault_injection(s)
    assert any(r.retries > 0 for r in faulty.requests)
    assert all(r.done > r.arrival for r in faulty.requests)
    base, hedged = sim_hedged_tiered_remote(s)
    assert any(r.retries > 0 for r in hedged.requests)
    assert all(h.ttft <= b.ttft + 1e-12
               for b, h in zip(base.requests, hedged.requests))
    dec = [r.breakdown()["decompress"] for r in sim_paged_decompress(s)]
    assert dec[0] > 0 and dec[1] == 0.0 and dec[2] > 0
    res_h, hits_h, res_r, hits_r = sim_tiered_store_code_path(s)
    assert hits_h == {"hbm": 3} and hits_r == {"remote": 3}
    (contend,) = sim_tiered_fetches_contend(s)
    waits = sorted(r.breakdown.get("wire_wait", 0.0)
                   for r in contend.requests)
    assert waits[0] == 0.0 and waits[1] == pytest.approx(1.0)
    for k, res in enumerate(sim_replay_topology(s)):
        for r in res.completed():
            assert sum(r.breakdown.values()) == pytest.approx(r.jct,
                                                              abs=1e-9)
            if k < 2:       # the topology runs stamp routes, flat does not
                assert r.route.startswith("p") and "->d" in r.route
    fast, est_f, slow, est_s = sim_fast_pd_vs_general_loop(s)[:4]
    assert est_f == est_s and fast.summary() == slow.summary()
    for a, b in zip(fast.requests, slow.requests):
        assert (a.done, a.ttft, a.breakdown) == (b.done, b.ttft, b.breakdown)


# ---------------------------------------------------------------------------
# Replay through the runtime (live JAX run through test_torch_cluster)
# ---------------------------------------------------------------------------
PHASE6_EVENTS = 16      # chip_smoke.py phase 6: default_tenants(), seed 2
PHASE6_SEED = 2


def phase6_events(W):
    """The trace phase 6 replays: the first 16 events of
    ``build_trace(default_tenants(), 30 s, seed 2)`` — eleven distinct
    prompts, five repeats (two chat prefixes, one three-turn agentic
    session)."""
    trace = W.build_trace(W.default_tenants(), duration=30.0,
                          seed=PHASE6_SEED)
    return trace, trace.events[:PHASE6_EVENTS]


def case_replay_pd(p):
    return _replay(p, "pd")


def case_replay_pool(p):
    return _replay(p, "pool")


def _replay(p, mode):
    """``test_trace_replay.py::test_cluster_replay_breakdowns_sum_to_jct``."""
    W = p.m("workloads")
    rt = _cluster(p, mode=mode, n_prefill=2, n_decode=2, bandwidth=0.5 * GBPS,
                  max_prefills=2, max_slots=4,
                  static_profile=p.profile(cr=2.0),
                  scheduler=p.sched(max_slots=4, max_prefills_per_step=2,
                                    max_queue=64))
    W.replay_runtime(rt, _bursty(W, duration=4.0, seed=21))
    return {"runtimes": {"rt": rt}}


def case_replay_phase6_tiny(p):
    """Phase 6's cluster at tiny-lm size: 2x2, pool, load-aware, paged,
    static int8 per-token symmetric groups, 4 slots per decode worker, 20
    decode tokens, the trace's events replayed twice; the hot and DRAM
    tiers hold three entries and one, as phase 6's 256 and 128 MiB do of
    its 69.2 MB entries.  Prompts of 128 tokens keep the trace's eleven
    prompts distinct (at 48 tokens two pairs coincide).  The virtual clock
    (74 ms a prefill, 66 ms a compress, 65 ms a decode step) runs both
    packages alike; unlike the card's wall clock, it gives the router a
    decode queue term and charges no hit landing, so the card's timeline
    is ``test_torch_phase6_timing.py``'s to emulate."""
    W = p.m("workloads")
    seq = 128
    kv = p.m("core.kvcache").KVCache.random(num_layers=4, kv_heads=2,
                                            seq=seq, head_dim=32, seed=0)
    prof = p.profile(s=kv.nbytes_wire() / 0.066, granularity="per_token",
                     symmetric=True, group_size=32)
    entry = p.m("core.pipeline").CompressionPipeline(
        prof.strategy).compress(kv).total_bytes()
    rt = _cluster(p, mode="pool", n_prefill=2, n_decode=2,
                  router="load_aware", static_profile=prof,
                  bandwidth=100 * GBPS, max_prefills=2, max_slots=4,
                  config=p.config(seq=seq, decode_tokens=20,
                                  prefill_tok_s=seq / 0.074,
                                  decode_tok_s=1 / 0.065, mode="pool",
                                  paged=True, page_size=16,
                                  hot_tier_bytes=int(3.88 * entry),
                                  dram_tier_bytes=int(1.94 * entry),
                                  store_capacity=60 * entry))
    trace, events = phase6_events(W)
    for _ in range(2):
        W.replay_runtime(rt, trace, events=[
            dataclasses.replace(e, t=e.t + rt.clock) for e in events])
    return {"runtimes": {"rt": rt}, "facts": {"entry": entry,
                                              "digest": trace.digest()}}


def case_trace_parity(p):
    """``tests/test_trace_parity.py``'s runtime replay."""
    rt = _trace_parity_runtime(p)
    p.m("workloads").replay_runtime(rt, _parity_trace(p))
    return {"runtimes": {"rt": rt}}


def _parity_trace(p):
    T = p.m("workloads.trace")
    return T.Trace([T.TraceEvent(
        rid=i, t=1.5 * i, tenant="parity", scenario="chat",
        workload=PARITY_WORKLOADS[i % 4], ctx_tokens=48,
        out_tokens=2 + (i % 3), prefix_group=100 + i, slo_class="standard",
        slo_metric="jct", t_slo=5.0) for i in range(8)], seed=0)


def _trace_parity_runtime(p):
    return _serving(p, mode="pd", decode_tokens=6, max_slots=4,
                    max_prefills=2)


CASES = {n[5:]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, reference_model):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_replay"),
                   "test_torch_workloads", sorted(CASES))
    yield runs
    runs.close()


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_runtime_matches_jax(name, jax_runs, port_model):
    got = run_case(CASES[name], Pkg("repro_torch", port_model, device="cpu"))
    for rec in got["runtimes"].values():
        for r in rec["requests"].values():
            assert sum(r["breakdown"].values()) == pytest.approx(
                r["jct"], abs=1e-9)
            assert 0 < r["ttft"] <= r["jct"] + 1e-12 and "->" in r["route"]
    if name == "replay_phase6_tiny":
        reqs = got["runtimes"]["rt"]["requests"].values()
        tiers = [r["tier"] for r in reqs if r["pool_hit"]]
        assert len(reqs) == 2 * PHASE6_EVENTS
        assert {"hbm", "dram"} & set(tiers) and "remote" in tiers, tiers
    assert_matches_jax(name, got, jax_runs.get(name))


def test_trace_parity_runtime_vs_simulator(port_model):
    """The port's runtime and the port's simulator on
    ``tests/test_trace_parity.py``'s sparse trace: same node speeds,
    bandwidth and profile, payloads from the runtime's on-wire sizes,
    TTFT and JCT within REL_TOL per request."""
    p = Pkg("repro_torch", port_model, device="cpu")
    S = p.m("serving")
    done = p.m("workloads").replay_runtime(_trace_parity_runtime(p),
                                           _parity_trace(p))
    kv = {r.rid: float(r.kv_bytes) for r in done}
    reqs = [S.Request(rid=e.rid, workload=e.workload, arrival=e.t,
                      ctx_tokens=e.ctx_tokens, out_tokens=e.out_tokens,
                      kv_bytes=kv[e.rid], t_slo=e.t_slo,
                      slo_metric=e.slo_metric, slo_class=e.slo_class)
            for e in _parity_trace(p).events]
    sim = S.Simulator(S.SimConfig(scenario="pd", n_prefill=1, n_decode=1,
                                  prefill_tok_s=2000.0, decode_tok_s=500.0,
                                  straggler_sigma=0.0, seed=0),
                      S.StaticPolicy(p.profile(), "u8"),
                      S.BandwidthTrace.constant(1 * GBPS), reqs).run()
    got = {r.rid: r for r in sim.completed()}
    assert len(done) == len(got) == 8
    for r in done:
        assert got[r.rid].ttft == pytest.approx(r.ttft, rel=REL_TOL)
        assert got[r.rid].jct == pytest.approx(r.jct, rel=REL_TOL)
