"""The six ``examples/torch_*.py`` scripts, run with ``--device cpu``,
against the JAX library calls their ``examples/*.py`` counterparts make,
with the same arguments.

Measured encode and decode seconds are wall clock, so the pipelines'
clocks are fixed in both packages (:func:`fixed_clock`: each read
advances 1 ms), which makes every profile's ``s_enc`` and ``s_dec``, and
with them the virtual-clock runtimes, equal by construction.  Held:

  - ``torch_quickstart``: per strategy the CR and wire bytes exactly and
    the mean |K error| within rtol 1e-5 (the Hadamard strategy through
    the device pipeline's plain versions here); each profile's B*, the
    envelope's choice per bandwidth and its predicted seconds equal the
    JAX controller's on the same profiles;
  - ``torch_adaptive_bandwidth``: the printed table, character for
    character (the simulator runs on the host in both);
  - ``torch_multi_tenant_serving`` and ``torch_pd_serving_e2e``: through
    ``tests/test_torch_cluster.py``'s harness (the JAX side in a
    subprocess with XLA's excess precision off): per request the pool
    hit, profile, wire bytes, breakdown, TTFT and JCT exactly, tokens up
    to a printed JAX near tie; pd_serving's profiles' CR exactly and
    quality within 1 / n_prompts (one prompt's continuation after a near
    tie; the differences are printed), its runtime served on the JAX
    profiles so that both controllers choose from the same table;
  - ``torch_offline_profiling`` (3 BO iterations): the candidates
    evaluated, in order, their CR exactly and accuracy within the same
    bound, and where no accuracy differs the frontier and the policy;
  - ``torch_train_small``: the launcher called with the JAX script's
    arguments (spied in both) and the loss falling.

The JAX scripts' own sizes are used but for pd_serving (8 requests, one
quality prompt) and offline profiling (3 iterations); each script also
imports nothing but ``repro_torch``, numpy and the standard library.
"""
import ast
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import (  # noqa: E402,F401
    JaxRuns,
    Pkg,
    _jsonable,
    assert_matches_jax,
    instrumented,
    one_thread,
    port_kv_sanitizer,
    record,
)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
NAMES = ("quickstart", "adaptive_bandwidth", "multi_tenant_serving",
         "offline_profiling", "pd_serving_e2e", "train_small")
PD_REQUESTS, PD_PROMPTS, BO_ITERS = 8, 1, 3


def load(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A ``time`` module whose ``perf_counter`` advances 1 ms a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t

    def __getattr__(self, name):
        import time
        return getattr(time, name)


@contextlib.contextmanager
def fixed_clock(pkg: str):
    mod = importlib.import_module(f"{pkg}.core.pipeline")
    real = mod.time
    mod.time = _Clock()
    try:
        yield
    finally:
        mod.time = real


def _profile_facts(profiles):
    return [[p.strategy.short_name(), p.cr, p.s_enc, p.s_dec]
            for p in profiles]


def _quality(profiles):
    return [dict(p.quality) for p in profiles]


# ---------------------------------------------------------------------------
# The JAX side's cases (``python tests/test_torch_cluster.py OUT_DIR
# test_torch_examples CASE...``): the JAX scripts' library calls
# ---------------------------------------------------------------------------
def case_multi_tenant_serving(p):
    ex = load("multi_tenant_serving")
    with fixed_clock(p.name):
        rt = p.serving(
            controller=ex.build_controller(),
            config=p.config(seq=96, decode_tokens=10, prefill_tok_s=2000.0,
                            decode_tok_s=400.0),
            trace=p.trace(0.01 * p.m("serving").GBPS),
            scheduler=p.sched(max_slots=6, max_prefills_per_step=2,
                              max_queue=32))
        for i in range(8):
            rt.submit("qalike", slo_class="interactive", prompt_seed=i % 2)
            rt.step()
        for i in range(6):
            rt.submit("summlike", slo_class="batch", prompt_seed=100 + i)
            rt.step()
        rt.run()
    return {"runtimes": {"rt": rt}}


def case_pd_serving_e2e(p):
    from repro.controller import ServiceAwareController
    from repro.core.strategy import BASELINES, StrategyConfig
    from repro.data.synthetic import WORKLOADS
    from repro.launch.profile_offline import build_profiles
    from repro.serving import GBPS, BandwidthTrace
    with fixed_clock(p.name):
        profiles = build_profiles(
            [BASELINES["kivi"], BASELINES["cachegen"], BASELINES["mixhq"],
             StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                            granularity="per_channel"),
             StrategyConfig(quantizer="uniform", key_bits=4, value_bits=4,
                            granularity="per_channel", codec="zstd3")],
            quality_kwargs={"n_prompts": PD_PROMPTS, "decode_tokens": 12})
        rt = p.serving(
            controller=ServiceAwareController({w: profiles
                                               for w in WORKLOADS}),
            config=p.config(seq=96, decode_tokens=16, prefill_tok_s=2000.0,
                            decode_tok_s=500.0, mode="pd"),
            trace=BandwidthTrace.steps(
                [(0.0, 0.2 * GBPS), (0.15, 0.002 * GBPS),
                 (1.4, 0.2 * GBPS)], jitter=0.1, seed=0),
            scheduler=p.sched(max_slots=6, max_prefills_per_step=2,
                              max_queue=64))
        rng = np.random.default_rng(0)
        for _ in range(PD_REQUESTS):
            w = list(WORKLOADS)[int(rng.integers(0, 4))]
            rt.submit(w, q_min=0.3, prompt_seed=int(rng.integers(0, 12)))
            rt.step()
        rt.run()
    return {"runtimes": {"rt": rt},
            "facts": {"profiles": _profile_facts(profiles),
                      "quality": _quality(profiles),
                      "json": [q.to_json() for q in profiles]}}


def case_offline_profiling(p):
    from repro.launch.profile_offline import search_and_build
    with fixed_clock(p.name):
        profiles, frontier = search_and_build(
            level="module", workload="summlike", acc_threshold=0.85,
            max_iters=BO_ITERS)
    return {"runtimes": {}, "facts": _offline_facts(profiles, frontier)}


def _offline_facts(profiles, frontier):
    return {"profiles": _profile_facts(profiles),
            "quality": _quality(profiles),
            "frontier": sorted([pt.profile.strategy.short_name(), pt.acc,
                                pt.cr, pt.lat] for pt in frontier)}


CASES = {n[5:]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, reference_model):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_examples"),
                   "test_torch_examples", sorted(CASES))
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def port_ref(reference_model):
    from repro_torch.core.quality import get_reference_model
    return get_reference_model(device="cpu")


def _run_port(name, argv, patch=None, **kw):
    """``examples/torch_<name>.py``'s ``main`` with ``--device cpu``
    (``patch(module)`` first, where given); returns (its data, what it
    printed)."""
    mod = load(f"torch_{name}")
    if patch is not None:
        patch(mod)
    out = io.StringIO()
    with fixed_clock("repro_torch"), instrumented("repro_torch"), \
            one_thread(), contextlib.redirect_stdout(out):
        res = mod.main(["--device", "cpu", *argv], **kw)
    return res, out.getvalue()


def _close_quality(got, want, n_prompts, label):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), label
        for k in w:
            if g[k] != w[k]:
                print(f"[{label}] quality {k}: port {g[k]} vs jax {w[k]}")
            assert abs(g[k] - w[k]) <= 1.0 / n_prompts + 1e-12, (label, k)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
def test_quickstart_matches_jax():
    from repro.controller import (bandwidth_threshold, build_envelope,
                                  predicted_latency, ServiceContext)
    from repro.core import CompressionPipeline, KVCache, measure_profile
    from repro.core.profiles import Profile as JProfile
    from repro.serving.network import GBPS

    ex = load("torch_quickstart")
    res, text = _run_port("quickstart", [])
    kv = KVCache.random(num_layers=8, kv_heads=4, seq=512, head_dim=64,
                        seed=0)
    assert "KV cache: (8, 4, 512, 64)" in text
    jprofiles = []
    for row, (name, cfg) in zip(res["rows"], ex.STRATEGIES.items()):
        from repro.core.strategy import StrategyConfig as JS
        jcfg = JS.from_json(cfg.to_json())
        restored, comp, _, _ = CompressionPipeline(jcfg).roundtrip(kv)
        assert row["name"] == name
        assert row["cr"] == comp.compression_ratio(), name
        assert row["wire_bytes"] == comp.total_bytes(), name
        np.testing.assert_allclose(
            row["mae"], np.abs(restored.k - kv.k).mean(), rtol=1e-5)
        assert measure_profile(jcfg, [kv]).cr == row["cr"]
    for p in res["profiles"]:
        jprofiles.append(JProfile.from_json(p.to_json()))
    assert res["thresholds"] == [bandwidth_threshold(p) for p in jprofiles]
    env = build_envelope(jprofiles)
    for choice in res["choices"]:
        ctx = ServiceContext("qalike", choice["gbps"] * GBPS, t_slo=0.0,
                             q_min=0.0, kv_bytes=kv.nbytes_wire())
        best = env.optimal(1.0 / ctx.bandwidth)
        assert choice["profile"] == best.strategy.short_name()
        assert choice["t_pred"] == pytest.approx(
            predicted_latency(best, ctx), rel=1e-12)


def test_adaptive_bandwidth_prints_the_jax_table(capsys):
    load("adaptive_bandwidth").main()
    want = capsys.readouterr().out
    res, got = _run_port("adaptive_bandwidth", [])
    assert got == want
    assert set(res) == {"default", "static-maxcr", "kvserve",
                        "kvserve(no bandit)", "kvserve(no controller)"}


def test_multi_tenant_serving_matches_jax(jax_runs, port_ref):
    res, text = _run_port("multi_tenant_serving", [], ref=port_ref)
    got = _jsonable({"runtimes": {"rt": record(res["runtime"])},
                     "facts": {}})
    assert_matches_jax("multi_tenant_serving", got,
                       jax_runs.get("multi_tenant_serving"))
    assert "pool_hit_rate=" in text and len(res["requests"]) == 14
    assert any(r["pool_hit"] for r in res["requests"])


def test_pd_serving_e2e_matches_jax(jax_runs, port_ref):
    from repro_torch.core.profiles import Profile
    want = jax_runs.get("pd_serving_e2e")
    built = {}

    def serve_on_jax_profiles(mod):
        real = mod.build_profiles

        def build_profiles(*args, **kw):
            built["port"] = real(*args, **kw)
            # both controllers choose from the same table
            return [Profile.from_json(s) for s in want["facts"]["json"]]

        mod.build_profiles = build_profiles

    res, _ = _run_port("pd_serving_e2e",
                       ["--requests", str(PD_REQUESTS), "--quality-prompts",
                        str(PD_PROMPTS)], patch=serve_on_jax_profiles,
                       ref=port_ref)
    assert _profile_facts(built["port"]) == want["facts"]["profiles"]
    _close_quality(_quality(built["port"]), want["facts"]["quality"],
                   PD_PROMPTS, "pd_serving_e2e")
    got = _jsonable({"runtimes": {"rt": record(res["runtime"])},
                     "facts": {}})
    assert_matches_jax("pd_serving_e2e", got,
                       {"runtimes": want["runtimes"], "facts": {}})
    assert len({r["profile"] for r in res["requests"]}) > 1


def test_offline_profiling_matches_jax(jax_runs, port_ref):
    res, text = _run_port("offline_profiling",
                          ["--max-iters", str(BO_ITERS)], ref=port_ref)
    want = jax_runs.get("offline_profiling")["facts"]
    got = _jsonable(_offline_facts(res["profiles"], res["frontier"]))
    assert got["profiles"] == want["profiles"]
    _close_quality(got["quality"], want["quality"], 6, "offline_profiling")
    if got["quality"] == want["quality"]:
        assert got["frontier"] == want["frontier"]
    assert "piecewise policy" in text and res["policy"]


def test_train_small_calls_the_launcher_as_the_jax_script(monkeypatch):
    from repro.launch import train as JT
    calls = {}

    def spy(tag):
        def train(arch, **kw):
            calls[tag] = (arch, kw)
            return None, None, [3.0, 2.0]
        return train

    monkeypatch.setattr(JT, "train", spy("jax"))
    monkeypatch.setattr(sys, "argv", ["train_small.py"])
    jax_ex = load("train_small")
    jax_ex.main()
    ex = load("torch_train_small")
    monkeypatch.setattr(ex, "train", spy("port"))
    assert ex.main(["--device", "cpu"]) == {"losses": [3.0, 2.0]}
    jarch, jkw = calls["jax"]
    parch, pkw = calls["port"]
    assert pkw.pop("device") == "cpu"
    jkw.pop("ckpt_dir")
    pkw.pop("ckpt_dir")
    assert (parch, pkw) == (jarch, jkw)
    monkeypatch.undo()
    with one_thread():
        res = ex.main(["--device", "cpu", "--steps", "6", "--grad-bits",
                       "8"])
    losses = res["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", NAMES)
def test_imports_repro_torch_numpy_and_the_standard_library(name):
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        for top in tops:
            assert (top in ("repro_torch", "numpy")
                    or top in sys.stdlib_module_names), (name, top)

