"""The port's serving runtime (repro_torch.serving) against the JAX
package's, live, on the same weights.

``tests/_runtime_scenario.py``'s pinned request stream runs through both
``ServingRuntime``s in pool and pd modes, on the dense and the paged
arena, with the pinned per-channel profile and with a paged-eligible int8
per-token one, under the virtual clock.  ``pool_hit``, ``wire_bytes`` and
every ``breakdown`` entry must be equal.  Greedy tokens must be equal up
to a step where the JAX top-2 logit gap lies within the logit tolerance
(atol 2e-2 + rtol 1.6e-2 of the top logit): both sides round to bf16 but
sum in another order, so such a near-tie may flip; the test prints it and
stops comparing that request there.

The JAX side runs in a subprocess with ``--xla_allow_excess_precision=false``:
with XLA's default, fused CPU kernels keep f32 where the JAX code rounds
to bf16, so the jitted reference would not follow its own cast points.
That process also records every JAX logit row (``jax.debug.callback``) so
the near-tie gaps are the JAX run's own.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
SEQ, DECODE_TOKENS, PAGE_SIZE = 64, 6, 8   # page_size divides max_len 72

CONFIGS = [(mode, paged, profile)
           for profile in ("per_channel", "per_token_int8")
           for paged in (False, True)
           for mode in ("pool", "pd")]


def _config_id(mode, paged, profile):
    return f"{mode}-{'paged' if paged else 'dense'}-{profile}"


def _strategy_kwargs(profile):
    if profile == "per_channel":
        return dict(quantizer="uniform", key_bits=8, value_bits=8,
                    granularity="per_channel")
    return dict(quantizer="uniform", key_bits=8, value_bits=8,
                granularity="per_token", symmetric=True, group_size=32)


def _build(pkg, mode, paged, profile, reference_model=None, **extra):
    """The pinned scenario's runtime from package ``pkg`` ("repro" or
    "repro_torch"), as tests/_runtime_scenario.py builds it."""
    import importlib
    prof_mod = importlib.import_module(f"{pkg}.core.profiles")
    strat_mod = importlib.import_module(f"{pkg}.core.strategy")
    serving = importlib.import_module(f"{pkg}.serving")
    engine = importlib.import_module(f"{pkg}.serving.engine")
    profile = prof_mod.Profile(strat_mod.StrategyConfig(
        **_strategy_kwargs(profile)), cr=2.0, s_enc=5e8, s_dec=5e8)
    rt = engine.ServingRuntime(
        static_profile=profile,
        config=engine.RuntimeConfig(
            seq=SEQ, decode_tokens=DECODE_TOKENS, prefill_tok_s=2000.0,
            decode_tok_s=500.0, mode=mode, paged=paged,
            page_size=PAGE_SIZE),
        trace=serving.BandwidthTrace.constant(1 * serving.GBPS),
        scheduler=serving.SchedulerConfig(max_slots=6,
                                          max_prefills_per_step=2,
                                          max_queue=32),
        **extra)
    if reference_model is not None:
        rt.model_cfg, rt.params = reference_model
    return rt


def _result(rt, outputs):
    return {r: dict(outputs[r], wire_bytes=int(c.wire_bytes),
                    breakdown=dict(c.breakdown))
            for r, c in ((str(c.rid), c) for c in rt.completed)}


# ---------------------------------------------------------------------------
# The JAX side (run as ``python tests/test_torch_runtime.py OUT.json``)
# ---------------------------------------------------------------------------
def _jax_reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    import repro.models as M
    from repro.core import quality as Q
    from _runtime_scenario import SCENARIO, run_scenario

    real_pre, real_dec = M.prefill, M.decode_step
    log = {"prefill": [], "decode": []}

    def top2(logits):
        return jax.lax.top_k(logits.astype(jnp.float32), 2)[0]

    def prefill(cfg, params, batch, max_len):
        logits, caches = real_pre(cfg, params, batch, max_len)
        jax.debug.callback(
            lambda t, g: log["prefill"].append((np.asarray(t).tobytes(),
                                                np.asarray(g))),
            batch["tokens"][0], top2(logits[0, -1]), ordered=True)
        return logits, caches

    def decode_step(cfg, params, caches, tokens, pos):
        logits, caches = real_dec(cfg, params, caches, tokens, pos)
        jax.debug.callback(
            lambda p, g: log["decode"].append((np.asarray(p),
                                               np.asarray(g))),
            pos, top2(logits[:, -1]), ordered=True)
        return logits, caches

    M.prefill, M.decode_step = prefill, decode_step
    ref = Q.get_reference_model()
    prompts = {}
    for w, _, seed, _, _ in SCENARIO:
        toks, _ = Q._prompts_for(w, 1, SEQ, seed)
        prompts[(w, seed)] = np.asarray(toks, np.int32)[0].tobytes()
    results = {}
    for mode, paged, profile in CONFIGS:
        Q._jitted_steps.cache_clear()
        Q._paged_steps.cache_clear()
        log["prefill"].clear()
        log["decode"].clear()
        rt = _build("repro", mode, paged, profile, ref)
        out = _result(rt, run_scenario(rt))
        jax.effects_barrier()
        first_gap = dict(log["prefill"])
        # Decode rows: a slot's live rows sit at SEQ.. (parked rows are
        # pinned past every live position); each occupant of a slot
        # restarts at SEQ, and occupants follow in completion order.
        rows = {}
        for pos, g in log["decode"]:
            for s in np.nonzero(pos < SEQ + DECODE_TOKENS + 1)[0]:
                rows.setdefault(int(s), []).append((int(pos[s]), g[s]))
        for s in rows:
            segs, cur = [], []
            for p, g in rows[s]:
                if p == SEQ and cur:
                    segs.append(cur)
                    cur = []
                cur.append(g)
            rows[s] = segs + [cur]
        by_slot = {}
        for c in sorted(rt.completed, key=lambda c: (c.done, c.rid)):
            by_slot.setdefault(c.slot, []).append(c)
        for s, occupants in by_slot.items():
            for c, seg in zip(occupants, rows.get(s, [])):
                # rids follow the scenario's submission order
                key = prompts[(c.workload, SCENARIO[c.rid][2])]
                out[str(c.rid)]["top2"] = (
                    [first_gap[key].tolist()]
                    + [g.tolist() for g in seg])
        results[_config_id(mode, paged, profile)] = out
    Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "runs.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_model(reference_model):
    import jax
    from repro_torch.models.convert import from_jax_arrays
    cfg, params = reference_model
    return cfg, from_jax_arrays(jax.tree_util.tree_map(np.asarray, params),
                                cfg, device="cpu")


def _within_tolerance(top2) -> bool:
    t1, t2 = top2
    return (t1 - t2) <= 2e-2 + 1.6e-2 * abs(t1)


@pytest.mark.parametrize("mode,paged,profile", CONFIGS,
                         ids=[_config_id(*c) for c in CONFIGS])
def test_runtime_matches_jax(jax_runs, port_model, mode, paged, profile):
    from _runtime_scenario import run_scenario
    rt = _build("repro_torch", mode, paged, profile, port_model,
                device="cpu")
    got = _result(rt, run_scenario(rt))
    want = jax_runs[_config_id(mode, paged, profile)]
    assert set(got) == set(want)
    for rid, w in sorted(want.items()):
        g = got[rid]
        assert g["pool_hit"] == w["pool_hit"], rid
        assert g["wire_bytes"] == w["wire_bytes"], rid
        assert g["breakdown"] == w["breakdown"], rid
        assert len(g["tokens"]) == len(w["tokens"]), rid
        for i, (a, b) in enumerate(zip(g["tokens"], w["tokens"])):
            if a == b:
                continue
            top2 = w["top2"][i]
            print(f"[{_config_id(mode, paged, profile)}] rid {rid} step {i}: "
                  f"port {a} vs jax {b}, JAX top-2 logits {top2} "
                  f"(gap {top2[0] - top2[1]:.4g})")
            assert _within_tolerance(top2), (rid, i, top2)
            break
    if paged:
        for dw in rt.decode_workers:
            dw.page_table.check()
            assert dw.page_table.free_pages == dw.page_table.num_pages - 1
    for r in rt.completed:
        assert sum(r.breakdown.values()) == pytest.approx(r.jct, abs=1e-9)


def test_paged_quant_resident_hits_skip_decompress(port_model):
    """Paged-eligible pool hits land as quant pages: no decompress term
    on their critical path."""
    from _runtime_scenario import run_scenario
    rt = _build("repro_torch", "pool", True, "per_token_int8", port_model,
                device="cpu")
    run_scenario(rt)
    hits = [r for r in rt.completed if r.pool_hit]
    assert hits and all(r.breakdown["decompress"] == 0.0 for r in hits)


# ---------------------------------------------------------------------------
# Structure: same config surface, no JAX anywhere in the port
# ---------------------------------------------------------------------------
def test_runtime_config_fields_and_defaults_match():
    from repro.serving.workers import RuntimeConfig as J
    from repro_torch.serving.workers import RuntimeConfig as P

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert spec(J) == spec(P)
    assert J().arena_max_len == P().arena_max_len


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.serving.engine, "
            "repro_torch.kernels, repro_torch.models.convert; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in list((REPO / "src" / "repro_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _jax_reference(sys.argv[1])
