"""The port's serving runtime on the other model families, against the JAX
package's, live: ``tests/_runtime_scenario.py``'s pinned request stream
through both ``ServingRuntime``s on the same reduced-config weights.

Served, as the JAX runtime serves them: deepseek-moe-16b and
llama4-scout-17b-a16e (MoE), qwen3-4b (qk-norm) and qwen2-vl-72b
(M-RoPE) and gemma2-9b (attention softcap, sliding window on alternate
layers), each in pool mode on the dense arena with the pinned
per-channel profile and in pd mode on the paged arena with a
paged-eligible int8 per-token profile.  ``pool_hit``, ``wire_bytes`` and every
``breakdown`` entry must be equal, and greedy tokens equal up to a step
where the JAX top-2 logit gap lies within the logit tolerance (atol 2e-2
+ rtol 1.6e-2 of the top logit), printed with ``-s``, as in
``test_torch_runtime.py``.

Refused by both packages, with an exception: jamba and falcon-mamba
(the slot arena holds attention caches only; falcon-mamba has no KV to
extract) and whisper (the runtime's prompts carry no audio frames).
Gemma2's paged case runs the arena entries with its cap and its local
layers' window (16 in the reduced config, so the 64-token prompts cross
it); the JAX runtime applies both to its gathered dense view.

The JAX side runs in one subprocess per architecture, all at once, with
``--xla_allow_excess_precision=false``
(``python tests/test_torch_families_runtime.py OUT.json ARCH``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import (  # noqa: E402,F401
    one_thread,
    port_kv_sanitizer,
)
from test_torch_runtime import (  # noqa: E402
    DECODE_TOKENS,
    SEQ,
    _build,
    _config_id,
    _result,
    _within_tolerance,
)

REPO = Path(__file__).resolve().parents[1]
SERVED = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "qwen3-4b",
          "qwen2-vl-72b", "gemma2-9b"]
REFUSED = ["jamba-v0.1-52b", "falcon-mamba-7b", "whisper-small"]
BOTH = [("pool", False, "per_channel"), ("pd", True, "per_token_int8")]


def _weights(pkg: str, arch: str):
    """(cfg, params) of ``arch``'s reduced config: the JAX package's
    seed-0 init, bridged leaf for leaf into the port."""
    from repro.configs import get_config
    from repro.models import init_params
    cfg = get_config(arch + "-reduced")
    params, _ = init_params(cfg, seed=0)
    if pkg == "repro":
        return cfg, params
    import jax
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import from_jax_arrays
    pcfg = port_config(arch + "-reduced")
    return pcfg, from_jax_arrays(jax.tree_util.tree_map(np.asarray, params),
                                 pcfg, device="cpu")


# ---------------------------------------------------------------------------
# The JAX side (run as ``python tests/test_torch_families_runtime.py
# OUT.json ARCH``)
# ---------------------------------------------------------------------------
def _jax_reference(out_path: str, arch: str) -> None:
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
    model = _weights("repro", arch)
    prompts = {}
    for w, _, seed, _, _ in SCENARIO:
        toks, _ = Q._prompts_for(w, 1, SEQ, seed)
        prompts[(w, seed)] = np.asarray(toks, np.int32)[0].tobytes()
    results = {}
    for mode, paged, profile in BOTH:
        Q._jitted_steps.cache_clear()
        Q._paged_steps.cache_clear()
        log["prefill"].clear()
        log["decode"].clear()
        rt = _build("repro", mode, paged, profile, model)
        key = _config_id(mode, paged, profile)
        if arch in REFUSED:
            try:
                run_scenario(rt)
            except Exception as e:      # noqa: BLE001 (recorded, compared)
                results[key] = {"refused": type(e).__name__}
            else:
                results[key] = {"refused": None}
            continue
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
                k = prompts[(c.workload, SCENARIO[c.rid][2])]
                out[str(c.rid)]["top2"] = (
                    [first_gap[k].tolist()] + [g.tolist() for g in seg])
        results[key] = out
    Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{arch: {config id: result}}: one JAX subprocess per architecture,
    all started together."""
    out = tmp_path_factory.mktemp("jax_families")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false"
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    procs = {arch: subprocess.Popen(
        [sys.executable, __file__, str(out / f"{arch}.json"), arch],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in SERVED + REFUSED}
    runs = {}
    for arch, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (arch, err[-4000:])
        runs[arch] = json.loads((out / f"{arch}.json").read_text())
    return runs


@pytest.fixture(scope="module")
def port_models():
    return {arch: _weights("repro_torch", arch) for arch in SERVED + REFUSED}


@pytest.mark.parametrize("arch,mode,paged,profile",
                         [(a, *c) for a in SERVED for c in BOTH],
                         ids=[f"{a}-{_config_id(*c)}" for a in SERVED
                              for c in BOTH])
def test_runtime_matches_jax(jax_runs, port_models, arch, mode, paged,
                             profile):
    from _runtime_scenario import run_scenario
    rt = _build("repro_torch", mode, paged, profile, port_models[arch],
                device="cpu")
    with one_thread():
        got = _result(rt, run_scenario(rt))
    want = jax_runs[arch][_config_id(mode, paged, profile)]
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
            print(f"[{arch} {_config_id(mode, paged, profile)}] rid {rid} "
                  f"step {i}: port {a} vs jax {b}, JAX top-2 logits {top2} "
                  f"(gap {top2[0] - top2[1]:.4g})")
            assert _within_tolerance(top2), (rid, i, top2)
            break
    if paged:
        for dw in rt.decode_workers:
            dw.page_table.check()
            assert dw.page_table.free_pages == dw.page_table.num_pages - 1
    for r in rt.completed:
        assert sum(r.breakdown.values()) == pytest.approx(r.jct, abs=1e-9)


@pytest.mark.parametrize("arch", REFUSED)
@pytest.mark.parametrize("mode,paged,profile", BOTH,
                         ids=[_config_id(*c) for c in BOTH])
def test_runtime_refuses_what_jax_refuses(jax_runs, port_models, arch, mode,
                                          paged, profile):
    from _runtime_scenario import run_scenario
    assert jax_runs[arch][_config_id(mode, paged, profile)]["refused"]
    rt = _build("repro_torch", mode, paged, profile, port_models[arch],
                device="cpu")
    with pytest.raises(NotImplementedError):
        with one_thread():
            run_scenario(rt)


def test_paged_decode_softcap_without_window_matches_jax():
    """A softcap model with no sliding window on the paged arena (the
    arena kernels cap every layer's scores, none windowed): the port's
    decode step over paged caches against the JAX decode step over the
    gathered view, a slot at kv_len 0 included."""
    from test_torch_gemma2_paged import _paged_step_vs_jax
    from test_torch_model import _close
    changes = {"sliding_window": 0, "local_global_period": 0}
    pl, jl = _paged_step_vs_jax(changes, 1, [40, 0, 33])
    _close(pl, jl, frac=None)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _jax_reference(sys.argv[1], sys.argv[2])
