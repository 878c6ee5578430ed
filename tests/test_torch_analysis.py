"""repro_torch.analysis: the port's static rules against the JAX package's.

Four rules are copies (``clock-accounting``, ``units``, ``ownership``,
``determinism``): every fixture of ``test_analysis.py`` gives the same
findings under both packages.  ``host-sync`` has a taint model of PyTorch
values: torch twins of the JAX fixtures fire on the same lines, every
PyTorch sync form fires, the forms that need no sync do not.
``determinism`` also sees PyTorch's global RNG, ``kernel-contract`` the
CUDA half of the kernel contract.  The port's own tree is clean under its
rules, and every ``# lint:`` comment in it documents a finding.
"""
import json
from pathlib import Path

import pytest

import repro.analysis as jax_analysis
from repro_torch.analysis import ALL_RULES
from repro_torch.analysis.cli import main, run_paths
from repro_torch.analysis.core import parse_suppressions
from test_analysis import (
    FIXTURES,
    KC_INIT_OK,
    SYNC_BAD,
    SYNC_CLEAN,
    SYNC_LAUNDERED,
)

REPO = Path(__file__).resolve().parents[1]
COPIED = ("clock-accounting", "units", "ownership", "determinism")


def _write(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return tmp_path


def _run(tmp_path, package=None):
    run = package.run_paths if package is not None else run_paths
    return run([str(tmp_path)], base=tmp_path)


def _key(f):
    return (f.rule, f.path, f.line, f.message, f.hint, f.suppressed)


# ---------------------------------------------------------------------------
# the copied rules: the JAX package's fixtures, the same findings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "rule_id,fires,files",
    [(rid, fires, files) for rid in COPIED for fires, files in FIXTURES[rid]],
    ids=[f"{rid}-{'fires' if fires else 'clean'}-{i}" for rid in COPIED
         for i, (fires, _) in enumerate(FIXTURES[rid])])
def test_copied_rules_match_jax(tmp_path, rule_id, fires, files):
    _write(tmp_path, files)
    got = [_key(f) for fs in _run(tmp_path) for f in fs
           if f.rule in COPIED]
    want = [_key(f) for fs in _run(tmp_path, jax_analysis) for f in fs
            if f.rule in COPIED]
    assert got == want
    assert any(f[0] == rule_id for f in want) == fires


def test_no_dead_rules_and_tokens():
    """The port registers the JAX rules in the JAX order, with the same
    six suppression tokens (a new token would be an unknown-token
    finding under the JAX rules, which also scan the port)."""
    assert [(r.id, r.token) for r in ALL_RULES] == [
        (r.id, r.token) for r in jax_analysis.ALL_RULES]


# ---------------------------------------------------------------------------
# host-sync: torch twins of the JAX fixtures
# ---------------------------------------------------------------------------
TORCH_SYNC_BAD = """\
import numpy as np
import torch
# the twin of test_analysis.SYNC_BAD, line for line

def step(state):
    logits = torch.ones((4, 8), device="cuda")
    tok = np.asarray(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    n = int(logits.sum())
    return tok, n
"""

TORCH_SYNC_CLEAN = """\
import numpy as np
import torch

def step(batch):
    toks = torch.as_tensor(np.asarray(batch["tokens"]))   # a host tensor
    return int(toks.sum())
"""

TORCH_SYNC_LAUNDERED = """\
import numpy as np
import torch

def helper(x):
    return [int(v) for v in x]

def step(state):
    logits = torch.ones((4, 8), device="cuda")
    # lint: sync-ok(fixture - the sanctioned once-per-iteration pull)
    host = logits.cpu().numpy()
    n = int(host.sum())        # host value: laundered, no finding
    hv = helper(logits)        # project def: result is host
    m = float(hv[0])
    return n, m
"""


def _sync_lines(tmp_path, package=None):
    open_, closed = _run(tmp_path, package)
    return ({f.line for f in open_ if f.rule == "host-sync"},
            {f.line for f in closed if f.rule == "host-sync"})


@pytest.mark.parametrize("jax_src,torch_src", [
    (SYNC_BAD, TORCH_SYNC_BAD), (SYNC_CLEAN, TORCH_SYNC_CLEAN),
    (SYNC_LAUNDERED, TORCH_SYNC_LAUNDERED)], ids=["bad", "clean",
                                                   "laundered"])
def test_torch_twins_fire_where_jax_fixtures_do(tmp_path, jax_src,
                                                torch_src):
    _write(tmp_path / "jax", {"serving/engine.py": jax_src})
    _write(tmp_path / "torch", {"serving/engine.py": torch_src})
    want = _sync_lines(tmp_path / "jax", jax_analysis)
    assert _sync_lines(tmp_path / "torch") == want
    # the JAX rule cannot see the twin at all
    assert _sync_lines(tmp_path / "torch", jax_analysis) == (set(), set())


PREAMBLE = """\
import numpy as np
import torch


def step(state, host_rows, lens):
    x = torch.ones(8, device="cuda")
    m = x > 0
    dev = x.device
"""
# (form, body line): each line is line 9 of the fixture and must be a
# host-sync finding there
SYNC_FORMS = [
    ("item", "v = x.sum().item()"),
    ("tolist", "v = x.tolist()"),
    ("cpu", "v = x.cpu()"),
    ("numpy", "v = x.numpy()"),
    ("to-cpu", 'v = x.to("cpu")'),
    ("to-device-cpu", 'v = x.to(device=torch.device("cpu"))'),
    ("np-asarray", "v = np.asarray(x)"),
    ("np-array", "v = np.array(x)"),
    ("float", "v = float(x[0])"),
    ("int", "v = int(x.argmax())"),
    ("bool", "v = bool(x.any())"),
    ("if", "if x.any(): pass"),
    ("while", "while x.sum() > 0: x = x - 1"),
    ("assert", "assert x.all()"),
    ("ifexp", "v = 1 if x.any() else 0"),
    ("cuda-synchronize", "torch.cuda.synchronize()"),
    ("event-synchronize", "torch.cuda.Event().synchronize()"),
    ("stream-synchronize", "torch.cuda.current_stream().synchronize()"),
    ("elapsed-time", "v = state.start.elapsed_time(state.end)"),
    ("torch-nonzero", "v = torch.nonzero(m)"),
    ("nonzero", "v = m.nonzero()"),
    ("chained-nonzero", "v = (x > 1).nonzero()"),
    ("unique", "v = torch.unique(x)"),
    ("masked-select", "v = x.masked_select(m)"),
    ("where-one-arg", "v = torch.where(m)"),
    ("repeat-interleave", "v = torch.repeat_interleave(x, lens)"),
    ("mask-index", "v = x[x > 0]"),
    ("mask-name-index", "v = x[m]"),
    ("mask-assign", "x[m] = 0.0"),
    ("as-tensor", "v = torch.as_tensor(host_rows, device=dev)"),
    ("tensor", "v = torch.tensor([1, 2], device=dev)"),
    ("to-device", "v = torch.from_numpy(host_rows).to(dev)"),
    ("cuda", "v = torch.from_numpy(host_rows).cuda()"),
    ("host-local-to", "h = torch.as_tensor(host_rows)\n    v = h.to(dev)"),
    ("as-tensor-of-device-value-item", "v = torch.as_tensor(x).item()"),
]


@pytest.mark.parametrize("form,line", SYNC_FORMS,
                         ids=[f for f, _ in SYNC_FORMS])
def test_torch_sync_form_fires(tmp_path, form, line):
    src = PREAMBLE + "    " + line + "\n    return state\n"
    _write(tmp_path, {"serving/engine.py": src})
    open_, _ = _run(tmp_path)
    hits = {f.line for f in open_ if f.rule == "host-sync"}
    want = 9 + line.count("\n")
    assert hits == {want}, (form, [f.render() for f in open_])


NO_SYNC = [
    ("laundered", "h = x.cpu().numpy()  # lint: sync-ok(fixture pull)\n"
                  "    v = int(h.sum())"),
    ("torch-device", 'd = torch.device("cuda", 0)\n    v = bool(d)'),
    ("pinned-copy", "p = torch.from_numpy(host_rows).pin_memory()\n"
                    "    v = p.to(dev, non_blocking=True)"),
    ("device-tensor-to-device", "v = x.to(dev)"),
    ("metadata", "v = int(x.shape[0]) + int(x.numel())\n"
                 "    if x.is_cuda: pass"),
    ("dtype-to", "v = x.to(torch.float16)"),
    ("repeat-interleave-output-size",
     "v = torch.repeat_interleave(x, lens, output_size=16)"),
    ("where-three-args", "v = torch.where(m, x, 0.0)"),
    ("as-tensor-of-device-value", "v = torch.as_tensor(x, device=dev)"),
]


@pytest.mark.parametrize("form,lines", NO_SYNC, ids=[f for f, _ in NO_SYNC])
def test_torch_no_sync_form_is_quiet(tmp_path, form, lines):
    src = PREAMBLE + "    " + lines + "\n    return state\n"
    _write(tmp_path, {"serving/engine.py": src})
    open_, _ = _run(tmp_path)
    assert not [f for f in open_ if f.rule == "host-sync"], \
        [f.render() for f in open_]


FIVE_SYNCS = """\
import torch


def step(state):
    logits = torch.randn(4, 8, device="cuda")
    n = logits.argmax(-1).sum().item()
    if bool(logits.isnan().any()):
        n += 1
    rows = torch.nonzero(logits > 0)
    last = logits[:, -1].cpu()
    toks = logits.argmax(-1).tolist()
    return n, rows, last, toks
"""

FIVE_SYNCS_JAX = """\
import jax.numpy as jnp


def step(state):
    logits = jnp.ones((4, 8))
    n = logits.argmax(-1).sum().item()
    if bool(jnp.isnan(logits).any()):
        n += 1
    rows = jnp.nonzero(logits > 0)
    last = logits[:, -1]
    toks = logits.argmax(-1).tolist()
    return n, rows, last, toks
"""


def test_five_pytorch_syncs_one_finding_each(tmp_path):
    """A serving step with five PyTorch syncs: the JAX rule sees none of
    them, the port's rule reports each once; the JAX twin of the step is
    seen by the JAX rule."""
    _write(tmp_path / "torch", {"serving/engine.py": FIVE_SYNCS})
    _write(tmp_path / "jax", {"serving/engine.py": FIVE_SYNCS_JAX})
    assert _sync_lines(tmp_path / "torch", jax_analysis) == (set(), set())
    open_, _ = _run(tmp_path / "torch")
    hits = sorted(f.line for f in open_ if f.rule == "host-sync")
    assert hits == [6, 7, 9, 10, 11], [f.render() for f in open_]
    assert _sync_lines(tmp_path / "jax", jax_analysis)[0]


def test_h2d_finding_says_pytorch_form(tmp_path):
    src = PREAMBLE + "    v = torch.as_tensor(host_rows, device=dev)\n"
    _write(tmp_path, {"serving/engine.py": src})
    open_, _ = _run(tmp_path)
    (f,) = [f for f in open_ if f.rule == "host-sync"]
    assert "PyTorch's own form" in f.message and "non_blocking" in f.hint


def test_step_closures_and_call_chains_are_reached(tmp_path):
    """A step closure handed out by a builder, and a method reached
    through a call chain (``self.draft().propose()``), are walked."""
    src = """\
import numpy as np
import torch


def _steps(dev):
    def arena(tokens):
        return torch.as_tensor(tokens, device=dev)
    return arena


class Draft:
    def propose(self, x: torch.Tensor):
        return x.sum().item()


class Worker:
    def draft(self):
        return Draft()

    def decode_iteration(self, toks):
        dec = _steps("cuda")
        out = dec(toks)
        return self.draft().propose(out)
"""
    _write(tmp_path, {"serving/workers.py": src})
    open_, _ = _run(tmp_path)
    assert sorted(f.line for f in open_ if f.rule == "host-sync") == [7, 13]


# ---------------------------------------------------------------------------
# determinism: PyTorch's global RNG
# ---------------------------------------------------------------------------
TORCH_RNG_FORMS = [
    "torch.manual_seed(0)", "torch.seed()", "torch.cuda.manual_seed_all(0)",
    "torch.rand(3)", "torch.randn(3)", "torch.randint(0, 9, (3,))",
    "torch.randperm(9)", "torch.normal(0.0, 1.0, (3,))",
    "torch.bernoulli(p)", "torch.multinomial(p, 2)", "p.uniform_()",
    "p.normal_()", "p.bernoulli_(0.5)", "p.exponential_()",
]


@pytest.mark.parametrize("form", TORCH_RNG_FORMS)
def test_torch_global_rng_fires(tmp_path, form):
    src = ("import torch\n\n\ndef _run_events(cfg, p):\n"
           f"    return {form}\n")
    _write(tmp_path, {"serving/simulator.py": src})
    open_, _ = _run(tmp_path)
    hits = [f for f in open_ if f.rule == "determinism"]
    assert [f.line for f in hits] == [5], [f.render() for f in open_]


def test_seeded_torch_generator_is_quiet(tmp_path):
    src = """\
import torch


def _run_events(cfg, p):
    gen = torch.Generator().manual_seed(cfg.seed)
    x = torch.randn(4, generator=gen)
    y = torch.randint(0, 9, (3,), generator=gen)
    p.uniform_(generator=gen)
    return x, y, torch.multinomial(p, 2, generator=gen)


def _jitter_mult(seed, gen):
    return 1.0 + 0.05 * torch.randn(1, generator=gen)
"""
    _write(tmp_path, {"workloads/trace.py": src})
    open_, _ = _run(tmp_path)
    assert not [f for f in open_ if f.rule == "determinism"], \
        [f.render() for f in open_]


# ---------------------------------------------------------------------------
# kernel-contract: the CUDA half
# ---------------------------------------------------------------------------
KC_OPS_CUDA = """\
def _launch(lib, fn, *args):
    pass


def foo_op(x, interpret=None):
    _launch("foo", "foo", x)
    return x
"""
KC_REF_CUDA = "def foo_ref(x):\n    return x\n"
KC_BUILD = 'SIGNATURES = {\n    "foo": {"foo": ()},\n}\n'
KC_GPU_TEST = ("import pytest\n\npytestmark = pytest.mark.gpu\n\n\n"
               "def test_foo():\n    assert foo_op and foo_ref\n")
KC_CPU_TEST = "def test_foo():\n    assert foo_op and foo_ref\n"


def _kc_project(**change):
    files = {"src/pkg/kernels/__init__.py": KC_INIT_OK,
             "src/pkg/kernels/ref.py": KC_REF_CUDA,
             "src/pkg/kernels/ops.py": KC_OPS_CUDA,
             "src/pkg/kernels/build.py": KC_BUILD,
             "src/pkg/kernels/csrc/foo.cu": "// the kernel\n",
             "tests/test_foo_gpu.py": KC_GPU_TEST}
    for k, v in change.items():
        path = {"ops": "src/pkg/kernels/ops.py",
                "build": "src/pkg/kernels/build.py",
                "cu": "src/pkg/kernels/csrc/foo.cu",
                "gpu_test": "tests/test_foo_gpu.py",
                "serving": "src/pkg/serving/engine.py",
                "extra_cu": "src/pkg/kernels/csrc/bar.cu"}[k]
        if v is None:
            files.pop(path)
        else:
            files[path] = v
    return files


KC_CASES = [
    ("clean", {}, None),
    ("missing-cu", {"cu": None}, "has no source csrc/foo.cu"),
    ("op-not-in-signatures", {"build": "SIGNATURES = {}\n"},
     "launches no library listed in"),
    ("no-gpu-test", {"gpu_test": KC_CPU_TEST},
     "no `gpu`-marked test references both `foo_op` and `foo_ref`"),
    ("unbuilt-cu", {"extra_cu": "// not built\n"},
     "csrc/bar.cu is built by no entry of SIGNATURES"),
    ("interpret-true", {"serving": "def step(x):\n"
                                   "    return foo_op(x, interpret=True)\n"},
     "`interpret=True` outside kernels/"),
]


@pytest.mark.parametrize("name,change,message", KC_CASES,
                         ids=[c[0] for c in KC_CASES])
def test_kernel_contract_cuda_half(tmp_path, name, change, message):
    _write(tmp_path, _kc_project(**change))
    open_, _ = _run(tmp_path)
    hits = [f for f in open_ if f.rule == "kernel-contract"]
    if message is None:
        assert not hits, [f.render() for f in hits]
    else:
        assert any(message in f.message for f in hits), \
            [f.render() for f in hits]
    # the JAX rule knows only the Pallas half: none of these fire there
    jax_hits = [f for f in _run(tmp_path, jax_analysis)[0]
                if f.rule == "kernel-contract"]
    assert not [f for f in jax_hits if message and message in f.message]


def test_real_kernels_package_passes():
    """The port's kernels package: the nine exports, each with its
    oracle, its `interpret` parameter, its library and source, and a
    `gpu`-marked test naming both."""
    from repro_torch.analysis import kernel_contract
    from repro_torch.analysis.core import load_project

    project, _ = load_project([str(REPO / "src" / "repro_torch")],
                              [r.token for r in ALL_RULES], base=REPO)
    assert kernel_contract.check(project) == []
    (init,) = [f for f in project.files
               if f.rel == "src/repro_torch/kernels/__init__.py"]
    ops = [n for n in kernel_contract._exports(init) if n.endswith("_op")]
    assert len(ops) == 9
    (build,) = [f for f in project.files
                if f.rel == "src/repro_torch/kernels/build.py"]
    libs, _ = kernel_contract._signatures(build)
    assert set(libs) == {p.stem for p in (
        REPO / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_json_and_exit_codes(tmp_path, capsys, monkeypatch):
    _write(tmp_path, {"serving/engine.py": TORCH_SYNC_BAD})
    monkeypatch.chdir(tmp_path)
    rc = main(["--format=json", "serving"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["counts"]["open"] == 3
    assert all({"rule", "path", "line", "message", "hint"} <=
               set(f) for f in payload["findings"])

    _write(tmp_path, {"serving/engine.py": TORCH_SYNC_CLEAN})
    rc = main(["--format=json", "serving"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["counts"]["open"] == 0


def test_cli_baseline_diff(tmp_path, capsys, monkeypatch):
    _write(tmp_path, {"serving/engine.py": TORCH_SYNC_BAD})
    monkeypatch.chdir(tmp_path)
    main(["--format=json", "serving"])
    (tmp_path / "base.json").write_text(capsys.readouterr().out)

    rc = main(["--format=json", "--baseline", "base.json", "serving"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["baseline"] == {"new": 0, "resolved": 0}

    _write(tmp_path, {"serving/engine.py": TORCH_SYNC_BAD +
                      "\ndef run(state):\n"
                      "    torch.cuda.synchronize()\n"})
    rc = main(["--format=json", "--baseline", "base.json", "serving"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["baseline"]["new"] == len(payload["findings"]) == 1
    assert "run()" in payload["findings"][0]["message"]

    _write(tmp_path, {"serving/engine.py": TORCH_SYNC_CLEAN})
    rc = main(["--format=json", "--baseline", "base.json", "serving"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["baseline"]["new"] == 0
    assert payload["baseline"]["resolved"] == 3


def test_cli_defaults_to_the_port(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert main([]) == 0
    assert "# 0 finding(s)" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port's tree is clean under its own rules
# ---------------------------------------------------------------------------
def test_port_tree_is_clean():
    open_, closed = run_paths([str(REPO / "src" / "repro_torch")],
                              base=REPO)
    assert not open_, "\n".join(f.render() for f in open_)
    assert all(f.reason for f in closed)
    # both sanctioned pulls of the decode worker stay documented
    pulls = [f for f in closed if f.rule == "host-sync"
             and f.path == "src/repro_torch/serving/workers.py"
             and "single sanctioned sync" in f.reason]
    assert {f.message.split("via ")[-1] for f in pulls} == {
        "decode_iteration())", "_verify_iteration())"}
    # no `# lint:` comment in the port suppresses nothing
    token_of = {r.token: r.id for r in ALL_RULES}
    used = {(f.path, line, f.rule) for f in closed
            for line in (f.line, f.line - 1)}
    dead = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        supp, bad = parse_suppressions(rel, path.read_text(), token_of)
        assert not bad, [f.render() for f in bad]
        dead += [f"{rel}:{line} {token}" for line, tokens in supp.items()
                 for token in tokens
                 if (rel, line, token_of[token]) not in used]
    assert not dead, dead
