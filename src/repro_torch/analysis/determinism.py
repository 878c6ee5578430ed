"""determinism: replay-safety of the virtual-clock simulator + workloads.

The event-driven simulator and the workload generators are the repo's
replay surface: every run is a pure function of (config, seed) — an
invariant once restored by hand after stateful jitter crept in, and the
base of the trace-replay harness.  This rule keeps the
invariant mechanical:

* **Wall-clock in virtual-clock paths** — ``time.time`` /
  ``perf_counter`` / ``monotonic`` / ``datetime.now`` have no place in a
  simulator whose clock is virtual; a replay on different hardware would
  diverge.
* **Unseeded / global-state RNG** — ``np.random.default_rng()`` with no
  seed, the legacy ``np.random.*`` module API (global state), and the
  stdlib ``random`` module all make replays irreproducible.  The
  sanctioned shape is a seeded ``np.random.Generator`` threaded
  explicitly (``rng = np.random.default_rng(cfg.seed)``).
* **PyTorch's global RNG** — ``torch.manual_seed`` / ``torch.seed``
  reseed the process-wide generator, and ``torch.rand`` / ``randn`` /
  ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
  ``multinomial`` (and the in-place ``Tensor.uniform_`` / ``normal_`` /
  ... draws) without ``generator=`` draw from it.  The sanctioned shape
  is the same as numpy's: a ``torch.Generator`` seeded from the config
  and passed in explicitly (``generator=gen``).
* **``id()``-based ordering** — ``sorted(..., key=id)`` (or a key
  lambda calling ``id``) orders by allocation address, which differs
  across processes.  (``id()`` as a cache key with an identity pin —
  the simulator's ``_profile_name`` — is fine: that's caching, not
  ordering.)
* **Stateful jitter** — a ``*jitter*``/``*noise*``/``*perturb*``
  function drawing from a long-lived generator (``self.rng.normal()``)
  depends on global call order, so two runs that interleave events
  differently see different jitter.  The sanctioned shape is
  ``_jitter_mult(seed, start, nbytes)``: a LOCAL generator derived from
  (seed, inputs) alone.

Scope: ``serving/simulator.py``, ``serving/network.py`` and
``workloads/``.  Suppression token: ``det-ok``.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from repro_torch.analysis.core import Finding, Project, SourceFile, dotted, func_defs

RULE_ID = "determinism"
TOKEN = "det-ok"

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "_time.time", "_time.perf_counter",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
# bare names that are wall-clock when imported from time/datetime
WALL_CLOCK_BARE = {"time", "perf_counter", "monotonic", "process_time"}

# np.random.* tails that are NOT the global-state legacy API
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "MT19937", "BitGenerator"}

# PyTorch's process-wide generator: reseeding it, and drawing from it
# (a draw that names no ``generator=``)
TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                     "torch.random.manual_seed", "torch.random.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                     "torch.cuda.seed", "torch.cuda.seed_all"}
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
               "bernoulli", "multinomial", "poisson", "rand_like",
               "randn_like", "randint_like"}
TENSOR_DRAWS_INPLACE = {"uniform_", "normal_", "bernoulli_", "random_",
                        "exponential_", "geometric_", "cauchy_",
                        "log_normal_"}

JITTER_RE = re.compile(r"jitter|noise|perturb")
DRAWS = {"normal", "standard_normal", "uniform", "random", "integers",
         "choice", "exponential", "poisson", "lognormal", "gamma",
         "shuffle", "permutation"}


def _in_scope(f: SourceFile) -> bool:
    if f.in_dir("tests") or f.in_dir("benchmarks") or f.in_dir("examples"):
        return False
    name = f.parts[-1] if f.parts else ""
    return f.in_dir("workloads") or name in ("simulator.py", "network.py")


def _wallclock_imports(tree: ast.Module) -> Set[str]:
    """Bare names imported from time/datetime that read the wall clock."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module in ("time", "datetime"):
            for alias in node.names:
                if alias.name in WALL_CLOCK_BARE:
                    out.add(alias.asname or alias.name)
    return out


# ---------------------------------------------------------------------------
def _check_calls(f: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    bare_clock = _wallclock_imports(f.tree)
    for node in ast.walk(f.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d in WALL_CLOCK or (isinstance(node.func, ast.Name)
                               and node.func.id in bare_clock):
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"wall-clock call `{d or node.func.id}()` in a "
                f"virtual-clock replay path — replays on different "
                f"hardware diverge",
                "derive every time from the virtual clock / event "
                "timestamps; annotate `# lint: det-ok(reason)` if this "
                "is genuinely offline instrumentation"))
            continue
        if d in ("np.random.default_rng", "numpy.random.default_rng") \
                and not node.args and not node.keywords:
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                "`default_rng()` with no seed — entropy-seeded, so no "
                "two replays draw the same stream",
                "seed from config: `np.random.default_rng(cfg.seed)`"))
            continue
        parts = d.split(".")
        if len(parts) >= 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and parts[2] not in NP_RANDOM_OK:
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"legacy global-state RNG `{d}()` — draws depend on "
                f"every other np.random call in the process",
                "thread a seeded np.random.Generator instead"))
            continue
        if d in TORCH_GLOBAL_SEED:
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"`{d}()` reseeds PyTorch's process-wide generator — every "
                f"other draw in the process depends on it",
                "seed a local `torch.Generator().manual_seed(cfg.seed)` "
                "and pass it as `generator=`"))
            continue
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if not has_gen and ((len(parts) == 2 and parts[0] == "torch"
                             and parts[1] in TORCH_DRAWS)
                            or (isinstance(node.func, ast.Attribute)
                                and node.func.attr in TENSOR_DRAWS_INPLACE)):
            what = d if len(parts) == 2 and parts[0] == "torch" \
                else f"Tensor.{node.func.attr}"
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"`{what}()` without `generator=` draws from PyTorch's "
                f"process-wide generator — not replay-safe",
                "pass a `torch.Generator` seeded from config as "
                "`generator=`"))
            continue
        if parts[0] == "random" and len(parts) == 2:
            if parts[1] == "Random" and (node.args or node.keywords):
                continue   # random.Random(seed) is explicitly seeded
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"stdlib `{d}()` — module-global RNG state is not "
                f"replay-safe",
                "use a seeded np.random.Generator threaded through "
                "the call"))
    return findings


# ---------------------------------------------------------------------------
def _key_uses_id(key: ast.AST) -> bool:
    if isinstance(key, ast.Name) and key.id == "id":
        return True
    for n in ast.walk(key):
        if isinstance(n, ast.Call) and dotted(n.func) == "id":
            return True
    return False


def _check_id_ordering(f: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(f.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        is_order = d in ("sorted", "min", "max") or d.endswith(".sort")
        if not is_order:
            continue
        for kw in node.keywords:
            if kw.arg == "key" and _key_uses_id(kw.value):
                findings.append(Finding(
                    RULE_ID, f.rel, node.lineno,
                    f"`{d}(..., key=id)`-style ordering — allocation "
                    f"addresses differ across processes, so replay "
                    f"order differs",
                    "order by a stable field (rid, name, arrival) "
                    "instead of object identity"))
    return findings


# ---------------------------------------------------------------------------
def _check_stateful_jitter(f: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fn in func_defs(f.tree):
        if not JITTER_RE.search(fn.name):
            continue
        # locals assigned from an explicitly seeded generator are pure
        seeded: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                vd = dotted(node.value.func)
                if vd.rsplit(".", 1)[-1] in ("default_rng", "Random") \
                        and (node.value.args or node.value.keywords):
                    seeded.add(node.targets[0].id)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in DRAWS):
                continue
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id in seeded:
                continue
            if dotted(recv).rsplit(".", 1)[-1] in ("random", "np", "numpy"):
                continue   # np.random.* handled by the RNG check above
            findings.append(Finding(
                RULE_ID, f.rel, node.lineno,
                f"`{fn.name}()` draws jitter from a long-lived generator "
                f"(`{dotted(recv) or '<expr>'}.{node.func.attr}`) — the "
                f"draw depends on global call order, not on "
                f"(seed, inputs)",
                "make jitter a pure function of (seed, inputs): build a "
                "local `np.random.default_rng(seed ^ hash(inputs))` "
                "per call (see BandwidthTrace._jitter_mult)"))
    return findings


# ---------------------------------------------------------------------------
def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for f in project.matching(_in_scope):
        findings.extend(_check_calls(f))
        findings.extend(_check_id_ordering(f))
        findings.extend(_check_stateful_jitter(f))
    return findings
