"""clock-accounting: virtual-clock billing invariants in serving/.

The runtime's core contract is that per-request ``breakdown`` dicts sum
exactly to the reported JCT (asserted end-to-end by the benchmarks).
Three statically checkable ways that contract has broken in past PRs:

* **dead-time-component** — a ``t_*`` local is computed but never
  consumed: the component exists in the cost model but is billed zero
  times (the identity-fallback bug shape).
* **double-billed-key** — the same breakdown key is plain-assigned twice
  on one control-flow path: the first component is silently dropped
  (use ``+=`` to accumulate, or distinct keys).
* **clock-regression** — an assignment to a ``clock``/``now``/
  ``free_at`` attribute whose right-hand side is not provably
  monotone (derived from ``max(...)``, from the attribute's own prior
  value, or from a local that is).  Virtual clocks only move forward.

Scope: modules under ``serving/`` (the virtual clock lives there).
Suppression token: ``clock-ok``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.core import Finding, Project, SourceFile, dotted, func_defs

RULE_ID = "clock-accounting"
TOKEN = "clock-ok"

T_VAR = re.compile(r"^t_\w+$")
CLOCK_ATTRS = {"clock", "now", "free_at"}
CLOCK_EXEMPT_FUNCS = {"__init__", "reset"}
BREAKDOWN_BASES = re.compile(r"(^|\.)(breakdown|bd)$")


def _in_scope(f: SourceFile) -> bool:
    return f.in_dir("serving") and not f.in_dir("tests")


# ---------------------------------------------------------------------------
# (1) dead t_* stores
# ---------------------------------------------------------------------------
def _dead_time_components(f: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    stores: Dict[str, int] = {}
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and T_VAR.match(node.id):
            if isinstance(node.ctx, ast.Store):
                stores.setdefault(node.id, node.lineno)
            else:
                loads.add(node.id)
    out = []
    for name, line in sorted(stores.items(), key=lambda kv: kv[1]):
        if name not in loads:
            out.append(Finding(
                RULE_ID, f.rel, line,
                f"time component `{name}` is computed in {fn.name}() but "
                f"never billed anywhere",
                "add it to the request breakdown / JCT sum, or drop the "
                "computation"))
    return out


# ---------------------------------------------------------------------------
# (2) double-assigned breakdown keys (path-sensitive)
# ---------------------------------------------------------------------------
def _breakdown_key(st: ast.AST) -> Tuple[str, str] | None:
    """('req.breakdown', 'queue') for `req.breakdown["queue"] = ...`."""
    if isinstance(st, ast.Subscript):
        base = dotted(st.value)
        if base and BREAKDOWN_BASES.search(base) and \
                isinstance(st.slice, ast.Constant) and \
                isinstance(st.slice.value, str):
            return base, st.slice.value
    return None


def _double_billed(f: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    out: List[Finding] = []

    def record(key, line, seen):
        if key in seen:
            out.append(Finding(
                RULE_ID, f.rel, line,
                f"breakdown key {key[1]!r} of `{key[0]}` plain-assigned "
                f"twice on one path (first assignment at line "
                f"{seen[key]}) — the earlier component is dropped",
                "accumulate with `+=`, or bill into a distinct key"))
        seen[key] = line

    def walk(stmts: List[ast.stmt], seen: Dict) -> None:
        for st in stmts:
            if isinstance(st, (ast.Return, ast.Raise, ast.Continue,
                               ast.Break)):
                seen.clear()   # path ends: later assigns are a new path
            elif isinstance(st, ast.Assign):
                for tgt in st.targets:
                    key = _breakdown_key(tgt)
                    if key:
                        record(key, st.lineno, seen)
                    # dict-literal init: bd = {"queue": ...}
                    if isinstance(tgt, (ast.Name, ast.Attribute)) and \
                            BREAKDOWN_BASES.search(dotted(tgt) or "") and \
                            isinstance(st.value, ast.Dict):
                        for k in st.value.keys:
                            if isinstance(k, ast.Constant) and \
                                    isinstance(k.value, str):
                                record((dotted(tgt), k.value),
                                       st.lineno, seen)
            elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                call = st.value
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr == "update" and \
                        BREAKDOWN_BASES.search(dotted(call.func.value) or ""):
                    for kw in call.keywords:
                        if kw.arg:
                            record((dotted(call.func.value), kw.arg),
                                   st.lineno, seen)
            elif isinstance(st, ast.If):
                walk(st.body, dict(seen))
                walk(st.orelse, dict(seen))
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                walk(st.body, {})   # fresh per-iteration state
                walk(st.orelse, dict(seen))
            elif isinstance(st, ast.With):
                walk(st.body, seen)
            elif isinstance(st, ast.Try):
                walk(st.body, dict(seen))
                for h in st.handlers:
                    walk(h.body, dict(seen))
                walk(st.orelse, dict(seen))
                walk(st.finalbody, dict(seen))

    walk(fn.body, {})
    return out


# ---------------------------------------------------------------------------
# (3) clock monotonicity
# ---------------------------------------------------------------------------
def _mentions_safe(expr: ast.AST, safe: Set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in CLOCK_ATTRS:
            return True
        if isinstance(n, ast.Name) and n.id in safe:
            return True
        if isinstance(n, ast.Call) and dotted(n.func) == "max":
            return True
    return False


def _clock_regressions(f: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    if fn.name in CLOCK_EXEMPT_FUNCS:
        return []
    out: List[Finding] = []
    safe: Set[str] = set()
    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                     key=lambda n: (n.lineno, n.col_offset))
    for node in assigns:
        is_safe_rhs = _mentions_safe(node.value, safe)
        for tgt in node.targets:
            els = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
            for el in els:
                if isinstance(el, ast.Name) and is_safe_rhs:
                    safe.add(el.id)
                if isinstance(el, ast.Attribute) and \
                        el.attr in CLOCK_ATTRS and not is_safe_rhs:
                    out.append(Finding(
                        RULE_ID, f.rel, node.lineno,
                        f"assignment to `{dotted(el)}` is not provably "
                        f"monotone — virtual clocks must never move "
                        f"backwards",
                        "derive the new value from max(...) or from the "
                        "clock's own prior value, or annotate "
                        "`# lint: clock-ok(reason)`"))
    return out


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for f in project.matching(_in_scope):
        for fn in func_defs(f.tree):
            findings.extend(_dead_time_components(f, fn))
            findings.extend(_double_billed(f, fn))
            findings.extend(_clock_regressions(f, fn))
    return findings
