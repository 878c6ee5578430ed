"""units: dimensional consistency from the repo's naming conventions.

The serving stack and the KVServe latency model (Eq. 1) juggle four
dimensions that all live in bare floats: payload sizes in **bytes**
(``*_bytes``, ``nbytes``, ``payload``, the paper's V), wall/virtual
times in **seconds** (``t_*``, ``now``, ``free_at``, ``*_latency``),
link **bandwidths** in bytes/s (``*_bw``, ``bandwidth``, ``goodput``,
the paper's B, codec speeds ``s_enc``/``s_dec``), and **token** counts /
rates (``*_tokens``, ``*_tok_s``).  A bytes-vs-seconds slip type-checks
fine and only shows up as a wrong crossover plot.

The rule infers a dimension *tag* for each name (variable, attribute,
call) from these conventions and flags:

* ``+``/``-``/comparisons mixing two *different* known tags,
* assignments storing a known tag into a name carrying a different one,
* ``max``/``min`` over mixed known tags.

Division and multiplication are the sanctioned conversions
(bytes / bandwidth -> seconds, tokens / tok_s -> seconds, ...).  Names
that match no convention stay untagged and never flag — the rule is
deliberately low-noise.

Scope: ``serving/`` (incl. the simulator), ``controller/``,
``workloads/`` and ``distribution/``.  Suppression token: ``units-ok``.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from repro_torch.analysis.core import Finding, Project, SourceFile, dotted, func_defs

RULE_ID = "units"
TOKEN = "units-ok"

BYTES, SECONDS, BW, TOKENS, TOKRATE = \
    "bytes", "seconds", "bytes/s", "tokens", "tokens/s"

# Ordered: first match wins (the tok/s patterns must pre-empt `_s$`).
NAME_TAGS = [
    (re.compile(r"(_tok_s|_tok_rate)$"), TOKRATE),
    (re.compile(r"^(bw|bandwidth|goodput|rate|estimate|B)$"
                r"|(_bw|_bandwidth|_goodput)$"
                r"|^s_(enc|dec|eff|p)$"), BW),
    (re.compile(r"^n?bytes$|_bytes$|^bytes_|^payload$"), BYTES),
    (re.compile(r"_tokens$"), TOKENS),
    (re.compile(r"^t[0-9]?$|^t_"
                r"|(_time|_latency|_seconds|_wait|_delay|_overhead|_s)$"
                r"|^(now|free_at|ready|arrival|done|deadline|ttft|jct"
                r"|elapsed|wall|dur|slack|start|end|cost|iter_cost)$"
                r"|_cost$"), SECONDS),
]

CALL_TAGS = [
    (re.compile(r"(_time|_latency|_seconds|_s|_cost|_wait)$"
                r"|^(perf_counter|codec_cost)$"), SECONDS),
    (re.compile(r"_bytes$|^n?bytes\w*$|^kv_bytes_for$"), BYTES),
]

DIV_RESULTS = {
    (BYTES, BW): SECONDS,
    (BYTES, SECONDS): BW,
    (TOKENS, TOKRATE): SECONDS,
    (TOKENS, SECONDS): TOKRATE,
}
MUL_RESULTS = {
    (BW, SECONDS): BYTES, (SECONDS, BW): BYTES,
    (TOKRATE, SECONDS): TOKENS, (SECONDS, TOKRATE): TOKENS,
}


def _name_tag(name: str) -> Optional[str]:
    for pat, tag in NAME_TAGS:
        if pat.search(name):
            return tag
    return None


def _call_tag(name: str) -> Optional[str]:
    for pat, tag in CALL_TAGS:
        if pat.search(name):
            return tag
    return None


def _in_scope(f: SourceFile) -> bool:
    return (f.in_dir("serving") or f.in_dir("controller")
            or f.in_dir("workloads") or f.in_dir("distribution")) \
        and not f.in_dir("tests")


class _Tagger:
    def __init__(self, f: SourceFile):
        self.f = f
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            RULE_ID, self.f.rel, node.lineno, what,
            "insert the conversion (divide by a bandwidth/rate), or "
            "rename the variable to match its dimension; annotate "
            "`# lint: units-ok(reason)` if the mix is intentional"))

    # -- expression tags ----------------------------------------------------
    def tag(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return _name_tag(node.id)
        if isinstance(node, ast.Attribute):
            return _name_tag(node.attr)
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d in ("float", "int", "abs", "round"):
                return self.tag(node.args[0]) if node.args else None
            if d in ("max", "min"):
                tags = {t for t in (self.tag(a) for a in node.args) if t}
                if len(tags) > 1:
                    self._flag(node, f"{d}() over mixed dimensions "
                                     f"({', '.join(sorted(tags))})")
                    return None
                return next(iter(tags), None)
            tail = d.rsplit(".", 1)[-1]
            return _call_tag(tail) if tail else None
        if isinstance(node, ast.UnaryOp):
            return self.tag(node.operand)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.IfExp):
            a, b = self.tag(node.body), self.tag(node.orelse)
            if a and b and a != b:
                self._flag(node, f"conditional mixes dimensions "
                                 f"({a} vs {b})")
                return None
            return a or b
        if isinstance(node, ast.Compare):
            self._compare(node)
            return None
        return None

    def _binop(self, node: ast.BinOp) -> Optional[str]:
        lt, rt = self.tag(node.left), self.tag(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if lt and rt and lt != rt:
                self._flag(node, f"{'+' if isinstance(node.op, ast.Add) else '-'} "
                                 f"mixes dimensions: {lt} "
                                 f"{'+' if isinstance(node.op, ast.Add) else '-'} "
                                 f"{rt}")
                return None
            return lt or rt
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            if lt and rt:
                return DIV_RESULTS.get((lt, rt))
            return None
        if isinstance(node.op, ast.Mult):
            if lt and rt:
                return MUL_RESULTS.get((lt, rt))
            return None
        return None

    def _compare(self, node: ast.Compare) -> None:
        operands = [node.left] + list(node.comparators)
        tags = [self.tag(o) for o in operands]
        for (a, ta), (b, tb) in zip(zip(operands, tags),
                                    zip(operands[1:], tags[1:])):
            if ta and tb and ta != tb:
                self._flag(node, f"comparison mixes dimensions: "
                                 f"{ta} vs {tb}")

    # -- statements ---------------------------------------------------------
    def _check_assign(self, target: ast.AST, value_tag: Optional[str],
                      node: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            return  # tuple-unpack: element tags unknown from one value tag
        name = target.id if isinstance(target, ast.Name) else (
            target.attr if isinstance(target, ast.Attribute) else None)
        if name is None:
            return
        nt = _name_tag(name)
        if nt and value_tag and nt != value_tag:
            self._flag(node, f"`{name}` ({nt}) assigned a {value_tag} "
                             f"value")

    def run(self) -> List[Finding]:
        for fn in func_defs(self.f.tree):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    vt = self.tag(node.value)
                    for tgt in node.targets:
                        self._check_assign(tgt, vt, node)
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.op, (ast.Add, ast.Sub)):
                    vt = self.tag(node.value)
                    self._check_assign(node.target, vt, node)
                elif isinstance(node, (ast.BinOp, ast.Compare, ast.IfExp)):
                    pass  # reached via parents below
            # one tagging pass over every top-level expression: BinOp /
            # Compare flags fire inside tag()
            for node in ast.walk(fn):
                if isinstance(node, (ast.BinOp, ast.Compare)):
                    self.tag(node)
        # dedupe (same BinOp reached via parent and via walk)
        seen = set()
        uniq = []
        for fd in self.findings:
            key = (fd.line, fd.message)
            if key not in seen:
                seen.add(key)
                uniq.append(fd)
        return uniq


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for f in project.matching(_in_scope):
        findings.extend(_Tagger(f).run())
    return findings
