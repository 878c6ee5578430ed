"""Shared infrastructure for the repro static-analysis suite.

The suite is a set of *repo-specific* AST checkers (DESIGN.md §13): each
rule knows this codebase's conventions (virtual-clock accounting, the
`t_*`/`*_bytes` naming scheme, the kernels/ops/ref layout) and flags
violations with a file:line, a rule id, and a fix hint.

Suppression grammar
-------------------
A finding is suppressed by an inline comment on the flagged line or the
line directly above it::

    nxt = np.asarray(nxt)   # lint: sync-ok(single per-iteration token pull)

The general form is ``# lint: <token>(<reason>) [<token>(<reason>) ...]``
where ``<token>`` is the rule's suppression token (``sync-ok``,
``clock-ok``, ``units-ok``, ``kernel-ok``).  The reason is mandatory: an
empty reason or an unknown token is itself a finding (rule
``lint-suppression``) and cannot be suppressed — the tree never goes
green by silencing the linter.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

SUPPRESS_RE = re.compile(r"#\s*lint:\s*(?P<body>.*)$")
ENTRY_RE = re.compile(r"(?P<token>[a-z][a-z0-9-]*)\s*\(\s*(?P<reason>[^()]*?)\s*\)")


@dataclass
class Finding:
    """One checker hit, addressable by file:line."""
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    reason: str = ""

    def render(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        if self.suppressed:
            s += f"\n    suppressed: {self.reason}"
        return s

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "suppressed": self.suppressed, "reason": self.reason}


@dataclass
class SourceFile:
    path: Path                    # absolute
    rel: str                      # display / matching path (posix, relative)
    text: str
    tree: ast.Module
    # line -> {token: reason}; parsed once, applied by the driver
    suppressions: Dict[int, Dict[str, str]] = field(default_factory=dict)

    @property
    def parts(self) -> Sequence[str]:
        return Path(self.rel).parts

    def in_dir(self, name: str) -> bool:
        return name in self.parts


@dataclass
class Project:
    files: List[SourceFile]

    def matching(self, pred: Callable[[SourceFile], bool]) -> List[SourceFile]:
        return [f for f in self.files if pred(f)]


@dataclass(frozen=True)
class Rule:
    id: str
    token: str                    # suppression token, e.g. "sync-ok"
    summary: str
    check: Callable[[Project], List[Finding]]


def parse_suppressions(rel: str, text: str, known_tokens: Iterable[str]
                       ) -> tuple[Dict[int, Dict[str, str]], List[Finding]]:
    """Scan a file's ``# lint:`` comments.  Returns (line -> token ->
    reason, grammar findings).  Malformed entries become findings of the
    un-suppressible ``lint-suppression`` rule."""
    known = set(known_tokens)
    out: Dict[int, Dict[str, str]] = {}
    bad: List[Finding] = []
    comments: List[tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.string))
    except tokenize.TokenizeError:
        pass  # a parse-error finding is raised by the loader anyway
    for lineno, comment in comments:
        m = SUPPRESS_RE.search(comment)
        if not m:
            continue
        body = m.group("body").strip()
        entries = list(ENTRY_RE.finditer(body))
        leftover = ENTRY_RE.sub("", body).replace(",", "").strip()
        if not entries or leftover:
            bad.append(Finding(
                "lint-suppression", rel, lineno,
                f"malformed suppression comment: {body!r}",
                "use `# lint: <token>(reason)`, e.g. `# lint: sync-ok(...)`"))
            continue
        for e in entries:
            token, reason = e.group("token"), e.group("reason").strip()
            if token not in known:
                bad.append(Finding(
                    "lint-suppression", rel, lineno,
                    f"unknown suppression token {token!r}",
                    f"known tokens: {', '.join(sorted(known))}"))
                continue
            if not reason:
                bad.append(Finding(
                    "lint-suppression", rel, lineno,
                    f"suppression {token}() has no reason",
                    "every suppression must say WHY the pattern is "
                    "intentional"))
                continue
            out.setdefault(lineno, {})[token] = reason
    return out, bad


def iter_python_files(paths: Sequence[str]) -> List[Path]:
    seen: List[Path] = []
    for p in paths:
        root = Path(p)
        if root.is_file() and root.suffix == ".py":
            seen.append(root)
        elif root.is_dir():
            for f in sorted(root.rglob("*.py")):
                if any(part.startswith(".") or part == "__pycache__"
                       for part in f.parts):
                    continue
                seen.append(f)
    return seen


def load_project(paths: Sequence[str], known_tokens: Iterable[str],
                 base: Optional[Path] = None
                 ) -> tuple[Project, List[Finding]]:
    """Parse every .py file under ``paths``.  Unparseable files become
    ``parse-error`` findings (never suppressible)."""
    base = base or Path.cwd()
    files: List[SourceFile] = []
    findings: List[Finding] = []
    tokens = list(known_tokens)
    for path in iter_python_files(paths):
        apath = path.resolve()
        try:
            rel = apath.relative_to(base.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            text = apath.read_text()
            tree = ast.parse(text, filename=rel)
        except (OSError, SyntaxError) as e:
            findings.append(Finding("parse-error", rel,
                                    getattr(e, "lineno", 1) or 1, str(e)))
            continue
        supp, bad = parse_suppressions(rel, text, tokens)
        findings.extend(bad)
        files.append(SourceFile(apath, rel, text, tree, supp))
    return Project(files), findings


def dotted(node: ast.AST) -> str:
    """'np.asarray' for Attribute/Name chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def func_defs(tree: ast.AST):
    """Yield every (Async)FunctionDef in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
