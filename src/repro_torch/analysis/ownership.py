"""ownership: worker-local vs cluster-shared object discipline (DESIGN.md §14).

Disaggregation makes KV explicitly *shared cluster state*: the N x M
``ClusterRuntime`` hands every worker the same ``ModelHandle``, the same
``ContinuousScheduler``, the same ``NetworkTopology`` links — and, in
pool mode, ONE cluster-wide shared remote ``KVTier`` that every decode
worker's hierarchy ends in.  Two PR-5 review passes caught, by hand, the
two bug shapes this rule now catches mechanically:

* a MOVE-shaped operation (``discard``/``_entries.pop``/``del``/
  ``.store`` reassignment) on a tier that may be cluster-shared, without
  a ``.shared`` guard — promotion out of a shared pool must COPY, never
  move, or the entry vanishes for every other worker;
* one worker's code path clobbering shared state (``put()``
  pre-removing a shared tier's copy during a local refresh).

Checks
------
1. **Shared-object mutation outside owner methods.**  Per class,
   attributes assigned from ``ModelHandle(...)`` / ``NetworkTopology(...)``
   / ``ContinuousScheduler(...)`` constructor calls, attributes whose
   name matches ``_shared*``, and attributes annotated ``.shared = True``
   are classified cluster-SHARED at their construction/annotation site.
   Writing *into* such an object (``self._model.cfg = ...``), rebinding
   it, or calling a raw container mutator on its private state
   (``self.scheduler._free_slots.append``) outside the allowlisted
   owner-method set (:data:`OWNER_METHODS`) is a finding.
2. **MOVE-shaped ops on maybe-shared tiers.**  Within a function, tier
   expressions (loop vars over ``*.tiers``, names assigned from
   ``*.tiers[i]``, dotted paths ending ``.tier``, ``_shared*`` attrs)
   are tracked flow-sensitively through ``if X.shared:`` guards; a
   ``discard``/``_entries.pop``/``del _entries[...]``/``.store =``
   on a tier NOT proven worker-local flags.  ``if t.shared: continue``
   and the ``else`` arm of ``if hit.tier.shared:`` prove locality.
3. **Unordered iteration feeding decisions.**  In routing/eviction
   decision functions (name matches ``choose|route|admit|evict|victim|
   place|promote|select|schedule``), iterating a set (literal,
   ``set()``, set comprehension) or a raw dict view (``.keys()`` /
   ``.values()`` / ``.items()``) — or ``next(iter(...))`` over one —
   makes the decision depend on insertion/hash order, which differs
   across workers and replays.  ``sorted(...)`` with an explicit key is
   the sanctioned shape.

Scope: ``serving/``.  Suppression token: ``own-ok``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Project, SourceFile, dotted, func_defs

RULE_ID = "ownership"
TOKEN = "own-ok"

# Constructor calls whose results are cluster-shared by design: every
# worker reads the model through one handle, the scheduler admits for the
# whole mesh, the topology owns every (src, dst) link.
SHARED_CONSTRUCTORS = {"ModelHandle", "NetworkTopology", "ContinuousScheduler"}
SHARED_NAME_RE = re.compile(r"^_?shared")

# Construction/annotation sites: the owner-method allowlist.  These are
# where shared objects are built, wired and flagged — mutation there IS
# ownership.
OWNER_METHODS = {"__init__", "__post_init__", "_build_store", "wrap_flat"}

# Raw container mutators: calling one on a shared object's private state
# bypasses its owner API.
MUTATORS = {"pop", "clear", "update", "remove", "append", "extend",
            "insert", "setdefault", "popitem", "discard"}

DECISION_RE = re.compile(
    r"choose|route|admit|evict|victim|place|promote|select|schedule")


def _in_scope(f: SourceFile) -> bool:
    return f.in_dir("serving") and not f.in_dir("tests")


# ---------------------------------------------------------------------------
# Check 1: shared-object mutation outside the owner-method allowlist
# ---------------------------------------------------------------------------
def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a `self.x` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _shared_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names classified cluster-shared from their
    construction/annotation sites anywhere in the class."""
    shared: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            a = _self_attr(tgt)
            if a is not None:
                if SHARED_NAME_RE.match(a):
                    shared.add(a)
                if isinstance(node.value, ast.Call) and \
                        dotted(node.value.func).rsplit(".", 1)[-1] \
                        in SHARED_CONSTRUCTORS:
                    shared.add(a)
            # self.<A>.shared = True annotates <A> as a shared tier
            if isinstance(tgt, ast.Attribute) and tgt.attr == "shared":
                base = _self_attr(tgt.value)
                if base is not None and isinstance(node.value, ast.Constant) \
                        and node.value.value is True:
                    shared.add(base)
    return shared


def _chain_base(node: ast.AST) -> Tuple[Optional[str], int, bool]:
    """Unroll an Attribute/Subscript chain.  Returns ``(self_attr,
    depth, has_private)``: the `self.<attr>` base (or None), how many
    attribute hops sit above it (0 = the base itself), and whether any
    hop above the base is underscore-private."""
    depth, private = 0, False
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            base = _self_attr(node)
            if base is not None:
                return base, depth, private
            if node.attr.startswith("_"):
                private = True
            depth += 1
        node = node.value
    return None, depth, private


def _check_shared_mutation(f: SourceFile, cls: ast.ClassDef,
                           shared: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    hint = ("mutate shared objects only from their owner methods "
            f"({', '.join(sorted(OWNER_METHODS))}); annotate "
            "`# lint: own-ok(reason)` if this site is an intentional "
            "cluster-wide mutation")
    for fn in (n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
        if fn.name in OWNER_METHODS:
            continue
        for node in ast.walk(fn):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = list(node.targets)
            for tgt in targets:
                base, depth, _ = _chain_base(tgt)
                if base not in shared:
                    continue
                if depth == 0 and isinstance(tgt, ast.Attribute):
                    findings.append(Finding(
                        RULE_ID, f.rel, node.lineno,
                        f"cluster-shared `{base}` rebound in "
                        f"{cls.name}.{fn.name}() — other holders keep the "
                        f"old object", hint))
                else:
                    findings.append(Finding(
                        RULE_ID, f.rel, node.lineno,
                        f"write into cluster-shared `{base}` in "
                        f"{cls.name}.{fn.name}() (outside the owner-method "
                        f"allowlist)", hint))
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                base, depth, private = _chain_base(node.func.value)
                if base in shared and private:
                    findings.append(Finding(
                        RULE_ID, f.rel, node.lineno,
                        f"raw `{node.func.attr}()` on cluster-shared "
                        f"`{base}`'s private state in "
                        f"{cls.name}.{fn.name}()", hint))
    return findings


# ---------------------------------------------------------------------------
# Check 2: MOVE-shaped operations on maybe-shared tiers
# ---------------------------------------------------------------------------
def _ends_with(node: ast.AST, attr: str) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == attr


class _TierWalker:
    """Flow-sensitive `.shared` narrowing over one function body.

    Env maps a tier key -> True (proven shared) | False (proven
    worker-local) | None (unknown).  MOVE ops flag unless the key is
    proven False at the site."""

    def __init__(self, f: SourceFile, fn: ast.FunctionDef):
        self.f = f
        self.fn = fn
        self.loop_vars: Set[str] = set()     # for X in *.tiers
        self.sub_names: Set[str] = set()     # X = *.tiers[i]
        self.findings: List[Finding] = []

    # -- candidate tier expressions ------------------------------------
    def _tier_key(self, node: ast.AST) -> Tuple[Optional[str],
                                                Optional[bool]]:
        """(key, known) for a candidate tier expression, (None, None)
        otherwise.  `_shared*` attrs are known-shared a priori."""
        if isinstance(node, ast.Name) and \
                (node.id in self.loop_vars or node.id in self.sub_names
                 or node.id == "tier"):
            return node.id, None
        if isinstance(node, ast.Attribute):
            if SHARED_NAME_RE.match(node.attr):
                return dotted(node) or node.attr, True
            if node.attr == "tier" or node.attr.endswith("tier"):
                d = dotted(node)
                return (d, None) if d else (None, None)
        if isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "tiers":
                return (dotted(v) or "tiers") + "[i]", None
        return None, None

    def _collect_candidates(self) -> None:
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.For, ast.AsyncFor)) and \
                    isinstance(node.target, ast.Name) and \
                    _ends_with(node.iter, "tiers"):
                self.loop_vars.add(node.target.id)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Subscript) and \
                    _ends_with(node.value.value, "tiers"):
                self.sub_names.add(node.targets[0].id)

    # -- MOVE-shape detection ------------------------------------------
    def _flag(self, node: ast.AST, key: str, what: str,
              known: Optional[bool]) -> None:
        kind = ("a cluster-SHARED tier" if known
                else "a possibly-shared tier (no `.shared` guard)")
        self.findings.append(Finding(
            RULE_ID, self.f.rel, node.lineno,
            f"MOVE-shaped {what} on {kind} `{key}` — promotion out of a "
            f"shared pool must COPY; the pool copy stays visible to "
            f"every other worker",
            "guard with `if X.shared:` (COPY via dataclasses.replace) "
            "or prove the tier worker-local; annotate "
            "`# lint: own-ok(reason)` if intentional"))

    def _move_site(self, node: ast.AST
                   ) -> Optional[Tuple[ast.AST, str, str]]:
        """(tier_expr, op, site_node) when `node` is a MOVE shape."""
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if node.func.attr == "discard":
                if _ends_with(recv, "store"):
                    return recv.value, "discard()", "call"
                return recv, "discard()", "call"
            if node.func.attr == "pop" and _ends_with(recv, "_entries") \
                    and _ends_with(recv.value, "store"):
                return recv.value.value, "_entries.pop()", "call"
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if _ends_with(tgt, "store"):
                    return tgt.value, ".store reassignment", "assign"
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        _ends_with(tgt.value, "_entries") and \
                        _ends_with(tgt.value.value, "store"):
                    return tgt.value.value.value, "del _entries[...]", "del"
        return None

    # -- statement walk -------------------------------------------------
    @staticmethod
    def _terminates(stmts: List[ast.stmt]) -> bool:
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Continue, ast.Return, ast.Raise, ast.Break))

    def _guard_key(self, test: ast.AST) -> Tuple[Optional[str], bool]:
        """(key, polarity) for an `X.shared` / `not X.shared` test."""
        neg = False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, neg = test.operand, True
        if _ends_with(test, "shared"):
            key, _ = self._tier_key(test.value)
            if key is not None:
                return key, not neg
        return None, False

    def _check_node(self, node: ast.AST,
                    env: Dict[str, Optional[bool]]) -> None:
        for n in ast.walk(node):
            site = self._move_site(n)
            if site is None:
                continue
            expr, op, _ = site
            key, known = self._tier_key(expr)
            if key is None:
                continue
            proven = known if known is not None else env.get(key)
            if proven is not False:
                self._flag(n, key, op, proven)

    def _walk(self, stmts: List[ast.stmt],
              env: Dict[str, Optional[bool]]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.If):
                key, truthy = self._guard_key(st.test)
                benv, oenv = dict(env), dict(env)
                if key is not None:
                    benv[key] = truthy
                    oenv[key] = not truthy
                self._walk(st.body, benv)
                self._walk(st.orelse, oenv)
                if key is not None:
                    if self._terminates(st.body):
                        env[key] = not truthy
                    elif st.orelse and self._terminates(st.orelse):
                        env[key] = truthy
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                benv = dict(env)
                if isinstance(st, (ast.For, ast.AsyncFor)) and \
                        isinstance(st.target, ast.Name):
                    benv.pop(st.target.id, None)   # fresh binding per iter
                self._check_node(st.iter if isinstance(
                    st, (ast.For, ast.AsyncFor)) else st.test, env)
                self._walk(st.body, benv)
                self._walk(st.orelse, dict(env))
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                self._walk(st.body, env)
                continue
            if isinstance(st, ast.Try):
                self._walk(st.body, dict(env))
                for h in st.handlers:
                    self._walk(h.body, dict(env))
                self._walk(st.orelse, dict(env))
                self._walk(st.finalbody, dict(env))
                continue
            self._check_node(st, env)

    def run(self) -> List[Finding]:
        self._collect_candidates()
        self._walk(self.fn.body, {})
        return self.findings


# ---------------------------------------------------------------------------
# Check 3: unordered iteration feeding routing/eviction decisions
# ---------------------------------------------------------------------------
def _check_decision_order(f: SourceFile, fn: ast.FunctionDef
                          ) -> List[Finding]:
    if not DECISION_RE.search(fn.name):
        return []
    findings: List[Finding] = []
    set_names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, (ast.Set, ast.SetComp)) or (
                    isinstance(v, ast.Call) and dotted(v.func) == "set"):
                set_names.add(node.targets[0].id)

    def unordered(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "a set"
        if isinstance(expr, ast.Name) and expr.id in set_names:
            return f"set `{expr.id}`"
        if isinstance(expr, ast.Call):
            d = dotted(expr.func)
            if d == "set":
                return "a set"
            if d.endswith((".keys", ".values", ".items")):
                return f"raw dict view `{d.rsplit('.', 1)[-1]}()`"
        return None

    def flag(node: ast.AST, what: str) -> None:
        findings.append(Finding(
            RULE_ID, f.rel, node.lineno,
            f"iteration over {what} feeds the order-sensitive decision "
            f"`{fn.name}()` — set/dict order varies across workers and "
            f"replays",
            "iterate a list kept in a deterministic order, or wrap in "
            "`sorted(..., key=...)`; annotate `# lint: own-ok(reason)` "
            "if order provably cannot matter"))

    sorted_spans: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                dotted(node.func) in ("sorted", "list"):
            for sub in ast.walk(node):
                if sub is not node:
                    sorted_spans.add(id(sub))
    for node in ast.walk(fn):
        iters: List[ast.AST] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
        elif isinstance(node, ast.Call) and dotted(node.func) == "next" \
                and node.args and isinstance(node.args[0], ast.Call) \
                and dotted(node.args[0].func) == "iter" \
                and node.args[0].args:
            iters.append(node.args[0].args[0])
        for it in iters:
            if id(it) in sorted_spans:
                continue
            what = unordered(it)
            if what is not None:
                flag(node if hasattr(node, "lineno") else it, what)
    return findings


# ---------------------------------------------------------------------------
def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for f in project.matching(_in_scope):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                shared = _shared_attrs(node)
                if shared:
                    findings.extend(
                        _check_shared_mutation(f, node, shared))
        for fn in func_defs(f.tree):
            # construction sites (the owner allowlist) wire hierarchies
            # together — a .store swap THERE is ownership, not a MOVE
            if fn.name not in OWNER_METHODS:
                findings.extend(_TierWalker(f, fn).run())
            findings.extend(_check_decision_order(f, fn))
    # dedupe (nested walks can reach one site twice)
    seen, uniq = set(), []
    for fd in findings:
        key = (fd.path, fd.line, fd.message)
        if key not in seen:
            seen.add(key)
            uniq.append(fd)
    return uniq
