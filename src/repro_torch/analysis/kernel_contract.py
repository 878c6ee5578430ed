"""kernel-contract: kernels, oracles, and parity tests in lockstep.

Every public kernel export (`X_op` in ``kernels/__init__.py.__all__``)
must ship with:

* a plain oracle ``X_ref`` in ``kernels/ref.py`` (the ground truth),
* an ``interpret`` fallback parameter on the ``X_op`` wrapper (so a CPU
  tensor takes the plain version and CPU tests run it),
* a parity test referencing BOTH names in one test file under
  ``tests/``.

And the inverse drift guard: an ``X_ref`` oracle in ``ref.py`` with no
matching export must at least be a building block referenced by another
oracle — a fully orphaned oracle means the kernel and its ground truth
have drifted apart.

The CUDA half, for a kernels package that builds its kernels
(``kernels/build.py`` with a ``SIGNATURES`` table of the libraries):

* each ``X_op`` wrapper launches a library that ``SIGNATURES`` lists
  (its first string argument names it, as in ``_launch("hadamard",
  ...)``), built from ``kernels/csrc/<library>.cu``, which exists;
* a ``gpu``-marked test file (``pytest.mark.gpu``) names both ``X_op``
  and ``X_ref``: the kernel itself is held against its oracle on the
  card, where no interpreter stands in for it;
* no ``csrc/*.cu`` is left unbuilt by ``SIGNATURES``;
* no module outside ``kernels/`` passes ``interpret=True``: on a CUDA
  tensor that swaps the kernel for its plain version, which would hide
  the kernel on the card.

Suppression token: ``kernel-ok``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import Finding, Project, SourceFile, func_defs

RULE_ID = "kernel-contract"
TOKEN = "kernel-ok"


def _find_tests_dir(kernels_dir: Path) -> Optional[Path]:
    for parent in kernels_dir.parents:
        cand = parent / "tests"
        if cand.is_dir():
            return cand
    return None


def _exports(init: SourceFile) -> Dict[str, int]:
    """{export_name: lineno} from __all__ (falls back to import names)."""
    out: Dict[str, int] = {}
    for node in ast.walk(init.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__" and \
                        isinstance(node.value, (ast.List, ast.Tuple)):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) and \
                                isinstance(el.value, str):
                            out[el.value] = node.lineno
    if not out:
        for node in ast.walk(init.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    out[alias.asname or alias.name] = node.lineno
    return out


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    # A "kernels package" is any scanned dir named `kernels` with both
    # an __init__.py and a ref.py.
    by_dir: Dict[Path, Dict[str, SourceFile]] = {}
    for f in project.files:
        if f.path.parent.name == "kernels":
            by_dir.setdefault(f.path.parent, {})[f.path.name] = f

    for kdir, members in sorted(by_dir.items()):
        init, ref = members.get("__init__.py"), members.get("ref.py")
        if init is None or ref is None:
            continue
        ref_defs: Dict[str, ast.FunctionDef] = {
            fn.name: fn for fn in func_defs(ref.tree)}
        # names referenced inside ref.py outside their own def
        ref_uses: Set[str] = set()
        for fn in ref_defs.values():
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    tgt = n.func
                    name = tgt.attr if isinstance(tgt, ast.Attribute) else (
                        tgt.id if isinstance(tgt, ast.Name) else "")
                    if name != fn.name:
                        ref_uses.add(name)

        # wrapper defs across the package (ops.py et al.)
        wrappers: Dict[str, tuple[SourceFile, ast.FunctionDef]] = {}
        for m in members.values():
            for fn in func_defs(m.tree):
                wrappers.setdefault(fn.name, (m, fn))

        tests_dir = _find_tests_dir(kdir)
        test_texts = {}
        if tests_dir is not None:
            for t in sorted(tests_dir.glob("*.py")):
                try:
                    test_texts[t.name] = t.read_text()
                except OSError:
                    pass

        exports = _exports(init)
        op_bases = {name[:-3] for name in exports if name.endswith("_op")}
        for name, lineno in sorted(exports.items()):
            if not name.endswith("_op"):
                continue
            base = name[:-3]
            # 1) oracle
            if f"{base}_ref" not in ref_defs:
                findings.append(Finding(
                    RULE_ID, init.rel, lineno,
                    f"public kernel `{name}` has no `{base}_ref` oracle "
                    f"in {ref.rel}",
                    f"add a pure-jnp `{base}_ref` (compose existing "
                    f"building-block oracles if the kernel is fused)"))
            # 2) interpret fallback on the wrapper
            w = wrappers.get(name)
            if w is None:
                findings.append(Finding(
                    RULE_ID, init.rel, lineno,
                    f"exported kernel `{name}` has no wrapper def in the "
                    f"kernels package"))
            else:
                wf, wfn = w
                argnames = {a.arg for a in (
                    wfn.args.args + wfn.args.kwonlyargs)}
                if "interpret" not in argnames:
                    findings.append(Finding(
                        RULE_ID, wf.rel, wfn.lineno,
                        f"kernel wrapper `{name}` has no `interpret` "
                        f"fallback parameter",
                        "add `interpret: Optional[bool] = None` routed "
                        "through `_default_interpret()` so CPU tests run "
                        "the Pallas interpreter"))
            # 3) parity test referencing both names
            if tests_dir is not None and not any(
                    name in txt and f"{base}_ref" in txt
                    for txt in test_texts.values()):
                findings.append(Finding(
                    RULE_ID, init.rel, lineno,
                    f"no parity test under {tests_dir.name}/ references "
                    f"both `{name}` and `{base}_ref`",
                    f"add a test asserting {name}(...) matches "
                    f"{base}_ref(...)"))

        build = members.get("build.py")
        if build is not None:
            findings.extend(_cuda_half(kdir, build, exports, wrappers,
                                       test_texts))

        # 4) orphaned oracles
        for rname, fn in sorted(ref_defs.items()):
            if not rname.endswith("_ref"):
                continue
            base = rname[:-4]
            if base in op_bases or rname in ref_uses:
                continue
            findings.append(Finding(
                RULE_ID, ref.rel, fn.lineno,
                f"oracle `{rname}` corresponds to no public kernel export "
                f"and no other oracle uses it",
                "export a matching `{}_op`, fold it into the oracle that "
                "needs it, or delete it".format(base)))
    findings.extend(_interpret_true(project))
    return findings


def _signatures(build: SourceFile) -> tuple[Dict[str, int], int]:
    """({library: lineno} of ``SIGNATURES``'s keys, the table's line)."""
    for node in ast.walk(build.tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
               for t in targets) and isinstance(value, ast.Dict):
            return ({k.value: k.lineno for k in value.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}, node.lineno)
    return {}, 1


def _cuda_half(kdir: Path, build: SourceFile, exports: Dict[str, int],
               wrappers, test_texts: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    libs, table_line = _signatures(build)
    csrc = kdir / "csrc"
    sources = {p.stem for p in csrc.glob("*.cu")} if csrc.is_dir() else set()
    gpu_tests = [txt for txt in test_texts.values()
                 if "pytest.mark.gpu" in txt]
    for name, lineno in sorted(exports.items()):
        if not name.endswith("_op") or name not in wrappers:
            continue
        base = name[:-3]
        wf, wfn = wrappers[name]
        launched = sorted({
            n.args[0].value for n in ast.walk(wfn)
            if isinstance(n, ast.Call) and n.args
            and isinstance(n.args[0], ast.Constant)
            and n.args[0].value in libs})
        if not launched:
            findings.append(Finding(
                RULE_ID, wf.rel, wfn.lineno,
                f"kernel wrapper `{name}` launches no library listed in "
                f"{build.rel}::SIGNATURES",
                "launch the CUDA kernel through its library "
                "(`_launch(\"<library>\", ...)`) and list the library's "
                "entry points in SIGNATURES"))
        for lib in launched:
            if lib not in sources:
                findings.append(Finding(
                    RULE_ID, build.rel, libs[lib],
                    f"library `{lib}` (launched by `{name}`) has no source "
                    f"csrc/{lib}.cu",
                    f"add csrc/{lib}.cu, or drop `{lib}` from SIGNATURES"))
        if not any(name in txt and f"{base}_ref" in txt
                   for txt in gpu_tests):
            findings.append(Finding(
                RULE_ID, wf.rel, wfn.lineno,
                f"no `gpu`-marked test references both `{name}` and "
                f"`{base}_ref`",
                f"add a `pytest.mark.gpu` test asserting {name}(...) on "
                f"CUDA tensors matches {base}_ref(...)"))
    for lib in sorted(sources - set(libs)):
        findings.append(Finding(
            RULE_ID, build.rel, table_line,
            f"csrc/{lib}.cu is built by no entry of SIGNATURES",
            f"list `{lib}`'s entry points in SIGNATURES, or delete the "
            f"source"))
    return findings


def _interpret_true(project: Project) -> List[Finding]:
    """``interpret=True`` passed outside a kernels package."""
    findings: List[Finding] = []
    for f in project.files:
        if f.in_dir("kernels") or f.in_dir("tests") or \
                f.in_dir("benchmarks") or f.in_dir("examples"):
            continue
        for n in ast.walk(f.tree):
            if isinstance(n, ast.Call) and any(
                    kw.arg == "interpret" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in n.keywords):
                findings.append(Finding(
                    RULE_ID, f.rel, n.lineno,
                    "`interpret=True` outside kernels/: on a CUDA tensor the "
                    "wrapper runs its plain version and the kernel never "
                    "launches",
                    "let `interpret=None` resolve from the tensor's device; "
                    "call the `_ref` oracle by name where the plain version "
                    "is meant"))
    return findings
