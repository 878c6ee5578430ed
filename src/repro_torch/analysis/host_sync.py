"""host-sync: device->host synchronisation in serving hot paths.

The continuous runtime's contract (DESIGN.md §9/§12) is ONE host sync
per decode iteration — the (B,) next-token pull.  Every other
``.item()``/``.cpu()``/``float()``/``int()`` of a CUDA tensor, every
``torch.cuda.synchronize``, and every copy that PyTorch itself runs as
a copy plus a stream synchronisation, reachable from the per-iteration
serving loops, stalls the enqueue pipeline (and breaks a CUDA-graph
capture) and must be either hoisted out or documented with
``# lint: sync-ok(reason)``.

Mechanics
---------
* **Hot roots**: defs named ``step``/``run``/``serve``/
  ``decode_iteration``/``prefill`` (or ``_run_*``) in modules under a
  ``serving`` directory, plus ``replay*`` defs under ``workloads/``
  (the trace-replay loops step the runtime per event and are just as
  hot).
* **Reachability**: a name-based call graph over the scanned sources
  (tests, benchmarks and examples are excluded — they are offline by
  definition).  Over-approximate on purpose: a bare-name match is an
  edge, and a def nested in a reachable def (a step closure handed out
  by a builder) is reachable too.
* **Device taint** (per hot function, flow-sensitive): the results of
  ``torch.*`` calls (a factory — ``torch.tensor``/``as_tensor``/
  ``zeros``/... — only with a ``device=``; ``torch.from_numpy`` never;
  the calls that make no tensor — ``torch.device``, ``torch.cuda``
  queries, ``no_grad``/``inference_mode``, ``synchronize`` — never), of
  the kernel wrappers ``*_op``, of producer defs (a def that returns a
  device value, found by a fixpoint), of locals and attributes assigned
  from those, parameters annotated ``torch.Tensor``, and anything
  derived from them (a tensor method's result too) are "devicey".
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``float``/``int``/
  ``np.asarray`` and the metadata (``.shape``, ``.dtype``, ``.device``,
  ``.size()``, ``.data_ptr()``, ...) are host values, so the single
  sanctioned pull does not taint everything downstream.  Loop bodies
  are walked twice so loop-carried taint is seen by the loop's own
  reads.

Sync sites
----------
* ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")`` and
  ``np.asarray``/``np.array`` of a devicey value;
* ``float()``/``int()``/``bool()`` of one, and an ``if``/``while``/
  ``assert``/conditional expression that tests one;
* ``torch.cuda.synchronize()``, ``Event``/``Stream.synchronize()`` and
  ``Event.elapsed_time``;
* data-dependent shapes: ``nonzero``, ``unique``, ``masked_select``,
  one-argument ``torch.where``, ``repeat_interleave`` without
  ``output_size=``, and indexing with a boolean mask;
* a host-to-device copy of a host value that does not say
  ``non_blocking=True``: ``torch.as_tensor(a, device=...)``,
  ``torch.tensor(..., device=...)``, ``.to(dev)``/``.cuda()`` and
  ``.copy_()``.  This form is PyTorch's own: from pageable memory its
  copy is a ``cudaMemcpy`` followed by a stream synchronisation.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.core import (
    Finding, Project, SourceFile, dotted, func_defs)

RULE_ID = "host-sync"
TOKEN = "sync-ok"

ROOT_NAMES = {"step", "run", "serve", "decode_iteration", "prefill"}
# device->host converters: flagged when fed a devicey value, and their
# result is a host value (kills taint on reassignment).
HOST_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
CASTS = {"float", "int", "bool"}
# tensor methods that pull the data to the host
PULL_METHODS = {"item", "tolist", "cpu", "numpy"}
# tensor metadata: host values that need no sync
HOST_ATTRS = {"shape", "dtype", "device", "ndim", "layout", "requires_grad",
              "itemsize", "nbytes", "device_mesh", "placements"}
HOST_METHODS = {"size", "dim", "numel", "nelement", "data_ptr", "stride",
                "element_size", "is_contiguous", "storage_offset",
                "get_device", "is_floating_point", "is_complex",
                "untyped_storage"}
# builtins whose result is a host value whatever they are given
HOST_BUILTINS = {"isinstance", "len", "hasattr", "callable", "type", "id",
                 "issubclass", "repr", "str"}
# torch.* calls that make no tensor
TORCH_HOST = {"torch.device", "torch.no_grad", "torch.inference_mode",
              "torch.enable_grad", "torch.set_grad_enabled", "torch.finfo",
              "torch.iinfo", "torch.is_tensor", "torch.is_floating_point",
              "torch.get_default_dtype", "torch.set_default_dtype",
              "torch.Size", "torch.Generator", "torch.from_numpy",
              "torch.manual_seed", "torch.use_deterministic_algorithms",
              "torch.set_num_threads", "torch.get_num_threads",
              "torch.numel", "torch.dtype"}
TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                       "torch.profiler.", "torch.autograd.",
                       "torch.utils.", "torch._C.", "torch.testing.")
# factories: on the device only when they name one
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
             "arange", "linspace", "eye", "rand", "randn", "randint",
             "randperm", "asarray"}
# host-to-device copies PyTorch may run as a copy plus a synchronisation
H2D_FACTORIES = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
# results whose shape depends on the data: the host waits for the count
DATA_SHAPED = {"nonzero", "unique", "unique_consecutive", "masked_select",
               "argwhere"}
# methods whose result is a boolean tensor
BOOL_METHODS = {"isnan", "isinf", "isfinite", "isin", "logical_and",
                "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt",
                "le", "gt", "ge", "bool"}
DTYPE_NAMES = {"float32", "float16", "bfloat16", "float64", "float", "half",
               "double", "int8", "int16", "int32", "int64", "uint8", "bool",
               "long", "int", "short", "complex64", "float8_e4m3fn",
               "float8_e5m2"}


def _is_scanned(f: SourceFile) -> bool:
    return not (f.in_dir("tests") or f.in_dir("benchmarks")
                or f.in_dir("examples"))


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_cpu(node) -> bool:
    """``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _is_dtype(node) -> bool:
    """``torch.int32``, ``x.dtype``, a name that says dtype."""
    d = dotted(node)
    if not d:
        return False
    tail = d.rsplit(".", 1)[-1]
    return (d.startswith("torch.") and tail in DTYPE_NAMES) \
        or "dtype" in tail.lower()


def _to_target(call: ast.Call):
    """What ``x.to(...)`` moves to: "cpu", "device", or None (a dtype)."""
    dev = _kw(call, "device")
    if dev is None and call.args and not _is_dtype(call.args[0]):
        dev = call.args[0]
    if dev is None:
        return None
    return "cpu" if _is_cpu(dev) else "device"


def _torch_call_is_device(call: ast.Call) -> bool:
    d = dotted(call.func)
    if not d.startswith("torch.") or d in TORCH_HOST \
            or d.startswith(TORCH_HOST_PREFIXES):
        return False
    tail = d.rsplit(".", 1)[-1]
    if d.count(".") == 1 and tail in FACTORIES:
        dev = _kw(call, "device")
        return dev is not None and not _is_cpu(dev)
    return True


def _tensor_annotated(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    return any(dotted(n) in ("torch.Tensor", "Tensor")
               for n in ast.walk(ann))


class _Index:
    """Project-wide def table + producer/device-callable sets."""

    def __init__(self, files: List[SourceFile]):
        self.defs: Dict[str, List[Tuple[SourceFile, ast.FunctionDef]]] = {}
        for f in files:
            for fn in func_defs(f.tree):
                self.defs.setdefault(fn.name, []).append((f, fn))
        # Producers: defs whose result (or the callables they hand out)
        # is on the device.  Seed: none; the walk of each def's body finds
        # the ones that return a torch result, then the ones returning
        # theirs, to a fixpoint.
        self.producers: Set[str] = set()
        # Attributes assigned from producer calls (self._dec = _steps(..))
        self.device_attrs: Set[str] = set()
        for _ in range(6):
            before = (len(self.producers), len(self.device_attrs))
            for f in files:
                for node in ast.walk(f.tree):
                    if isinstance(node, ast.Assign) and \
                            self._produces(node.value):
                        for tgt in node.targets:
                            for el in (tgt.elts if isinstance(
                                    tgt, (ast.Tuple, ast.List)) else [tgt]):
                                if isinstance(el, ast.Attribute):
                                    self.device_attrs.add(el.attr)
            for name, defs in self.defs.items():
                if name in self.producers:
                    continue
                for f, fn in defs:
                    walker = _TaintWalker(self, f, fn, flag=False)
                    walker.run()
                    if walker.returns_device:
                        self.producers.add(name)
                        break
            if (len(self.producers), len(self.device_attrs)) == before:
                break

    def _produces(self, expr: ast.AST) -> bool:
        """A call whose result is on the device or hands out a producer."""
        if not isinstance(expr, ast.Call):
            return False
        tail = dotted(expr.func).rsplit(".", 1)[-1]
        return _torch_call_is_device(expr) or tail.endswith("_op") \
            or tail in self.producers


def _reachable(index: _Index, files: List[SourceFile]
               ) -> List[Tuple[SourceFile, ast.FunctionDef]]:
    roots = [
        (f, fn) for f in files
        for fn in func_defs(f.tree)
        if (f.in_dir("serving")
            and (fn.name in ROOT_NAMES or fn.name.startswith("_run")))
        or (f.in_dir("workloads") and fn.name.startswith("replay"))]
    seen: Set[Tuple[str, int]] = set()
    work = list(roots)
    out: List[Tuple[SourceFile, ast.FunctionDef]] = []
    while work:
        f, fn = work.pop()
        key = (f.rel, fn.lineno)
        if key in seen:
            continue
        seen.add(key)
        out.append((f, fn))
        for n in ast.walk(fn):
            if n is not fn and isinstance(n, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                work.append((f, n))   # a closure the def hands out
            if not isinstance(n, ast.Call):
                continue
            # the called name, also at the end of a call chain
            # (``self.draft().propose_all(...)``)
            name = n.func.attr if isinstance(n.func, ast.Attribute) else \
                dotted(n.func)
            for callee in index.defs.get(name, ()):
                work.append(callee)
    return out


class _TaintWalker:
    """Flow-sensitive device-taint over one function body."""

    def __init__(self, index: _Index, f: SourceFile, fn: ast.FunctionDef,
                 flag: bool = True):
        self.index = index
        self.flag = flag          # False: only find what the def returns
        self.f = f
        self.fn = fn
        self.findings: Dict[Tuple[int, int], Finding] = {}
        self.returns_device = False
        self.hosts: Set[str] = set()    # locals built on the host
        self.bools: Set[str] = set()    # locals bound to boolean tensors
        self.closures = {n.name for n in fn.body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    # -- expression taint -------------------------------------------------
    def _call_is_device(self, call: ast.Call, env: Set[str]) -> bool:
        if self.index._produces(call):
            return True
        tail = dotted(call.func).rsplit(".", 1)[-1]
        if tail in self.index.device_attrs:
            return True
        if isinstance(call.func, ast.Name) and call.func.id in env:
            return True  # call to a device-callable local
        return False

    def _tainted(self, expr: ast.AST, env: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return isinstance(expr.ctx, ast.Load) and expr.id in env
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # the elements' taint, the targets devicey where their
            # iterable is
            inner = set(env)
            for gen in expr.generators:
                if self._tainted(gen.iter, inner):
                    inner |= {n.id for n in ast.walk(gen.target)
                              if isinstance(n, ast.Name)}
            elts = [expr.key, expr.value] if isinstance(
                expr, ast.DictComp) else [expr.elt]
            return any(self._tainted(e, inner) for e in elts)
        if isinstance(expr, ast.Attribute):
            if expr.attr in HOST_ATTRS or expr.attr.startswith("is_"):
                return False
            return expr.attr in self.index.device_attrs or \
                self._tainted(expr.value, env)
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in expr.ops):
            return False
        if isinstance(expr, (ast.Lambda, ast.JoinedStr)):
            return False
        if isinstance(expr, ast.Call):
            d = dotted(expr.func)
            tail = d.rsplit(".", 1)[-1]
            # host converters sync and return host values: taint stops here
            if d in HOST_CONVERTERS or (isinstance(expr.func, ast.Name)
                                        and expr.func.id in CASTS
                                        | HOST_BUILTINS):
                return False
            if isinstance(expr.func, ast.Attribute) and (
                    expr.func.attr in PULL_METHODS | HOST_METHODS
                    or (expr.func.attr == "to"
                        and _to_target(expr) == "cpu")):
                return False
            if self._call_is_device(expr, env):
                return True
            if d in H2D_FACTORIES and expr.args:
                return self._tainted(expr.args[0], env)  # stays where it is
            if d.startswith("torch."):
                return False   # a torch call that makes no device tensor
            # calls to known project defs that are NOT producers return
            # host values (their own internals are analysed separately) —
            # a tainted argument does not taint the result
            if tail in self.index.defs:
                return False
            return any(self._tainted(c, env)
                       for c in ast.iter_child_nodes(expr))
        return any(self._tainted(c, env)
                   for c in ast.iter_child_nodes(expr))

    # -- sync-site detection ----------------------------------------------
    def _flag(self, node: ast.AST, what: str, hint: str) -> None:
        key = (node.lineno, node.col_offset)
        # a method call is placed where Python places it in a traceback:
        # on the line of the method's name
        line = node.func.end_lineno if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) else node.lineno
        if key not in self.findings:
            self.findings[key] = Finding(
                RULE_ID, self.f.rel, line,
                f"{what} in a serving hot path "
                f"(reachable from a per-iteration loop via "
                f"{self.fn.name}())", hint)

    def _flag_test(self, test: ast.AST, env: Set[str]) -> None:
        if self.flag and self._tainted(test, env):
            self._flag(test, "truth value of a device tensor (host sync)",
                       "branch on host state, or compute both sides with "
                       "torch.where; annotate `# lint: sync-ok(reason)`")

    def _check_h2d(self, n: ast.Call, d: str, env: Set[str]) -> None:
        """A host value copied to the device without non_blocking=True."""
        if _is_true(_kw(n, "non_blocking")):
            return
        src = None
        if d in H2D_FACTORIES:
            dev = _kw(n, "device")
            if dev is not None and not _is_cpu(dev) and n.args:
                src = n.args[0]
            what = f"{d}(..., device=...)"
        elif isinstance(n.func, ast.Attribute) and (
                n.func.attr == "cuda"
                or (n.func.attr == "to" and _to_target(n) == "device")):
            src = n.func.value
            if not self._host_evident(src):
                return   # a tensor of unknown residence: no evidence
            what = f".{n.func.attr}(device)"
        else:
            return
        if src is not None and not self._tainted(src, env):
            self._flag(n, f"host-to-device copy `{what}` of a host value "
                          f"without non_blocking=True (host sync: "
                          f"PyTorch's own form — from pageable memory the "
                          f"copy waits for the stream)",
                       "build the value on the device, or stage it in "
                       "pinned memory and copy with non_blocking=True; "
                       "annotate `# lint: sync-ok(reason)`")

    def _host_evident(self, expr: ast.AST) -> bool:
        """Built on the host for all the walk can see: a local assigned
        from a host call, a numpy/torch/function call, or a method or an
        index of one (taint is checked apart)."""
        if isinstance(expr, ast.Name):
            return expr.id in self.hosts
        if isinstance(expr, ast.Subscript):
            return self._host_evident(expr.value)
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Attribute):
                d = dotted(expr.func)
                return d.startswith(("np.", "numpy.", "torch.")) or \
                    self._host_evident(expr.func.value)
            return isinstance(expr.func, ast.Name)
        return False

    def _check_calls(self, expr: ast.AST, env: Set[str]) -> None:
        for n in ast.walk(expr):
            if isinstance(n, ast.IfExp):
                self._flag_test(n.test, env)
            elif isinstance(n, ast.Subscript):
                self._check_mask_index(n, env)
            if not isinstance(n, ast.Call):
                continue
            d = dotted(n.func)
            attr = n.func.attr if isinstance(n.func, ast.Attribute) else ""
            recv = n.func.value if attr else None
            tail = attr or d       # also at the end of a call chain
            if d == "torch.cuda.synchronize" or attr == "synchronize":
                self._flag(n, f"{d or '.synchronize'}() (host sync)",
                           "only wall-clock measurement should block; "
                           "annotate `# lint: sync-ok(reason)` if so")
            elif attr == "elapsed_time":
                self._flag(n, "Event.elapsed_time (host sync)",
                           "read event times after the loop; annotate "
                           "`# lint: sync-ok(reason)`")
            elif d in HOST_CONVERTERS and n.args and \
                    self._tainted(n.args[0], env):
                self._flag(n, f"{d} on a device value (host sync)",
                           "pull once per iteration at most; annotate "
                           "`# lint: sync-ok(reason)` for the sanctioned "
                           "pull")
            elif isinstance(n.func, ast.Name) and n.func.id in CASTS and \
                    n.args and self._tainted(n.args[0], env):
                self._flag(n, f"{n.func.id}() on a device value (host sync)",
                           "scalarizing a device array blocks dispatch; "
                           "batch the readback or annotate "
                           "`# lint: sync-ok(reason)`")
            elif attr in PULL_METHODS and self._tainted(recv, env):
                self._flag(n, f".{attr}() on a device value (host sync)",
                           "use one batched readback per iteration; "
                           "annotate `# lint: sync-ok(reason)` for the "
                           "sanctioned pull")
            elif attr == "to" and _to_target(n) == "cpu" and \
                    self._tainted(recv, env):
                self._flag(n, ".to(cpu) on a device value (host sync)",
                           "use one batched readback per iteration; "
                           "annotate `# lint: sync-ok(reason)`")
            elif (tail in DATA_SHAPED and (
                    d.startswith("torch.") or self._tainted(recv, env))) \
                    or (d == "torch.where" and len(n.args) == 1
                        and not n.keywords) \
                    or (tail == "repeat_interleave"
                        and _kw(n, "output_size") is None
                        and (d.startswith("torch.")
                             or self._tainted(recv, env))):
                self._flag(n, f"`{tail}` has a data-dependent shape (host "
                              f"sync: the host waits for the count)",
                           "keep shapes static (a mask with torch.where, "
                           "`output_size=`); annotate "
                           "`# lint: sync-ok(reason)`")
            else:
                self._check_h2d(n, d, env)

    def _boolish(self, e: ast.AST) -> bool:
        """A boolean tensor for all the walk can see: a comparison, its
        negation or conjunction, a bool-valued method, a local bound to
        one, or a local named as a mask."""
        if isinstance(e, ast.Name):
            return e.id in self.bools or "mask" in e.id.lower()
        if isinstance(e, (ast.Compare, ast.BoolOp)):
            return True
        if isinstance(e, ast.UnaryOp):
            return isinstance(e.op, (ast.Not, ast.Invert))
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._boolish(e.left) or self._boolish(e.right)
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
            return e.func.attr in BOOL_METHODS
        return False

    def _check_mask_index(self, n: ast.Subscript, env: Set[str]) -> None:
        """``x[mask]`` with a boolean device mask: a data-dependent shape."""
        idx = n.slice
        if not self.flag:
            return
        if self._boolish(idx) and self._tainted(idx, env) and \
                self._tainted(n.value, env):
            self._flag(n, "indexing with a boolean device mask (host sync: "
                          "the result's length depends on the data)",
                       "use torch.where, or index with positions known on "
                       "the host; annotate `# lint: sync-ok(reason)`")

    # -- statement walk ----------------------------------------------------
    def _assign(self, targets: List[ast.AST], value: ast.AST,
                env: Set[str]) -> None:
        devicey = self._tainted(value, env)
        host = not devicey and self._host_evident(value)
        for tgt in targets:
            els = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
            for el in els:
                if isinstance(el, ast.Starred):
                    el = el.value
                if isinstance(el, ast.Name):
                    (env.add if devicey else env.discard)(el.id)
                    (self.hosts.add if host else self.hosts.discard)(el.id)
                    (self.bools.add if self._boolish(value)
                     else self.bools.discard)(el.id)

    def _walk(self, stmts: List[ast.stmt], env: Set[str]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs analysed via their own reachability
            for expr in ast.iter_child_nodes(st):
                if self.flag and isinstance(expr, ast.expr):
                    self._check_calls(expr, env)
            if isinstance(st, ast.Assign):
                for tgt in st.targets:
                    if isinstance(tgt, ast.Subscript):
                        self._check_mask_index(tgt, env)
                self._assign(st.targets, st.value, env)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._assign([st.target], st.value, env)
            elif isinstance(st, ast.AugAssign):
                if self._tainted(st.value, env) and \
                        isinstance(st.target, ast.Name):
                    env.add(st.target.id)
            elif isinstance(st, ast.Return) and st.value is not None:
                # a device value, or a nested producer def handed out
                if self._tainted(st.value, env) or any(
                        isinstance(n, ast.Name) and n.id in self.closures
                        and n.id in self.index.producers
                        for n in ast.walk(st.value)):
                    self.returns_device = True
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                if self._tainted(st.iter, env) and \
                        isinstance(st.target, ast.Name):
                    env.add(st.target.id)
                for _ in range(2):  # expose loop-carried taint
                    self._walk(st.body, env)
                self._walk(st.orelse, env)
            elif isinstance(st, ast.While):
                for _ in range(2):
                    self._flag_test(st.test, env)
                    self._walk(st.body, env)
                self._walk(st.orelse, env)
            elif isinstance(st, ast.If):
                self._flag_test(st.test, env)
                b, o = set(env), set(env)
                self._walk(st.body, b)
                self._walk(st.orelse, o)
                env |= b | o
            elif isinstance(st, ast.Assert):
                self._flag_test(st.test, env)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                self._walk(st.body, env)
            elif isinstance(st, ast.Try):
                self._walk(st.body, env)
                for h in st.handlers:
                    self._walk(h.body, env)
                self._walk(st.orelse, env)
                self._walk(st.finalbody, env)

    def run(self) -> List[Finding]:
        args = self.fn.args
        env = {a.arg for a in (args.posonlyargs + args.args
                               + args.kwonlyargs)
               if _tensor_annotated(a)}
        self._walk(self.fn.body, env)
        return list(self.findings.values())


def check(project: Project) -> List[Finding]:
    files = project.matching(_is_scanned)
    index = _Index(files)
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, int]] = set()
    for f, fn in _reachable(index, files):
        for fd in _TaintWalker(index, f, fn).run():
            key = (fd.path, fd.line, fd.message)
            if key not in seen:
                seen.add(key)
                findings.append(fd)
    return findings
