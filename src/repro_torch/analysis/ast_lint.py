"""Pass 2 — AST convention lint over the port's own files.

The port's counterpart of ``repro/analysis/ast_lint.py``.  It scans
``src/repro_torch/``, ``tests/test_torch_*.py`` and ``chip_smoke.py``.
Every rule is a heuristic static check, and every finding can be waived in
``analysis_baseline_torch.json`` with a justification (``report.py``).

Rules
-----
``GEN-REUSE`` (was KEY-REUSE)
    Torch cannot split a key; the port's streams are seeded
    ``torch.Generator``s and the counter-based ``core.analog.
    counter_normals``.  The rule fires when, in one function, one seed
    expression seeds two ``torch.Generator(...).manual_seed(...)`` streams,
    or one (key, ``v_idx``, ``dim``) triple reaches ``counter_normals``
    twice — two draws that were meant to be independent are then the same
    numbers.  A seeding or a draw inside a loop whose arguments do not
    change in the loop repeats every iteration and counts as reuse.
    Mutually exclusive ``if`` / ``else`` branches do not conflict.

``DEVICE-THREAD`` (was INTERPRET-THREAD)
    The port has no interpret switch: the tensor's device picks the kernel
    (a CUDA tensor launches it, a CPU tensor runs the plain version).  The
    rule fires when a public function that takes ``device=`` calls a
    callee that takes ``device=None`` without passing it on (the callee
    then falls back to the card); when a ``torch.cuda.is_available()`` test
    outside ``device.py`` chooses between a kernel and its plain version;
    and when a ``try`` around a kernel call runs the plain version in its
    handler (a silent fallback).

``DEVICE-MOVE`` (was PYTREE-REG)
    A dataclass with ``torch.Tensor`` fields must move between devices as
    a whole (``api/compiled.py::_to_device`` moves every tensor field).  The
    rule fires on a construction of such a class, or a
    ``dataclasses.replace`` of it, that moves some tensor fields with
    ``.to(...)`` and leaves others out: those stay on the old device.

``BANNED-IN-HOT``
    Inside a hot function — a registered entry point
    (``analysis.entrypoints.HOT_SYMBOLS``) or anything it reaches through
    calls this pass can resolve (same module, ``self.``, imported port
    modules and names): ``np.random.*`` (hidden host RNG state), the host
    clock, ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` and
    ``float()`` / ``int()`` / ``bool()`` of a tensor — each waits for the
    card.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Optional

from repro_torch.analysis.report import Finding

BANNED_TIME = {"time", "perf_counter", "perf_counter_ns", "monotonic",
               "sleep", "process_time"}
#: Tensor methods that copy to the host (and so wait for the card).
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: torch callables that return no tensor.
TORCH_NON_TENSOR = {"device", "Size", "finfo", "iinfo", "is_tensor",
                    "Generator", "no_grad", "inference_mode", "dtype",
                    "get_default_dtype", "is_grad_enabled", "Stream",
                    "Event", "numel", "result_type", "promote_types",
                    "manual_seed", "set_grad_enabled"}
#: Tensor methods and attributes that return no tensor.
TENSOR_NON_TENSOR = {"item", "tolist", "numpy", "dim", "size", "numel",
                     "data_ptr", "element_size", "is_contiguous", "stride",
                     "nelement", "ndimension", "get_device", "shape", "ndim",
                     "dtype", "device", "is_cuda", "is_floating_point",
                     "storage_offset", "untyped_storage"}
#: The ops entry points and the kernel wrappers' suffixes (DEVICE-THREAD).
OPS_ENTRY_NAMES = ("rbf_matrix", "solve_lanes", "solve_lanes_gram",
                   "flash_attention", "ssd_scan")


def _qualname(node: ast.expr) -> str:
    """Dotted name of an expression, '' when not a plain attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _params(func) -> list[ast.arg]:
    a = func.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _own_nodes(func):
    """Walk ``func`` without descending into nested def / class scopes
    (lambdas stay included)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _functions(tree: ast.Module):
    """``(qualname, def, enclosing class or None)`` of every function,
    methods as ``Class.method``, nested defs as ``outer.inner``."""
    out = []

    def visit(node, prefix, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child, cls))
                visit(child, f"{q}.", None)
    visit(tree, "", None)
    return out


# ---------------------------------------------------------------------------
# Branches and loops (GEN-REUSE)
# ---------------------------------------------------------------------------


def _exclusive(sig_a: tuple, sig_b: tuple) -> bool:
    """Two events on opposite sides of one shared ``if``."""
    for (na, sa), (nb, sb) in zip(sig_a, sig_b):
        if na != nb:
            return False
        if sa != sb:
            return True
    return False


@dataclasses.dataclass
class _Event:
    key: str           # ast.dump of the seed / (key, v_idx, dim)
    what: str
    line: int
    branch: tuple
    loops: tuple       # ((loop_id, names assigned in the loop), ...)
    names: frozenset   # names the arguments read


class _StreamScanner:
    """One function's generator seedings and counter draws, in order."""

    def __init__(self, func, path: str, symbol: str,
                 findings: list[Finding]):
        self.func, self.path, self.symbol = func, path, symbol
        self.findings = findings
        self.events: list[_Event] = []
        self.branch: list[tuple] = []
        self.loops: list[tuple] = []

    def run(self) -> None:
        for stmt in self.func.body:
            self._visit(stmt)
        self._check()

    def _visit(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, ast.If):
            self._scan(node.test)
            self.branch.append((id(node), 0))
            for s in node.body:
                self._visit(s)
            self.branch[-1] = (id(node), 1)
            for s in node.orelse:
                self._visit(s)
            self.branch.pop()
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            head = node.iter if not isinstance(node, ast.While) else node.test
            self._scan(head)
            assigned = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                    assigned.add(sub.id)
            self.loops.append((id(node), frozenset(assigned)))
            for s in node.body:
                self._visit(s)
            self.loops.pop()
            for s in node.orelse:
                self._visit(s)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._scan(item.context_expr)
            for s in node.body:
                self._visit(s)
            return
        if isinstance(node, ast.Try):
            for s in node.body:
                self._visit(s)
            for h in node.handlers:
                for s in h.body:
                    self._visit(s)
            for s in node.orelse + node.finalbody:
                self._visit(s)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._scan(child)

    def _scan(self, expr: ast.expr) -> None:
        for call in [n for n in ast.walk(expr) if isinstance(n, ast.Call)]:
            leaf = call.func.attr if isinstance(call.func, ast.Attribute) \
                else _qualname(call.func)
            if leaf == "manual_seed" and call.args and \
                    isinstance(call.func.value, ast.Call) and \
                    _qualname(call.func.value.func).endswith("Generator"):
                self._record(call.args[0], [call.args[0]],
                             "torch.Generator seed", call.lineno)
            elif leaf == "counter_normals" and len(call.args) >= 3:
                self._record(ast.Tuple(elts=list(call.args[:3]),
                                       ctx=ast.Load()),
                             call.args[:3], "counter_normals (key, v_idx, "
                             "dim)", call.lineno)

    def _record(self, key_expr, args, what: str, line: int) -> None:
        names = frozenset(n.id for a in args for n in ast.walk(a)
                          if isinstance(n, ast.Name))
        self.events.append(_Event(ast.dump(key_expr), what, line,
                                  tuple(self.branch), tuple(self.loops),
                                  names))

    def _fire(self, ev: _Event, why: str) -> None:
        self.findings.append(Finding(
            rule="GEN-REUSE", path=self.path, symbol=self.symbol,
            line=ev.line,
            message=(f"{ev.what} at line {ev.line} {why} — the two draws are "
                     f"the same numbers")))

    def _check(self) -> None:
        seen: list[_Event] = []
        for ev in self.events:
            loop_reuse = any(not (ev.names & assigned)
                             for _, assigned in ev.loops)
            prior = [p for p in seen if p.key == ev.key
                     and not _exclusive(p.branch, ev.branch)]
            if loop_reuse:
                self._fire(ev, "repeats inside a loop with arguments the "
                               "loop does not change")
            elif prior:
                self._fire(ev, f"reuses the arguments of line "
                               f"{prior[-1].line}")
            seen.append(ev)


# ---------------------------------------------------------------------------
# Module index: imports, functions, call resolution
# ---------------------------------------------------------------------------


def _module_name(rel: str) -> Optional[str]:
    parts = rel.replace(os.sep, "/").split("/")
    if parts[0] == "src":
        parts = parts[1:]
    if not parts or not parts[-1].endswith(".py"):
        return None
    parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Index:
    """Every scanned file's functions and the names its imports bind."""

    def __init__(self, trees: dict[str, ast.Module]):
        self.trees = trees
        self.by_module = {}
        for rel in trees:
            mod = _module_name(rel)
            if mod:
                self.by_module[mod] = rel
        self.funcs: dict[tuple, tuple] = {}      # (rel, qual) -> (def, cls)
        self.by_file: dict[str, list] = {}       # rel -> [(qual, def, cls)]
        self.own: dict[tuple, list] = {}         # (rel, qual) -> own nodes
        for rel, tree in trees.items():
            self.by_file[rel] = _functions(tree)
            for q, f, cls in self.by_file[rel]:
                self.funcs[(rel, q)] = (f, cls)
                self.own[(rel, q)] = list(_own_nodes(f))
        self.modules: dict[str, dict] = {}   # rel -> alias -> module rel
        self.names: dict[str, dict] = {}     # rel -> name -> (rel, name)
        for rel, tree in trees.items():
            mods, names = {}, {}
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        sub = f"{node.module}.{a.name}"
                        if sub in self.by_module:
                            mods[a.asname or a.name] = self.by_module[sub]
                        elif node.module in self.by_module:
                            names[a.asname or a.name] = (
                                self.by_module[node.module], a.name)
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        if a.name in self.by_module and a.asname:
                            mods[a.asname] = self.by_module[a.name]
            self.modules[rel], self.names[rel] = mods, names

    def resolve(self, rel: str, call: ast.Call, cls: Optional[ast.ClassDef]
                ) -> Optional[tuple]:
        """``(rel, qualname)`` of the function ``call`` reaches, where this
        index can tell: a module function by bare or imported name, a
        ``self.`` / ``cls.`` method, a port module's function, a class's
        ``__init__``."""
        qn = _qualname(call.func)
        if not qn:
            return None
        head, _, rest = qn.partition(".")
        if not rest:
            return self._named(rel, head)
        if head in ("self", "cls") and cls is not None and "." not in rest:
            site = (rel, f"{cls.name}.{rest}")
            return site if site in self.funcs else None
        mod_rel = self.modules.get(rel, {}).get(head)
        if mod_rel is not None and "." not in rest:
            return self._named(mod_rel, rest)
        return None

    def _named(self, rel: str, name: str) -> Optional[tuple]:
        if (rel, name) in self.funcs:
            return (rel, name)
        if (rel, f"{name}.__init__") in self.funcs:
            return (rel, f"{name}.__init__")
        target = self.names.get(rel, {}).get(name)
        if target is not None and target[0] != rel:
            return self._named(*target)
        return None


# ---------------------------------------------------------------------------
# DEVICE-THREAD
# ---------------------------------------------------------------------------


def _device_param(func) -> Optional[int]:
    """Position of a ``device`` parameter defaulting to None (``self``
    dropped for methods), else None."""
    a = func.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for i, (arg, dflt) in enumerate(zip(pos, defaults)):
        if arg.arg == "device" and isinstance(dflt, ast.Constant) \
                and dflt.value is None:
            return i
    for arg, dflt in zip(a.kwonlyargs, a.kw_defaults):
        if arg.arg == "device" and isinstance(dflt, ast.Constant) \
                and dflt.value is None:
            return -1
    return None


def _passes_device(call: ast.Call, pos: int, method: bool) -> bool:
    if any(kw.arg in ("device", None) for kw in call.keywords):
        return True
    if any(isinstance(a, ast.Starred) for a in call.args):
        return True
    at = pos - 1 if method else pos
    return pos >= 0 and len(call.args) > at


def _is_kernel_call(call: ast.Call) -> bool:
    qn = _qualname(call.func)
    leaf = qn.rsplit(".", 1)[-1]
    return leaf.endswith(("_cuda", "_plain")) or qn.startswith("ref.") \
        or (qn.startswith(("ops.", "kops.")) and leaf in OPS_ENTRY_NAMES)


def _check_device_thread(index: _Index, rel: str,
                         findings: list[Finding]) -> None:
    for q, func, cls in index.by_file[rel]:
        own = index.own[(rel, q)]
        names = {p.arg for p in _params(func)}
        public = not any(part.startswith("_") and part != "__init__"
                         for part in q.split("."))
        if public and "device" in names:
            for call in [n for n in own if isinstance(n, ast.Call)]:
                target = index.resolve(rel, call, cls)
                if target is None:
                    continue
                callee, callee_cls = index.funcs[target]
                pos = _device_param(callee)
                if pos is None:
                    continue
                method = callee_cls is not None
                if not _passes_device(call, pos, method):
                    findings.append(Finding(
                        rule="DEVICE-THREAD", path=rel, symbol=q,
                        line=call.lineno,
                        message=(f"{q}() takes device= but calls "
                                 f"{target[1]}() without it — the callee "
                                 f"falls back to the card")))
        for node in own:
            if isinstance(node, (ast.If, ast.IfExp)) and \
                    not rel.endswith("repro_torch/device.py") and \
                    any(_qualname(c.func) == "torch.cuda.is_available"
                        for c in ast.walk(node.test)
                        if isinstance(c, ast.Call)):
                branches = node.body if isinstance(node.body, list) \
                    else [node.body]
                branches = branches + (node.orelse if isinstance(
                    node.orelse, list) else [node.orelse])
                if any(_is_kernel_call(c) for b in branches
                       for c in ast.walk(b) if isinstance(c, ast.Call)):
                    findings.append(Finding(
                        rule="DEVICE-THREAD", path=rel, symbol=q,
                        line=node.lineno,
                        message=("torch.cuda.is_available() chooses between "
                                 "a kernel and its plain version — the "
                                 "tensor's device must choose")))
            if isinstance(node, ast.Try) and any(
                    _is_kernel_call(c) for s in node.body
                    for c in ast.walk(s) if isinstance(c, ast.Call)) and any(
                    _is_kernel_call(c) for h in node.handlers
                    for s in h.body for c in ast.walk(s)
                    if isinstance(c, ast.Call)):
                findings.append(Finding(
                    rule="DEVICE-THREAD", path=rel, symbol=q,
                    line=node.lineno,
                    message=("a kernel call's failure runs a kernel or plain "
                             "version in the handler — a silent fallback")))


# ---------------------------------------------------------------------------
# DEVICE-MOVE
# ---------------------------------------------------------------------------


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _qualname(target).rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


def _tensor_fields(cls: ast.ClassDef) -> list[str]:
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                "torch.Tensor" in ast.unparse(stmt.annotation):
            out.append(stmt.target.id)
    return out


def _is_move(call: ast.Call) -> bool:
    """``.cuda()`` / ``.cpu()``, or a ``.to(...)`` that names a device (a
    ``.to`` whose only argument is a dtype is a cast)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr in ("cuda", "cpu"):
        return True
    if call.func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    return any(not _qualname(a).startswith("torch.")
               and not _qualname(a).endswith("dtype") for a in call.args)


def _moves(expr: ast.expr) -> bool:
    return any(isinstance(c, ast.Call) and _is_move(c)
               for c in ast.walk(expr))


def _check_device_move(index: _Index, findings: list[Finding]) -> None:
    classes = {}
    for tree in index.trees.values():
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            fields = _tensor_fields(cls) if _is_dataclass(cls) else []
            if fields:
                classes[cls.name] = fields
    if not classes:
        return
    for rel, funcs in index.by_file.items():
        for q, func, cls in funcs:
            for call in [n for n in index.own[(rel, q)]
                         if isinstance(n, ast.Call)]:
                qn = _qualname(call.func)
                leaf = qn.rsplit(".", 1)[-1]
                name = None
                if leaf in classes:
                    name = leaf
                elif leaf == "replace" and call.args and cls is not None \
                        and _qualname(call.args[0]) == "self" \
                        and cls.name in classes:
                    name = cls.name
                if name is None:
                    continue
                given = {kw.arg: kw.value for kw in call.keywords if kw.arg}
                moved = {f for f, v in given.items() if _moves(v)}
                if not moved:
                    continue
                left = [f for f in classes[name] if f not in moved]
                if left:
                    findings.append(Finding(
                        rule="DEVICE-MOVE", path=rel, symbol=q,
                        line=call.lineno,
                        message=(f"{name} moves {sorted(moved)} with .to() "
                                 f"but not {left} — those fields stay on "
                                 f"the old device; move it as a whole "
                                 f"(api/compiled.py::_to_device)")))


# ---------------------------------------------------------------------------
# BANNED-IN-HOT
# ---------------------------------------------------------------------------


class _TensorNames:
    """Which expressions of one function hold a tensor (a heuristic)."""

    def __init__(self, func):
        self.names = {p.arg for p in _params(func)
                      if p.annotation is not None
                      and "Tensor" in ast.unparse(p.annotation)}
        changed = True
        while changed:           # assignments in any order, to a fixpoint
            changed = False
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and self.is_tensor(node.value):
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name) and \
                                    n.id not in self.names:
                                self.names.add(n.id)
                                changed = True

    def is_tensor(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            qn = _qualname(e.func)
            if qn.startswith("torch."):
                parts = qn.split(".")
                return parts[1] not in ("cuda", "backends", "distributed") \
                    and parts[-1] not in TORCH_NON_TENSOR
            if isinstance(e.func, ast.Attribute):
                return e.func.attr not in TENSOR_NON_TENSOR and \
                    self.is_tensor(e.func.value)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr in ("T", "mT") and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            return self.is_tensor(e.left) or any(
                self.is_tensor(c) for c in e.comparators)
        return False


def _banned(func) -> list[tuple[int, str, str]]:
    """``(line, what, why)`` of every banned construct in ``func``,
    nested defs and lambdas included."""
    out = []
    tn = _TensorNames(func)
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute):
            qn = _qualname(node)
            if qn.startswith(("np.random.", "numpy.random.")):
                out.append((node.lineno, qn, "hidden host RNG state"))
        if not isinstance(node, ast.Call):
            continue
        qn = _qualname(node.func)
        mod, _, leaf = qn.rpartition(".")
        if mod == "time" and leaf in BANNED_TIME:
            out.append((node.lineno, f"{qn}()", "the host clock"))
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_METHODS and not node.args:
            out.append((node.lineno, f".{node.func.attr}()",
                        "copies to the host and waits for the card"))
        if qn in ("float", "int", "bool") and len(node.args) == 1 and \
                tn.is_tensor(node.args[0]):
            out.append((node.lineno, f"{qn}() of a tensor",
                        "reads the value on the host and waits for the card"))
    return out


def _check_banned_in_hot(index: _Index, hot: Iterable[tuple],
                         findings: list[Finding]) -> dict:
    """BANNED-IN-HOT over the closure of ``hot`` under resolvable calls."""
    todo = [(h, h) for h in hot if tuple(h) in index.funcs]
    reached: dict[tuple, tuple] = {}
    while todo:
        site, entry = todo.pop()
        site = tuple(site)
        if site in reached:
            continue
        reached[site] = tuple(entry)
        func, cls = index.funcs[site]
        for call in [n for n in ast.walk(func) if isinstance(n, ast.Call)]:
            target = index.resolve(site[0], call, cls)
            if target is not None and target not in reached:
                todo.append((target, entry))
    for (rel, q), (_, entry) in sorted(reached.items()):
        func, _ = index.funcs[(rel, q)]
        for line, what, why in _banned(func):
            findings.append(Finding(
                rule="BANNED-IN-HOT", path=rel, symbol=q, line=line,
                message=(f"{what} in {q}(), reached from the hot entry point "
                         f"{entry} — {why}")))
    return {"hot_functions": len(reached)}


# ---------------------------------------------------------------------------
# Running the pass
# ---------------------------------------------------------------------------


def _iter_port_files(root: str) -> list[str]:
    out = []
    top = os.path.join(root, "src", "repro_torch")
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [x for x in dirnames if x != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out += [os.path.join(tests, f) for f in os.listdir(tests)
                if f.startswith("test_torch_") and f.endswith(".py")]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.isfile(smoke):
        out.append(smoke)
    return sorted(out)


def lint_files(paths: list[str], root: str, hot: Optional[Iterable] = None
               ) -> tuple[list[Finding], dict]:
    """Run every AST rule over ``paths``; ``hot`` is the ``(path,
    qualname)`` list BANNED-IN-HOT starts from (default: the registry's
    ``HOT_SYMBOLS``).  Returns (findings, info)."""
    if hot is None:
        from repro_torch.analysis.entrypoints import HOT_SYMBOLS
        hot = HOT_SYMBOLS
    findings: list[Finding] = []
    trees: dict[str, ast.Module] = {}
    skipped = []
    for p in paths:
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        try:
            with open(p, encoding="utf-8") as fh:
                trees[rel] = ast.parse(fh.read(), filename=rel)
        except SyntaxError as e:
            skipped.append({"path": rel, "error": str(e)})
    index = _Index(trees)
    for rel in trees:
        for q, func, _ in index.by_file[rel]:
            _StreamScanner(func, rel, q, findings).run()
        _check_device_thread(index, rel, findings)
    _check_device_move(index, findings)
    hot_info = _check_banned_in_hot(index, hot, findings)
    info = {"files_scanned": len(trees), "skipped": skipped, **hot_info}
    return findings, info


def lint_tree(root: str) -> tuple[list[Finding], dict]:
    """Lint the port's files under ``root``."""
    return lint_files(_iter_port_files(root), root)
