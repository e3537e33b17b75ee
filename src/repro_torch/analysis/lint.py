"""AST lint pass over the port: named, suppressible rules for its hazards.

The port's counterpart of `repro.analysis.lint`, with the same pragma,
report types and entry points (`lint_source`, `lint_paths`,
`lint_tree`). Rules carried over, in their torch form:

- ``frozen-dataclass-mutable-default`` — a mutable default on a frozen
  config dataclass field (shared across instances; use
  ``dataclasses.field(default_factory=...)``).
- ``per-item-host-sync`` — a device value pulled to host *inside a
  loop*: ``x.item()``, ``float(f(...))``, ``np.asarray(expr)``, or
  ``.cpu()`` / ``.tolist()`` / ``.numpy()`` of an expression computed
  there. Each iteration waits for the card; pull one stacked tensor
  outside the loop and index it on the host. Pulls of a plain name
  (``np.asarray(mat)``, ``t.cpu()``) are exempt, as in the reference: a
  named buffer is usually already the hoisted pull.
- ``numpy-handoff-no-copy`` — a numpy buffer handed to
  ``torch.from_numpy`` or ``torch.as_tensor`` (both alias it) and then
  mutated in place in the same scope: the tensor changes with it, and a
  copy to the card queued from it may read the new values. Hand off
  ``buf.copy()`` instead.
- ``kernel-package-triple`` — a kernel package under
  ``src/repro_torch/kernels/`` with an ``ops.py`` but without its
  ``ref.py`` (the plain version) or ``parity.py`` (its cases on the
  card), or naming a kernel library (``dispatch.bind("name", ...)``,
  ``dispatch.library()["name"]``) that has no ``csrc/<name>.cu``.

Rules of the reference that are dropped: ``jit-static-unhashable`` and
``traced-python-branch`` guard ``jax.jit``'s static arguments and its
tracing, and the port has no jit.

Rules of the port's own:

- ``jax-import`` — ``jax``, ``jaxlib`` or the JAX package ``repro``
  imported by the port (``src/repro_torch/``, ``chip_smoke.py``,
  ``benchmarks_torch/``, ``examples_torch/``): the port stands alone.
- ``tf32-enabled`` — ``allow_tf32 = True``, or
  ``set_float32_matmul_precision`` with another value than
  ``"highest"``: TF32 keeps about three digits and cannot hold the
  port's 1e-5 tolerances.
- ``kernel-fallback`` — an ``except`` that catches ``KernelBuildError``,
  ``KernelLaunchError`` or ``RuntimeError`` around a kernel wrapper's
  call and does not raise again: the port has no fallback, a kernel
  launches or the call fails.

Suppress a finding with an inline pragma on the flagged line:

    x = risky_thing()  # lint: disable=per-item-host-sync

(``disable=all`` silences every rule on that line.) Suppressed
violations stay in the report flagged ``suppressed=True``; the gate
fails only on unsuppressed ones.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "frozen-dataclass-mutable-default":
        "mutable default on a frozen dataclass field",
    "per-item-host-sync":
        "device value materialized to host inside a loop (.item()/"
        "float(call)/np.asarray(expr)/.cpu()/.tolist()/.numpy() per "
        "element) — each iteration pays a device sync; batch one pull "
        "outside the loop",
    "numpy-handoff-no-copy":
        "numpy buffer handed to torch (aliased) then mutated in place",
    "kernel-package-triple":
        "kernel package missing its ref.py/parity.py or its csrc source",
    "jax-import":
        "jax, jaxlib or the JAX package repro imported by the port",
    "tf32-enabled":
        "TF32 matmuls enabled (allow_tf32 = True or a float32 matmul "
        "precision other than 'highest')",
    "kernel-fallback":
        "kernel error caught around a kernel wrapper and not raised "
        "again (the port has no fallback)",
}

_PRAGMA = re.compile(r"#\s*lint:\s*disable=([\w,\-]+)")

_MUTABLE_CALLS = {"list", "dict", "set", "bytearray"}
_MUTABLE_ARRAY_ATTRS = {"array", "asarray", "zeros", "ones", "empty",
                        "full", "arange", "tensor"}
_HANDOFF_FUNCS = {"torch.from_numpy", "torch.as_tensor"}
# host-materializing callables: flagged when the first arg is an
# expression (Call/Subscript/Attribute) computed in-loop
_SYNC_FUNCS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_SYNC_METHODS = {"cpu", "tolist", "numpy"}
_KERNEL_ERRORS = {"KernelBuildError", "KernelLaunchError", "RuntimeError"}
# the kernel wrappers' public entry points (kernels/*/ops.py)
_KERNEL_WRAPPERS = {
    "stream_tick_fused", "stream_tick_fused_stacked", "sparse_tick_fused",
    "sparse_tick_fused_stacked", "delta_stats_fused", "vnge_q_stats",
    "vnge_tilde_dense", "quadratic_q_dense", "attention_graph_stats",
    "attention_graph_entropy", "bsr_matvec", "power_iteration_lmax_bsr",
    "library", "bind", "empty_launch", "check_launch"}
# where the port's own rules apply
_PORT_DIRS = ("repro_torch", "benchmarks_torch", "examples_torch")
_FOREIGN = ("jax", "jaxlib", "repro")


@dataclasses.dataclass
class LintViolation:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} " \
               f"{self.message}"


@dataclasses.dataclass
class LintReport:
    violations: List[LintViolation]

    @property
    def unsuppressed(self) -> List[LintViolation]:
        return [v for v in self.violations if not v.suppressed]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed

    def to_dict(self) -> Dict[str, object]:
        return {"ok": self.ok,
                "violations": [v.to_dict() for v in self.violations]}


def _pragmas(source: str) -> Dict[int, Set[str]]:
    """line → set of rule names disabled on that line ('all' wildcard)."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = _PRAGMA.search(tok.string)
                if m:
                    out.setdefault(tok.start[0], set()).update(
                        m.group(1).split(","))
    except tokenize.TokenizeError:
        pass
    return out


def _dotted(node: ast.expr) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_mutable_default(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _MUTABLE_CALLS:
            return True
        if isinstance(fn, ast.Attribute) \
                and fn.attr in _MUTABLE_ARRAY_ATTRS:
            return True
    return False


def _loop_spans(tree: ast.AST) -> List[Tuple[int, int]]:
    return [(node.lineno, max(n.lineno for n in ast.walk(node)
                              if hasattr(n, "lineno")))
            for node in ast.walk(tree)
            if isinstance(node, (ast.For, ast.While))]


def _check_frozen_dataclasses(tree: ast.AST, path: str,
                              out: List[LintViolation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        frozen = any(
            isinstance(dec, ast.Call)
            and (_dotted(dec.func) or "") in ("dataclasses.dataclass",
                                              "dataclass")
            and any(kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in dec.keywords)
            for dec in node.decorator_list)
        if not frozen:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and _is_mutable_default(stmt.value):
                field = stmt.target.id \
                    if isinstance(stmt.target, ast.Name) else "?"
                out.append(LintViolation(
                    "frozen-dataclass-mutable-default", path, stmt.lineno,
                    f"field '{field}' of frozen dataclass {node.name} has "
                    "a mutable default — shared across instances; use "
                    "dataclasses.field(default_factory=...)"))


_EXPR = (ast.Call, ast.Subscript, ast.Attribute)
# calls a pull chains through (``t.detach().cpu().numpy()`` pulls ``t``)
_CHAIN = _SYNC_METHODS | {"detach", "contiguous", "float", "clone"}


def _pulled(node: ast.expr) -> ast.expr:
    """What a chain of argument-less `_CHAIN` calls pulls."""
    while isinstance(node, ast.Call) and not node.args \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _CHAIN:
        node = node.func.value
    return node


def _host_sync(node: ast.Call) -> Optional[str]:
    """The per-item-host-sync finding of one call inside a loop, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and not node.args:
        if fn.attr == "item":
            return (".item() inside a loop — one blocking device→host sync "
                    "per iteration; pull the whole tensor once outside the "
                    "loop and index host-side")
        if fn.attr in _SYNC_METHODS and isinstance(_pulled(fn.value), _EXPR):
            return (f".{fn.attr}() of a freshly computed tensor inside a "
                    "loop — one device→host sync per iteration; batch the "
                    "computation and pull one stacked tensor outside the "
                    "loop")
    dotted = _dotted(fn) or ""
    if (dotted == "float" and node.args
            and isinstance(node.args[0], ast.Call)) \
            or (dotted in _SYNC_FUNCS and node.args
                and isinstance(node.args[0], _EXPR)):
        return (f"'{dotted}(...)' materializes a freshly computed value "
                "inside a loop — one device→host sync per iteration; batch "
                "the computation and pull one stacked tensor outside the "
                "loop")
    return None


def _check_host_sync(tree: ast.AST, path: str,
                     out: List[LintViolation]) -> None:
    """The per-item-host-sync rule (see module docstring), one finding a
    line: a chain such as ``f(x).cpu().numpy()`` pulls once."""
    spans = _loop_spans(tree)
    seen: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or node.lineno in seen \
                or not any(a <= node.lineno <= b for a, b in spans):
            continue
        message = _host_sync(node)
        if message is not None:
            seen.add(node.lineno)
            out.append(LintViolation("per-item-host-sync", path,
                                     node.lineno, message))


class _Scope(ast.NodeVisitor):
    """Per-function collector for the handoff/mutation rule."""

    def __init__(self):
        self.handoffs: List[Tuple[str, int]] = []   # (name, line)
        self.mutations: List[Tuple[str, int]] = []  # (name, line)
        self.rebinds: List[Tuple[str, int]] = []    # (name, line)
        self.loop_spans: List[Tuple[int, int]] = []

    def visit_For(self, node):
        self.loop_spans.append((node.lineno, max(
            n.lineno for n in ast.walk(node) if hasattr(n, "lineno"))))
        self.generic_visit(node)

    visit_While = visit_For

    def visit_Call(self, node: ast.Call):
        if (_dotted(node.func) or "") in _HANDOFF_FUNCS:
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    self.handoffs.append((arg.id, node.lineno))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Name):
                self.mutations.append((tgt.value.id, tgt.lineno))
            elif isinstance(tgt, ast.Name):
                # plain rebinding: the old buffer is no longer aliased
                # by this name
                self.rebinds.append((tgt.id, node.lineno))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        tgt = node.target
        if isinstance(tgt, ast.Subscript) \
                and isinstance(tgt.value, ast.Name):
            self.mutations.append((tgt.value.id, tgt.lineno))
        elif isinstance(tgt, ast.Name):
            # numpy's `a += b` works in place
            self.mutations.append((tgt.id, tgt.lineno))
        self.generic_visit(node)

    # don't descend into nested function scopes
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


def _check_numpy_handoff(tree: ast.AST, path: str,
                         out: List[LintViolation]) -> None:
    for scope in [n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))]:
        coll = _Scope()
        for stmt in scope.body:
            coll.visit(stmt)
        if not coll.handoffs or not coll.mutations:
            continue

        def in_loop(line):
            return any(a <= line <= b for a, b in coll.loop_spans)

        def rebound_between(name, lo, hi):
            return any(rn == name and lo < rl <= hi
                       for rn, rl in coll.rebinds)

        def rebound_in_loop(name, line):
            return any(rn == name and any(a <= rl <= b and a <= line <= b
                                          for a, b in coll.loop_spans)
                       for rn, rl in coll.rebinds)

        for name, hline in coll.handoffs:
            for mname, mline in coll.mutations:
                if mname != name:
                    continue
                sequential = mline > hline \
                    and not rebound_between(name, hline, mline)
                looped = in_loop(hline) and in_loop(mline) \
                    and not rebound_in_loop(name, hline)
                if sequential or looped:
                    out.append(LintViolation(
                        "numpy-handoff-no-copy", path, hline,
                        f"'{name}' is handed to torch here (aliased) but "
                        f"mutated in place at line {mline} — the tensor "
                        "changes with it, and a queued copy may read the "
                        f"new values (hand off '{name}.copy()' instead)"))
                    break


def _applies_to_port(path: str) -> bool:
    parts = Path(path).parts
    return Path(path).name == "chip_smoke.py" \
        or any(d in parts for d in _PORT_DIRS)


def _check_jax_imports(tree: ast.AST, path: str,
                       out: List[LintViolation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in _FOREIGN:
                out.append(LintViolation(
                    "jax-import", path, node.lineno,
                    f"'{name}' imported by the port — repro_torch, "
                    "chip_smoke.py and the twins stand alone: keep a copy "
                    "of what is needed instead"))


def _check_tf32(tree: ast.AST, path: str,
                out: List[LintViolation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Constant) \
                    and node.value.value is True \
                    and any(isinstance(t, ast.Attribute)
                            and t.attr == "allow_tf32"
                            for t in node.targets):
                out.append(LintViolation(
                    "tf32-enabled", path, node.lineno,
                    "allow_tf32 = True — TF32 keeps about three digits "
                    "and cannot hold the port's 1e-5 tolerances"))
        elif isinstance(node, ast.Call) \
                and (_dotted(node.func) or "").endswith(
                    "set_float32_matmul_precision"):
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant)
                    and arg.value == "highest"):
                out.append(LintViolation(
                    "tf32-enabled", path, node.lineno,
                    "set_float32_matmul_precision other than 'highest' "
                    "lets float32 matmuls run in TF32 or bf16"))


def _caught_names(handler: ast.ExceptHandler) -> Set[str]:
    if handler.type is None:
        return set()
    nodes = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    return {(_dotted(n) or "").rsplit(".", 1)[-1] for n in nodes}


def _calls_kernel(stmts) -> Optional[str]:
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = (_dotted(node.func) or "").rsplit(".", 1)[-1]
                if name in _KERNEL_WRAPPERS or name.endswith("_cuda"):
                    return name
    return None


def _check_kernel_fallback(tree: ast.AST, path: str,
                           out: List[LintViolation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        wrapper = _calls_kernel(node.body)
        if wrapper is None:
            continue
        for handler in node.handlers:
            caught = _caught_names(handler) & _KERNEL_ERRORS
            if caught and not any(isinstance(n, ast.Raise)
                                  for s in handler.body
                                  for n in ast.walk(s)):
                out.append(LintViolation(
                    "kernel-fallback", path, handler.lineno,
                    f"{sorted(caught)} caught around {wrapper}() and not "
                    "raised again — the port has no fallback: a kernel "
                    "launches or the call fails by name"))


def lint_source(source: str, path: str) -> List[LintViolation]:
    """Run every AST rule over one file's source; the port's own rules
    (``jax-import``, ``tf32-enabled``, ``kernel-fallback``) where
    ``path`` lies in the port."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [LintViolation("syntax-error", path, exc.lineno or 1,
                              f"could not parse: {exc.msg}")]
    out: List[LintViolation] = []
    _check_numpy_handoff(tree, path, out)
    _check_frozen_dataclasses(tree, path, out)
    _check_host_sync(tree, path, out)
    if _applies_to_port(path):
        _check_jax_imports(tree, path, out)
        _check_tf32(tree, path, out)
        _check_kernel_fallback(tree, path, out)

    disabled = _pragmas(source)
    for v in out:
        rules = disabled.get(v.line, set())
        if "all" in rules or v.rule in rules:
            v.suppressed = True
    return out


def _library_names(ops: Path) -> List[Tuple[str, int]]:
    """(library name, line) of every ``dispatch.bind("name", ...)`` and
    ``dispatch.library()["name"]`` in a wrapper."""
    out = []
    for node in ast.walk(ast.parse(ops.read_text(), filename=str(ops))):
        if isinstance(node, ast.Call) \
                and (_dotted(node.func) or "").endswith("bind") \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.append((node.args[0].value, node.lineno))
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Call) \
                and (_dotted(node.value.func) or "").endswith("library") \
                and isinstance(node.slice, ast.Constant):
            out.append((node.slice.value, node.lineno))
    return out


def check_kernel_triples(kernels: Path, csrc: Path) -> List[LintViolation]:
    """The ``kernel-package-triple`` rule over a kernels directory and
    the CUDA sources beside it."""
    out: List[LintViolation] = []
    if not kernels.is_dir():
        return out
    for child in sorted(kernels.iterdir()):
        ops = child / "ops.py"
        if not child.is_dir() or not ops.is_file():
            continue
        for required in ("ref.py", "parity.py"):
            if not (child / required).is_file():
                out.append(LintViolation(
                    "kernel-package-triple", str(ops), 1,
                    f"kernel package '{child.name}' is missing {required} "
                    "— every kernel ships its plain version (ref.py) and "
                    "its cases on the card (parity.py)"))
        for name, line in _library_names(ops):
            if not (csrc / f"{name}.cu").is_file():
                out.append(LintViolation(
                    "kernel-package-triple", str(ops), line,
                    f"'{child.name}' binds kernel library '{name}' but "
                    f"{csrc / (name + '.cu')} does not exist"))
    return out


def lint_paths(paths: Sequence[Path],
               port_root: Optional[Path] = None,
               relative_to: Optional[Path] = None) -> LintReport:
    """Lint the given python files (plus the kernel-package rule over
    ``port_root``'s ``kernels/`` and ``csrc/`` when it is given: the
    ``src/repro_torch`` directory), reporting paths relative to
    ``relative_to`` when it is given."""
    violations: List[LintViolation] = []
    for p in paths:
        shown = p.relative_to(relative_to) if relative_to else p
        violations.extend(lint_source(p.read_text(), str(shown)))
    if port_root is not None:
        violations.extend(check_kernel_triples(port_root / "kernels",
                                               port_root / "csrc"))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return LintReport(violations)


def port_files(repo_root: Path) -> List[Path]:
    """The files `lint_tree` reads: every .py under ``src/repro_torch``,
    ``benchmarks_torch`` and ``examples_torch``, and ``chip_smoke.py``."""
    files = [repo_root / "chip_smoke.py"]
    for d in (repo_root / "src" / "repro_torch",
              repo_root / "benchmarks_torch", repo_root / "examples_torch"):
        files.extend(d.rglob("*.py"))
    return sorted(f for f in files if f.is_file())


def lint_tree(repo_root: Path) -> LintReport:
    """Lint the port in the repository at ``repo_root`` (`port_files`)."""
    repo_root = Path(repo_root).resolve()
    return lint_paths(port_files(repo_root),
                      port_root=repo_root / "src" / "repro_torch",
                      relative_to=repo_root)
