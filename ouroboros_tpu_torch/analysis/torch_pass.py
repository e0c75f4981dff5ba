"""Pass 2 — torch launch-path lint for crypto/ and parallel/.

The port's counterpart of the JAX package's JAX pass: the hazards here
are the port's own.  A kernel wrapper of crypto/kernels.py checks its
tensors and calls `_launch`, which hands raw pointers and the current
stream to the library and returns at once; the card runs the kernel
while the host goes on.  Walks every module under
ouroboros_tpu_torch/crypto and ouroboros_tpu_torch/parallel:

- TORCH001 host-sync-in-launch-path: `.item()`, `.cpu()`, `.tolist()`,
  `.numpy()`, `torch.cuda.synchronize()`, or int()/float()/bool() of a
  non-static expression, inside a *launch-path* function: one that
  calls `_launch` or one of the kernel wrappers (`K.<wrapper>`,
  `kernels.<wrapper>`, a bare wrapper name in kernels.py, or
  `getattr(K, name)`), or a same-module callee of one (bare names and
  `self.<method>` calls).  Each such call waits for the card to finish
  everything queued before it, so the host stops overlapping the
  device; where the host needs the value (a verdict read back), the
  finding is baselined with the reason.
- TORCH002 cuda-at-import: CUDA work at module level — a
  `torch.cuda.Stream`/`Event` built, `torch.cuda.init`/`synchronize`/
  `set_device`/`current_stream` called, a tensor made or moved onto a
  CUDA device (`device="cuda..."`, `torch.device("cuda...")`,
  `.cuda()`, `.to("cuda...")`), or the kernel library built or loaded
  (`build()`, `library()`, `K.build`, `kernels.library`).  Importing a
  module must not touch the card: the tests import every module on
  machines without one, and a library build takes seconds.
- TORCH003 build-in-loop: the kernel library built or loaded
  (`build`/`library`, `ctypes.CDLL`, `cpp_extension.load`) or a
  `torch.cuda.Stream` constructed lexically inside a for/while loop — a
  rebuild, a reload or a new stream per window (the analog of the JAX
  pass's JAX006).  A builder called from a loop is fine when it
  memoises (kernels.library does); building in the loop body never is.

The launch-path set is same-module only, as the JAX pass's traced set
is: a wrapper's cross-module callees (the plain versions in ed25519.py,
vrf.py) run only for host tensors and launch nothing.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from . import Finding, register, relpath
from .astutil import QualnameVisitor, dotted_name, iter_py_files, parse_file

SCAN_DIRS = ("ouroboros_tpu_torch/crypto", "ouroboros_tpu_torch/parallel")

# the wrappers of crypto/kernels.py that reach `_launch`
WRAPPERS = frozenset({
    "_launch", "_chain", "ed25519_split", "vrf_verify", "gamma8",
    "kes_hash", "ed25519_verify", "field_chain", "field_chain_lp",
    "point_chain", "point_chain_x4", "window_fold"})
_KERNELS_ALIASES = frozenset({"K", "kernels"})
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "index"})
_CUDA_CALLS = frozenset({
    "torch.cuda.Stream", "torch.cuda.Event", "torch.cuda.init",
    "torch.cuda.synchronize", "torch.cuda.set_device",
    "torch.cuda.current_stream", "torch.cuda.default_stream"})
_BUILD_LEAVES = frozenset({"build", "library"})
_LOADERS = frozenset({"ctypes.CDLL", "cpp_extension.load",
                      "torch.utils.cpp_extension.load", "torch.cuda.Stream"})


def _is_static_expr(node: ast.AST) -> bool:
    """Expressions whose int()/bool() conversion reads no device value:
    literals, len(), shape/dtype/device metadata (and arithmetic over
    those)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) == "len"
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand)
    return False


def _launches(node: ast.Call, in_kernels: bool) -> bool:
    """Does this call launch a kernel: `_launch`, `K.<wrapper>`,
    `kernels.<wrapper>`, a bare wrapper in kernels.py itself, or
    `getattr(K, name)(...)`?"""
    func = node.func
    if isinstance(func, ast.Call) and dotted_name(func.func) == "getattr" \
            and func.args and dotted_name(func.args[0]) in _KERNELS_ALIASES:
        return True
    name = dotted_name(func)
    if name is None:
        return False
    head, _, leaf = name.rpartition(".")
    if leaf not in WRAPPERS:
        return False
    return head in _KERNELS_ALIASES or (head == "" and (
        in_kernels or leaf == "_launch"))


def _builds(name: str) -> bool:
    """A call that builds or loads the kernel library."""
    head, _, leaf = name.rpartition(".")
    return leaf in _BUILD_LEAVES and head in ("", *_KERNELS_ALIASES)


def _cuda_device(node: ast.AST) -> bool:
    """A constant "cuda..." device, or torch.device("cuda...")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "torch.device", "device") and node.args:
        return _cuda_device(node.args[0])
    return False


def _cuda_work(node: ast.Call) -> str:
    """What CUDA work this call does at import time, or ''."""
    name = dotted_name(node.func) or ""
    if name in _CUDA_CALLS:
        return f"{name}()"
    if name and _builds(name):
        return f"{name}() builds or loads the kernel library"
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda" and not node.args:
            return ".cuda()"
        if node.func.attr == "to" and node.args \
                and _cuda_device(node.args[0]):
            return ".to(<cuda device>)"
    for kw in node.keywords:
        if kw.arg == "device" and _cuda_device(kw.value):
            return f"{name or 'a call'}(device=<cuda device>)"
    return ""


class _ModuleIndex(ast.NodeVisitor):
    """First sweep: defs by bare name, launch-path roots, call graph
    (bare names and self.<method>)."""

    def __init__(self, in_kernels: bool):
        self.in_kernels = in_kernels
        self.defs: Dict[str, List[ast.AST]] = {}
        self.roots: Set[str] = set()
        self.calls: Dict[str, Set[str]] = {}
        self.enclosing: Dict[int, tuple] = {}
        self._stack: List[str] = []

    def _visit_def(self, node):
        self.defs.setdefault(node.name, []).append(node)
        self.enclosing[id(node)] = tuple(self._stack)
        self._stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_Call(self, node: ast.Call):
        if self._stack:
            caller = self._stack[-1]
            if _launches(node, self.in_kernels):
                self.roots.add(caller)
            func = node.func
            if isinstance(func, ast.Name):
                self.calls.setdefault(caller, set()).add(func.id)
            elif isinstance(func, ast.Attribute) and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id == "self":
                self.calls.setdefault(caller, set()).add(func.attr)
        self.generic_visit(node)

    def launch_path(self) -> Set[str]:
        """Launch-path roots and their same-module callees."""
        path = set(self.roots)
        frontier = list(path)
        while frontier:
            fn = frontier.pop()
            for callee in self.calls.get(fn, ()):
                if callee in self.defs and callee not in path:
                    path.add(callee)
                    frontier.append(callee)
        return path


class _SyncLint(QualnameVisitor):
    """TORCH001 within one launch-path function subtree."""

    def __init__(self, file: str, findings: List[Finding], prefix: str):
        super().__init__()
        self.file = file
        self.findings = findings
        self._prefix = prefix

    def _add(self, node, message):
        qn = self.qualname
        symbol = self._prefix if qn == "<module>" else \
            f"{self._prefix}.{qn}"
        self.findings.append(Finding(
            file=self.file, line=node.lineno, rule="TORCH001",
            symbol=symbol, message=message))

    def visit_Call(self, node: ast.Call):
        name = dotted_name(node.func)
        if name in ("int", "float", "bool") and node.args and \
                not _is_static_expr(node.args[0]):
            self._add(node, f"{name}() of a tensor value in a kernel's "
                            f"launch path waits for the card")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args:
            self._add(node, f".{node.func.attr}() in a kernel's launch "
                            f"path copies to the host and waits for the "
                            f"card")
        elif name in _SYNC_CALLS:
            self._add(node, f"{name}() in a kernel's launch path waits "
                            f"for every queued kernel")
        self.generic_visit(node)


class _ScopeLint(QualnameVisitor):
    """TORCH002 (module level) and TORCH003 (inside loops) over the whole
    module."""

    def __init__(self, file: str, findings: List[Finding]):
        super().__init__()
        self.file = file
        self.findings = findings
        self._fn_depth = 0
        self._loop_depth = 0

    def _visit_loop(self, node):
        self._loop_depth += 1
        try:
            self.generic_visit(node)
        finally:
            self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def _visit_fn(self, node):
        # a def runs at call time, not at import or per loop iteration
        outer_loops, self._loop_depth = self._loop_depth, 0
        self._fn_depth += 1
        try:
            QualnameVisitor._visit_scope(self, node)
        finally:
            self._fn_depth -= 1
            self._loop_depth = outer_loops

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node):
        outer_loops, self._loop_depth = self._loop_depth, 0
        self._fn_depth += 1
        try:
            self.generic_visit(node)
        finally:
            self._fn_depth -= 1
            self._loop_depth = outer_loops

    def _add(self, node, rule, message):
        self.findings.append(Finding(
            file=self.file, line=node.lineno, rule=rule,
            symbol=self.qualname, message=message))

    def visit_Call(self, node: ast.Call):
        name = dotted_name(node.func) or ""
        if self._fn_depth == 0:
            work = _cuda_work(node)
            if work:
                self._add(node, "TORCH002",
                          f"CUDA work at import time: {work}; importing a "
                          f"module must not touch the card — do it at "
                          f"first use")
        if self._loop_depth > 0 and (name in _LOADERS or
                                     (name and _builds(name))):
            self._add(node, "TORCH003",
                      f"{name}() inside a loop body builds or loads the "
                      f"kernel library, or makes a CUDA stream, every "
                      f"iteration; hoist it out of the loop or memoise "
                      f"the builder")
        self.generic_visit(node)


def lint_source(source: str, file: str) -> List[Finding]:
    """Run the torch pass over one source text (fixture entry point)."""
    return _lint_tree(ast.parse(source, filename=file), file)


def _lint_tree(tree: ast.Module, file: str) -> List[Finding]:
    index = _ModuleIndex(in_kernels=file.endswith("kernels.py"))
    index.visit(tree)
    path = index.launch_path()
    findings: List[Finding] = []
    for name in sorted(path):
        for node in index.defs.get(name, ()):
            # a def nested in a launch-path def is covered by the outer
            # walk; a walk of its own would report its lines twice
            if any(enc in path for enc in index.enclosing.get(id(node), ())):
                continue
            lint = _SyncLint(file, findings, prefix=name)
            for child in ast.iter_child_nodes(node):
                lint.visit(child)
    _ScopeLint(file, findings).visit(tree)
    return sorted(set(findings))


def run_files(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        findings.extend(_lint_tree(parse_file(path), relpath(path)))
    return findings


@register("torch")
def run() -> List[Finding]:
    return run_files(iter_py_files(*SCAN_DIRS))
