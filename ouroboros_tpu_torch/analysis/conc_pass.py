"""Pass 4 — STM concurrency lint (the static half of ouro-race).

The dynamic half (simharness/race.py) finds unordered TVar access pairs
by exploring schedules; this pass finds the *idioms* that create them
before any schedule runs.  It walks everything under ouroboros_tpu_torch/
except the simharness runtime implementation itself (core/stm/runtime/
io_runtime/race are the machinery being linted FOR, not WITH):

- CONC001 tvar-mutation-outside-atomically: `.set_notify(...)` calls and
  assignments to a `._value` attribute mutate a TVar without a
  transaction.  set_notify is the sanctioned runtime-internal escape
  hatch for non-sim-thread producers, so every live use carries a
  baseline justification explaining why the unordered write commutes.
  (A plain `self._value = ...` — defining one's OWN private attribute —
  is the standard Python idiom and does not fire; TVars are never `self`
  outside the excluded runtime.)
- CONC002 blocking-in-atomic: a blocking primitive (`await`, a channel
  `recv`/`collect`, `time.sleep`/`sim.sleep`) inside a transaction
  function.  Transactions are plain functions run atomically by the
  scheduler; blocking inside one stalls every thread and can never be
  rolled back.  Use `retry()`/`tx.check(...)` to block transactionally.
- CONC003 global-mutation-in-sim-thread: an async function (or a helper
  nested in one) declaring `global X` and assigning it — module-global
  state shared across sim threads without a TVar is invisible to both
  the STM wake-up machinery and the race detector's HB model.
- CONC004 unsupervised-fork: a bare-statement `spawn(...)` whose handle
  is discarded.  A thread nobody can join/poll/cancel leaks past the
  sim snapshot and its failure is silently swallowed (the reference
  links forked threads to a supervisor; ThreadNet polls every handle).
- CONC005 nested-atomically: calling `atomically` from inside a
  transaction function.  The sim would run the inner transaction's
  effect record as a *coroutine await inside a sync function* — it
  cannot work, and in GHC STM nested atomically is outright illegal.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from . import Finding, register, relpath
from .astutil import dotted_name, iter_py_files, parse_file

SCAN_DIRS = ("ouroboros_tpu_torch",)
# the STM/runtime implementation: mutating TVar internals IS its job
RUNTIME_IMPL_DIR = "ouroboros_tpu_torch/simharness"

_BLOCKING_LEAVES = {"recv", "collect"}
_SLEEP_CALLS = {"time.sleep", "sim.sleep", "sleep"}


def _tx_fn_nodes(call: ast.Call, local_defs: dict) -> list:
    """The transaction-function bodies reachable from an atomically(...)
    call: a direct lambda, or a bare Name resolving to a def in this
    file.  Attribute references (``self._tx_fn``, ``q.get``) are NOT
    resolved — bound STM-structure methods are trusted, and chasing a
    method reference to its class body needs type information an AST
    walk doesn't have; a method-valued tx fn is only linted where it is
    defined next to its atomically call as a local def."""
    out = []
    for arg in call.args[:1]:
        if isinstance(arg, ast.Lambda):
            out.append(arg)
        elif isinstance(arg, ast.Name) and arg.id in local_defs:
            out.append(local_defs[arg.id])
    return out


class _ConcLint(ast.NodeVisitor):
    def __init__(self, file: str):
        self.file = file
        self.findings: List[Finding] = []
        self._stack: List[str] = []
        self._async_depth = 0
        # bare name -> innermost def node seen (good enough for lint:
        # tx fns are defined next to their atomically call)
        self._defs: dict = {}
        self._linted_tx_bodies: set = set()

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _add(self, node, rule, message, symbol: Optional[str] = None):
        self.findings.append(Finding(
            file=self.file, line=node.lineno, rule=rule,
            symbol=symbol or self.qualname, message=message))

    # -- scope tracking ------------------------------------------------------
    def _visit_scope(self, node, is_async: bool):
        self._defs[node.name] = node
        self._stack.append(node.name)
        self._async_depth += is_async
        try:
            if self._async_depth > 0:
                self._check_global_mutation(node)
            self.generic_visit(node)
        finally:
            self._async_depth -= is_async
            self._stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_scope(node, is_async=False)

    def visit_AsyncFunctionDef(self, node):
        self._visit_scope(node, is_async=True)

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._stack.pop()

    # -- CONC003 -------------------------------------------------------------
    @staticmethod
    def _walk_own_scope(fn):
        """Walk fn's body WITHOUT descending into nested defs/lambdas:
        the same name there is a fresh local binding (and nested scopes
        get their own _check_global_mutation via _visit_scope)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    def _check_global_mutation(self, fn) -> None:
        declared: set = set()
        for stmt in fn.body:
            if isinstance(stmt, ast.Global):
                declared.update(stmt.names)
        if not declared:
            return
        for stmt in self._walk_own_scope(fn):
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in declared:
                    self._add(stmt, "CONC003",
                              f"module-global {t.id!r} mutated from a sim "
                              f"thread without a TVar: invisible to STM "
                              f"wake-ups and the race detector; hold it "
                              f"in a TVar")
                    declared.discard(t.id)

    # -- CONC001 -------------------------------------------------------------
    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check_value_write(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_value_write(node.target)
        self.generic_visit(node)

    def _check_value_write(self, target) -> None:
        if isinstance(target, ast.Attribute) and target.attr == "_value" \
                and not (isinstance(target.value, ast.Name)
                         and target.value.id == "self"):
            self._add(target, "CONC001",
                      "direct write to a TVar's ._value bypasses the "
                      "transaction log AND the STM wake-up; use "
                      "atomically() (or set_notify with a baseline "
                      "justification)")

    # -- calls: CONC001 set_notify, CONC004 spawn, CONC002/5 tx bodies -------
    def visit_Expr(self, node: ast.Expr):
        # a bare-statement spawn(...) discards the only handle to the
        # thread — CONC004.  spawn in any other position (assigned,
        # appended, awaited, returned) is assumed supervised.
        if isinstance(node.value, ast.Call):
            name = dotted_name(node.value.func)
            if name and name.rsplit(".", 1)[-1] == "spawn":
                self._add(node, "CONC004",
                          f"fork without a join/supervisor: {name}(...) "
                          f"discards the Async handle, so the thread "
                          f"can't be polled, cancelled or reaped — keep "
                          f"the handle and poll it (or hand it to a "
                          f"supervisor)")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        name = dotted_name(node.func)
        leaf = name.rsplit(".", 1)[-1] if name else ""
        if leaf == "set_notify":
            self._add(node, "CONC001",
                      f"{name}() mutates a TVar outside atomically(); "
                      f"sanctioned only for non-sim-thread producers "
                      f"with an order-insensitivity justification in "
                      f"the baseline")
        elif leaf == "atomically":
            for fn in _tx_fn_nodes(node, self._defs):
                if id(fn) not in self._linted_tx_bodies:
                    self._linted_tx_bodies.add(id(fn))
                    self._lint_tx_body(fn)
        self.generic_visit(node)

    def _lint_tx_body(self, fn) -> None:
        body = fn.body if isinstance(fn, ast.Lambda) else fn
        for sub in ast.walk(body):
            if sub is fn:
                continue
            if isinstance(sub, ast.Await):
                self._add(sub, "CONC002",
                          "await inside a transaction function: "
                          "transactions are atomic sync blocks; block "
                          "with retry()/tx.check() instead")
            elif isinstance(sub, ast.Call):
                sub_name = dotted_name(sub.func) or ""
                sub_leaf = sub_name.rsplit(".", 1)[-1]
                if sub_name in _SLEEP_CALLS:
                    self._add(sub, "CONC002",
                              f"{sub_name}() inside a transaction "
                              f"function stalls every sim thread; "
                              f"transactions must not block — use "
                              f"retry() against a timer TVar "
                              f"(new_timeout)")
                elif sub_leaf in _BLOCKING_LEAVES:
                    self._add(sub, "CONC002",
                              f"{sub_name}() is a blocking receive "
                              f"inside a transaction function; read "
                              f"through a TQueue/TMVar with retry() "
                              f"semantics instead")
                elif sub_leaf == "atomically":
                    self._add(sub, "CONC005",
                              "nested atomically inside a transaction "
                              "function: the inner transaction can "
                              "never run (sync context) and nesting is "
                              "illegal STM; merge into one transaction "
                              "or use tx.or_else")


def lint_source(source: str, file: str) -> List[Finding]:
    """Run the conc pass over one source text (fixture entry point)."""
    lint = _ConcLint(file)
    lint.visit(ast.parse(source, filename=file))
    return lint.findings


def run_files(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        lint = _ConcLint(relpath(path))
        lint.visit(parse_file(path))
        findings.extend(lint.findings)
    return findings


@register("conc")
def run() -> List[Finding]:
    return run_files(iter_py_files(*SCAN_DIRS,
                                   exclude_dirs=(RUNTIME_IMPL_DIR,)))
