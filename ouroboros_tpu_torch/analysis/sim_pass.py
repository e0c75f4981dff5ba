"""Pass 3 — sim-determinism lint.

Everything under ouroboros_tpu_torch/ is written against the simharness
facade and must stay replayable on the deterministic Sim scheduler; only
simharness/io_runtime.py and network/socket_bearer.py are the declared
real-IO boundary.  This pass walks every *async* function outside that
boundary (nested helper defs included — they run on the same cooperative
scheduler unless explicitly shipped to an executor) and flags operations
that would block the event loop or smuggle in wall-clock/OS entropy:

- SIM001 real-sleep: time.sleep() stalls the whole cooperative scheduler
  and reads the real clock; use sim.sleep.
- SIM002 global-rng: module-global random.*() draws from interpreter-wide
  state, so interleaving changes results between runs; use a seeded
  random.Random instance plumbed from the test/sim config (constructing
  random.Random(seed)/SystemRandom is allowed).
- SIM003 real-threads: threading.* bypasses the cooperative scheduler
  entirely; use sim.spawn.
- SIM004 raw-socket: socket.*() calls are real network IO; use the
  snocket/bearer abstractions (socket module *constants* are fine).
- SIM005 blocking-file-io: open()/io.open()/os.open() block the loop; go
  through storage.fs or the IO runtime's executor.

One rule is scoped to ouroboros_tpu_torch/node/ only (the peer-facing layer
whose liveness the protocol watchdogs own):

- SIM006 unbounded-receive: an `await` on a channel/queue receive
  (`.recv()` / `.collect()` / `sim.atomically(...queue.get...)`) with no
  time limit parks the thread forever when the peer goes silent — route
  peer-facing receives through node/watchdog.py's recv_with_limit/
  collect_with_limit (per-state ProtocolTimeLimits) or wrap the await in
  sim.timeout.  Receives that legitimately wait forever (server loops on
  client agency, internal work queues) are baselined with justifications.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from . import Finding, register, relpath
from .astutil import dotted_name, iter_py_files, parse_file

SCAN_DIRS = ("ouroboros_tpu_torch",)
IO_BOUNDARY = (
    # the real-clock runtime itself: asyncio's loop, its clock and its
    # executor stand in for the Sim scheduler under `sim.io_run`
    "ouroboros_tpu_torch/simharness/io_runtime.py",
    # the one bearer over real sockets (TCP and Unix), read and written
    # by that runtime's stream readers and writers
    "ouroboros_tpu_torch/network/socket_bearer.py",
)
# SIM006 applies only under this prefix (repo-relative, forward slashes)
NODE_PREFIX = "ouroboros_tpu_torch/node/"

_RNG_FACTORIES = {"Random", "SystemRandom"}
_OPEN_CALLS = {"open", "io.open", "os.open"}
# receive method names whose bare await in node/ code is unbounded
_RECV_ATTRS = {"recv", "collect"}


def _is_unbounded_receive(call: ast.Call) -> bool:
    """A channel/queue receive with no built-in bound: session.recv(),
    session.collect(), or sim.atomically(<something reading a queue's
    .get>).  The watchdog helpers (recv_with_limit/collect_with_limit)
    and sim.timeout(...) wrappers do not match."""
    name = dotted_name(call.func)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _RECV_ATTRS:
        return True
    if leaf == "atomically":
        for arg in call.args:
            # sim.atomically(q.get) or sim.atomically(lambda tx: q.get(tx))
            if isinstance(arg, ast.Attribute) and arg.attr == "get":
                return True
            if isinstance(arg, ast.Lambda):
                for sub in ast.walk(arg.body):
                    if isinstance(sub, ast.Call):
                        sub_name = dotted_name(sub.func) or ""
                        if sub_name.rsplit(".", 1)[-1] == "get":
                            return True
    return False


class _AsyncBodyLint(ast.NodeVisitor):
    def __init__(self, file: str):
        self.file = file
        self.findings: List[Finding] = []
        self._stack: List[str] = []
        self._async_depth = 0
        self._node_scope = file.replace("\\", "/").startswith(NODE_PREFIX)

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _visit_scope(self, node, is_async: bool):
        self._stack.append(node.name)
        self._async_depth += is_async
        try:
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

    def _add(self, node, rule, message):
        self.findings.append(Finding(
            file=self.file, line=node.lineno, rule=rule,
            symbol=self.qualname, message=message))

    def visit_Call(self, node: ast.Call):
        if self._async_depth > 0:
            name = dotted_name(node.func)
            if name == "time.sleep":
                self._add(node, "SIM001",
                          "time.sleep blocks the cooperative scheduler and "
                          "reads the real clock; use sim.sleep")
            elif name and name.startswith("random.") and \
                    name.split(".", 1)[1] not in _RNG_FACTORIES:
                self._add(node, "SIM002",
                          f"{name}() uses interpreter-global RNG state; "
                          f"use a seeded random.Random instance")
            elif name and name.startswith("threading."):
                self._add(node, "SIM003",
                          f"{name}() spawns a real thread outside the "
                          f"Sim scheduler; use sim.spawn")
            elif name and name.startswith("socket."):
                self._add(node, "SIM004",
                          f"{name}() is real network IO outside the "
                          f"declared boundary; use snocket/bearer")
            elif name in _OPEN_CALLS:
                self._add(node, "SIM005",
                          f"{name}() is blocking file IO on the "
                          f"cooperative scheduler; use storage.fs or the "
                          f"IO runtime executor")
        self.generic_visit(node)

    def visit_Await(self, node: ast.Await):
        if self._async_depth > 0 and self._node_scope \
                and isinstance(node.value, ast.Call) \
                and _is_unbounded_receive(node.value):
            name = dotted_name(node.value.func)
            self._add(node, "SIM006",
                      f"unbounded await on {name}() — a silent peer parks "
                      f"this thread forever; use node/watchdog.py's "
                      f"recv_with_limit/collect_with_limit or sim.timeout")
        self.generic_visit(node)


def lint_source(source: str, file: str) -> List[Finding]:
    """Run the sim pass over one source text (fixture entry point)."""
    lint = _AsyncBodyLint(file)
    lint.visit(ast.parse(source, filename=file))
    return lint.findings


def run_files(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        lint = _AsyncBodyLint(relpath(path))
        lint.visit(parse_file(path))
        findings.extend(lint.findings)
    return findings


@register("sim")
def run() -> List[Finding]:
    return run_files(iter_py_files(*SCAN_DIRS, exclude=IO_BOUNDARY))
