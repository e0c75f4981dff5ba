"""Pass 5 — observability hot-path lint (OBS001, OBS002).

A nop `Tracer` makes the trace() CALL free, but Python still evaluates
the call's ARGUMENT first: a dataclass event build or an f-string
formatted for a tracer that is not listening is pure hot-path waste —
exactly the cost the contra-tracer design exists to avoid.  On the
replay hot paths (crypto/, parallel/) every tracer call site whose
payload does work must therefore sit under a `tracer.active` guard:

    if tracer.active:
        tracer.trace(WindowDispatched(ne, nv, f"{key}"))   # ok
    tracer.trace(WindowDispatched(ne, nv))                 # OBS001
    tracer.trace(EVENT_CONSTANT)                           # ok (cheap)

- OBS001 unguarded-event-construction: `X.trace(arg)` / `X.trace(...)`
  via an attribute chain ending in `.trace`, or a bare/dotted
  `trace_event(...)` call, whose argument expression contains a Call,
  an f-string (JoinedStr), a `%`/`+` on strings or a comprehension —
  and no enclosing `if` whose test mentions `.active`.

- OBS002 unbound-instrument-observation (ISSUE 9): a histogram write
  through a FRESH registry lookup — `histogram("name").observe(v)` /
  `reg.histogram(...).observe(v)` (and the counter/gauge analogues
  `.inc(...)`/`.set(...)` chained onto a `counter(`/`gauge(` lookup).
  Registry creation is an idempotent dict probe plus a kind check —
  dozens of bytecode ops repeated per observation on paths that run
  per window or per tx.  Bind the handle ONCE at module/init scope:

    _LAT = _metrics.latency_histogram("pipeline.submit_drain_secs")
    ...
    _LAT.observe(dt)                                       # ok
    _metrics.histogram("pipeline...").observe(dt)          # OBS002

  OBS002 scans the whole ouroboros_tpu_torch package (any module may grow a
  hot loop); genuinely cold sites — a once-per-scrape handler — are
  tolerated via justified baseline entries.

- OBS003 dynamic-instrument-name (ISSUE 14): a metric name BUILT from
  runtime values — an f-string, `%`/`+` string concat, `.format(...)`
  or `str(...)` as the name argument of a registry factory
  (counter/gauge/histogram/latency_histogram).  A series per raw
  runtime value (peer addr, protocol number) is an unbounded-
  cardinality bomb on an O(100)-node net; route the dynamic part
  through the bounded-label helper instead:

    _net.labeled_counter("watchdog.firings_by_protocol",
                         protocol=proto)                   # ok
    _metrics.counter(f"watchdog.firings.{proto}")          # OBS003

  OBS003 scans the whole package; observe/netmetrics.py itself (the
  helper's implementation) is exempt.  Names bounded by construction
  (a small author-declared vocabulary, memoised per handle) are
  tolerated via justified baseline entries.

Cheap payloads (names, constants, attribute reads, plain tuples of
those) pass OBS001: a tuple build of locals is two bytecode ops, the
guard would cost as much as it saves.  Cold-path sites (an autotune
measurement that runs once per shape per process) are tolerated via
justified baseline entries, the same contract as every other pass.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from . import Finding, register, relpath
from .astutil import QualnameVisitor, dotted_name, iter_py_files, parse_file

SCAN_DIRS = ("ouroboros_tpu_torch/crypto", "ouroboros_tpu_torch/parallel")
# OBS002/OBS003 apply package-wide: pre-binding and bounded labels cost
# nothing, and hot loops appear outside crypto/ (pipeline drains,
# mempool admission, mux)
OBS2_SCAN_DIRS = ("ouroboros_tpu_torch",)
# the bounded-label helper builds labeled names BY DESIGN — exempt from
# its own rule
OBS3_EXEMPT_FILES = ("ouroboros_tpu_torch/observe/netmetrics.py",)

_TRACE_FN_NAMES = {"trace_event", "sim.trace_event"}

# instrument-factory name suffix -> the write method whose chaining we
# flag (quantile/snapshot reads on a fresh lookup are cold by nature)
_INSTRUMENT_WRITES = {"histogram": "observe",
                      "latency_histogram": "observe",
                      "counter": "inc",
                      "gauge": "set"}

# factory leafs whose NAME argument OBS003 inspects
_INSTRUMENT_FACTORIES = frozenset(_INSTRUMENT_WRITES)


def _is_trace_call(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Attribute) and node.func.attr == "trace":
        return True
    name = dotted_name(node.func)
    return name in _TRACE_FN_NAMES or (
        name is not None and name.endswith(".trace_event"))


def _expensive(node: ast.AST) -> bool:
    """Does evaluating this argument expression do real work?"""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Call, ast.JoinedStr, ast.ListComp,
                            ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            return True
        if isinstance(sub, ast.BinOp):
            # string build via % or + on anything non-constant-foldable
            if isinstance(sub.op, (ast.Mod, ast.Add)) and not (
                    isinstance(sub.left, ast.Constant)
                    and isinstance(sub.right, ast.Constant)):
                return True
    return False


def _guard_mentions_active(test: ast.AST) -> bool:
    return any(isinstance(sub, ast.Attribute) and sub.attr == "active"
               for sub in ast.walk(test))


def _dynamic_name_arg(node: ast.Call) -> bool:
    """Is this call's metric-name argument BUILT from runtime values —
    an f-string, a non-constant `%`/`+` concat, `.format(...)` or
    `str(...)`?  Plain names/attributes are not flagged (the rule
    targets construction at the call site, where the helper belongs)."""
    arg = None
    if node.args:
        arg = node.args[0]
    else:
        for kw in node.keywords:
            if kw.arg == "name":
                arg = kw.value
                break
    if arg is None:
        return False
    if isinstance(arg, ast.JoinedStr):
        return True
    if isinstance(arg, ast.BinOp) and isinstance(arg.op,
                                                 (ast.Mod, ast.Add)):
        return not (isinstance(arg.left, ast.Constant)
                    and isinstance(arg.right, ast.Constant))
    if isinstance(arg, ast.Call):
        if isinstance(arg.func, ast.Attribute) \
                and arg.func.attr == "format":
            return True
        return dotted_name(arg.func) == "str"
    return False


def _instrument_factory_call(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    if name is None:
        return False
    return name.rsplit(".", 1)[-1] in _INSTRUMENT_FACTORIES


def _unbound_instrument_write(node: ast.Call) -> bool:
    """Is `node` a metric write chained directly onto an instrument
    FACTORY call — `<...>.histogram("x").observe(v)` and friends?"""
    if not isinstance(node.func, ast.Attribute):
        return False
    recv = node.func.value
    if not isinstance(recv, ast.Call):
        return False
    factory = dotted_name(recv.func)
    if factory is None:
        return False
    leaf = factory.rsplit(".", 1)[-1]
    return _INSTRUMENT_WRITES.get(leaf) == node.func.attr


class _ObsLint(QualnameVisitor):
    def __init__(self, file: str, findings: List[Finding],
                 rules: Iterable[str] = ("OBS001", "OBS002")):
        super().__init__()
        self.file = file
        self.findings = findings
        self.rules = frozenset(rules)
        self._guard_depth = 0

    def visit_If(self, node: ast.If):
        guarded = _guard_mentions_active(node.test)
        self._guard_depth += guarded
        for child in node.body:
            self.visit(child)
        self._guard_depth -= guarded
        for child in node.orelse:
            self.visit(child)

    def visit_IfExp(self, node: ast.IfExp):
        guarded = _guard_mentions_active(node.test)
        self.visit(node.test)
        self._guard_depth += guarded
        self.visit(node.body)
        self._guard_depth -= guarded
        self.visit(node.orelse)

    def visit_Call(self, node: ast.Call):
        if "OBS001" in self.rules and _is_trace_call(node) \
                and self._guard_depth == 0:
            payload = list(node.args) + [kw.value for kw in node.keywords]
            if any(_expensive(a) for a in payload):
                self.findings.append(Finding(
                    file=self.file, line=node.lineno, rule="OBS001",
                    symbol=self.qualname,
                    message="event constructed (call/f-string) for a "
                            "tracer that may be nop; guard the call "
                            "site with `if tracer.active:` on hot "
                            "paths"))
        if "OBS002" in self.rules and _unbound_instrument_write(node):
            self.findings.append(Finding(
                file=self.file, line=node.lineno, rule="OBS002",
                symbol=self.qualname,
                message="instrument write through a fresh registry "
                        "lookup; pre-bind the handle once "
                        "(H = metrics.histogram(...)) at module/init "
                        "scope and call H.observe(v) on the hot path"))
        if "OBS003" in self.rules and _instrument_factory_call(node) \
                and _dynamic_name_arg(node):
            self.findings.append(Finding(
                file=self.file, line=node.lineno, rule="OBS003",
                symbol=self.qualname,
                message="metric name built from runtime values "
                        "(unbounded registry cardinality); route the "
                        "dynamic part through the bounded-label helper "
                        "(observe/netmetrics.py labeled_counter/"
                        "labeled_gauge/peer_label)"))
        self.generic_visit(node)


def lint_source(source: str, file: str,
                rules: Iterable[str] = ("OBS001", "OBS002", "OBS003")
                ) -> List[Finding]:
    """Run the OBS pass over one source text (fixture entry point)."""
    findings: List[Finding] = []
    _ObsLint(file, findings, rules).visit(
        ast.parse(source, filename=file))
    return sorted(set(findings))


def run_files(paths: Iterable[str],
              rules: Iterable[str] = ("OBS001", "OBS002", "OBS003")
              ) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        rel = relpath(path)
        file_rules = rules if rel not in OBS3_EXEMPT_FILES else \
            tuple(r for r in rules if r != "OBS003")
        lint = _ObsLint(rel, findings, file_rules)
        lint.visit(parse_file(path))
    return sorted(set(findings))


@register("obs")
def run() -> List[Finding]:
    # OBS001+OBS002+OBS003 on the crypto/parallel hot paths; OBS002+
    # OBS003 over the rest of the package (OBS001's tracer-payload rule
    # would drown in the cold protocol layers, where a guard costs more
    # than it saves — the unbound-handle and bounded-label rules are
    # cheap to satisfy anywhere)
    hot = set(iter_py_files(*SCAN_DIRS))
    findings = run_files(sorted(hot))
    rest = [p for p in iter_py_files(*OBS2_SCAN_DIRS) if p not in hot]
    findings += run_files(sorted(rest), rules=("OBS002", "OBS003"))
    return sorted(set(findings))
