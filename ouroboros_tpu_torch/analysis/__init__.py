"""ouro-lint — static analysis for the PyTorch/CUDA port
(`ouroboros_tpu_torch`).

A copy of the JAX package's tool (`tools/analysis/`) over the port's own
modules, with a torch pass in place of its JAX pass.  The Haskell
reference gets mini-protocol conformance at compile time (typed-protocols
GADTs); the Python rebuild moved those guarantees to runtime
(network/typed.py).  This package restores a compile-time-shaped safety
net as registry/AST-driven passes:

- protocol  (protocol_pass.py): ProtocolSpec soundness — agency totality,
  transition well-formedness, reachability, codec coverage.
- torch     (torch_pass.py): host syncs in the kernels' launch paths,
  CUDA work at import time, and kernel libraries or CUDA streams built
  inside loops, under crypto/ and parallel/.
- sim       (sim_pass.py): real-clock / real-IO / nondeterminism leaks in
  async code that runs on the deterministic Sim scheduler.
- conc      (conc_pass.py): STM concurrency idioms that create races.
- obs       (obs_pass.py): unguarded event construction at Tracer call
  sites on the crypto/parallel hot paths.

Findings are structured (file, line, rule, symbol, message).  A committed
`baseline.json` suppresses known pre-existing findings by
(file, rule, symbol) — line-independent, so unrelated edits don't churn
the baseline.  Run `python -m ouroboros_tpu_torch.analysis --strict`
(exit 0 clean, 1 findings, 2 internal error); see README.md for the rule
catalog.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


@dataclass(frozen=True, order=True)
class Finding:
    """One lint result.  `symbol` is the enclosing def/class qualname (AST
    passes) or the spec/attr name (protocol pass) — the stable identity the
    baseline matches on, so findings survive line drift."""
    file: str       # repo-relative, forward slashes
    line: int
    rule: str       # e.g. "PROTO001"
    symbol: str
    message: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.file, self.rule, self.symbol)

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.symbol}] " \
               f"{self.message}"


def relpath(path: str) -> str:
    return os.path.relpath(os.path.abspath(path), REPO_ROOT).replace(
        os.sep, "/")


# --- pass registry ----------------------------------------------------------

PASSES: Dict[str, Callable[[], List[Finding]]] = {}


def register(name: str):
    def deco(fn):
        PASSES[name] = fn
        return fn
    return deco


def _ensure_passes_loaded() -> None:
    from . import (  # noqa: F401
        conc_pass, obs_pass, protocol_pass, sim_pass, torch_pass,
    )


# --- baseline ---------------------------------------------------------------

@dataclass
class Baseline:
    """Per-pass suppression sets.  Each entry carries a justification so the
    reason a finding is tolerated is reviewable next to the suppression."""
    entries: Dict[str, List[dict]] = field(default_factory=dict)

    def keys_for(self, pass_name: str) -> Dict[Tuple[str, str, str], str]:
        out = {}
        for e in self.entries.get(pass_name, []):
            out[(e["file"], e["rule"], e["symbol"])] = e.get(
                "justification", "")
        return out

    @classmethod
    def load(cls, path: str = BASELINE_PATH) -> "Baseline":
        if not os.path.exists(path):
            if os.path.abspath(path) != os.path.abspath(BASELINE_PATH):
                # a typo'd --baseline path must not silently drop every
                # committed suppression; only the default may be absent
                raise FileNotFoundError(f"baseline file not found: {path}")
            return cls()
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: baseline must be a JSON object")
        for name, items in data.items():
            for e in items:
                for k in ("file", "rule", "symbol", "justification"):
                    if k not in e:
                        raise ValueError(
                            f"{path}: baseline entry in {name!r} missing "
                            f"{k!r}: {e}")
        return cls(entries=data)

    @classmethod
    def from_findings(cls, by_pass: Dict[str, List[Finding]],
                      existing: Optional["Baseline"] = None) -> "Baseline":
        """Baseline regenerated from current findings.  Sections for passes
        not in `by_pass` and justifications for keys that persist are
        carried over from `existing` — a rewrite never silently drops
        hand-written suppressions for passes that didn't run."""
        existing = existing or cls()
        entries = dict(existing.entries)
        for name, fs in sorted(by_pass.items()):
            kept = existing.keys_for(name)
            # dedup by the baseline's own identity (file, rule, symbol):
            # two findings in one symbol (e.g. a set_notify + its _value
            # fallback) must yield ONE entry, or edits leave a
            # contradictory twin the matcher can never distinguish
            seen: set = set()
            entries[name] = []
            for f in sorted(set(fs)):
                if f.key in seen:
                    continue
                seen.add(f.key)
                entries[name].append(
                    {"file": f.file, "rule": f.rule, "symbol": f.symbol,
                     "justification": kept.get(f.key)
                     or "TODO: justify or fix"})
        return cls(entries=entries)

    def dump(self, path: str = BASELINE_PATH) -> None:
        """Canonical form: sections alphabetical, entries sorted by
        (file, rule, symbol), entry keys in (file, rule, symbol,
        justification) order.  load->dump round-trips byte-identically,
        so a --write-baseline on an unchanged tree produces a zero-line
        diff (tests/test_static_analysis.py gates this)."""
        data = {
            name: [{"file": e["file"], "rule": e["rule"],
                    "symbol": e["symbol"],
                    "justification": e.get("justification", "")}
                   for e in sorted(self.entries[name],
                                   key=lambda e: (e["file"], e["rule"],
                                                  e["symbol"]))]
            for name in sorted(self.entries)
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
            f.write("\n")


@dataclass
class Report:
    """Outcome of a full run: findings split by baseline status."""
    by_pass: Dict[str, List[Finding]]
    new: List[Finding]            # not in the baseline — blocking
    baselined: List[Finding]      # suppressed, still visible
    stale: List[Tuple[str, Tuple[str, str, str]]]  # baseline w/o finding


def run_passes(names: Optional[List[str]] = None,
               baseline: Optional[Baseline] = None) -> Report:
    _ensure_passes_loaded()
    names = names or sorted(PASSES)
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es): {unknown}; "
                         f"have {sorted(PASSES)}")
    baseline = baseline if baseline is not None else Baseline()
    by_pass: Dict[str, List[Finding]] = {}
    new: List[Finding] = []
    old: List[Finding] = []
    stale: List[Tuple[str, Tuple[str, str, str]]] = []
    for name in names:
        findings = sorted(PASSES[name]())
        by_pass[name] = findings
        suppressed = baseline.keys_for(name)
        seen = set()
        for f in findings:
            if f.key in suppressed:
                old.append(f)
                seen.add(f.key)
            else:
                new.append(f)
        for key in suppressed:
            if key not in seen:
                stale.append((name, key))
    return Report(by_pass=by_pass, new=new, baselined=old, stale=stale)
