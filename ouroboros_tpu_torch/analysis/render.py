"""Machine-readable ouro-lint output: --format json / sarif.

Text stays the CLI default; these renderers exist so CI annotates PRs
and editors ingest findings without scraping.  Both are pure functions
of a Report — no IO, no exit-code logic (that stays in __main__).

JSON is the tool's own stable schema (versioned, keys sorted); SARIF is
the minimal valid subset of SARIF 2.1.0 that GitHub code scanning and
VS Code's SARIF viewer accept: one run, one driver, explicit rule
metadata, one result per finding with a physical location.  Baselined
findings are emitted at level "note" with suppression metadata so
consumers can distinguish them from blocking ("error") findings; stale
baseline entries ride along in JSON (SARIF has no natural slot for a
finding that does NOT exist, so they are JSON-only).
"""
from __future__ import annotations

from typing import Dict, List

from . import Finding, Report

JSON_SCHEMA_VERSION = 1
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

# one-line rule descriptions surfaced as SARIF rule metadata; kept here
# (not in the pass modules) so the renderer imports no pass code
_RULE_DESCRIPTIONS = {
    "PROTO": "ProtocolSpec soundness (agency/reachability/codec)",
    "TORCH": "PyTorch/CUDA launch-path hazard (host sync / CUDA work at "
             "import / library or stream built in a loop)",
    "SIM": "sim-determinism leak (real clock/IO/RNG in async code)",
    "CONC": "STM concurrency hazard (see analysis/conc_pass.py)",
}


def _finding_dict(f: Finding) -> dict:
    return {"file": f.file, "line": f.line, "rule": f.rule,
            "symbol": f.symbol, "message": f.message}


def report_to_json(report: Report, strict: bool) -> dict:
    """The CLI's own schema: everything the text output says, typed."""
    blocking = bool(report.new) or (strict and bool(report.stale))
    return {
        "schema_version": JSON_SCHEMA_VERSION,
        "tool": "ouro-lint",
        "strict": strict,
        "blocking": blocking,
        "summary": {name: len(fs)
                    for name, fs in sorted(report.by_pass.items())},
        "new": [_finding_dict(f) for f in report.new],
        "baselined": [_finding_dict(f) for f in report.baselined],
        "stale": [{"pass": name, "file": key[0], "rule": key[1],
                   "symbol": key[2]} for name, key in report.stale],
    }


def _sarif_rules(findings: List[Finding]) -> List[dict]:
    rules: Dict[str, dict] = {}
    for f in findings:
        if f.rule in rules:
            continue
        prefix = f.rule.rstrip("0123456789")
        rules[f.rule] = {
            "id": f.rule,
            "shortDescription": {
                "text": _RULE_DESCRIPTIONS.get(prefix, f.rule)},
        }
    return [rules[r] for r in sorted(rules)]


def _sarif_result(f: Finding, baselined: bool) -> dict:
    res = {
        "ruleId": f.rule,
        "level": "note" if baselined else "error",
        "message": {"text": f"[{f.symbol}] {f.message}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.file,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(f.line, 1)},
            }}],
    }
    if baselined:
        res["suppressions"] = [{"kind": "external",
                                "justification": "baseline.json"}]
    return res


def report_to_sarif(report: Report) -> dict:
    findings = report.new + report.baselined
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "ouro-lint",
                "informationUri":
                    "ouroboros_tpu_torch/analysis/README.md",
                "rules": _sarif_rules(findings),
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": [_sarif_result(f, baselined=False)
                        for f in report.new]
                       + [_sarif_result(f, baselined=True)
                          for f in report.baselined],
        }],
    }
