"""ouro-lint CLI for the PyTorch/CUDA port.

    python -m ouroboros_tpu_torch.analysis [--strict]
        [--passes protocol,torch,sim,conc,obs]
        [--baseline PATH | --no-baseline] [--write-baseline]
        [--format text|json|sarif]

Exit codes: 0 clean, 1 non-baselined findings (under --strict also stale
baseline entries), 2 internal error — identical across output formats,
so CI keys off the exit code and feeds the JSON/SARIF to annotations.
Baselined findings are printed but never block.  Runs fully on the CPU:
the passes are AST walks plus one import of the port's protocols
package, which imports no torch and touches no card.
"""
import argparse
import os
import sys

from ouroboros_tpu_torch.analysis import (
    BASELINE_PATH, Baseline, run_passes,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ouroboros_tpu_torch.analysis",
        description="ouro-lint: protocol-soundness, torch launch-path and "
                    "sim-determinism static analysis of the port")
    ap.add_argument("--strict", action="store_true",
                    help="also fail (exit 1) on stale baseline entries")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of: "
                         "protocol,torch,sim,conc,obs")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"),
                    help="output format (default text; json/sarif print "
                         "one document on stdout for CI/editors)")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help=f"baseline file (default {BASELINE_PATH})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: every finding blocks")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(then edit in the justifications)")
    args = ap.parse_args(argv)

    names = args.passes.split(",") if args.passes else None
    if args.write_baseline and not os.path.exists(args.baseline):
        on_disk = Baseline()               # creating a fresh baseline file
    else:
        on_disk = Baseline.load(args.baseline)  # typo'd path -> exit 2
    report = run_passes(names, Baseline() if args.no_baseline else on_disk)

    if args.write_baseline:
        regenerated = Baseline.from_findings(report.by_pass,
                                             existing=on_disk)
        regenerated.dump(args.baseline)
        print(f"wrote {sum(len(v) for v in regenerated.entries.values())} "
              f"entries to {args.baseline}")
        return 0

    if args.format != "text":
        import json as _json

        from ouroboros_tpu_torch.analysis.render import (
            report_to_json, report_to_sarif)
        doc = report_to_sarif(report) if args.format == "sarif" \
            else report_to_json(report, strict=args.strict)
        print(_json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in report.baselined:
            print(f"baselined: {f.render()}")
        for f in report.new:
            print(f.render())
        for pass_name, key in report.stale:
            print(f"stale baseline entry [{pass_name}]: {key[0]} {key[1]} "
                  f"[{key[2]}] — finding no longer exists; remove it")

        checked = ", ".join(f"{name}: {len(fs)} finding(s)"
                            for name, fs in sorted(report.by_pass.items()))
        print(f"ouro-lint: {checked}; {len(report.new)} blocking, "
              f"{len(report.baselined)} baselined, {len(report.stale)} stale")

    if report.new:
        return 1
    if args.strict and report.stale:
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:                      # internal error -> 2
        print(f"ouro-lint internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(2)
