"""perfgate — the measured BENCH trajectory as an ENFORCED gate.

    python -m ouroboros_tpu_torch.perfgate --check BENCH_r*.json
    python -m ouroboros_tpu_torch.perfgate BENCH_r01.json BENCH_r02.json ...

The repo's performance story lives in the BENCH_r01..rNN round files
(2.03x -> 5.30x -> 2.65x -> 5.66x -> 12.13x vs the CPU baseline so
far); until now that trajectory was prose in ROADMAP.md — a regression
like the r03 dip was only caught by a human reading the numbers.  This
tool turns it into a merge gate: the LATEST round is judged against the
rounds before it and the run fails (rc 1) on any of

- **vs_baseline drop**: latest ``vs_baseline`` below the best earlier
  round by more than ``--max-drop`` (default 0.25 — r03's 50% dip would
  have failed this gate the day it landed);
- **best-rep spread**: latest rep spread ((max-min)/median over timed
  reps) above ``--max-spread`` (default 0.45 — the BENCH_r05 "45% vrf
  spread" class of instability);
- **hidden fraction**: latest ``overlap.hidden_frac_median`` (the
  pipelined replay's host-under-device hiding, recorded since r06)
  below ``--min-hidden-frac`` (default 0.25) — the producer/consumer
  overlap silently degrading back to additive host+device time.

Checks only apply where the round records the field (early rounds lack
spread/overlap sections), so the gate passes on the committed
r01..r05 history as-is.

``--multichip MULTICHIP_r*.json`` additionally gates the MULTICHIP
trajectory (the mesh dryrun artifacts: ``{n_devices, rc, ok, tail}``
with a ``MULTICHIP_OBS {json}`` line in the stdout tail).
The latest multichip round must be green end to end:

- **rc**: exit code 0 — a timeout (rc 124) or budget overrun (rc 3) is
  a red round;
- **compile attribution**: the MULTICHIP_OBS line is present and
  carries at least one ``*_compile_secs`` field (a red with no
  attribution is the MULTICHIP_r05 failure mode the dryrun was
  rebuilt to prevent);
- **sharded replay parity**: the obs ``sharded_replay`` section reports
  ``state_hash_parity`` true (the real pipelined mesh replay).

The multichip checks only become BINDING once at least one recorded
round carries the ``sharded_replay`` section: historical rounds predate
the sharded pipelined replay (r01-r05 have no MULTICHIP_OBS at all, or
none with that section), and the gate reports their checks as skipped
instead of failing tier-1 retroactively.  From the first green sharded
round onward, a later red round fails the gate.

``--serve BENCH_r*.json`` gates the verification-service trajectory
(the ``serve`` section a bench round carries from r06 on) with the same
binding pattern: once any recorded round carries a ``serve`` section,
the latest round's saturated leg must hold ``vs_unbatched_cpu >= 5.0``
and ``p95_within_deadline`` — earlier rounds report their checks as
skipped.

Exit codes: 0 pass, 1 regression, 2 unreadable/unrecognised input.
One JSON verdict object is printed on stdout either way.

Ported from `tools/perfgate.py` (the port imports nothing of the JAX
package or of `tools/`). Copied whole: it loads rounds with the port's
`obsreport.load_bench`, reads round files and never writes one, and
comments and messages that named old issues are reworded.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional

# reuse obsreport's tolerant loader (raw bench JSON, harness-wrapped
# ``parsed``, JSON-line lists)
from .obsreport import load_bench

DEFAULT_MAX_DROP = 0.25
# rep-spread bound tightened 0.45 -> 0.35: the GC discipline and the
# ("vrff", m) autotune key removed the two known variance sources of the
# JAX package's rounds, so a 0.40-spread round is a regression again.
# Historic rounds were measured before those fixes and stay judged by
# the old bound — the tight one binds from r06 on.
DEFAULT_MAX_SPREAD = 0.35
LEGACY_MAX_SPREAD = 0.45
SPREAD_BINDS_FROM_ROUND = 6
DEFAULT_MIN_HIDDEN_FRAC = 0.25
# the acceptance bar the serve section was landed against:
# saturated coalescing must beat the unbatched per-request CPU baseline
# by 5x with p95 inside the deadline
SERVE_MIN_VS_UNBATCHED = 5.0


def _round_no(path: str) -> Optional[int]:
    m = re.search(r"_r(\d+)\.json$", os.path.basename(path))
    return int(m.group(1)) if m else None


def load_round(path: str) -> dict:
    """One trajectory point: the fields the gate judges, plus identity."""
    doc = load_bench(path)
    overlap = doc.get("overlap") or {}
    return {
        "path": os.path.basename(path),
        "round": _round_no(path),
        "metric": doc.get("metric"),
        "value": doc.get("value"),
        "vs_baseline": doc.get("vs_baseline"),
        "spread": doc.get("spread"),
        "hidden_frac": overlap.get("hidden_frac_median"),
    }


def check_trajectory(paths: List[str],
                     max_drop: float = DEFAULT_MAX_DROP,
                     max_spread: float = DEFAULT_MAX_SPREAD,
                     min_hidden_frac: float = DEFAULT_MIN_HIDDEN_FRAC
                     ) -> dict:
    """Judge the newest round of `paths` against the rest; returns the
    verdict dict ({"ok": bool, "checks": [...], ...}).  Raises ValueError
    on inputs that are not bench rounds (rc 2 at the CLI)."""
    if not paths:
        raise ValueError("no bench rounds given")
    rounds = [load_round(p) for p in paths]
    # newest last: by recorded round number when the filenames carry one,
    # else by the order given
    if all(r["round"] is not None for r in rounds):
        rounds.sort(key=lambda r: r["round"])
    latest, earlier = rounds[-1], rounds[:-1]
    checks: List[dict] = []

    def check(name: str, ok: Optional[bool], detail: str) -> None:
        checks.append({"check": name,
                       "result": ("skipped" if ok is None
                                  else "pass" if ok else "FAIL"),
                       "detail": detail})

    prev_best = max((r["vs_baseline"] for r in earlier
                     if r["vs_baseline"] is not None), default=None)
    if latest["vs_baseline"] is None or prev_best is None:
        check("vs_baseline", None, "field absent in latest or history")
    else:
        floor = prev_best * (1.0 - max_drop)
        check("vs_baseline", latest["vs_baseline"] >= floor,
              f"latest {latest['vs_baseline']}x vs best earlier "
              f"{prev_best}x (floor {floor:.3f}x at max_drop={max_drop})")

    if latest["spread"] is None:
        check("rep_spread", None, "no 'spread' field in latest round")
    else:
        # rounds measured before the r06 variance fixes are judged by
        # the legacy bound; the caller's (tighter) bound binds after
        rnd = latest["round"]
        bound = max_spread
        note = ""
        if rnd is not None and rnd < SPREAD_BINDS_FROM_ROUND:
            bound = max(max_spread, LEGACY_MAX_SPREAD)
            note = (f" (legacy bound: r{rnd:02d} predates the "
                    f"variance fixes; {max_spread} binds from "
                    f"r{SPREAD_BINDS_FROM_ROUND:02d})")
        check("rep_spread", latest["spread"] <= bound,
              f"latest rep spread {latest['spread']} vs allowed "
              f"{bound}{note}")

    if latest["hidden_frac"] is None:
        check("hidden_frac", None,
              "no 'overlap.hidden_frac_median' in latest round "
              "(rounds before r06 lack it)")
    else:
        check("hidden_frac", latest["hidden_frac"] >= min_hidden_frac,
              f"latest hidden_frac {latest['hidden_frac']} vs floor "
              f"{min_hidden_frac}")

    return {"ok": all(c["result"] != "FAIL" for c in checks),
            "latest": latest["path"],
            "rounds": [{"path": r["path"],
                        "vs_baseline": r["vs_baseline"]} for r in rounds],
            "thresholds": {"max_drop": max_drop,
                           "max_spread": max_spread,
                           "min_hidden_frac": min_hidden_frac},
            "checks": checks}


# ---------------------------------------------------------------------------
# Verification-service gate over the ``serve`` section
# ---------------------------------------------------------------------------

def check_serve(paths: List[str],
                min_vs_unbatched: float = SERVE_MIN_VS_UNBATCHED) -> dict:
    """Judge the newest round's ``serve`` section.  Binding only once
    some recorded round carries one (bench emits it from r06 on); the
    pre-service history reports skipped — the --multichip pattern."""
    if not paths:
        raise ValueError("no bench rounds given")
    rounds = []
    for p in paths:
        doc = load_bench(p)
        rounds.append({"path": os.path.basename(p),
                       "round": _round_no(p),
                       "serve": doc.get("serve")})
    if all(r["round"] is not None for r in rounds):
        rounds.sort(key=lambda r: r["round"])
    latest = rounds[-1]
    binding = any(r["serve"] for r in rounds)
    sat = (latest["serve"] or {}).get("saturated") or {}
    checks: List[dict] = []

    def check(name: str, ok: bool, detail: str) -> None:
        if not binding:
            result = "skipped"
            detail += " [advisory: no serve-section round recorded yet]"
        else:
            result = "pass" if ok else "FAIL"
        checks.append({"check": name, "result": result, "detail": detail})

    vs = sat.get("vs_unbatched_cpu")
    check("serve_vs_unbatched",
          vs is not None and vs >= min_vs_unbatched,
          f"latest saturated vs_unbatched_cpu {vs} vs floor "
          f"{min_vs_unbatched}")
    check("serve_p95_deadline", sat.get("p95_within_deadline") is True,
          f"latest saturated p95_within_deadline="
          f"{sat.get('p95_within_deadline')} "
          f"(deadline {(latest['serve'] or {}).get('deadline_secs')}s)")

    return {"ok": all(c["result"] != "FAIL" for c in checks),
            "latest": latest["path"],
            "binding": binding,
            "rounds": [{"path": r["path"],
                        "has_serve": bool(r["serve"])} for r in rounds],
            "checks": checks}


# ---------------------------------------------------------------------------
# MULTICHIP trajectory gate
# ---------------------------------------------------------------------------

def load_multichip_round(path: str) -> dict:
    """One multichip trajectory point: the harness record's rc plus the
    MULTICHIP_OBS object recovered from the stored stdout tail (absent on
    rounds that died before printing it — exactly the red shape the rc
    check exists for)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "rc" not in doc:
        raise ValueError(f"{path}: not a multichip round (no 'rc' field)")
    obs = None
    for line in (doc.get("tail") or "").splitlines():
        marker = line.find("MULTICHIP_OBS ")
        if marker < 0:
            continue
        try:
            obs = json.loads(line[marker + len("MULTICHIP_OBS "):])
        except json.JSONDecodeError:
            pass          # truncated tail: treat as unattributed
    return {"path": os.path.basename(path),
            "round": _round_no(path),
            "rc": doc.get("rc"),
            "n_devices": doc.get("n_devices"),
            "obs": obs}


def _compile_attributed(obs: Optional[dict]) -> bool:
    return bool(obs) and any(k.endswith("_compile_secs")
                             and obs[k] is not None for k in obs)


def check_multichip(paths: List[str]) -> dict:
    """Judge the newest MULTICHIP round; returns a verdict dict like
    check_trajectory's.  Checks are binding only once some recorded
    round carries the ``sharded_replay`` obs section (see module doc)."""
    if not paths:
        raise ValueError("no multichip rounds given")
    rounds = [load_multichip_round(p) for p in paths]
    if all(r["round"] is not None for r in rounds):
        rounds.sort(key=lambda r: r["round"])
    latest = rounds[-1]
    binding = any(r["obs"] and "sharded_replay" in r["obs"]
                  for r in rounds)
    checks: List[dict] = []

    def check(name: str, ok: bool, detail: str) -> None:
        if not binding:
            result = "skipped"
            detail += " [advisory: no sharded-replay round recorded yet]"
        else:
            result = "pass" if ok else "FAIL"
        checks.append({"check": name, "result": result, "detail": detail})

    check("rc", latest["rc"] == 0,
          f"latest {latest['path']} rc={latest['rc']}")
    check("compile_attribution", _compile_attributed(latest["obs"]),
          "MULTICHIP_OBS line with *_compile_secs fields "
          + ("present" if _compile_attributed(latest["obs"]) else "MISSING"))
    sharded = (latest["obs"] or {}).get("sharded_replay") or {}
    check("sharded_replay_parity",
          sharded.get("state_hash_parity") is True,
          f"latest sharded_replay section: "
          f"{ {k: sharded[k] for k in sorted(sharded) if k != 'padding'} }"
          if sharded else "no sharded_replay section in latest round")

    return {"ok": all(c["result"] != "FAIL" for c in checks),
            "latest": latest["path"],
            "binding": binding,
            "rounds": [{"path": r["path"], "rc": r["rc"],
                        "attributed": _compile_attributed(r["obs"])}
                       for r in rounds],
            "checks": checks}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ouroboros_tpu_torch.perfgate",
        description="fail (rc 1) when the newest BENCH round regresses "
                    "the measured trajectory")
    ap.add_argument("paths", nargs="*", help="BENCH_rNN.json round files")
    ap.add_argument("--check", nargs="+", default=[], metavar="PATH",
                    help="additional round files (alias for positionals)")
    ap.add_argument("--max-drop", type=float, default=DEFAULT_MAX_DROP,
                    help="max fractional vs_baseline drop from the best "
                         f"earlier round (default {DEFAULT_MAX_DROP})")
    ap.add_argument("--max-spread", type=float,
                    default=DEFAULT_MAX_SPREAD,
                    help="max rep spread in the latest round "
                         f"(default {DEFAULT_MAX_SPREAD})")
    ap.add_argument("--min-hidden-frac", type=float,
                    default=DEFAULT_MIN_HIDDEN_FRAC,
                    help="min pipelined-replay hidden fraction "
                         f"(default {DEFAULT_MIN_HIDDEN_FRAC})")
    ap.add_argument("--multichip", nargs="+", default=[], metavar="PATH",
                    help="MULTICHIP_rNN.json round files: gate the mesh "
                         "dryrun trajectory (rc=0, compile attribution, "
                         "sharded replay parity) alongside — or instead "
                         "of — the BENCH rounds")
    ap.add_argument("--serve", nargs="+", default=[], metavar="PATH",
                    help="BENCH_rNN.json round files: gate the "
                         "verification-service serve section (saturated "
                         f"vs_unbatched >= {SERVE_MIN_VS_UNBATCHED}x, "
                         "p95 inside the deadline); rounds predating "
                         "the section report skipped")
    args = ap.parse_args(argv)
    paths = list(args.paths) + list(args.check)
    if not paths and not args.multichip and not args.serve:
        print("perfgate: no rounds given", file=sys.stderr)
        return 2
    verdict: dict = {"ok": True}
    try:
        if paths:
            verdict = check_trajectory(
                paths, max_drop=args.max_drop,
                max_spread=args.max_spread,
                min_hidden_frac=args.min_hidden_frac)
        if args.multichip:
            mc = check_multichip(args.multichip)
            verdict["multichip"] = mc
            verdict["ok"] = verdict["ok"] and mc["ok"]
        if args.serve:
            sv = check_serve(args.serve)
            verdict["serve"] = sv
            verdict["ok"] = verdict["ok"] and sv["ok"]
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"perfgate: cannot judge trajectory: {e}", file=sys.stderr)
        return 2
    print(json.dumps(verdict, indent=2, sort_keys=True))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
