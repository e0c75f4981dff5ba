"""Broken forms of the timed path, which `correct` has to catch.

Each wraps the backend a pass replays through (`harness.run`'s
`wrap_backend`), or patches the program for a run (`unchanged_state`):

- `skip_witnesses`: the control.  Transaction witnesses are never sent
  to the card and count as valid: the configuration's guarantee that
  every witness is verified, broken as a node that trusted its mempool
  would break it;
- `half_batch`, `half_batch_first`: the second or the first half of
  each window's requests is left out and counts as valid;
- `first_window_skipped`: every request of a pass's first window is left
  out and counts as valid;
- `accept_all`: the verdict altered where it is produced: every window
  reported valid;
- `altered_beta`: a VRF output altered where it is produced: a bit of
  every beta the card returns flipped;
- `unchanged_state`: a step that returns its state unchanged: the
  ledger's block application hands back the state it was given.

`python3 benchmark/faults.py --workload W --fault F --seeds a,b,c
--seconds S` runs whole runs of a cell on the card with one of them and
prints each run's `correct` and compared numbers.
"""
from __future__ import annotations

import contextlib


class _Wrapped:
    """A backend whose every other attribute is the wrapped one's."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _Dropping(_Wrapped):
    """Sends only `keep(reqs)` of a window to the card; the rest count as
    valid.  Verdicts are mapped back to the window's own indices."""

    def keep(self, reqs) -> list:
        raise NotImplementedError

    def submit_window(self, reqs, next_beta_proofs=(), fold=False):
        kept = self.keep(reqs)
        return (self.inner.submit_window([reqs[i] for i in kept],
                                         next_beta_proofs, fold=fold),
                kept, len(reqs))

    def finish_window(self, state):
        from ouroboros_tpu_torch.crypto.backend import WindowVerdict
        inner, kept, n = state
        ok, betas = self.inner.finish_window(inner)
        if isinstance(ok, WindowVerdict):
            return WindowVerdict(n, None if ok.first_bad is None
                                 else kept[ok.first_bad]), betas
        full = [True] * n
        for i, good in zip(kept, ok):
            full[i] = good
        return full, betas


class skip_witnesses(_Dropping):
    def keep(self, reqs) -> list:
        from ouroboros_tpu_torch.crypto.backend import Ed25519Req
        # a witness signs its transaction's 32-byte id; the certificate's
        # signature signs its longer CBOR body
        return [i for i, r in enumerate(reqs)
                if not (isinstance(r, Ed25519Req) and len(r.msg) == 32)]


class half_batch(_Dropping):
    def keep(self, reqs) -> list:
        return list(range(len(reqs) // 2))


class half_batch_first(_Dropping):
    def keep(self, reqs) -> list:
        return list(range(len(reqs) // 2, len(reqs)))


class first_window_skipped(_Dropping):
    """The wrapper is made anew for each pass (harness.run)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.seen = 0

    def keep(self, reqs) -> list:
        self.seen += 1
        return [] if self.seen == 1 else list(range(len(reqs)))


class accept_all(_Wrapped):
    def finish_window(self, state):
        from ouroboros_tpu_torch.crypto.backend import WindowVerdict
        ok, betas = self.inner.finish_window(state)
        if isinstance(ok, WindowVerdict):
            return WindowVerdict(ok.n, None), betas
        return [True] * len(ok), betas


def _alter(beta):
    return bytes([beta[0] ^ 1]) + beta[1:] if beta else beta


class altered_beta(_Wrapped):
    """Both ways betas leave the card: a window's carried betas and the
    plain prefetch of the first windows'."""

    def finish_window(self, state):
        ok, betas = self.inner.finish_window(state)
        return ok, {pi: _alter(b) for pi, b in betas.items()}

    def vrf_betas_batch(self, proofs):
        return [_alter(b) for b in self.inner.vrf_betas_batch(proofs)]


@contextlib.contextmanager
def unchanged_state():
    """The ledger's block application returns the state it was given."""
    from ouroboros_tpu_torch.eras.shelley import ShelleyLedger
    real = ShelleyLedger.reapply_block
    ShelleyLedger.reapply_block = lambda self, ticked, block: ticked
    try:
        yield
    finally:
        ShelleyLedger.reapply_block = real


WRAPPERS = {"skip_witnesses": skip_witnesses, "half_batch": half_batch,
            "half_batch_first": half_batch_first,
            "first_window_skipped": first_window_skipped,
            "accept_all": accept_all, "altered_beta": altered_beta}
FAULTS = tuple(WRAPPERS) + ("unchanged_state",)


def run_with(fault: str, workload: str, seed: int, seconds: float, **kw):
    """One run of the cell with `fault` in the timed path."""
    import harness
    if fault == "unchanged_state":
        with unchanged_state():
            return harness.run(workload, seed, seconds, False, **kw)
    return harness.run(workload, seed, seconds, False,
                       wrap_backend=WRAPPERS[fault], **kw)


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    caught = 0
    seeds = [int(s) for s in a.seeds.split(",")]
    for seed in seeds:
        out = run_with(a.fault, a.workload, seed, a.seconds,
                       say=lambda line: None)
        caught += not out["correct"]
        print(json.dumps({"fault": a.fault, "workload": a.workload,
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0 if caught == len(seeds) else 1


if __name__ == "__main__":
    import os
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import run  # noqa: F401  (the thread pools and caches, as a run sets them)
    raise SystemExit(main())
