"""How `correct` is decided: every pass of the window against the reference.

The reference (reference/) replays the same bytes block by block.  It
checks every block's envelope, leader value, certificate rules, nonces
and transactions, and verifies every proof and signature of a sample of
blocks drawn from the seed and of every tampered block.  From that it
knows, for the valid chain and for each tampered form of it, the
verdict of a replay (how many blocks are valid, whether it is
accepted) and the state after each window (the UTxO set, the nonces,
the issue numbers, the tip, the blocks each pool made).

Three numbers are compared, each against its limit of 0:

- `verdict_mismatches`: passes whose verdict is not the reference's;
- `state_mismatches`: (window, field) pairs of a pass's window states
  that are missing or differ from the reference's;
- `vrf_output_mismatches`: sampled VRF outputs, as the program cached
  them in a pass, that are not the reference's proof_to_hash, or that
  are missing although the pass checked their block.
"""
from __future__ import annotations

import random

import forge
from reference import chain, ledger, vrf

LIMITS = {"verdict_mismatches": 0, "state_mismatches": 0,
          "vrf_output_mismatches": 0}


def samples(blocks: list, check: dict, seed: int) -> tuple:
    """(indices of the blocks verified in full, [(block index, VRF
    proof)] whose outputs are compared), drawn from the seed."""
    rng = random.Random(f"check:{seed}")
    n = len(blocks)
    full = sorted(rng.sample(range(n), min(check["full_blocks"], n)))
    at = rng.sample(range(n), min(check["vrf_outputs"], n))
    proofs = [(i, chain.decode_block(blocks[i]).fields[
        chain.ETA if j % 2 else chain.LEADER]) for j, i in enumerate(at)]
    return full, proofs


def checked(n_blocks: int, variants: list) -> dict:
    """The blocks a pass over each form checks: the whole chain (-1), or
    a tampered form's blocks to the end of its tampered block's window,
    which is re-chained onto it."""
    out = {-1: n_blocks}
    for v, (_k, i, _raw, headers) in enumerate(variants):
        out[v] = i + 1 + len(headers)
    return out


class Expectation:
    """The reference's verdict and window states for each form of the
    chain: -1 the valid chain, v the chain with its v-th tampered block
    in place."""

    def __init__(self, g, blocks: list, variants: list, window: int,
                 full: list, proofs: list):
        self.g, self.stake, self.window = g, g.stake(), window
        self.full = set(full)
        at = {v[1] for v in variants}
        before: dict = {}              # block index -> state before it
        valid = self._replay(ledger.State.genesis(g), blocks, 0, at, before)
        self.outcome = {-1: valid[:2]}  # variant -> (n_valid, accepted)
        self.windows = {-1: valid[2]}   # variant -> {n_done: digest}
        self.checked = checked(len(blocks), variants)
        for v, (_k, i, raw, headers) in enumerate(variants):
            end = self.checked[v]
            form = ([raw] + [forge.with_header(blocks[j], h) for j, h
                             in enumerate(headers, i + 1)] + blocks[end:])
            n_valid, accepted, after = self._replay(before[i], form, i, {i})
            self.outcome[v] = (n_valid, accepted)
            self.windows[v] = dict(
                {k: d for k, d in valid[2].items() if k <= i}, **after)
        self.betas = {pi: (i, vrf.proof_to_hash(pi)) for i, pi in proofs}

    def _replay(self, st, blocks: list, start: int, verify: set,
                before: dict = None) -> tuple:
        """(n_valid, accepted, {n_done: digest}) of applying `blocks`,
        the first of them block `start`, to `st`; a window's state is
        kept once each of its blocks holds.  Blocks in `verify` or in the
        sample are verified in full; `before` gets the state before
        each block of `verify`."""
        windows = {}
        for j, raw in enumerate(blocks):
            i = start + j
            if before is not None and i in verify:
                before[i] = st
            try:
                st = ledger.apply_block(self.g, self.stake, st,
                                        chain.decode_block(raw),
                                        i in verify or i in self.full)
            except ledger.Invalid:
                return i, False, windows
            if (i + 1) % self.window == 0 or j == len(blocks) - 1:
                windows[i + 1] = st.digest()
        return start + len(blocks), True, windows

    def windows_of(self, variant: int) -> dict:
        return self.windows[variant]


def compare(expect: Expectation, records: list, digest) -> dict:
    """The compared numbers over every pass, each beside its limit."""
    verdicts = states = outputs = 0
    for rec in records:
        if expect.outcome[rec.variant] != (rec.n_valid, rec.accepted):
            verdicts += 1
        want = expect.windows_of(rec.variant)
        got = {n: digest(st) for n, st in rec.windows}
        for n, d in want.items():
            g = got.get(n)
            states += (len(d) if g is None
                       else sum(g.get(k) != v for k, v in d.items()))
        states += len(set(got) - set(want))
        for pi, (i, beta) in expect.betas.items():
            got = rec.betas.get(pi)
            outputs += (i < expect.checked[rec.variant] if got is None
                        else got != beta)
    numbers = {"verdict_mismatches": verdicts, "state_mismatches": states,
               "vrf_output_mismatches": outputs}
    return {name: {"value": v, "limit": LIMITS[name]}
            for name, v in numbers.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
