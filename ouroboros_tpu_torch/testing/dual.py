"""Dual ledger — impl vs executable-spec lockstep conformance oracle.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Ledger/Dual.hs (the
DualBlock machinery running the production ledger and the executable spec
side by side, failing on ANY observable divergence) and the byronspec
package it pairs with (SURVEY.md §2 ouroboros-consensus-byronspec).

The specs here are deliberately naive re-implementations of the era rules
over plain dicts — recomputed from scratch wherever the production ledger
keeps incremental state (stake snapshots, frozen tuples, sorted indexes) —
so lockstep runs catch exactly the bookkeeping bugs incremental code
grows.

Ported from `ouroboros_tpu/testing/dual.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..consensus.ledger import LedgerError, LedgerRules
from ..eras.byron import CERT_DLG, CERT_UPDATE
from ..eras.shelley import (
    CERT_DELEG, CERT_POOL, CERT_RETIRE, ISSUER_FIELD, pool_id_of,
)


class DualLedgerMismatch(AssertionError):
    """The implementation diverged from the executable spec."""


# ---------------------------------------------------------------------------
# Executable specs (plain-dict semantics, no incremental state)
# ---------------------------------------------------------------------------

def _spec_verify_witnesses(tx) -> set:
    """Signature validity straight from the reference crypto (the spec may
    use the ground-truth primitive); returns the set of witnessing vks."""
    from ..crypto import ed25519_ref
    vks = set()
    for vk, sig in tx.witnesses:
        if not ed25519_ref.verify(vk, tx.txid, sig):
            raise LedgerError("spec: invalid witness signature")
        vks.add(vk)
    return vks


class ByronSpec:
    """UTxO + heavyweight delegation, straight from the rules."""

    def __init__(self, genesis: dict, genesis_vks, initial_delegates):
        self.utxo = {(b"\x00" * 32, ix): (addr, amt)
                     for ix, (addr, amt) in enumerate(
                         sorted(genesis.items()))}
        self.genesis_vks = list(genesis_vks)
        self.delegates = list(initial_delegates)
        self.update_epoch = -1

    def apply_tx(self, tx) -> None:
        wit_vks = _spec_verify_witnesses(tx)
        for key in tx.inputs:
            if key in self.utxo and self.utxo[key][0] not in wit_vks:
                raise LedgerError("spec: spend without witness")
        for kind, arg, vk in tx.certs:
            if kind == CERT_DLG:
                gix = int.from_bytes(arg, "big")
                if not 0 <= gix < len(self.genesis_vks) \
                        or self.genesis_vks[gix] not in wit_vks:
                    raise LedgerError("spec: unwitnessed delegation")
            elif kind == CERT_UPDATE:
                if not any(v in wit_vks for v in self.genesis_vks):
                    raise LedgerError("spec: unwitnessed update")
        if len(set(tx.inputs)) != len(tx.inputs):
            raise LedgerError("spec: duplicate inputs")
        spent = 0
        for key in tx.inputs:
            if key not in self.utxo:
                raise LedgerError("spec: missing input")
            spent += self.utxo[key][1]
        if any(m < 0 for _a, m in tx.outputs):
            raise LedgerError("spec: negative output")
        if sum(m for _a, m in tx.outputs) > spent:
            raise LedgerError("spec: overspend")
        for kind, arg, vk in tx.certs:
            if kind == CERT_DLG:
                gix = int.from_bytes(arg, "big")
                if not 0 <= gix < len(self.delegates):
                    raise LedgerError("spec: unknown genesis key")
                self.delegates[gix] = vk
            elif kind == CERT_UPDATE:
                self.update_epoch = int.from_bytes(arg, "big")
            else:
                raise LedgerError("spec: unknown cert")
        for key in tx.inputs:
            del self.utxo[key]
        for ix, (addr, amt) in enumerate(tx.outputs):
            self.utxo[(tx.txid, ix)] = (addr, amt)

    def observe(self) -> dict:
        return {"utxo": dict(self.utxo),
                "delegates": tuple(self.delegates),
                "update_epoch": self.update_epoch}


class ShelleySpec:
    """UTxO + pools + delegation + per-epoch stake recomputation from
    scratch (vs the impl's incremental mark/set snapshot rotation)."""

    def __init__(self, genesis: dict, config, initial_pools,
                 initial_delegs, era: str = "shelley",
                 initial_reserves: int = 1_000_000):
        self.utxo = {(b"\x00" * 32, ix): (addr, amt, ())
                     for ix, (addr, amt) in enumerate(
                         sorted(genesis.items()))}
        self.pools = dict(initial_pools)
        self.delegs = dict(initial_delegs)
        self.config = config
        self.era = era
        self.epoch = 0
        # snapshots as plain recomputations
        self.snap_mark = self._stake()
        self.snap_set = dict(self.snap_mark)
        self.snap_go = dict(self.snap_mark)
        self.reserves = initial_reserves
        self.treasury = 0
        self.rewards: dict = {}
        self.retiring: dict = {}
        self.blocks_made: dict = {}

    def _stake(self) -> dict:
        by_addr: dict = {}
        for (_t, _i), (addr, amt, _assets) in self.utxo.items():
            by_addr[addr] = by_addr.get(addr, 0) + amt
        out: dict = {}
        for addr, pid in self.delegs.items():
            if pid in self.pools:
                out[pid] = out.get(pid, 0) + by_addr.get(addr, 0)
        return {p: s for p, s in out.items() if s > 0}

    def note_block(self, issuer_vk) -> None:
        if issuer_vk is not None:
            pid = pool_id_of(issuer_vk)
            self.blocks_made[pid] = self.blocks_made.get(pid, 0) + 1

    def tick_to(self, slot: int) -> None:
        cfg = self.config
        target = slot // cfg.epoch_length
        while self.epoch < target:
            self.epoch += 1
            # rewards: rho of reserves -> pot, tau of pot -> treasury,
            # rest split over the GO snapshot by stake x performance
            pot = self.reserves * cfg.rho.numerator // cfg.rho.denominator
            if pot:
                cut = pot * cfg.tau.numerator // cfg.tau.denominator
                distributable = pot - cut
                total_go = sum(self.snap_go.values())
                total_blocks = sum(self.blocks_made.values())
                paid = 0
                if total_go and total_blocks:
                    for pid in sorted(self.snap_go):
                        stake = self.snap_go[pid]
                        base = distributable * stake // total_go
                        expected = max(1, total_blocks * stake // total_go)
                        r = base * min(self.blocks_made.get(pid, 0),
                                       expected) // expected
                        if r:
                            self.rewards[pid] = self.rewards.get(pid, 0) + r
                            paid += r
                self.reserves -= cut + paid
                self.treasury += cut
            # rotation go <- set <- mark <- live
            self.snap_go = dict(self.snap_set)
            self.snap_set = dict(self.snap_mark)
            self.snap_mark = self._stake()
            # retirement
            due = {p for p, e in self.retiring.items() if e <= self.epoch}
            for p in due:
                self.pools.pop(p, None)
                self.retiring.pop(p, None)
            if due:
                self.delegs = {a: p for a, p in self.delegs.items()
                               if p not in due}
            self.blocks_made = {}

    def apply_tx(self, tx, slot: int) -> None:
        # feature gating (era-indexed tx admission)
        family = ("shelley", "allegra", "mary")
        ix = family.index(self.era)
        if tx.validity:
            if ix < family.index("allegra"):
                raise LedgerError("spec: validity needs allegra+")
            before, after = tx.validity
            if (before >= 0 and slot < before) or \
                    (after >= 0 and slot > after):
                raise LedgerError("spec: outside validity interval")
        if (tx.mint or any(assets for _a, _m, assets in tx.outputs)) \
                and ix < family.index("mary"):
            raise LedgerError("spec: multi-asset needs mary")
        # witnesses: signature validity + structural coverage
        wit_vks = _spec_verify_witnesses(tx)
        for key in tx.inputs:
            if key in self.utxo and self.utxo[key][0] not in wit_vks:
                raise LedgerError("spec: spend without witness")
        for kind, a, _b in tx.certs:
            if kind in (CERT_POOL, CERT_DELEG, CERT_RETIRE) \
                    and a not in wit_vks:
                raise LedgerError("spec: unwitnessed certificate")
        policies = {pool_id_of(vk) for vk in wit_vks}
        for aid, _q in tx.mint:
            if aid not in policies:
                raise LedgerError("spec: unwitnessed mint policy")
        wds = getattr(tx, "withdrawals", ())
        if len({p for p, _a in wds}) != len(wds):
            raise LedgerError("spec: duplicate withdrawals")
        for pid, _amt in wds:
            if pid not in policies:
                raise LedgerError("spec: unwitnessed withdrawal")
        if len(set(tx.inputs)) != len(tx.inputs):
            raise LedgerError("spec: duplicate inputs")
        spent = 0
        consumed: dict = {}
        for key in tx.inputs:
            if key not in self.utxo:
                raise LedgerError("spec: missing input")
            _a, amt, assets = self.utxo[key]
            spent += amt
            for aid, q in assets:
                consumed[aid] = consumed.get(aid, 0) + q
        for pid, amt in getattr(tx, "withdrawals", ()):
            if amt <= 0 or amt != self.rewards.get(pid, 0):
                raise LedgerError("spec: withdrawal != reward balance")
            spent += amt
        for aid, q in tx.mint:
            consumed[aid] = consumed.get(aid, 0) + q
        produced = 0
        produced_assets: dict = {}
        for _a, amt, assets in tx.outputs:
            if amt < 0:
                raise LedgerError("spec: negative output")
            produced += amt
            for aid, q in assets:
                if q <= 0:
                    raise LedgerError("spec: non-positive output asset")
                produced_assets[aid] = produced_assets.get(aid, 0) + q
        if produced > spent:
            raise LedgerError("spec: overspend")
        if produced_assets != {a: q for a, q in consumed.items() if q}:
            raise LedgerError("spec: asset imbalance")
        for kind, a, b in tx.certs:
            if kind == CERT_POOL:
                self.pools[pool_id_of(a)] = b
                self.retiring.pop(pool_id_of(a), None)
            elif kind == CERT_DELEG:
                if b not in self.pools:
                    raise LedgerError("spec: unregistered pool")
                self.delegs[a] = b
            elif kind == CERT_RETIRE:
                pid = pool_id_of(a)
                if pid not in self.pools:
                    raise LedgerError("spec: retiring unregistered pool")
                epoch = int.from_bytes(b, "big")
                if epoch <= self.epoch:
                    raise LedgerError("spec: retirement not in the future")
                self.retiring[pid] = epoch
            else:
                raise LedgerError("spec: unknown cert")
        for pid, _amt in getattr(tx, "withdrawals", ()):
            del self.rewards[pid]
        for key in tx.inputs:
            del self.utxo[key]
        for ix, (addr, amt, assets) in enumerate(tx.outputs):
            self.utxo[(tx.txid, ix)] = (addr, amt, assets)

    def observe(self) -> dict:
        return {"utxo": dict(self.utxo), "pools": dict(self.pools),
                "delegs": dict(self.delegs), "epoch": self.epoch,
                "snap_set": dict(self.snap_set),
                "snap_mark": dict(self.snap_mark),
                "snap_go": dict(self.snap_go),
                "reserves": self.reserves, "treasury": self.treasury,
                "rewards": dict(self.rewards),
                "retiring": dict(self.retiring),
                "blocks_made": dict(self.blocks_made)}


# ---------------------------------------------------------------------------
# The lockstep wrapper
# ---------------------------------------------------------------------------

def _observe_byron_impl(state) -> dict:
    return {"utxo": {(t, i): (a, m) for t, i, a, m in state.utxo},
            "delegates": tuple(state.delegates),
            "update_epoch": state.update_epoch}


def _observe_shelley_impl(state) -> dict:
    return {"utxo": {(t, i): (a, m, assets)
                     for t, i, a, m, assets in state.utxo},
            "pools": dict(state.pools),
            "delegs": dict(state.delegs),
            "epoch": state.epoch,
            "snap_set": {p: s for p, s, _v in state.snap_set},
            "snap_mark": {p: s for p, s, _v in state.snap_mark},
            "snap_go": {p: s for p, s, _v in state.snap_go},
            "reserves": state.reserves, "treasury": state.treasury,
            "rewards": dict(state.rewards),
            "retiring": dict(state.retiring),
            "blocks_made": dict(state.blocks_made)}


@dataclass
class DualResult:
    impl_error: Optional[Exception]
    spec_error: Optional[Exception]


class DualLedger:
    """Run the production LedgerRules and the spec in lockstep
    (Dual.hs agreeOnError + state comparison after every block)."""

    def __init__(self, impl: LedgerRules, impl_state, spec,
                 observe_impl, era: str):
        self.impl = impl
        self.state = impl_state
        self.spec = spec
        self.observe_impl = observe_impl
        self.era = era

    def _compare(self) -> None:
        a = self.observe_impl(self.state)
        b = self.spec.observe()
        if a != b:
            keys = [k for k in a if a[k] != b.get(k)]
            raise DualLedgerMismatch(
                f"impl/spec divergence in {keys}: "
                f"impl={ {k: a[k] for k in keys} } "
                f"spec={ {k: b.get(k) for k in keys} }")

    def apply_block(self, block, backend=None) -> DualResult:
        """Apply to both; errors must AGREE (both reject or both accept),
        and accepted states must observe equal.  The impl rejects blocks
        atomically, so the spec runs on a copy that is committed only on
        success — a rejected block must leave BOTH sides untouched."""
        import copy
        impl_err = spec_err = None
        ticked = self.impl.tick(self.state, block.slot)
        try:
            new_state = self.impl.apply_block(ticked, block,
                                              backend=backend)
        except LedgerError as e:
            impl_err = e
        spec_try = copy.deepcopy(self.spec)
        if self.era == "shelley":
            try:
                spec_try.tick_to(block.slot)
                for tx in block.body:
                    spec_try.apply_tx(tx, block.slot)
                # block-production accounting (BlocksMade), mirroring the
                # impl's header-issuer bookkeeping
                header = getattr(block, "header", None)
                if header is not None and hasattr(header, "get"):
                    spec_try.note_block(header.get(ISSUER_FIELD))
            except LedgerError as e:
                spec_err = e
        else:
            try:
                for tx in block.body:
                    spec_try.apply_tx(tx)
            except LedgerError as e:
                spec_err = e
        if (impl_err is None) != (spec_err is None):
            raise DualLedgerMismatch(
                f"impl error={impl_err!r} but spec error={spec_err!r}")
        if impl_err is None:
            self.state = new_state
            self.spec = spec_try
            self._compare()
        return DualResult(impl_err, spec_err)


def dual_byron(genesis: dict, genesis_vks, initial_delegates):
    from ..eras.byron import ByronLedger
    impl = ByronLedger(genesis, genesis_vks, initial_delegates)
    spec = ByronSpec(genesis, genesis_vks, initial_delegates)
    return DualLedger(impl, impl.initial_state(), spec,
                      _observe_byron_impl, era="byron")


def dual_shelley(genesis: dict, config, initial_pools, initial_delegs,
                 era: str = "shelley", initial_reserves: int = 1_000_000):
    from ..eras.shelley import ShelleyLedger
    impl = ShelleyLedger(genesis, config, initial_pools, initial_delegs,
                         era=era, initial_reserves=initial_reserves)
    spec = ShelleySpec(genesis, config, initial_pools, initial_delegs,
                       era=era, initial_reserves=initial_reserves)
    return DualLedger(impl, impl.initial_state(), spec,
                      _observe_shelley_impl, era="shelley")
