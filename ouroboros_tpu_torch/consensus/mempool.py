"""Mempool — validated pending transactions, revalidated on tip change.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Mempool/API.hs:53-155
(`Mempool` {tryAddTxs, removeTxs, syncWithLedger, getSnapshot(For)}, ticket-
based zero-copy reader at :285), Mempool/Impl.hs (TVar `InternalState`
revalidated against the ledger tip on change), Mempool/TxSeq.hs (`TxSeq`
finger-tree with `TicketNo`).  Capacity defaults to twice the max block
body size (Impl.hs capacity policy).

Device-first note: per-tx admission stays on the host CPU path (batch-of-one
witness checks — txs arrive one at a time from the network), while the bulk
witness verification happens when a *block* containing these txs is
validated through consensus/batch.py as one device batch.  Re-validation on
tip change reuses ledger.apply_tx and never re-runs witness crypto for txs
that merely moved to a new tip (witnesses sign the txid, which is
tip-independent) — mirroring the reference's revalidateTxsFor using
reapply.

Ported from `ouroboros_tpu/consensus/mempool.py` (the port imports nothing
of the JAX package). Copied whole, comments naming old work items
reworded.  In the port `default_backend()` is a `TorchBackend` on the card
and raises without one, so a mempool on the host is given its backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..chain.block import Point
from ..crypto.backend import default_backend as _default_backend
from ..observe import metrics as _metrics
from ..observe.spans import monotonic_now as _now
from ..utils import cbor
from .ledger import LedgerError, LedgerRules

# arrival instrumentation: a caught-up node's mempool sees a firehose of
# batch-of-1 tx admissions — these three histograms make the batch-of-1
# vs batch-of-N trade measurable.  Handles pre-bound (OBS002); sizes and
# latencies are timing/traffic-shaped, so all three are unstable.
_ARRIVAL_TXS = _metrics.histogram("mempool.arrival_txs", stable=False)
_ADMIT_SECS = _metrics.latency_histogram("mempool.admit_secs")
_INTERARRIVAL = _metrics.latency_histogram("mempool.interarrival_secs")


@dataclass(frozen=True)
class MempoolEntry:
    """One tx with its admission ticket (TxSeq.hs `TxTicket`)."""
    ticket: int
    tx: Any
    size: int

    @property
    def txid(self) -> bytes:
        return self.tx.txid


@dataclass(frozen=True)
class MempoolSnapshot:
    """Point-in-time view (API.hs `MempoolSnapshot`): the validated tx
    sequence and the ledger state *after* applying all of them."""
    entries: tuple              # MempoolEntry, ticket-ordered
    ledger_state: Any
    tip_point: Point
    slot: int

    @property
    def txs(self) -> list:
        return [e.tx for e in self.entries]

    @property
    def tx_ids(self) -> list:
        return [e.txid for e in self.entries]

    def entries_after(self, ticket: int) -> list:
        """Zero-copy reader support (API.hs:285 snapshotTxsAfter)."""
        return [e for e in self.entries if e.ticket > ticket]

    def has_tx(self, txid: bytes) -> bool:
        return any(e.txid == txid for e in self.entries)


def _tx_size(tx: Any) -> int:
    enc = tx.encode() if hasattr(tx, "encode") else tx
    return len(cbor.dumps(enc))


class Mempool:
    """The mempool implementation (Impl.hs).

    get_ledger -- () -> (ledger_state, tip_point): the current ledger tip,
                  normally ChainDB.current_ledger().ledger + tip_point.
    capacity_bytes -- admission bound; reference default is 2x the max
                  block body size.
    """

    def __init__(self, ledger_rules: LedgerRules,
                 get_ledger: Callable[[], tuple],
                 capacity_bytes: int = 2 * 65536,
                 backend=None, verify_service=None):
        self.rules = ledger_rules
        self.get_ledger = get_ledger
        self.capacity_bytes = capacity_bytes
        self.backend = backend
        # adaptive batching service (crypto/batching.py): when attached,
        # try_add_txs_async coalesces witness checks with every other
        # protocol thread's single-proof traffic
        self.verify_service = verify_service
        self._entries: list[MempoolEntry] = []
        self._last_arrival: Optional[float] = None
        self._next_ticket = 1
        base, tip = get_ledger()
        self._base_state = base          # ledger state at tip, no mempool txs
        self._state = base               # after all mempool txs
        self._tip_point = tip
        # version TVar for blocking readers (TxSubmission outbound); plain
        # int fallback outside the sim
        try:
            from ..simharness.stm import TVar
            self.version: Optional[Any] = TVar(0, label="mempool-version")
        except Exception:                                  # pragma: no cover
            self.version = None
        self._version_int = 0

    # -- internals ------------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return sum(e.size for e in self._entries)

    def _bump(self) -> None:
        self._version_int += 1
        if self.version is not None:
            try:
                self.version.set_notify(self._version_int)
            except Exception:
                # outside the sim: keep the raw value fresh for polling
                self.version._value = self._version_int

    # -- API (API.hs:53-155) --------------------------------------------------
    def try_add_txs(self, txs: Sequence[Any],
                    backend=None) -> tuple[list, list]:
        """Validate and admit txs against the current mempool state.

        Returns (added_txids, [(tx, error)rejected]).  Stops admitting (but
        keeps rejecting-on-validity) when capacity is reached, like
        tryAddTxs's MempoolCapacityBytesOverride behaviour.  `backend`
        overrides the mempool's own for this call (the service admission
        path passes a PrecheckedBackend carrying coalesced verdicts).
        """
        observing = _metrics.enabled()
        if observing:
            t0 = _now()
            _ARRIVAL_TXS.observe(len(txs))
            if self._last_arrival is not None:
                _INTERARRIVAL.observe(t0 - self._last_arrival)
            self._last_arrival = t0
        added, rejected = [], []
        for tx in txs:
            size = _tx_size(tx)
            if self.bytes_used + size > self.capacity_bytes:
                rejected.append((tx, LedgerError("mempool full")))
                continue
            if any(e.txid == tx.txid for e in self._entries):
                rejected.append((tx, LedgerError("duplicate tx")))
                continue
            try:
                new_state = self.rules.apply_tx(
                    self._state, tx,
                    backend=backend if backend is not None
                    else self.backend)
            except LedgerError as e:
                rejected.append((tx, e))
                continue
            self._entries.append(MempoolEntry(self._next_ticket, tx, size))
            self._next_ticket += 1
            self._state = new_state
            added.append(tx.txid)
        if added:
            self._bump()
        if observing:
            _ADMIT_SECS.observe(_now() - t0)
        return added, rejected

    async def try_add_txs_async(self, txs: Sequence[Any]
                                ) -> tuple[list, list]:
        """try_add_txs with the witness crypto routed through the
        attached VerifyService (the batch-of-1 firehose coalesced into
        device batches across ALL submitting threads).

        Each tx's proofs (rules.tx_proofs) are verified through the
        service first — blocking on back-pressure like any other caller
        — then the synchronous admission runs with those verdicts
        honored via a PrecheckedBackend, so a verdict is never computed
        twice and admission semantics (capacity, duplicates, ordering)
        are IDENTICAL to the direct path.  Degrades to plain
        try_add_txs when no service is attached or the ledger does not
        expose tx-level proofs."""
        if self.verify_service is None:
            return self.try_add_txs(txs)
        reqs: list = []
        for tx in txs:
            p = self.rules.tx_proofs(self._state, tx)
            if p is None:                    # ledger can't pre-extract:
                return self.try_add_txs(txs)  # plain path for the batch
            reqs.extend(p)
        from ..crypto.batching import PrecheckedBackend, verdict_map
        verdicts = await verdict_map(self.verify_service, reqs)
        return self.try_add_txs(
            txs, backend=PrecheckedBackend(
                self.backend or _default_backend(), verdicts))

    def remove_txs(self, txids: Sequence[bytes]) -> None:
        """Drop the named txs and revalidate the remainder (removeTxs)."""
        drop = set(txids)
        keep = [e for e in self._entries if e.txid not in drop]
        if len(keep) != len(self._entries):
            self._revalidate(keep)
            self._bump()

    def sync_with_ledger(self) -> list:
        """Re-fetch the ledger tip and revalidate every tx against it
        (syncWithLedger).  Returns txids dropped as now-invalid (typically:
        included in the new tip block, or double-spent by it)."""
        base, tip = self.get_ledger()
        if tip == self._tip_point:
            return []
        self._base_state, self._tip_point = base, tip
        before = {e.txid for e in self._entries}
        self._revalidate(self._entries)
        dropped = [t for t in before
                   if not any(e.txid == t for e in self._entries)]
        self._bump()
        return dropped

    def _apply_all(self, state: Any, candidates: Sequence[MempoolEntry]
                   ) -> tuple[list, Any]:
        """Fold apply_tx over entries, dropping now-invalid ones — the
        shared core of syncWithLedger and getSnapshotFor revalidation."""
        kept: list[MempoolEntry] = []
        for e in candidates:
            try:
                state = self.rules.apply_tx(state, e.tx,
                                            backend=self.backend)
            except LedgerError:
                continue
            kept.append(e)
        return kept, state

    def _revalidate(self, candidates: Sequence[MempoolEntry]) -> None:
        self._entries, self._state = self._apply_all(self._base_state,
                                                     candidates)

    def get_snapshot(self) -> MempoolSnapshot:
        return MempoolSnapshot(tuple(self._entries), self._state,
                               self._tip_point, self._state_slot())

    def get_snapshot_for(self, slot: int, ticked_ledger: Any
                         ) -> MempoolSnapshot:
        """Snapshot revalidated against a *ticked* state for forging at
        `slot` (getSnapshotFor): the forge path must only include txs valid
        in the block being made."""
        kept, state = self._apply_all(ticked_ledger, self._entries)
        return MempoolSnapshot(tuple(kept), state, self._tip_point, slot)

    def _state_slot(self) -> int:
        return getattr(self._state, "slot", -1)

    def reader(self) -> "MempoolReader":
        return MempoolReader(self)


class MempoolReader:
    """Cursor over the mempool for TxSubmission outbound
    (TxSubmission/Mempool/Reader.hs): next_ids advances a ticket cursor,
    lookup resolves an id to the tx if still present."""

    def __init__(self, mempool: Mempool):
        self.mempool = mempool
        self.cursor = 0                  # last ticket handed out

    def next_ids(self, n: int) -> list[tuple[bytes, int]]:
        out = []
        for e in self.mempool.get_snapshot().entries_after(self.cursor):
            if len(out) >= n:
                break
            out.append((e.txid, e.size))
            self.cursor = e.ticket
        return out

    def lookup(self, txid: bytes) -> Optional[Any]:
        for e in self.mempool.get_snapshot().entries:
            if e.txid == txid:
                return e.tx
        return None
