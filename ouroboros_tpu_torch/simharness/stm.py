"""Software transactional memory for the sim harness.

MonadSTM analog (io-sim-classes/src/Control/Monad/Class/MonadSTM.hs:91-162;
execAtomically: io-sim/src/Control/Monad/IOSim/Internal.hs:1300).

Because the sim runtime is single-threaded and cooperative, a transaction is
atomic by construction; this module provides the read/write-set tracking that
implements ``retry`` (block until a read var changes) and ``orElse``
(nested-transaction rollback), plus the derived structures the reference uses
everywhere: TQueue, TBQueue, TMVar (strict, as in MonadSTM/Strict.hs).

Transactions are *plain functions* (not coroutines) receiving a ``Tx`` handle:

    async def producer(q):
        await atomically(lambda tx: q.put(tx, item))

Ported from `ouroboros_tpu/simharness/stm.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Optional

from . import runtime as _runtime

__all__ = ["TVar", "Tx", "Retry", "retry", "TQueue", "TBQueue", "TMVar"]

_tvar_ids = itertools.count()


class Retry(Exception):
    """Raised by a transaction to block until a read TVar changes."""


def retry():
    raise Retry()


class TVar:
    """Transactional variable. Read/write only through a Tx inside atomically.

    ``value`` property gives a non-transactional peek (for assertions/tracing
    only — analogous to readTVarIO).
    """

    __slots__ = ("_id", "_value", "label")

    def __init__(self, value: Any = None, label: str = ""):
        self._id = next(_tvar_ids)
        self._value = value
        self.label = label

    @property
    def value(self) -> Any:
        det = _runtime.active_detector()
        if det is not None:
            det.on_peek(self)
        return self._value

    def set_notify(self, value: Any) -> None:
        """Runtime-internal: write outside a transaction and wake STM
        waiters.  For non-sim-thread producers (timer callbacks, registration
        hooks); user code should write through atomically()."""
        det = _runtime.active_detector()
        if det is not None:
            det.on_raw_write(self)
        self._value = value
        _runtime.current().stm_notify([self._id])

    def __repr__(self):
        return f"<TVar {self._id}{' ' + self.label if self.label else ''}={self._value!r}>"


class Tx:
    """In-flight transaction: tracks read set and buffered writes."""

    __slots__ = ("_sim", "read_vars", "_writes")

    def __init__(self, sim):
        self._sim = sim
        # id -> TVar: one store per read serves both the retry read-set
        # (keys) and the race detector's commit hook, which needs the
        # objects (their labels) — no extra cost on the STM hot path
        self.read_vars: dict[int, TVar] = {}
        self._writes: dict[int, tuple[TVar, Any]] = {}

    @property
    def read_set(self):
        """TVar ids read so far (retry registration uses this view)."""
        return self.read_vars.keys()

    def read(self, tvar: TVar) -> Any:
        self.read_vars[tvar._id] = tvar
        if tvar._id in self._writes:
            return self._writes[tvar._id][1]
        return tvar._value

    def write(self, tvar: TVar, value: Any) -> None:
        self._writes[tvar._id] = (tvar, value)

    def modify(self, tvar: TVar, fn: Callable[[Any], Any]) -> Any:
        v = fn(self.read(tvar))
        self.write(tvar, v)
        return v

    def check(self, cond: bool) -> None:
        """STM 'check': retry unless cond holds."""
        if not cond:
            retry()

    def or_else(self, first: Callable[["Tx"], Any],
                second: Callable[["Tx"], Any]) -> Any:
        """Run first; if it retries, roll back its writes and run second.

        orElse analog (MonadSTM.hs; io-sim Internal.hs:1300 region).  The
        read sets of both branches accumulate (a change to either read set
        should wake a blocked orElse), matching GHC STM semantics; only the
        writes of a retried branch are rolled back.
        """
        saved_writes = dict(self._writes)
        try:
            return first(self)
        except Retry:
            self._writes = saved_writes
            return second(self)

    # called by the scheduler
    def commit(self) -> list[int]:
        written = []
        for vid, (tvar, value) in self._writes.items():
            tvar._value = value
            written.append(vid)
        return written

    def rollback(self) -> None:
        self._writes.clear()


# ---------------------------------------------------------------------------
# Derived transactional structures (MonadSTM derived API)
# ---------------------------------------------------------------------------

def _rev(cons):
    out = None
    while cons is not None:
        head, cons = cons
        out = (head, out)
    return out


class TQueue:
    """Unbounded FIFO queue (TQueue analog).

    Two-stack cons-list representation (front to pop from, back to push to),
    as in the reference TQueue — amortized O(1) per operation with purely
    immutable values, so transaction rollback stays free.
    """

    def __init__(self, label: str = ""):
        lbl = label or "tqueue"
        self._front = TVar(None, label=lbl + ".front")
        self._back = TVar(None, label=lbl + ".back")
        self._count = TVar(0, label=lbl + ".count")

    def put(self, tx: Tx, item: Any) -> None:
        tx.write(self._back, (item, tx.read(self._back)))
        tx.write(self._count, tx.read(self._count) + 1)

    def _pop(self, tx: Tx):
        front = tx.read(self._front)
        if front is None:
            front = _rev(tx.read(self._back))
            if front is None:
                return _NO_ITEM
            tx.write(self._back, None)
        head, rest = front
        tx.write(self._front, rest)
        tx.write(self._count, tx.read(self._count) - 1)
        return head

    def get(self, tx: Tx) -> Any:
        item = self._pop(tx)
        if item is _NO_ITEM:
            retry()
        return item

    def try_get(self, tx: Tx) -> Optional[Any]:
        item = self._pop(tx)
        return None if item is _NO_ITEM else item

    def size(self, tx: Tx) -> int:
        return tx.read(self._count)


_NO_ITEM = object()


class TBQueue(TQueue):
    """Bounded FIFO queue (TBQueue analog) — put blocks when full."""

    def __init__(self, capacity: int, label: str = ""):
        super().__init__(label=label or "tbqueue")
        self.capacity = capacity

    def put(self, tx: Tx, item: Any) -> None:
        if tx.read(self._count) >= self.capacity:
            retry()
        super().put(tx, item)

    def try_put(self, tx: Tx, item: Any) -> bool:
        if tx.read(self._count) >= self.capacity:
            return False
        super().put(tx, item)
        return True


_EMPTY = object()


class TMVar:
    """Transactional MVar (TMVar analog): full-or-empty box."""

    def __init__(self, value: Any = _EMPTY, label: str = ""):
        self._box = TVar(value, label=label or "tmvar")

    def take(self, tx: Tx) -> Any:
        v = tx.read(self._box)
        if v is _EMPTY:
            retry()
        tx.write(self._box, _EMPTY)
        return v

    def try_take(self, tx: Tx) -> Optional[Any]:
        v = tx.read(self._box)
        if v is _EMPTY:
            return None
        tx.write(self._box, _EMPTY)
        return v

    def put(self, tx: Tx, value: Any) -> None:
        if tx.read(self._box) is not _EMPTY:
            retry()
        tx.write(self._box, value)

    def read_(self, tx: Tx) -> Any:
        v = tx.read(self._box)
        if v is _EMPTY:
            retry()
        return v

    def is_empty(self, tx: Tx) -> bool:
        return tx.read(self._box) is _EMPTY
