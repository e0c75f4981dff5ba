"""BlockchainTime — wall-clock slot ticking.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/BlockchainTime/
{API.hs,WallClock/Default.hs,Simple.hs}: a `BlockchainTime` exposes the
current slot as an STM view, advanced by a background thread watching the
(virtual) clock.  Fixed slot length only — the HFC-aware version layers era
translation on top (WallClock/HardFork.hs).

Ported from `ouroboros_tpu/node/blockchain_time.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from .. import simharness as sim
from ..simharness import Retry, TVar


class BlockchainTime:
    """Current-slot TVar driven by the simharness virtual clock.

    Slot s spans [s*slot_length, (s+1)*slot_length).  `start()` spawns the
    ticker thread; `wait_slot_after(prev)` blocks (STM retry) until the
    current slot exceeds `prev` — the knownSlotWatcher pattern the forging
    loop uses (NodeKernel.hs:344-351).
    """

    def __init__(self, slot_length: float = 1.0):
        self.slot_length = slot_length
        self.current: TVar = TVar(self._slot_of_now(), label="current-slot")
        self._ticker = None

    def _slot_of_now(self) -> int:
        try:
            return int(sim.now() / self.slot_length)
        except Exception:
            return 0                     # outside the sim: epoch start

    def start(self, label: str = "btime") -> None:
        self._ticker = sim.spawn(self._tick_loop(), label=label)

    def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            self._ticker = None

    async def _tick_loop(self) -> None:
        while True:
            nxt = self.current.value + 1
            at = nxt * self.slot_length
            delay = at - sim.now()
            if delay > 0:
                await sim.sleep(delay)
            # max() guards against float truncation (int(k*L/L) can be
            # k-1): the slot always advances, so this loop cannot spin
            # without yielding, and the TVar is monotone
            self.current.set_notify(
                max(nxt, int(sim.now() / self.slot_length)))

    async def wait_slot_after(self, prev: int) -> int:
        """Block until the current slot is > prev; return it."""
        def tx_fn(tx):
            s = tx.read(self.current)
            if s <= prev:
                raise Retry()
            return s
        return await sim.atomically(tx_fn)


class HardForkBlockchainTime(BlockchainTime):
    """Slot ticking through the era summary — slot length may change at
    era boundaries (BlockchainTime/WallClock/HardFork.hs:
    hardForkBlockchainTime interprets the HFC time summary).

    get_summary() is re-read every tick so a transition decided by the
    ledger mid-run takes effect (the reference re-runs the Qry against the
    current ledger state the same way).
    """

    def __init__(self, get_summary):
        self.get_summary = get_summary
        try:
            now = sim.now()
        except RuntimeError:             # outside the sim: epoch start
            now = 0.0
        self.current = TVar(get_summary().wallclock_to_slot(now),
                            label="current-slot")
        self._ticker = None

    async def _tick_loop(self) -> None:
        while True:
            summary = self.get_summary()
            nxt = self.current.value + 1
            at = summary.slot_to_wallclock(nxt)
            delay = at - sim.now()
            if delay > 0:
                await sim.sleep(delay)
            # max(nxt, ...) keeps the slot monotone and always advancing:
            # float truncation can compute nxt-1, and a transition decided
            # during the sleep can remap the wallclock to an earlier slot
            # — neither may regress the TVar or stall this loop
            self.current.set_notify(
                max(nxt,
                    self.get_summary().wallclock_to_slot(sim.now())))
