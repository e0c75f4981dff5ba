"""IoRuntime — the real-IO interpreter of the simharness interface.

The production half of the io-sim-classes story (SURVEY.md §1): everything
in the port is written against the simharness facade; `Sim` interprets
it deterministically with a virtual clock, this runtime interprets it over
asyncio with the wall clock and real sockets.  The STM stays atomic for
the same reason as in the sim — asyncio is cooperative and single-threaded,
so a transaction function that never awaits runs atomically; `retry` blocks
on per-TVar wakeup events.

Usage:
    from ouroboros_tpu_torch.simharness.io_runtime import io_run
    io_run(main())          # instead of sim.run(main())

Ported from `ouroboros_tpu/simharness/io_runtime.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import asyncio
import time as _time
from typing import Any, Coroutine, Optional

from . import runtime as _runtime
from .core import AsyncCancelled
from .stm import Retry, Tx


class IoAsync:
    """Async-handle mirror of core.Async over an asyncio.Task."""

    _next_tid = [1]

    def __init__(self, task: asyncio.Task, label: str):
        self._task = task
        self.label = label
        self.tid = IoAsync._next_tid[0]
        IoAsync._next_tid[0] += 1

    @property
    def done(self) -> bool:
        return self._task.done()

    async def wait(self) -> Any:
        try:
            return await asyncio.shield(self._task)
        except asyncio.CancelledError as e:
            if self._task.cancelled():
                raise AsyncCancelled() from e
            raise

    def cancel(self) -> None:
        self._task.cancel()

    async def cancel_wait(self) -> None:
        self.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass

    def poll(self) -> Optional[Any]:
        if not self._task.done():
            return None
        if self._task.cancelled():
            raise AsyncCancelled()
        exc = self._task.exception()
        if exc is not None:
            raise exc
        return self._task.result()


class IoRuntime:
    """The asyncio-backed runtime."""

    def __init__(self):
        self._t0 = _time.monotonic()
        self._tvar_waiters: dict[int, set] = {}     # tvar id -> {Event}
        self.trace: list = []
        self.collect_trace = False

    # -- time -----------------------------------------------------------------
    def now(self) -> float:
        return _time.monotonic() - self._t0

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(max(0.0, seconds))

    async def yield_(self) -> None:
        await asyncio.sleep(0)

    # -- threads --------------------------------------------------------------
    def spawn(self, coro: Coroutine, label: str = "") -> IoAsync:
        task = asyncio.get_event_loop().create_task(coro, name=label)
        return IoAsync(task, label)

    async def timeout(self, seconds: float, coro) -> tuple[bool, Any]:
        try:
            return True, await asyncio.wait_for(coro, seconds)
        except asyncio.TimeoutError:
            return False, None

    # -- STM ------------------------------------------------------------------
    async def atomically(self, tx_fn) -> Any:
        while True:
            tx = Tx(self)
            try:
                result = tx_fn(tx)
            except Retry:
                read_ids = list(tx.read_set)
                tx.rollback()
                if not read_ids:
                    raise RuntimeError(
                        "STM retry with empty read set would block forever")
                await self._wait_tvars(read_ids)
                continue
            except BaseException:
                tx.rollback()
                raise
            written = tx.commit()
            if written:
                self.stm_notify(written)
            return result

    async def _wait_tvars(self, tvar_ids: list[int]) -> None:
        event = asyncio.Event()
        for vid in tvar_ids:
            self._tvar_waiters.setdefault(vid, set()).add(event)
        try:
            await event.wait()
        finally:
            for vid in tvar_ids:
                ws = self._tvar_waiters.get(vid)
                if ws is not None:
                    ws.discard(event)
                    if not ws:
                        del self._tvar_waiters[vid]

    def stm_notify(self, tvar_ids) -> None:
        for vid in tvar_ids:
            for event in self._tvar_waiters.get(vid, ()):
                event.set()

    # -- misc -----------------------------------------------------------------
    def trace_event(self, payload: Any, label: str = "user") -> None:
        if self.collect_trace:
            self.trace.append((self.now(), label, payload))

    def new_timeout(self, seconds: float):
        from .stm import TVar
        tv = TVar(False, label=f"io-timeout+{seconds}")

        def fire():
            tv._value = True
            self.stm_notify([tv._id])
        asyncio.get_event_loop().call_later(seconds, fire)
        return tv


def io_run(main: Coroutine, debug: bool = False) -> Any:
    """Run `main` under the IO runtime (the production `sim.run`)."""
    rt = IoRuntime()

    async def entry():
        prev = _runtime.current_or_none()
        _runtime.set_current(rt)
        try:
            return await main
        finally:
            _runtime.set_current(prev)

    return asyncio.run(entry(), debug=debug)
