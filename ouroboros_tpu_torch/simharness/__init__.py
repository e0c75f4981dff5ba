"""simharness — one async/STM interface, two interpreters.

The io-sim / io-sim-classes analog (the reference's io-sim and
io-sim-classes packages).  All higher layers of ouroboros_tpu are
written against this facade, never against wall-clock asyncio directly —
the property that makes whole-system deterministic simulation possible
(SURVEY.md §1, §4.1) while the SAME code runs in production:

- `run(main)`     — the deterministic simulator (io-sim: virtual clock,
                    seeded scheduler, trace, deadlock detection)
- `io_run(main)`  — the asyncio-backed IO runtime (io_runtime.py), real
                    clock + real sockets

The module-level functions dispatch to whichever runtime is active.

Ported from `ouroboros_tpu/simharness/__init__.py` (the port imports
nothing of the JAX package): the simulator (`core.py`), STM (`stm.py`),
the IO runtime (`io_runtime.py`) and ouro-race (`race.py`) are copied
whole.  Left out: `faults.py` (FaultPlan, FaultyChannel and the other
fault injectors), which waits for the diffusion slice with the chaos
ThreadNet that drives it.
"""
from typing import Any

from . import runtime as _runtime
from .core import (
    Async, AsyncCancelled, Deadlock, Sim, SimEvent, Trace, current_sim,
    leaked_threads, mask, run, run_trace,
)
from .core import (
    atomically as _sim_atomically,
    new_timeout as _sim_new_timeout,
    sleep as _sim_sleep,
    timeout as _sim_timeout,
    trace_event as _sim_trace_event,
    yield_ as _sim_yield,
)
from .io_runtime import IoAsync, IoRuntime, io_run
from .race import (
    Race, RaceDetector, RaceReport, ScheduleController, explore_races,
)
from .stm import Retry, TBQueue, TMVar, TQueue, TVar, Tx, retry

__all__ = [
    "Async", "AsyncCancelled", "Deadlock", "Sim", "SimEvent", "Trace",
    "IoAsync", "IoRuntime", "io_run",
    "Race", "RaceDetector", "RaceReport", "ScheduleController",
    "explore_races",
    "atomically", "current_sim", "leaked_threads", "mask", "new_timeout",
    "now", "run", "run_trace", "sleep", "spawn", "timeout", "trace_event",
    "yield_",
    "Retry", "TBQueue", "TMVar", "TQueue", "TVar", "Tx", "retry",
]


def _rt():
    return _runtime.current()


def spawn(coro, label: str = ""):
    return _rt().spawn(coro, label)


def now() -> float:
    return _rt().now()


async def sleep(seconds: float) -> None:
    rt = _rt()
    if isinstance(rt, Sim):
        await _sim_sleep(seconds)
    else:
        await rt.sleep(seconds)


async def yield_() -> None:
    rt = _rt()
    if isinstance(rt, Sim):
        await _sim_yield()
    else:
        await rt.yield_()


async def atomically(tx_fn) -> Any:
    rt = _rt()
    if isinstance(rt, Sim):
        return await _sim_atomically(tx_fn)
    return await rt.atomically(tx_fn)


async def timeout(seconds: float, coro):
    rt = _rt()
    if isinstance(rt, Sim):
        return await _sim_timeout(seconds, coro)
    return await rt.timeout(seconds, coro)


def trace_event(payload, label: str = "user") -> None:
    rt = _runtime.current_or_none()
    if rt is None:
        return
    if isinstance(rt, Sim):
        _sim_trace_event(payload, label)
    else:
        rt.trace_event(payload, label)


def new_timeout(seconds: float):
    rt = _rt()
    if isinstance(rt, Sim):
        return _sim_new_timeout(seconds)
    return rt.new_timeout(seconds)


async def wait_pred(pred, timeout: float) -> bool:
    """Block until `pred(tx)` is true (returns True) or `timeout` elapses
    (returns False) — one STM transaction, nothing consumed, no task
    cancellation involved.  The building block for non-destructive channel
    polling (Channel/MuxChannel.wait_ready)."""
    tv = new_timeout(timeout)

    def tx_fn(tx):
        if pred(tx):
            return True
        if tx.read(tv):
            return False
        retry()
    return await atomically(tx_fn)
