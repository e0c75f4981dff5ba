"""Runtime registry: which runtime (Sim or IoRuntime) is active.

The io-sim-classes move (SURVEY.md §1 "the defining architectural move"):
all node code is written against the simharness facade, and the facade
dispatches to the active runtime — the deterministic simulator for tests,
the asyncio-backed IO runtime for production.  One implementation, two
interpreters, like `IOLike`'s IO/IOSim instances.

Ported from `ouroboros_tpu/simharness/runtime.py` (the port imports
nothing of the JAX package). Copied whole: the runtime registry that
`observe/spans.py` reads its clock from and the simulator and the IO
runtime register with.
"""
from __future__ import annotations

from typing import Optional

_current = None


def current():
    if _current is None:
        raise RuntimeError("not inside a simulation or IO runtime")
    return _current


def current_or_none():
    return _current


def set_current(rt) -> None:
    global _current
    _current = rt


def active_detector():
    """The active runtime's happens-before race detector, or None.

    Sim carries one only while an ouro-race exploration is attached
    (simharness/race.py); the IO runtime never does.  TVar's peek and
    set_notify hooks call this on every access, so it must stay a pair
    of attribute reads — no isinstance, no raising."""
    return getattr(_current, "_race", None)
