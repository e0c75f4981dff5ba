"""ouro-race — happens-before race detection + schedule exploration.

The reference io-sim's signature correctness tool is ``exploreRaces`` /
IOSimPOR (io-sim:src/Control/Monad/IOSimPOR/*): systematic schedule
perturbation that surfaces races the one default deterministic schedule
never exercises.  This module is the Python-rebuild analog, split the
same way the reference splits it:

- **Instrumentation** (`RaceDetector`): every TVar read/write, every
  ``atomically`` commit, thread fork/join and timer event is recorded
  against per-thread *vector clocks* (FastTrack-style happens-before,
  PAPERS.md).  An access pair on the same TVar is a race when the two
  accesses are causally unordered, at least one is a write, and at least
  one happened *outside* an atomic block (committed transactions
  serialize on the vars they touch, so tx/tx pairs are ordered by
  construction — exactly GHC-STM semantics).
- **Exploration** (`ScheduleController` / `explore_races`): re-run the
  same program under K seeded schedule perturbations.  Schedule 0 is the
  production FIFO schedule; later schedules insert preemption points at
  every yield/STM boundary by picking the next runnable thread at
  random (seeded) or in reversed (LIFO) order, which flips the commit
  order of racy pairs so *both* directions of an unordered pair get
  exercised.
- **Repro** (`Race.trace`): each race carries a minimized two-thread
  interleaving — only the two racing threads' events on the racing
  TVar, plus their fork points — enough to replay the schedule by hand.

Happens-before edges modeled:
  fork          parent -> child (child starts with the parent's clock)
  join          target's final clock -> waiter (Async.wait)
  commit        a transaction acquires the clocks of every TVar it read
                or wrote and releases its own to every TVar it wrote
                (commit serialization on conflicting vars)
  set_notify    a non-transactional write releases the writer's clock to
                the TVar (the wake-up edge to blocked STM readers) but
                acquires nothing — so it *races* with any unordered
                access, which is the point of the CONC001 discipline
  timer         a timer callback runs with the clock its creator had at
                registration; timer writes (new_timeout flips) propagate
                that clock but are exempt from race checks — timers are
                scheduler-mediated sync primitives, racing with one's
                own timeout is the *purpose* of a timeout

Deterministic end to end: same program factory + same seed + same K
produce a byte-identical ``RaceReport.render()``.

Ported from `ouroboros_tpu/simharness/race.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Callable, Iterable, Optional

__all__ = [
    "Race", "RaceDetector", "RaceReport", "ScheduleController",
    "explore_races",
]


# ---------------------------------------------------------------------------
# Vector clocks
# ---------------------------------------------------------------------------

class VClock:
    """Sparse vector clock over thread ids (plus timer pseudo-ids)."""

    __slots__ = ("c",)

    def __init__(self, c: Optional[dict] = None):
        self.c = dict(c) if c else {}

    def tick(self, tid) -> None:
        self.c[tid] = self.c.get(tid, 0) + 1

    def copy(self) -> "VClock":
        return VClock(self.c)

    def join(self, other: "VClock") -> None:
        for tid, n in other.c.items():
            if self.c.get(tid, 0) < n:
                self.c[tid] = n

    def leq(self, other: "VClock") -> bool:
        """self happens-before-or-equals other."""
        for tid, n in self.c.items():
            if n > other.c.get(tid, 0):
                return False
        return True

    def __repr__(self):
        return "VC" + repr(sorted(self.c.items()))


# ---------------------------------------------------------------------------
# Access records / per-var state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Access:
    seq: int
    tid: Any
    label: str
    kind: str           # "read" | "write"
    atomic: bool
    clock: VClock       # immutable snapshot
    timer: bool = False  # scheduler-mediated timer write: never races


class _VarState:
    __slots__ = ("name", "clock", "last_writes", "reads_since")

    def __init__(self, name: str):
        self.name = name
        self.clock = VClock()          # released clocks (commits/notifies)
        self.last_writes: list = []    # _Access of the latest write "front"
        self.reads_since: list = []    # reads since the latest write front


@dataclass(frozen=True)
class Race:
    """One detected race: an unordered access pair on the same TVar."""
    var: str                 # TVar label (or normalized id when unlabeled)
    kind: str                # "write-write" | "read-write"
    a_thread: str
    b_thread: str
    schedule: int            # schedule index it was first observed under
    trace: tuple             # minimized two-thread interleaving lines

    @property
    def key(self):
        return (self.var, self.kind, frozenset((self.a_thread,
                                                self.b_thread)))

    def render(self) -> str:
        head = (f"RACE {self.kind} on TVar[{self.var}] between "
                f"{self.a_thread!r} and {self.b_thread!r} "
                f"(schedule {self.schedule})")
        body = "\n".join(f"    {line}" for line in self.trace)
        return head + ("\n" + body if body else "")


class RaceDetector:
    """Happens-before detector attached to one Sim run.

    The Sim scheduler drives the hooks; user code never calls them.  All
    state is per-run: normalized var names are assigned in first-access
    order, so reports never leak the process-global TVar id counter and
    stay byte-identical across repeated explorations.
    """

    TRACE_WINDOW = 4096      # rolling event window repro traces draw from
    REPRO_MAX = 24           # cap on minimized-interleaving length

    def __init__(self, schedule_index: int = 0):
        self.schedule_index = schedule_index
        self.races: dict = {}             # Race.key -> Race
        self._clocks: dict = {}           # tid -> VClock
        self._vars: dict = {}             # tvar id -> _VarState
        self._var_seq = 0
        self._seq = 0
        self._events: deque = deque(maxlen=self.TRACE_WINDOW)
        self._ctx_tid: Any = None         # current thread (set by Sim)
        self._ctx_label: str = "sim"
        self._timer_clocks: dict = {}     # token -> VClock snapshot
        self._timer_depth = 0
        self._next_timer = 0

    # -- context (Sim scheduler) --------------------------------------------
    def set_ctx(self, tid, label: str) -> None:
        self._ctx_tid, self._ctx_label = tid, label

    def begin_timer(self, token: int) -> None:
        self._timer_depth += 1
        self._saved_ctx = (self._ctx_tid, self._ctx_label)
        self.set_ctx(("timer", token), f"timer-{token}")
        self._clocks[("timer", token)] = \
            self._timer_clocks.get(token, VClock()).copy()

    def end_timer(self) -> None:
        self._timer_depth -= 1
        self.set_ctx(*self._saved_ctx)

    @property
    def _in_timer(self) -> bool:
        return self._timer_depth > 0

    def _clock(self, tid=None) -> VClock:
        tid = tid if tid is not None else self._ctx_tid
        vc = self._clocks.get(tid)
        if vc is None:
            vc = self._clocks[tid] = VClock()
            vc.tick(tid)
        return vc

    # -- structural edges ----------------------------------------------------
    def on_fork(self, parent_tid, child_tid, child_label: str) -> None:
        if parent_tid is not None:
            parent = self._clock(parent_tid)
            parent.tick(parent_tid)
            child = parent.copy()
        else:
            child = VClock()
        child.tick(child_tid)
        self._clocks[child_tid] = child
        self._log(child_tid, child_label, "fork", "", "")

    def on_join(self, waiter_tid, waiter_label: str, target_tid,
                target_label: str) -> None:
        target = self._clocks.get(target_tid)
        if target is not None:
            w = self._clock(waiter_tid)
            w.join(target)
            w.tick(waiter_tid)
        self._log(waiter_tid, waiter_label, "join", target_label, "")

    def on_timer_create(self) -> int:
        token = self._next_timer
        self._next_timer += 1
        self._timer_clocks[token] = self._clock().copy()
        return token

    # -- TVar accesses -------------------------------------------------------
    def _var(self, tvar) -> _VarState:
        vs = self._vars.get(tvar._id)
        if vs is None:
            name = tvar.label or f"v{self._var_seq}"
            self._var_seq += 1
            vs = self._vars[tvar._id] = _VarState(name)
        return vs

    def on_commit(self, tid, label: str, read_vars: dict,
                  written: dict) -> None:
        """Transaction commit: acquire every accessed var's clock (commit
        serialization), then record the accesses, then release to the
        written vars."""
        vc = self._clock(tid)
        touched = {**read_vars, **written}
        for tvar in touched.values():
            vc.join(self._var(tvar).clock)
        vc.tick(tid)
        for vid, tvar in read_vars.items():
            if vid not in written:
                self._access(tvar, "read", atomic=True)
        for tvar in written.values():
            self._access(tvar, "write", atomic=True)
            vs = self._var(tvar)
            vs.clock.join(vc)
        self._log(tid, label, "commit",
                  ",".join(sorted(self._var(t).name
                                  for t in touched.values())), "")

    def on_raw_write(self, tvar) -> None:
        """Non-transactional write (TVar.set_notify, timer flips)."""
        vc = self._clock()
        vc.tick(self._ctx_tid)
        if self._in_timer:
            # timers are scheduler-mediated: propagate the creator's
            # clock (the wake-up edge) but do not race-check
            self._record_only(tvar, "write")
        else:
            self._access(tvar, "write", atomic=False)
        self._var(tvar).clock.join(vc)

    def on_peek(self, tvar) -> None:
        """Non-transactional read (TVar.value)."""
        if self._ctx_tid is None:
            return          # outside any scheduled step: nothing to order
        vc = self._clock()
        vc.tick(self._ctx_tid)
        self._access(tvar, "read", atomic=False)

    # -- core check ----------------------------------------------------------
    def _access(self, tvar, kind: str, atomic: bool) -> None:
        vs = self._var(tvar)
        self._seq += 1
        acc = _Access(self._seq, self._ctx_tid, self._ctx_label, kind,
                      atomic, self._clock().copy())
        self._log(acc.tid, acc.label,
                  ("tx-" if atomic else "") + kind, vs.name, "")
        against = vs.last_writes if kind == "read" \
            else vs.last_writes + vs.reads_since
        for prev in against:
            if prev.tid == acc.tid:
                continue
            if prev.timer:
                continue    # timer writes never race (both directions:
                            # polling one's own timeout flag is the
                            # documented purpose of registerDelay)
            if prev.atomic and acc.atomic:
                continue    # committed transactions serialize
            if prev.clock.leq(acc.clock):
                continue    # ordered: prev happens-before acc
            self._report(vs, prev, acc)
        if kind == "write":
            vs.last_writes = [acc]
            vs.reads_since = []
        else:
            vs.reads_since.append(acc)
            if len(vs.reads_since) > 64:     # bound: keep the newest reads
                del vs.reads_since[0]

    def _record_only(self, tvar, kind: str) -> None:
        vs = self._var(tvar)
        self._seq += 1
        self._log(self._ctx_tid, self._ctx_label, "timer-" + kind,
                  vs.name, "")
        # a timer write still supersedes the write front — clearing the
        # stale pre-timer accesses — but carries timer=True so LATER
        # accesses never race against it either (the exemption must be
        # two-sided, or polling one's own timeout flag reports a race)
        acc = _Access(self._seq, self._ctx_tid, self._ctx_label, kind,
                      True, self._clock().copy(), timer=True)
        if kind == "write":
            vs.last_writes = [acc]
            vs.reads_since = []

    def _report(self, vs: _VarState, a: _Access, b: _Access) -> None:
        kind = "write-write" if a.kind == "write" and b.kind == "write" \
            else "read-write"
        race = Race(var=vs.name, kind=kind, a_thread=a.label,
                    b_thread=b.label, schedule=self.schedule_index,
                    trace=self._minimize(vs.name, a, b))
        self.races.setdefault(race.key, race)

    # -- repro ---------------------------------------------------------------
    def _log(self, tid, label, op, var, detail) -> None:
        self._events.append((tid, label, op, var, detail))

    def _minimize(self, var_name: str, a: _Access, b: _Access) -> tuple:
        """The two racing threads' events on the racing var, plus their
        fork points — the smallest interleaving that still shows the
        unordered pair."""
        tids = {a.tid, b.tid}
        lines = []
        for tid, label, op, var, _detail in self._events:
            if tid not in tids:
                continue
            if op == "fork" or var == var_name or op == "join":
                lines.append(f"[{label}] {op}"
                             + (f" {var}" if var else ""))
        lines.append(f"=> unordered: [{a.label}] {a.kind}"
                     f"{' (atomic)' if a.atomic else ''} vs "
                     f"[{b.label}] {b.kind}"
                     f"{' (atomic)' if b.atomic else ''} on {var_name}")
        return tuple(lines[-self.REPRO_MAX:])


# ---------------------------------------------------------------------------
# Schedule exploration
# ---------------------------------------------------------------------------

def _derived_seed(seed: int, index: int) -> int:
    h = hashlib.blake2b(b"ouro-race:%d:%d" % (seed, index),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


@dataclass
class RaceReport:
    """Outcome of a K-schedule exploration.  `races` block; `tolerated`
    (label matched a tolerate glob) are visible but non-blocking, the
    same split as the ouro-lint baseline."""
    seed: int
    k: int
    races: list = field(default_factory=list)
    tolerated: list = field(default_factory=list)
    failures: list = field(default_factory=list)   # (schedule, repr(exc))
    schedules_run: int = 0

    @property
    def found(self) -> bool:
        return bool(self.races)

    def render(self) -> str:
        out = [f"ouro-race: seed={self.seed} k={self.k} "
               f"schedules={self.schedules_run} races={len(self.races)} "
               f"tolerated={len(self.tolerated)} "
               f"failures={len(self.failures)}"]
        for r in self.races:
            out.append(r.render())
        for r in self.tolerated:
            out.append("tolerated: " + r.render())
        for sched, err in self.failures:
            out.append(f"schedule {sched} failed: {err}")
        return "\n".join(out)


class ScheduleController:
    """Re-run one sim program under K seeded schedule perturbations.

    Schedule 0 is the production FIFO schedule (so the baseline behavior
    is always covered); schedules 1..K-1 perturb at every preemption
    point (yield / sleep / STM boundary — every spot the cooperative
    scheduler makes a choice) with a seeded random pick, and every
    fourth schedule runs LIFO, which reverses the commit order of racy
    pairs relative to FIFO."""

    def __init__(self, make_program: Callable[[], Any], k: int = 16,
                 seed: int = 0, tolerate: Iterable[str] = ()):
        if k < 1:
            raise ValueError("need at least one schedule")
        self.make_program = make_program
        self.k = k
        self.seed = seed
        self.tolerate = tuple(tolerate)

    def _mode(self, index: int) -> str:
        if index == 0:
            return "fifo"
        return "lifo" if index % 4 == 3 else "random"

    def run_schedule(self, index: int):
        """Run one perturbed schedule; returns (detector, exc_or_None)."""
        from .core import Sim
        det = RaceDetector(schedule_index=index)
        sim = Sim(seed=_derived_seed(self.seed, index),
                  schedule_mode=self._mode(index), race=det)
        try:
            sim.run(self.make_program())
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            # BaseException, not Exception: AsyncCancelled (the most
            # timing-dependent failure shape a perturbation provokes)
            # must land in report.failures, not abort the exploration
            # and lose every schedule already collected
            return det, exc
        return det, None

    def explore(self, pre_collected=(), start: int = 0) -> RaceReport:
        """Run schedules [start, k) and fold in `pre_collected`
        detectors from runs the caller already made (e.g. the measured
        FIFO run run_chaos_threadnet performs anyway — re-running it as
        schedule 0 would be byte-identical wasted work)."""
        report = RaceReport(seed=self.seed, k=self.k)
        seen: set = set()

        def harvest(det):
            for race in det.races.values():
                if race.key in seen:
                    continue
                seen.add(race.key)
                if any(fnmatchcase(race.var, pat)
                       for pat in self.tolerate):
                    report.tolerated.append(race)
                else:
                    report.races.append(race)

        for det in pre_collected:
            report.schedules_run += 1
            harvest(det)
        for index in range(start, self.k):
            det, exc = self.run_schedule(index)
            report.schedules_run += 1
            if exc is not None:
                report.failures.append((index, f"{type(exc).__name__}: "
                                        f"{exc}"))
            harvest(det)
        report.races.sort(key=lambda r: (r.var, r.kind, r.a_thread,
                                         r.b_thread))
        report.tolerated.sort(key=lambda r: (r.var, r.kind, r.a_thread,
                                             r.b_thread))
        return report


def explore_races(make_program: Callable[[], Any], k: int = 16,
                  seed: int = 0,
                  tolerate: Iterable[str] = ()) -> RaceReport:
    """exploreRaces analog: run `make_program()` under K seeded schedule
    perturbations and report every unordered TVar access pair.

    make_program must return a FRESH coroutine (and fresh program state)
    per call — each schedule is an independent run."""
    return ScheduleController(make_program, k=k, seed=seed,
                              tolerate=tolerate).explore()
