"""Deterministic fault injection — seeded network hostility for sim tests.

Reference behaviour being reproduced: io-sim based fault exploration in the
reference test suites (ouroboros-network-framework's sim tests drive
`AbsBearerInfo`/attenuated channels: per-direction delay, error-at-byte and
SDU corruption — testlib/Ouroboros/Network/ConnectionManager/Experiments
and Simulation/Network/Snocket.hs attenuations), plus the ThreadNet
restart/partition plans of Test/ThreadNet/General.hs.

A :class:`FaultPlan` is a *seeded* description of network hostility:

- latency jitter          (extra per-message delay, uniform in [0, jitter])
- message drops           (an SDU/message silently vanishes)
- byte corruption         (one byte of an SDU payload is flipped)
- mid-stream disconnects  (the link dies; every later op raises LinkDown)
- silent stalls           (the link goes quiet for `stall_for` seconds)
- scheduled partitions    (messages between node groups dropped in a window)

Wrap any bearer or Channel with ``plan.wrap_bearer(...)`` /
``plan.wrap_channel(...)`` and an existing sim test runs under faults with
NO other changes.  Every decision draws from a per-edge RNG derived from
``(seed, src, dst)`` via blake2b, so the fault schedule is a pure function
of the plan — same seed, same program: identical faults, identical sim
trace (the determinism the chaos-threadnet replay check relies on).

Every injected fault emits a ``sim.trace_event(("fault", kind, edge, ...))``
so a chaos run is debuggable from the trace alone.

Ported from `ouroboros_tpu/simharness/faults.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

from . import core as sim


class LinkDown(ConnectionError):
    """Fault-injected mid-stream disconnect: the link is gone for good
    (until the subscription/governor layer dials a fresh connection)."""


@dataclass(frozen=True)
class FaultSpec:
    """Per-message fault probabilities + magnitudes for one plan."""
    jitter: float = 0.0          # max extra delay per message (seconds)
    drop_prob: float = 0.0       # P(message silently dropped)
    corrupt_prob: float = 0.0    # P(one payload byte flipped)
    disconnect_prob: float = 0.0  # P(link dies at this message)
    stall_prob: float = 0.0      # P(link goes quiet before this message)
    stall_for: float = 5.0       # silent-stall duration (seconds)

    def any_active(self) -> bool:
        return any((self.jitter, self.drop_prob, self.corrupt_prob,
                    self.disconnect_prob, self.stall_prob))


@dataclass(frozen=True)
class Partition:
    """A scheduled partition: during [start, end) messages crossing between
    different groups are dropped.  Nodes named in no group are unaffected
    (they can still talk to everyone)."""
    start: float
    end: float
    groups: Tuple[Tuple[str, ...], ...]

    def severs(self, t: float, src: str, dst: str) -> bool:
        if not (self.start <= t < self.end):
            return False
        gsrc = gdst = None
        for i, g in enumerate(self.groups):
            if src in g:
                gsrc = i
            if dst in g:
                gdst = i
        return gsrc is not None and gdst is not None and gsrc != gdst


class _EdgeState:
    """Mutable per-direction link state: its RNG stream and health."""

    __slots__ = ("rng", "down", "stalled_until")

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.down = False
        self.stalled_until = 0.0


class FaultPlan:
    """A seeded fault schedule applied to the links it wraps.

    One plan may wrap many links; each (src, dst) direction gets its own
    blake2b-derived RNG stream, so adding or removing one link never
    perturbs the fault schedule of another (schedule stability under
    topology edits, same idea as per-peer key derivation in threadnet.py).
    """

    def __init__(self, seed: int, spec: FaultSpec = FaultSpec(),
                 partitions: Sequence[Partition] = (),
                 until: Optional[float] = None):
        self.seed = seed
        self.spec = spec
        self.partitions = tuple(partitions)
        # per-message hostility stops at `until` (sim seconds); partitions
        # keep their own explicit windows.  None = hostile forever.
        self.until = until
        self._edges: Dict[Tuple[str, str], _EdgeState] = {}
        # (time, kind, "src->dst") summary of every injected fault, for
        # test assertions that don't want to grep the sim trace
        self.events: list = []

    def _edge(self, src: str, dst: str) -> _EdgeState:
        key = (src, dst)
        st = self._edges.get(key)
        if st is None:
            h = hashlib.blake2b(f"{self.seed}:{src}->{dst}".encode(),
                                digest_size=8).digest()
            st = _EdgeState(random.Random(int.from_bytes(h, "big")))
            self._edges[key] = st
        return st

    def _note(self, kind: str, src: str, dst: str, detail: Any = None):
        now = sim.current_sim().time
        self.events.append((now, kind, f"{src}->{dst}"))
        sim.trace_event((kind, f"{src}->{dst}", detail), label="fault")

    def partition_severs(self, src: str, dst: str) -> bool:
        now = sim.current_sim().time
        return any(p.severs(now, src, dst) for p in self.partitions)

    async def perturb(self, src: str, dst: str, payload: Any,
                      corrupt) -> Tuple[bool, Any]:
        """Apply the plan to one outbound message on edge src->dst.

        Returns (deliver, payload'); raises LinkDown on a (possibly
        previously) injected disconnect.  `corrupt(payload, rng)` produces
        the corrupted variant (byte-level for bearers, None to disable for
        message channels)."""
        st = self._edge(src, dst)
        if st.down:
            raise LinkDown(f"fault-injected link down: {src}->{dst}")
        if self.partition_severs(src, dst):
            self._note("partition-drop", src, dst)
            return False, payload
        if self.until is not None and sim.current_sim().time >= self.until:
            return True, payload
        spec, rng = self.spec, st.rng
        if spec.disconnect_prob and rng.random() < spec.disconnect_prob:
            st.down = True
            self._note("disconnect", src, dst)
            raise LinkDown(f"fault-injected disconnect: {src}->{dst}")
        if spec.stall_prob and rng.random() < spec.stall_prob:
            self._note("stall", src, dst, spec.stall_for)
            await sim.sleep(spec.stall_for)
        if spec.drop_prob and rng.random() < spec.drop_prob:
            self._note("drop", src, dst)
            return False, payload
        if corrupt is not None and spec.corrupt_prob \
                and rng.random() < spec.corrupt_prob:
            payload = corrupt(payload, rng)
            self._note("corrupt", src, dst)
        if spec.jitter:
            delay = rng.random() * spec.jitter
            if delay > 0.0:
                self._note("jitter", src, dst, round(delay, 6))
                await sim.sleep(delay)
        return True, payload

    # -- wrappers ------------------------------------------------------------
    def wrap_bearer(self, bearer, src: str, dst: str) -> "FaultyBearer":
        """Wrap a mux bearer (write(SDU)/read()/sdu_size): faults apply to
        the src->dst write direction; reads pass through (the other
        direction is wrapped on the peer's side).

        Wrapping is how a FRESH connection is born, so it heals a
        previously fault-killed edge: a LinkDown poisons one link, not the
        address — the redial the reconnect policy pays for gets a live
        wire (the docstring contract on LinkDown)."""
        self._edge(src, dst).down = False
        return FaultyBearer(bearer, self, src, dst)

    def wrap_channel(self, channel, src: str, dst: str) -> "FaultyChannel":
        """Wrap a message-level Channel: drops lose exactly one message
        (no byte-stream framing to tear), corruption is disabled.  Like
        wrap_bearer, a fresh wrap heals a fault-killed edge."""
        self._edge(src, dst).down = False
        return FaultyChannel(channel, self, src, dst)


class FaultyBearer:
    """A mux bearer with the plan applied to writes.

    Dropping or corrupting an SDU tears the byte stream exactly the way a
    hostile relay would: the peer sees a codec error or an unbounded stall
    — precisely the failure modes the node's watchdogs must convert into
    a clean peer kill."""

    def __init__(self, inner, plan: FaultPlan, src: str, dst: str):
        self._inner = inner
        self._plan = plan
        self._src = src
        self._dst = dst

    @property
    def sdu_size(self) -> int:
        return self._inner.sdu_size

    @staticmethod
    def _corrupt_sdu(sdu, rng: random.Random):
        payload = sdu.payload
        if not payload:
            return sdu
        i = rng.randrange(len(payload))
        flipped = bytes([payload[i] ^ (1 + rng.randrange(255))])
        from ..network.mux import SDU
        return SDU(sdu.timestamp, sdu.mode, sdu.num,
                   payload[:i] + flipped + payload[i + 1:])

    async def write(self, sdu) -> None:
        deliver, sdu = await self._plan.perturb(
            self._src, self._dst, sdu, self._corrupt_sdu)
        if deliver:
            await self._inner.write(sdu)

    async def read(self):
        # reads fail once the edge died (symmetric teardown: a dead link
        # is dead in both call directions on this endpoint)
        if self._plan._edge(self._src, self._dst).down:
            raise LinkDown(
                f"fault-injected link down: {self._src}->{self._dst}")
        return await self._inner.read()

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close:
            close()


class FaultyChannel:
    """A message-level Channel under the plan (drops/jitter/stalls/
    disconnects; no byte corruption at this granularity)."""

    def __init__(self, inner, plan: FaultPlan, src: str, dst: str):
        self._inner = inner
        self._plan = plan
        self._src = src
        self._dst = dst
        self.label = getattr(inner, "label", f"{src}->{dst}")

    async def send(self, item) -> None:
        deliver, item = await self._plan.perturb(
            self._src, self._dst, item, None)
        if deliver:
            await self._inner.send(item)

    async def recv(self):
        if self._plan._edge(self._src, self._dst).down:
            raise LinkDown(
                f"fault-injected link down: {self._src}->{self._dst}")
        return await self._inner.recv()

    async def wait_ready(self, timeout: float) -> bool:
        # a fault-killed link reports ready IMMEDIATELY so the caller's
        # recv raises LinkDown now — same contract as MuxChannel on a
        # closed mux: transport death must not masquerade as peer
        # silence and burn the whole watchdog limit
        if self._plan._edge(self._src, self._dst).down:
            return True
        return await self._inner.wait_ready(timeout)
