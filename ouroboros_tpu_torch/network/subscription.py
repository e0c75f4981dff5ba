"""Subscription workers — valency-tracked outbound connection maintenance.

Reference: ouroboros-network-framework/src/Ouroboros/Network/Subscription/
Worker.hs:207-233 (`worker`/`subscriptionLoop`: keep `valency` live
connections from a target list, redialling as they fail), Ip.hs:66-89 (IP
targets), Dns.hs:239-292 (name resolution + the A/AAAA race: both address
families resolve concurrently and the first usable answer wins, the loser
is kept as fallback), PeerState.hs (per-peer suspension state consulted
before dialling), with ErrorPolicy verdicts driving the suspensions.

The dial function abstracts the transport (in-sim kernel dialling here;
a socket Snocket plugs into the same seam).

Ported from `ouroboros_tpu/network/subscription.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

from .. import simharness as sim
from ..observe import metrics as _metrics
from ..observe import netmetrics as _net
from .error_policy import ErrorPolicy, SuspendDecision, eval_error_policies

# process-wide reconnect/suspension counters: the registry
# replaces grepping sim traces for dial/suspend tuples.  Gated writes —
# int bumps, invisible to sim determinism (no clock, no RNG).
_DIALS = _metrics.counter("subscription.dials")
_RECONNECTS = _metrics.counter("subscription.reconnects")
_CLEAN_ENDS = _metrics.counter("subscription.clean_ends")
_SUSPENSIONS = _metrics.counter("subscription.suspensions")
_FATALS = _metrics.counter("subscription.fatals")


class Resolver:
    """Name resolution seam (Dns.hs `Resolver`): resolve_a/resolve_aaaa
    return address lists for one family.  Implementations: a dict-backed
    sim resolver below; a getaddrinfo-backed one for the IO runtime."""

    async def resolve_a(self, name: str) -> list:
        return []

    async def resolve_aaaa(self, name: str) -> list:
        return []


class DictResolver(Resolver):
    """Deterministic resolver for sim tests: {name: (a_list, aaaa_list)}
    with optional per-family artificial latency."""

    def __init__(self, table: Dict[str, tuple], a_delay: float = 0.0,
                 aaaa_delay: float = 0.0):
        self.table = dict(table)
        self.a_delay = a_delay
        self.aaaa_delay = aaaa_delay

    async def resolve_a(self, name: str) -> list:
        if self.a_delay:
            await sim.sleep(self.a_delay)
        return list(self.table.get(name, ((), ()))[0])

    async def resolve_aaaa(self, name: str) -> list:
        if self.aaaa_delay:
            await sim.sleep(self.aaaa_delay)
        return list(self.table.get(name, ((), ()))[1])


class GetAddrInfoResolver(Resolver):
    """IO-runtime resolver over the system's getaddrinfo."""

    def __init__(self, port: int):
        self.port = port

    async def _resolve(self, name: str, family) -> list:
        import asyncio
        import socket
        loop = asyncio.get_event_loop()
        try:
            infos = await loop.getaddrinfo(name, self.port, family=family,
                                           type=socket.SOCK_STREAM)
        except OSError:
            return []
        # normalise sockaddrs to the (host, port) shape every dial path
        # consumes (AF_INET6 sockaddrs carry flowinfo/scopeid extras)
        return [(info[4][0], info[4][1]) for info in infos]

    async def resolve_a(self, name: str) -> list:
        import socket
        return await self._resolve(name, socket.AF_INET)

    async def resolve_aaaa(self, name: str) -> list:
        import socket
        return await self._resolve(name, socket.AF_INET6)


async def resolve_racing(resolver: Resolver, name: str,
                         prefer_delay: float = 0.05) -> list:
    """The Dns.hs A/AAAA race: both lookups run concurrently and the
    FIRST usable answer wins — a hung family cannot stall dialling.  After
    the winner arrives, the other family gets `prefer_delay` more to land
    (AAAA answering within the window still leads, as in the reference);
    a straggler past the window is dropped, not awaited."""
    from ..simharness import TQueue
    answers: TQueue = TQueue(label=f"dns-{name}")

    async def run(tag, coro):
        addrs = await coro

        def push(tx):
            answers.put(tx, (tag, addrs))
        await sim.atomically(push)

    sim.spawn(run("aaaa", resolver.resolve_aaaa(name)),
              label=f"dns-aaaa-{name}")
    sim.spawn(run("a", resolver.resolve_a(name)),
              label=f"dns-a-{name}")
    got: dict = {}
    # wait for the first USABLE (non-empty) answer, or both to finish
    while len(got) < 2:
        tag, addrs = await sim.atomically(answers.get)
        got[tag] = addrs
        if addrs:
            break
    if len(got) < 2:
        done, item = await sim.timeout(prefer_delay,
                                       sim.atomically(answers.get))
        if done and item is not None:
            got[item[0]] = item[1]
    a6 = got.get("aaaa", [])
    a4 = got.get("a", [])
    if a6:
        return list(a6) + [a for a in a4 if a not in a6]
    return list(a4)


async def dns_subscription_targets(resolver: Resolver, names: Sequence[str],
                                   prefer_delay: float = 0.05) -> list:
    """Resolve a root-peer name list into a concrete dial-target list
    (RootPeersDNS's role for the governor/subscription layer).  Names
    resolve CONCURRENTLY — wall clock is bounded by the slowest single
    lookup, not the sum."""
    results: dict = {}

    async def one(name):
        results[name] = await resolve_racing(resolver, name, prefer_delay)

    handles = [sim.spawn(one(n), label=f"dns-targets-{n}") for n in names]
    for h in handles:
        await h.wait()
    out: list = []
    for name in names:
        for addr in results.get(name, []):
            if addr not in out:
                out.append(addr)
    return out


@dataclass
class PeerState:
    """Subscription/PeerState.hs: per-address dial bookkeeping.

    The two suspension clocks mirror the reference's SuspendDecision
    split: `consumer_until` blocks only OUR outbound dialling
    (suspend-consumer — the peer's inbound service to us may be fine),
    `peer_until` marks the peer bad in both directions (suspend-peer —
    protocol violation / invalid data; an accept path can consult
    `peer_suspended`)."""
    fail_count: int = 0
    consumer_until: float = 0.0
    peer_until: float = 0.0
    connected: bool = False
    dials: int = 0            # lifetime dial count (dials>1 = reconnect)

    @property
    def suspended_until(self) -> float:
        return max(self.consumer_until, self.peer_until)


class SubscriptionFatal(Exception):
    """A THROW verdict: the error policy classified the failure as fatal
    to the application, not to the one peer (ErrorPolicy.hs `Throw`).
    Carries the original exception as __cause__."""


class SubscriptionWorker:
    """Maintain `valency` live connections from `targets`.

    dial(addr) -> Async handle whose completion (normal or exceptional)
    means the connection ended.  Failures are classified by the error
    policies into SuspendDecision verdicts (Worker.hs + PeerState.hs):

    - throw             -> SubscriptionFatal out of run() (application dies)
    - suspend-peer      -> both-direction suspension, exponential backoff
    - suspend-consumer  -> dial-side suspension, exponential backoff
    - clean end         -> fail_count RESET, one base_backoff churn pause
                           (a successful session wipes the escalation —
                           the reference re-zeroes the peer state when a
                           connection completes without error)

    Backoff is `duration * 2^min(fail_count-1, 5)` plus seeded jitter so
    a fleet of workers never thundering-herds a recovering peer — and the
    jitter comes from a per-worker blake2b-seeded RNG, keeping whole-sim
    replays byte-identical.
    """

    def __init__(self, targets: Sequence, valency: int,
                 dial: Callable, error_policies: Sequence[ErrorPolicy] = (),
                 base_backoff: float = 5.0, label: str = "subscription",
                 jitter: float = 0.25, seed: int = 0):
        self.targets = list(targets)
        self.valency = min(valency, len(self.targets))
        self.dial = dial
        self.error_policies = list(error_policies)
        self.base_backoff = base_backoff
        self.label = label
        self.jitter = jitter
        h = hashlib.blake2b(f"{seed}:{label}".encode(), digest_size=8)
        self.rng = random.Random(int.from_bytes(h.digest(), "big"))
        self.states: Dict[object, PeerState] = {
            a: PeerState() for a in self.targets}
        self.trace: list = []
        self._conns: Dict[object, object] = {}     # addr -> Async

    def _candidates(self) -> list:
        now = sim.now()
        return [a for a in self.targets
                if not self.states[a].connected
                and self.states[a].suspended_until <= now]

    def peer_suspended(self, addr) -> bool:
        """True while `addr` sits in a suspend-peer window — the signal an
        accept/server path can consult to refuse the peer's inbound too."""
        st = self.states.get(addr)
        return st is not None and st.peer_until > sim.now()

    def _backoff(self, duration: float, fail_count: int) -> float:
        scaled = duration * (2 ** min(max(fail_count - 1, 0), 5))
        return scaled * (1.0 + self.rng.random() * self.jitter)

    def _on_conn_end(self, addr, exc: Optional[BaseException]) -> None:
        st = self.states[addr]
        st.connected = False
        now = sim.now()
        if exc is None:
            # clean session: reset the escalation entirely; pause one
            # base_backoff (no exponent) before re-dialling so a cleanly
            # churning peer is not hammered — but never escalates either
            st.fail_count = 0
            st.consumer_until = now + self._backoff(self.base_backoff, 0)
            self.trace.append((now, "conn-end", addr, None))
            _CLEAN_ENDS.inc()
            sim.trace_event((self.label, "conn-end-clean", addr),
                            label="subscription")
            return
        verdict = eval_error_policies(self.error_policies, exc)
        if verdict is None:
            verdict = SuspendDecision("suspend-consumer", self.base_backoff)
        if verdict.kind == "throw":
            # fatal: surface to the application instead of converting the
            # verdict into a quiet backoff window
            _FATALS.inc()
            sim.trace_event((self.label, "fatal", addr, repr(exc)),
                            label="subscription")
            raise SubscriptionFatal(
                f"{self.label}: THROW verdict for {addr}") from exc
        st.fail_count += 1
        until = now + self._backoff(verdict.duration, st.fail_count)
        st.consumer_until = max(st.consumer_until, until)
        if verdict.kind == "suspend-peer":
            st.peer_until = max(st.peer_until, until)
        _SUSPENSIONS.inc()
        if _metrics.REGISTRY.enabled:
            # per-peer suspension attribution through the bounded-label
            # helper; cold path (one write per connection death)
            _net.labeled_counter("net.peer.suspensions",
                                 peer=_net.peer_label(addr)).inc()
        self.trace.append((now, "conn-end", addr, repr(exc)))
        sim.trace_event((self.label, "suspend", addr, verdict.kind,
                         round(until - now, 6), st.fail_count),
                        label="subscription")

    async def run(self) -> None:
        """subscriptionLoop: top up to valency, then block until a
        connection ends (watcher threads feed an STM queue) or a
        suspension window expires."""
        from ..simharness import TQueue
        endings: TQueue = TQueue(label=f"{self.label}-endings")

        async def watch(addr, handle):
            exc = None
            try:
                await handle.wait()
            except BaseException as e:
                exc = e

            def push(tx):
                endings.put(tx, (addr, exc))
            await sim.atomically(push)

        while True:
            for addr in self._candidates():
                if len(self._conns) >= self.valency:
                    break
                st = self.states[addr]
                st.connected = True
                if st.dials:
                    _RECONNECTS.inc()
                st.dials += 1
                _DIALS.inc()
                self.trace.append((sim.now(), "dial", addr))
                sim.trace_event((self.label, "dial", addr, st.fail_count),
                                label="subscription")
                handle = self.dial(addr)
                self._conns[addr] = handle
                sim.spawn(watch(addr, handle),
                          label=f"{self.label}.watch-{addr}")

            # wait for an ending, or poll again when the earliest
            # suspension expires
            now = sim.now()
            pending = [s.suspended_until for s in self.states.values()
                       if not s.connected and s.suspended_until > now]
            wait_for = min(pending) - now if pending else self.base_backoff
            done, item = await sim.timeout(
                max(wait_for, 0.01),
                sim.atomically(lambda tx: endings.get(tx)))
            if done and item is not None:
                addr, exc = item
                self._conns.pop(addr, None)
                self._on_conn_end(addr, exc)
