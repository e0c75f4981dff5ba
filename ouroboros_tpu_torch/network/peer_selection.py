"""Peer-selection governor — declarative connectivity targets.

Reference: ouroboros-network/src/Ouroboros/Network/PeerSelection/
Governor.hs:427-469 (main loop re-running a guarded STM decision set),
Governor/Types.hs:89-94 (`PeerSelectionTargets` {root/known/established/
active}), KnownPeers.hs (known-peer set with reconnect times),
LedgerPeers.hs:96 (`accPoolStake` stake-weighted sampling), and the churn
stub `peerChurnGovernor` (Governor.hs:557).

As in the reference snapshot, the governor is a standalone, heavily
property-tested component (diffusion wires the subscription machinery;
governor-driven P2P was future work there — SURVEY.md §2).  Decisions are
pure (`governor_decisions`) over an immutable view so properties mirror
the reference's: targets are reached, no oscillation, suspensions respected.

Ported from `ouroboros_tpu/network/peer_selection.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Sequence

from .. import simharness as sim
from ..observe import metrics as _metrics
from ..simharness import Retry, TVar

# governor churn counters: successful ladder transitions plus
# failure-driven suspensions, pre-bound (OBS002).  Gated int bumps —
# invisible to sim determinism.
_PROMOTED_COLD = _metrics.counter("net.governor.promote_cold")
_PROMOTED_WARM = _metrics.counter("net.governor.promote_warm")
_DEMOTED_HOT = _metrics.counter("net.governor.demote_hot")
_DEMOTED_WARM = _metrics.counter("net.governor.demote_warm")
_CHURN_ROUNDS = _metrics.counter("net.governor.churn_rounds")
_GOV_SUSPENSIONS = _metrics.counter("net.governor.suspensions")


@dataclass(frozen=True)
class PeerSelectionTargets:
    """Governor/Types.hs:89-94."""
    target_known: int = 20
    target_established: int = 10
    target_active: int = 5

    def sane(self) -> bool:
        return (0 <= self.target_active <= self.target_established
                <= self.target_known)


@dataclass
class KnownPeerInfo:
    """KnownPeers.hs per-peer bookkeeping."""
    source: str = "gossip"           # "root" | "ledger" | "gossip"
    fail_count: int = 0
    reconnect_at: float = 0.0        # suspended until (virtual time)


class KnownPeers:
    """The known-peer set (PeerSelection/KnownPeers.hs)."""

    def __init__(self):
        self.peers: Dict[object, KnownPeerInfo] = {}

    def add(self, addr, source: str = "gossip") -> None:
        self.peers.setdefault(addr, KnownPeerInfo(source=source))

    def remove(self, addr) -> None:
        self.peers.pop(addr, None)

    def suspend(self, addr, until: float) -> None:
        info = self.peers.get(addr)
        if info is not None:
            info.fail_count += 1
            info.reconnect_at = max(info.reconnect_at, until)

    def cooldown(self, addr, until: float) -> None:
        """Churn cool-down: delay re-selection WITHOUT counting a failure."""
        info = self.peers.get(addr)
        if info is not None:
            info.reconnect_at = max(info.reconnect_at, until)

    def available(self, now: float, exclude=()) -> list:
        ex = set(exclude)
        return sorted((a for a, i in self.peers.items()
                       if a not in ex and i.reconnect_at <= now),
                      key=str)

    def __len__(self) -> int:
        return len(self.peers)

    def __contains__(self, addr) -> bool:
        return addr in self.peers


@dataclass(frozen=True)
class GovernorView:
    """Immutable snapshot the pure decision step runs over."""
    now: float
    targets: PeerSelectionTargets
    known: tuple                     # available (non-suspended) known addrs
    known_total: int
    established: tuple               # warm + hot
    active: tuple                    # hot subset


@dataclass(frozen=True)
class Decision:
    kind: str                        # below
    addr: object = None

# decision kinds (each maps to one guarded job in Governor.hs:427-469)
REQUEST_MORE_PEERS = "request-more-peers"
PROMOTE_COLD = "promote-cold-to-warm"    # connect
PROMOTE_WARM = "promote-warm-to-hot"     # activate protocols
DEMOTE_HOT = "demote-hot-to-warm"
DEMOTE_WARM = "demote-warm-to-cold"


def governor_decisions(view: GovernorView,
                       rng: Optional[random.Random] = None) -> list[Decision]:
    """One pure decision round: everything the guarded set would fire now.

    Mirrors Governor.hs's decision order: grow known peers, then promote
    toward the established/active targets, then demote overshoot."""
    out: list[Decision] = []
    t = view.targets
    est, act = set(view.established), set(view.active)

    if view.known_total < t.target_known:
        out.append(Decision(REQUEST_MORE_PEERS))

    cold = [a for a in view.known if a not in est]
    want_est = t.target_established - len(est)
    pick = rng.sample if rng else (lambda xs, n: xs[:n])
    for a in pick(cold, min(want_est, len(cold))) if want_est > 0 else []:
        out.append(Decision(PROMOTE_COLD, a))

    warm = [a for a in view.established if a not in act]
    want_act = t.target_active - len(act)
    for a in pick(warm, min(want_act, len(warm))) if want_act > 0 else []:
        out.append(Decision(PROMOTE_WARM, a))

    over_act = len(act) - t.target_active
    if over_act > 0:
        for a in sorted(act, key=str)[:over_act]:
            out.append(Decision(DEMOTE_HOT, a))

    over_est = len(est) - t.target_established
    if over_est > 0:
        demotable = sorted((a for a in est if a not in act), key=str)
        for a in demotable[:over_est]:
            out.append(Decision(DEMOTE_WARM, a))
    return out


def ledger_peer_sample(stake_map: Dict[object, int], n: int,
                       rng: random.Random) -> list:
    """Stake-weighted sampling without replacement (accPoolStake,
    LedgerPeers.hs:96): repeatedly draw from the cumulative stake line."""
    pool = dict(stake_map)
    out = []
    while pool and len(out) < n:
        total = sum(pool.values())
        x = rng.uniform(0, total)
        acc = 0.0
        chosen = None
        for addr in sorted(pool, key=str):
            acc += pool[addr]
            if x <= acc:
                chosen = addr
                break
        if chosen is None:
            chosen = sorted(pool, key=str)[-1]
        out.append(chosen)
        del pool[chosen]
    return out


class PeerSelectionActions:
    """Side-effect interface the governor loop drives (the reference's
    PeerSelectionActions record): override in the integration layer."""

    async def request_peers(self) -> Sequence:
        """Root/ledger peer discovery: return new addrs (RootPeersDNS /
        LedgerPeers role)."""
        return []

    async def gossip(self, addr) -> Sequence:
        """Ask one established peer for ITS known peers (the gossip /
        peer-sharing requests of Governor.hs's known-peers-below-target
        job).  Default: nothing."""
        return []

    async def connect(self, addr) -> bool:
        """Cold→warm (establish).  True on success."""
        return True

    async def activate(self, addr) -> bool:
        """Warm→hot (start the mini-protocol set)."""
        return True

    async def deactivate(self, addr) -> None:
        """Hot→warm."""

    async def disconnect(self, addr) -> None:
        """Warm→cold."""


class PeerSelectionGovernor:
    """The main loop (Governor.hs:427): re-run decisions when state
    changes or a retry timer expires."""

    def __init__(self, targets: PeerSelectionTargets,
                 actions: PeerSelectionActions,
                 seed: int = 0, retry_interval: float = 5.0,
                 suspend_base: float = 10.0,
                 gossip_interval: float = 30.0,
                 self_addr=None):
        assert targets.sane()
        self.targets = targets
        self.actions = actions
        self.rng = random.Random(seed)
        self.retry_interval = retry_interval
        self.suspend_base = suspend_base
        self.gossip_interval = gossip_interval
        self.self_addr = self_addr
        self.known = KnownPeers()
        self.established: set = set()
        self.active: set = set()
        self.wakeup = TVar(0, label="governor-wakeup")
        self._v = 0
        self._last_gossip: Dict[object, float] = {}
        self.trace: list = []

    def poke(self) -> None:
        self._v += 1
        try:
            self.wakeup.set_notify(self._v)
        except Exception:
            self.wakeup._value = self._v

    def view(self) -> GovernorView:
        return GovernorView(
            now=sim.now(), targets=self.targets,
            known=tuple(self.known.available(sim.now())),
            known_total=len(self.known),
            established=tuple(sorted(self.established, key=str)),
            active=tuple(sorted(self.active, key=str)))

    def report_failure(self, addr) -> None:
        """Connection/protocol failure feedback (ErrorPolicy verdicts land
        here): exponential-backoff suspension (KnownPeers reconnect)."""
        info = self.known.peers.get(addr)
        backoff = self.suspend_base * (2 ** min(info.fail_count if info
                                                else 0, 6))
        self.known.suspend(addr, sim.now() + backoff)
        self.established.discard(addr)
        self.active.discard(addr)
        _GOV_SUSPENSIONS.inc()
        self.poke()

    async def _apply(self, d: Decision) -> None:
        self.trace.append((sim.now(), d.kind, d.addr))
        if d.kind == REQUEST_MORE_PEERS:
            for a in await self.actions.request_peers():
                self.known.add(a, source="root")
            # gossip round: ask established peers (not recently asked) for
            # their peers — the transitive discovery that fills KnownPeers
            # past the root set (Governor.hs known-peers job)
            now = sim.now()
            for peer in sorted(self.established, key=str):
                if now - self._last_gossip.get(peer, -1e9) \
                        < self.gossip_interval:
                    continue
                self._last_gossip[peer] = now
                for a in await self.actions.gossip(peer):
                    if a != self.self_addr:
                        self.known.add(a, source="gossip")
        elif d.kind == PROMOTE_COLD:
            ok = await self.actions.connect(d.addr)
            if ok:
                self.established.add(d.addr)
                _PROMOTED_COLD.inc()
                info = self.known.peers.get(d.addr)
                if info is not None:
                    info.fail_count = 0
            else:
                self.report_failure(d.addr)
        elif d.kind == PROMOTE_WARM:
            if await self.actions.activate(d.addr):
                self.active.add(d.addr)
                _PROMOTED_WARM.inc()
            else:
                self.report_failure(d.addr)
        elif d.kind == DEMOTE_HOT:
            await self.actions.deactivate(d.addr)
            self.active.discard(d.addr)
            _DEMOTED_HOT.inc()
        elif d.kind == DEMOTE_WARM:
            await self.actions.disconnect(d.addr)
            self.established.discard(d.addr)
            _DEMOTED_WARM.inc()

    async def churn_round(self) -> Optional[object]:
        """One churn step (peerChurnGovernor, Governor.hs:557): demote a
        random hot peer to cold with a cool-down so the replacement is a
        DIFFERENT peer — continuous rotation keeps the peer graph fresh
        and defeats eclipse-by-staleness.  Returns the rotated peer."""
        if not self.active:
            return None
        victim = self.rng.choice(sorted(self.active, key=str))
        _CHURN_ROUNDS.inc()
        self.trace.append((sim.now(), "churn", victim))
        await self.actions.deactivate(victim)
        self.active.discard(victim)
        await self.actions.disconnect(victim)
        self.established.discard(victim)
        self.known.cooldown(victim, sim.now() + self.retry_interval)
        self.poke()
        return victim

    async def run_churn(self, interval: float = 60.0) -> None:
        """The churn loop; fork alongside run()."""
        while True:
            await sim.sleep(interval)
            await self.churn_round()

    async def run(self) -> None:
        while True:
            decisions = governor_decisions(self.view(), self.rng)
            progressed = False
            for d in decisions:
                before = (len(self.known), len(self.established),
                          len(self.active))
                await self._apply(d)
                after = (len(self.known), len(self.established),
                         len(self.active))
                progressed = progressed or after != before
            if progressed:
                await sim.yield_()
                continue
            # idle: wait for a poke or the retry timer (suspended peers
            # coming back / discovery returning nothing yet)
            seen = self.wakeup.value

            def wait(tx, seen=seen):
                if tx.read(self.wakeup) == seen:
                    raise Retry()
            done, _ = await sim.timeout(self.retry_interval,
                                        sim.atomically(wait))
