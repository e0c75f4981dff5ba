"""Protocol watchdogs — per-state time limits on peer agency.

Reference: the `ProtocolTimeLimits` attached to every mini-protocol codec:
- ouroboros-network/src/Ouroboros/Network/Protocol/ChainSync/Codec.hs
  `timeLimitsChainSync` (StIntersect / StNext CanAwait: `shortWait` = 10 s;
  StNext MustReply: the long must-reply timeout, 135–269 s in the
  reference, randomised against eclipse timing attacks)
- .../Protocol/KeepAlive/Codec.hs `timeLimitsKeepAlive` (server reply
  within 60 s)
- .../Protocol/BlockFetch/Codec.hs `timeLimitsBlockFetch` (BFBusy /
  BFStreaming: 60 s)

A state where the PEER holds agency gets a deadline; when it expires the
peer is silent past its contract and the connection is killed — the
resulting :class:`WatchdogTimeout` flows into the ErrorPolicy layer
exactly like any other connection failure (suspend + redial).  States
where WE hold agency, and genuinely-unbounded server waits, carry no
limit (`None` = waitForever).

The wait itself uses the non-destructive ``channel.wait_ready`` poll
rather than cancelling a recv inside ``sim.timeout`` — a cancelled recv
continuation can lose pipeline bookkeeping (see Channel.wait_ready), and
a watchdog must never corrupt the very session it is guarding before the
kill decision is made.

Ported from `ouroboros_tpu/node/watchdog.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

from .. import simharness as sim
from ..observe import metrics as _metrics
from ..observe import netmetrics as _net

# one firing counter for all watchdogs; per-protocol attribution is a
# labeled series through the bounded-label helper (the name carries a
# runtime value, so it pays the same cardinality discipline as peer
# labels — OBS003).  Cold path: a firing kills the connection, so it
# happens at most once per peer lifetime.
_FIRINGS = _metrics.counter("watchdog.firings")


def _count_firing(protocol: str) -> None:
    _FIRINGS.inc()
    _net.labeled_counter("watchdog.firings_by_protocol",
                         protocol=protocol).inc()


class WatchdogTimeout(Exception):
    """A peer held agency past its per-state time limit: it is considered
    dead/adversarial and the connection must be torn down."""

    def __init__(self, protocol: str, state: str, limit: float):
        super().__init__(
            f"{protocol}: peer silent in state {state} past {limit}s limit")
        self.protocol = protocol
        self.state = state
        self.limit = limit


class KeepAliveTimeout(WatchdogTimeout):
    """The keep-alive responder missed its reply deadline — the
    whole-connection liveness signal (KeepAlive/Codec.hs 60 s limit)."""


@dataclass(frozen=True)
class ProtocolTimeLimits:
    """state -> seconds of allowed peer silence (None = wait forever)."""
    name: str
    limits: Mapping[str, Optional[float]]

    def limit_for(self, state: str) -> Optional[float]:
        return self.limits.get(state)


@dataclass(frozen=True)
class NodeTimeLimits:
    """The node's watchdog configuration, one knob set per protocol.

    Defaults mirror the reference's production values; chaos tests scale
    them down to the sim's slot length."""
    chain_sync_short: float = 10.0       # StIntersect + StNext (can-await)
    chain_sync_must_reply: float = 135.0  # StMustReply (caught-up idle)
    keep_alive_timeout: float = 60.0     # KAServer reply deadline
    block_fetch_busy: float = 60.0       # whole-request ceiling
    handshake_timeout: float = 10.0      # whole version negotiation
    # DeltaQ-informed BlockFetch deadline: a request is given
    # max(floor, mult * expected_fetch_time) capped by block_fetch_busy,
    # so a measured-fast peer is held to a measured-fast deadline
    # (Decision.hs deadline-mode expectations feeding the client).
    fetch_deadline_floor: float = 2.0
    fetch_deadline_mult: float = 4.0

    def chain_sync(self) -> ProtocolTimeLimits:
        return ProtocolTimeLimits("chain-sync", {
            "StIntersect": self.chain_sync_short,
            "StNext": self.chain_sync_short,
            "StMustReply": self.chain_sync_must_reply,
        })

    def fetch_deadline(self, tracker, est_bytes: int) -> float:
        """The per-request BlockFetch watchdog: DeltaQ expected duration
        scaled by `fetch_deadline_mult` (slack for queueing + variance),
        floored and capped.  An unmeasured peer gets the full ceiling."""
        # default False: a tracker without the `measured` attribute is
        # treated as UNmeasured (full ceiling) — failing the other way
        # would hand an optimistic-default GSV the tight deadline and
        # spuriously kill a healthy peer
        if tracker is None or not getattr(tracker, "measured", False):
            return self.block_fetch_busy
        expected = tracker.expected_fetch_time(max(est_bytes, 1))
        return min(self.block_fetch_busy,
                   max(self.fetch_deadline_floor,
                       self.fetch_deadline_mult * expected))


async def recv_with_limit(session, limits: ProtocolTimeLimits,
                          peer_id=None):
    """session.recv() guarded by the current state's time limit.

    Non-destructive: waits for a complete decodable message via
    wait_ready, then recv()s it — nothing is consumed on the timeout
    path, and the raised WatchdogTimeout carries the violated state."""
    limit = limits.limit_for(session.state)
    if limit is not None:
        ready = await session.channel.wait_ready(limit)
        if not ready:
            _count_firing(limits.name)
            sim.trace_event(("timeout", limits.name, session.state,
                             peer_id), label="watchdog")
            raise WatchdogTimeout(limits.name, session.state, limit)
    return await session.recv()


async def collect_with_limit(session, limits: ProtocolTimeLimits,
                             peer_id=None):
    """PipelinedSession.collect() under the time limit of the state the
    oldest outstanding reply is expected in (the pipelined analog of the
    reference's per-state limits — the peer owes us a reply for THAT
    state, not for the pipeline's advanced send state)."""
    state = session._outstanding[0] if session._outstanding \
        else session.state
    limit = limits.limit_for(state)
    if limit is not None:
        ready = await session.channel.wait_ready(limit)
        if not ready:
            _count_firing(limits.name)
            sim.trace_event(("timeout", limits.name, state, peer_id),
                            label="watchdog")
            raise WatchdogTimeout(limits.name, state, limit)
    return await session.collect()
