"""ErrorPolicy — classify connection failures into suspend/shutdown verdicts.

Reference: ouroboros-network-framework/src/Ouroboros/Network/ErrorPolicy.hs
:52-89 (`ErrorPolicy` GADT matching exception types, `evalErrorPolicy`,
`SuspendDecision` semigroup: SuspendPeer/SuspendConsumer/Throw with
duration-max combining), and the consensus instantiation
(ouroboros-consensus/src/Ouroboros/Consensus/Node/ErrorPolicy.hs).

Ported from `ouroboros_tpu/network/error_policy.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Type


@dataclass(frozen=True)
class SuspendDecision:
    """What to do about a peer after an exception.

    kind: "suspend-peer" (both directions) | "suspend-consumer" (our
    outbound only) | "throw" (fatal: shut the application down).
    """
    kind: str
    duration: float = 0.0

    def __or__(self, other: "SuspendDecision") -> "SuspendDecision":
        """The semigroup (ErrorPolicy.hs `SuspendDecision` Semigroup):
        throw dominates; suspend-peer dominates suspend-consumer;
        durations combine by max."""
        if "throw" in (self.kind, other.kind):
            return SuspendDecision("throw")
        kind = "suspend-peer" if "suspend-peer" in (self.kind, other.kind) \
            else "suspend-consumer"
        return SuspendDecision(kind, max(self.duration, other.duration))


def suspend_peer(duration: float) -> SuspendDecision:
    return SuspendDecision("suspend-peer", duration)


def suspend_consumer(duration: float) -> SuspendDecision:
    return SuspendDecision("suspend-consumer", duration)


THROW = SuspendDecision("throw")


@dataclass(frozen=True)
class ErrorPolicy:
    """One rule: exception class -> decision (ErrorPolicy.hs:52)."""
    exc_type: Type[BaseException]
    decide: Callable[[BaseException], Optional[SuspendDecision]]


def eval_error_policies(policies: Sequence[ErrorPolicy],
                        exc: BaseException) -> Optional[SuspendDecision]:
    """First match (in list order) wins, so specific rules listed before a
    catch-all take precedence; a single rule may still return None to
    decline (evalErrorPolicy/evalErrorPolicies — the reference combines
    only the verdicts of *independent* policy sets with the semigroup,
    which callers can do with `|`)."""
    for p in policies:
        if isinstance(exc, p.exc_type):
            d = p.decide(exc)
            if d is not None:
                return d
    return None


def default_node_policies(violation: float = 200.0,
                          transport: float = 20.0,
                          unknown: float = 60.0) -> list[ErrorPolicy]:
    """The consensus-flavoured defaults (Node/ErrorPolicy.hs): protocol
    violations and validation failures suspend the peer for a long time;
    transport hiccups suspend briefly; everything unknown suspends
    conservatively.  The three duration knobs exist so sim/chaos harnesses
    can scale the windows to sim time while exercising the SAME policy
    set (testing a hand-copied list would let the two drift)."""
    from ..node.chain_sync import ChainSyncClientError
    from ..node.watchdog import WatchdogTimeout
    from .mux import MuxError
    from .typed import ProtocolError
    from ..network.protocols.codec import CodecError
    return [
        ErrorPolicy(ChainSyncClientError,
                    lambda e: suspend_peer(violation)),
        ErrorPolicy(ProtocolError, lambda e: suspend_peer(violation)),
        ErrorPolicy(CodecError, lambda e: suspend_peer(violation)),
        # a peer silent past its per-state time limit is likely overloaded
        # or partitioned, not hostile: brief consumer-side suspension, then
        # redial (the reference's shortDelay for timeout errors)
        ErrorPolicy(WatchdogTimeout, lambda e: suspend_consumer(transport)),
        # the mux died under the protocol (bearer EOF / poisoned teardown
        # after a watchdog kill): transport-level hiccup, brief suspension
        ErrorPolicy(MuxError, lambda e: suspend_consumer(transport)),
        ErrorPolicy(ConnectionError, lambda e: suspend_consumer(transport)),
        ErrorPolicy(Exception, lambda e: suspend_consumer(unknown)),
    ]
