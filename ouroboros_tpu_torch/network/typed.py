"""Typed protocols — session-typed state machines, runtime-enforced.

Reference: typed-protocols/src/Network/TypedProtocol/Core.hs:264-403 (the
Protocol class + Message GADT + Peer) and Pipelined.hs (type-level pipelining).
Haskell enforces protocol conformance statically; the Python rebuild enforces
it dynamically: a ProtocolSpec declares per-state agency and the transition
relation, and every send/recv is checked against it, so a misbehaving peer
fails deterministically at the exact violating step (same error surface the
reference gets at compile time, moved to simulation time).

A peer is an async function `peer(session)`; `run_peer` drives it over a
Channel with a Codec.  Pipelining follows Driver.hs:150-186: a receiver task
drains replies into a collect queue while the sender keeps issuing requests,
bounded by `max_outstanding`.

Ported from `ouroboros_tpu/network/typed.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import simharness as sim
from ..simharness import TBQueue
from .channel import Channel

CLIENT, SERVER, NOBODY = "client", "server", "nobody"


class ProtocolError(Exception):
    """Agency/transition violation or codec failure."""


def branch(fn: Callable, *targets: str) -> Callable:
    """Tag a message-value-dependent transition callable with its
    statically-known target states.

    The Haskell reference encodes value-dependent branches in the Message
    GADT's result index, so the compiler still sees every target state; a
    bare Python callable hides them.  `branch` restores the static view:
    ouro-lint's protocol pass (tools/analysis/protocol_pass.py) reads
    `.targets` for reachability/totality and rejects opaque callables.
    The returned dispatcher also enforces the declaration at run time, so
    the analyzer's graph can't silently diverge from actual behaviour."""
    if not targets:
        raise ValueError("branch() needs at least one target state")
    declared = frozenset(targets)

    def dispatch(msg):
        nxt = fn(msg)
        if nxt not in declared:
            raise ProtocolError(
                f"branch callable returned undeclared state {nxt!r}; "
                f"declared targets are {sorted(declared)}")
        return nxt

    dispatch.targets = tuple(targets)
    return dispatch


@dataclass(frozen=True)
class ProtocolSpec:
    """States + agency + transitions for one mini-protocol.

    transitions: (state, message type name) -> next state, or a callable
    (msg -> next state) for message-value-dependent transitions (e.g.
    TxSubmission's blocking flag).
    agency: state -> CLIENT | SERVER | NOBODY (who may send in that state).
    """
    name: str
    init_state: str
    agency: dict
    transitions: dict

    def _next(self, state: str, msg) -> Optional[str]:
        nxt = self.transitions.get((state, type(msg).__name__))
        if callable(nxt):
            return nxt(msg)
        return nxt

    def check_send(self, state: str, role: str, msg) -> str:
        who = self.agency.get(state, NOBODY)
        if who != role:
            raise ProtocolError(
                f"{self.name}: {role} tried to send {type(msg).__name__} "
                f"in state {state} where agency is {who}")
        nxt = self._next(state, msg)
        if nxt is None:
            raise ProtocolError(
                f"{self.name}: message {type(msg).__name__} not allowed "
                f"in state {state}")
        return nxt

    def is_done(self, state: str) -> bool:
        return self.agency.get(state, NOBODY) == NOBODY


class Session:
    """The per-peer protocol handle: send/recv with conformance checking."""

    def __init__(self, spec: ProtocolSpec, role: str, channel: Channel):
        self.spec = spec
        self.role = role
        self.channel = channel
        self.state = spec.init_state

    @property
    def done(self) -> bool:
        return self.spec.is_done(self.state)

    async def send(self, msg) -> None:
        self.state = self.spec.check_send(self.state, self.role, msg)
        await self.channel.send(msg)

    async def recv(self):
        other = SERVER if self.role == CLIENT else CLIENT
        who = self.spec.agency.get(self.state, NOBODY)
        if who != other:
            raise ProtocolError(
                f"{self.spec.name}: {self.role} tried to recv in state "
                f"{self.state} where agency is {who}")
        msg = await self.channel.recv()
        nxt = self.spec._next(self.state, msg)
        if nxt is None:
            raise ProtocolError(
                f"{self.spec.name}: peer sent {type(msg).__name__} "
                f"invalid in state {self.state}")
        self.state = nxt
        return msg


class PipelinedSession(Session):
    """Client-side pipelining: fire requests ahead of replies.

    Reference: Pipelined.hs:63 (type-level outstanding bound) and the
    two-thread driver (Driver.hs:150-186).  send_pipelined() advances the
    state machine through the *expected* reply state immediately; replies
    are collected in order via collect().
    """

    def __init__(self, spec: ProtocolSpec, role: str, channel: Channel,
                 max_outstanding: int = 16):
        super().__init__(spec, role, channel)
        self.max_outstanding = max_outstanding
        self._outstanding: list[str] = []   # states awaiting replies

    async def send_pipelined(self, msg, reply_state: str) -> None:
        """Send msg; the reply (to be collected later) is expected in the
        state the msg moves us to; after the reply we'll be in reply_state."""
        if len(self._outstanding) >= self.max_outstanding:
            raise ProtocolError(f"{self.spec.name}: pipeline depth exceeded")
        st = self.spec.check_send(self.state, self.role, msg)
        self._outstanding.append(st)
        self.state = reply_state
        await self.channel.send(msg)

    @property
    def outstanding(self) -> int:
        return len(self._outstanding)

    async def collect(self):
        """Await the oldest outstanding reply.

        A reply may span several messages (e.g. ChainSync's MsgAwaitReply
        followed by the eventual MsgRollForward): when the state after this
        message still has peer agency, the continuation state goes back to
        the front of the queue so the next collect() consumes the rest.

        Cancellation-safe: the outstanding entry is only consumed AFTER the
        recv completes, so wrapping collect() in a timeout and cancelling it
        (e.g. the ChainSync client's horizon-stall poll) leaves the pipeline
        bookkeeping intact — the reply the server still owes will be matched
        against the right expected state by the next collect()."""
        if not self._outstanding:
            raise ProtocolError(f"{self.spec.name}: nothing to collect")
        reply_in_state = self._outstanding[0]
        msg = await self.channel.recv()
        # no await between here and the pop: atomic under the cooperative
        # scheduler, so a single consumer can never double-collect the entry
        popped = self._outstanding.pop(0)
        assert popped is reply_in_state
        nxt = self.spec._next(reply_in_state, msg)
        if nxt is None:
            raise ProtocolError(
                f"{self.spec.name}: pipelined peer sent "
                f"{type(msg).__name__} invalid in state {reply_in_state}")
        other = SERVER if self.role == CLIENT else CLIENT
        if self.spec.agency.get(nxt, NOBODY) == other:
            self._outstanding.insert(0, nxt)
        return msg


async def run_peer(spec: ProtocolSpec, role: str, channel: Channel,
                   peer: Callable, pipelined: bool = False,
                   max_outstanding: int = 16):
    """Run an async peer function against a channel; returns its result.

    The message-object analog of runPeerWithDriver (Driver.hs:17-25); byte
    framing happens one layer down (mux channels / codecs).
    """
    if pipelined:
        session = PipelinedSession(spec, role, channel, max_outstanding)
    else:
        session = Session(spec, role, channel)
    return await peer(session)


async def connect(spec: ProtocolSpec, client, server,
                  capacity: int = 64, delay: float = 0.0):
    """Direct client<->server execution over an in-memory channel pair —
    the Proofs.hs `connect` analog used throughout protocol tests."""
    from .channel import channel_pair
    ca, cb = channel_pair(capacity=capacity, delay=delay,
                          label=spec.name)
    ch = sim.spawn(run_peer(spec, CLIENT, ca, client),
                   label=f"{spec.name}.client")
    sh = sim.spawn(run_peer(spec, SERVER, cb, server),
                   label=f"{spec.name}.server")
    return await ch.wait(), await sh.wait()
