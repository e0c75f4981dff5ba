"""Consensus-side ChainSync client + server.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/MiniProtocol/
ChainSync/Client.hs:418-431 (intersect, then pipelined roll-forward with
full header validation per header at :792, candidate-fragment STM publish,
kill on invalid header / too-deep rollback at :1114) and ChainSync/Server.hs
(server from a ChainDB follower).

A batched redesign of the client hot loop: instead of validating each
header as it arrives (the reference's per-header `validateHeader`), the
client pipelines up to `window` MsgRequestNext, buffers the roll-forwards,
and validates the whole buffer through consensus/batch.py — ONE device
batch for all VRF/KES/Ed25519 proofs in the window.  While syncing this
turns thousands of device round-trips into dozens; when caught up the
window degrades gracefully to batch-of-1.

Ported from `ouroboros_tpu/node/chain_sync.py` (the port imports nothing of
the JAX package). Copied whole; its two lazy imports (the forecast error and
the coalesced flush) are the port's own (`..consensus.ledger`,
`..crypto.batching`), so a caught-up flush reaches the port's
`VerifyService` and, through it, the card.
"""
from __future__ import annotations

from typing import Optional

from .. import simharness as sim
from ..chain.block import Point, point_of
from ..chain.fragment import AnchoredFragment
from ..consensus.batch import validate_headers_batched
from ..consensus.header_validation import HeaderState, HeaderStateHistory
from ..observe import metrics as _metrics
from ..observe.spans import monotonic_now as _mono_now
from ..network.protocols.chainsync import (
    MsgAwaitReply, MsgFindIntersect, MsgIntersectFound, MsgIntersectNotFound,
    MsgRequestNext, MsgRollBackward, MsgRollForward,
)
from ..simharness import Retry, TVar
from .watchdog import collect_with_limit, recv_with_limit

# Fibonacci-ish offsets for intersection points, like the reference's
# chainSyncClient headerPoints (Client.hs mkPoints)
_OFFSETS = (0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144)

# header-arrival instrumentation: while syncing the window
# fills to `window` headers per flush; caught up it degrades to
# batch-of-1 — the exact distribution the adaptive batching service
# (ROADMAP item 3) needs to see live.  Handles pre-bound (OBS002);
# virtual-time gaps under sim, wall gaps in production (unstable).
_ARRIVAL_GAP = _metrics.latency_histogram("chainsync.arrival_gap_secs")
_FLUSH_HEADERS = _metrics.histogram("chainsync.flush_headers",
                                    stable=False)


def pipeline_decision(outstanding: int, low: int, high: int,
                      caught_up: bool) -> str:
    """The low/high-watermark pipelining policy
    (Protocol/ChainSync/PipelineDecision.hs pipelineDecisionLowHighMark):
    behind the server tip, pipeline until the HIGH mark; caught up, only
    refill to the LOW mark (collect otherwise) so a quiescent tip is not
    saturated with speculative requests."""
    target = low if caught_up else high
    return "pipeline" if outstanding < target else "collect"


class ChainSyncClientError(Exception):
    """Peer sent an invalid header / rolled back too deep — disconnect and
    (for invalid headers) remember the block as bad (Client.hs:1114)."""


class CandidateState:
    """Per-peer candidate header chain published to BlockFetch
    (the candidate-fragment map entry, NodeKernel.hs:156)."""

    def __init__(self, peer_id):
        self.peer_id = peer_id
        self.fragment: Optional[AnchoredFragment] = None
        self.version = TVar(0, label=f"candidate-{peer_id}")
        self._v = 0

    def publish(self, fragment: AnchoredFragment) -> None:
        self.fragment = fragment
        self._v += 1
        try:
            self.version.set_notify(self._v)
        except Exception:
            self.version._value = self._v


async def chain_sync_client(session, kernel, candidate: CandidateState,
                            window: int = 32) -> None:
    """Pipelined ChainSync client against `session` (CLIENT role,
    PipelinedSession).  Publishes validated headers into `candidate`;
    raises ChainSyncClientError to kill the connection.
    """
    db = kernel.chain_db
    protocol = kernel.protocol
    # per-state time limits (timeLimitsChainSync): a peer silent past its
    # state's deadline is killed via WatchdogTimeout -> ErrorPolicy
    limits = kernel.time_limits.chain_sync()
    # block-propagation lifecycle tracker: records
    # first-header-seen / validated stamps when the kernel carries one
    prop = getattr(kernel, "propagation", None)

    # -- find intersection with our current chain ----------------------------
    points = db.current_chain.select_points(_OFFSETS)
    if db.current_chain.anchor not in points:
        points.append(db.current_chain.anchor)
    await session.send(MsgFindIntersect(tuple(points)))
    reply = await recv_with_limit(session, limits, peer_id=candidate.peer_id)
    if isinstance(reply, MsgIntersectNotFound):
        raise ChainSyncClientError("no intersection with peer chain")
    assert isinstance(reply, MsgIntersectFound)
    isect: Point = reply.point

    # Seed the header-state history with ALL of the ledger DB's recent
    # states up to the intersection (not just the intersection's), so a
    # legitimate rollback to a point *before* the intersection — a fork
    # whose branch point predates where we joined the peer — still rewinds
    # instead of killing the peer (the reference seeds from
    # HeaderStateHistory of the last k states for exactly this reason).
    past = db.ledger_db.past_points()
    if isect not in past:
        raise ChainSyncClientError(
            f"intersection {isect} deeper than our ledger history")
    seed_points = past[:past.index(isect) + 1]
    history = HeaderStateHistory(
        protocol.security_param, db.ledger_db.state_at(seed_points[0]).header)
    for p in seed_points[1:]:
        history.append(db.ledger_db.state_at(p).header)

    anchor_bn = _block_no_at(db, isect)
    fragment = AnchoredFragment(isect, (), anchor_block_no=anchor_bn)
    candidate.publish(fragment.copy())

    buffered: list = []          # validated-pending roll-forward headers

    async def flush() -> None:
        """Validate `buffered` as one batched window and publish.

        Views are forecast at each header's slot (cross-era aware); when
        the forecast horizon is hit the validated prefix is published and
        the rest stays buffered until the chain advances (the reference's
        forecast-horizon waiting, Client.hs:~740-790).

        A sub-window flush — the caught-up batch-of-1 regime — routes
        its proofs through the kernel's VerifyService when one is wired
        (crypto/batching.py): the window's handful of proofs coalesces
        with every other protocol thread's traffic into one device batch
        (or takes the CPU break-even fallback) instead of dispatching
        alone.  Full windows keep the direct batched path: they already
        ARE a good device batch."""
        if not buffered:
            return
        _FLUSH_HEADERS.observe(len(buffered))
        from ..consensus.ledger import OutsideForecastRange
        svc = getattr(kernel, "verify_service", None)
        if svc is not None and len(buffered) < window:
            from ..crypto.batching import (
                validate_headers_coalesced,
            )
            res = await validate_headers_coalesced(
                protocol, buffered, history.current,
                lambda i, h: kernel.forecast_view(h.slot), svc)
        else:
            res = validate_headers_batched(
                protocol, buffered, history.current,
                lambda i, h: kernel.forecast_view(h.slot),
                backend=kernel.backend)
        for st, h in zip(res.states, buffered[:res.n_valid]):
            history.append(st)
            fragment.add_block(h)
            if prop is not None:
                prop.mark("validated", h.hash, peer=candidate.peer_id)
        del buffered[:res.n_valid]
        if res.n_valid:
            if kernel.tracers.chain_sync.active:
                from ..utils.tracer import TraceChainSyncEvent
                kernel.tracers.chain_sync.trace(TraceChainSyncEvent(
                    peer_id=candidate.peer_id, event="validated",
                    slot=fragment.head_point.slot, n=res.n_valid))
            candidate.publish(fragment.copy())
        if res.error is None:
            return
        if isinstance(res.error, OutsideForecastRange):
            horizon_stalled[0] = True   # wait: headers stay buffered
            return
        del buffered[:]
        raise ChainSyncClientError(f"invalid header from peer: "
                                   f"{res.error}")

    horizon_stalled = [False]
    last_arrival = [None]        # roll-forward inter-arrival gap state
    # watermark pipelining (Protocol/ChainSync/PipelineDecision.hs
    # low/high mark): while BEHIND the server tip the pipeline fills to
    # the high mark (`window`); once caught up new requests only refill
    # to the low mark, so a quiescent tip holds few outstanding requests
    low_mark = max(1, window // 4)
    caught_up = [False]

    def _note_tip(tip) -> None:
        # count the not-yet-validated buffered headers too: a single push
        # at the tip must not flip the policy back to the high mark
        caught_up[0] = (tip is not None
                        and fragment.head_block_no + len(buffered)
                        >= tip.block_no)

    # -- pipelined follow loop ------------------------------------------------
    while True:
        while pipeline_decision(session.outstanding, low_mark, window,
                                caught_up[0]) == "pipeline":
            await session.send_pipelined(MsgRequestNext(), "StIdle")
        if horizon_stalled[0] and buffered:
            # forecast horizon hit: our own chain must advance (BlockFetch
            # adopting the validated prefix) before the rest validates —
            # poll the channel NON-destructively instead of cancelling a
            # collect() (cancellation would lose pipeline bookkeeping /
            # in-flight replies) while the peer may be quiescent at its tip
            # (Client.hs forecast waiting)
            ready = await session.channel.wait_ready(0.2)
            horizon_stalled[0] = False
            if not ready:
                await flush()
                continue
        msg = await collect_with_limit(session, limits,
                                       peer_id=candidate.peer_id)
        if isinstance(msg, MsgAwaitReply):
            # caught up: validate what we have, then wait for the next
            # server push (the collect below blocks on the channel)
            caught_up[0] = True
            await flush()
            continue
        if isinstance(msg, MsgRollForward):
            if _metrics.enabled():
                now = _mono_now()
                if last_arrival[0] is not None:
                    _ARRIVAL_GAP.observe(now - last_arrival[0])
                last_arrival[0] = now
            if prop is not None:
                prop.mark("header_seen", msg.header.hash,
                          peer=candidate.peer_id)
            buffered.append(msg.header)
            _note_tip(msg.tip)
            if len(buffered) >= window:
                await flush()
            elif session.outstanding == 0:
                await flush()
            continue
        if isinstance(msg, MsgRollBackward):
            _note_tip(msg.tip)
            await flush()
            if not history.rewind(msg.point):
                raise ChainSyncClientError(
                    f"peer rolled back beyond k to {msg.point}")
            if not fragment.truncate_to(msg.point):
                # rollback target is before the candidate's anchor but
                # within our header history: re-anchor an empty fragment
                # there (the peer's new chain branches below where we
                # joined it)
                bn = history.current.tip.block_no \
                    if history.current.tip else -1
                fragment = AnchoredFragment(msg.point, (),
                                            anchor_block_no=bn)
            candidate.publish(fragment.copy())
            continue
        raise ChainSyncClientError(f"unexpected message {msg}")


def _block_no_at(db, point: Point) -> int:
    if point.is_genesis:
        return -1
    blk = db.current_chain.lookup(point.hash)
    if blk is not None:
        return blk.block_no
    if point == db.current_chain.anchor:
        return db.current_chain.anchor_block_no
    raise ChainSyncClientError(f"intersection {point} not on our chain")


async def chain_sync_server(session, chain_db, content_of=None) -> None:
    """ChainSync server from a ChainDB follower (ChainSync/Server.hs).

    Serves the current chain — headers by default; pass
    ``content_of=lambda b: b`` for the node-to-client variant that rolls
    full blocks forward.  Blocks on the ChainDB version TVar when the
    follower is caught up (followerInstructionBlocking).
    """
    content_of = content_of or (lambda b: b.header)
    from ..network.protocols.chainsync import (
        MsgDone, MsgIntersectFound, MsgIntersectNotFound, MsgRequestNext,
    )
    follower = chain_db.new_follower()
    try:
        while True:
            msg = await session.recv()
            if isinstance(msg, MsgDone):
                return
            if isinstance(msg, MsgFindIntersect):
                found = None
                for p in msg.points:
                    if p.is_genesis or chain_db.contains_point(p):
                        found = p
                        break
                tip = _tip_of(chain_db)
                if found is None:
                    await session.send(MsgIntersectNotFound(tip))
                else:
                    follower.point = found
                    follower.needs_rollback = False
                    await session.send(MsgIntersectFound(found, tip))
                continue
            assert isinstance(msg, MsgRequestNext)
            ins = follower.instruction()
            if ins is None:
                await session.send(MsgAwaitReply())
                while True:
                    # read the version BEFORE re-checking the instruction so
                    # a block added in between is seen here, not lost to the
                    # wait below (same lost-wakeup discipline as the example
                    # server in network/protocols/chainsync.py)
                    seen = kernel_version_value(chain_db)
                    ins = follower.instruction()
                    if ins is not None:
                        break
                    await _wait_version_above(chain_db, seen)
            kind, payload = ins
            tip = _tip_of(chain_db)
            if kind == "forward":
                await session.send(MsgRollForward(content_of(payload), tip))
            else:
                await session.send(MsgRollBackward(payload, tip))
    finally:
        chain_db.remove_follower(follower)


def _tip_of(chain_db):
    from ..chain.block import Tip
    return Tip(chain_db.tip_point(), chain_db.current_chain.head_block_no)


def kernel_version_value(chain_db) -> int:
    tv = getattr(chain_db, "version_tvar", None)
    return tv.value if tv is not None else chain_db.version


async def _wait_version_above(chain_db, seen: int) -> None:
    tv = getattr(chain_db, "version_tvar", None)
    if tv is None:
        # no STM hook (ChainDB used outside a kernel): cooperative poll
        while chain_db.version == seen:
            await sim.yield_()
        return

    def tx_fn(tx):
        if tx.read(tv) == seen:
            raise Retry()
    await sim.atomically(tx_fn)
