"""BlockFetch logic — the download governor.

Reference: ouroboros-network/src/Ouroboros/Network/BlockFetch/Decision.hs:
150-184,526 (pure decision pipeline: filter plausible candidates → filter
already-fetched/in-flight → prioritise → per-peer requests with in-flight
limits), BlockFetch.hs:239 (logic iteration loop re-run on STM change),
ClientState.hs (per-peer in-flight tracking), BlockFetch/Client.hs (protocol
adapter), BlockFetch/Server.hs (server from a ChainDB iterator).

The decision pipeline is a pure function over immutable snapshots
(fetch_decisions) so it is testable exactly like the reference's
property-tested `fetchDecisions`.

Ported from `ouroboros_tpu/node/block_fetch.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

from .. import simharness as sim
from ..chain.block import Point, point_of
from ..network.protocols.blockfetch import fetch_range
from ..observe import metrics as _metrics
from ..simharness import Retry, TQueue, TVar

# per-request BlockFetch latency (the net.rtt.* namespace, beside
# the KeepAlive RTT in network/deltaq.py); handle pre-bound (OBS002)
_FETCH_REQUEST_SECS = _metrics.latency_histogram(
    "net.rtt.blockfetch_secs")


@dataclass(frozen=True)
class FetchRequest:
    """A contiguous run of headers to download from one peer.

    start is EXCLUSIVE (the predecessor point), matching the server's
    (from, to] streaming semantics; headers are oldest..newest."""
    peer_id: object
    start: Point
    headers: tuple
    est_bytes: int = 0               # in-flight byte accounting estimate

    @property
    def end(self) -> Point:
        return point_of(self.headers[-1])


@dataclass(frozen=True)
class FetchBudget:
    """The request-sizing limits of fetchRequestDecisions
    (Decision.hs:526): per-peer in-flight bytes (the low/high watermark
    pair collapsed to one cap), a network-wide concurrency budget, and a
    DeltaQ bound on a single request's expected duration."""
    max_blocks_per_request: int = 16
    max_in_flight_bytes_per_peer: int = 256 * 1024
    max_concurrent_peers: int = 4
    max_request_expected_secs: float = 5.0
    # deadline-mode duplicate-fetch race (Decision.hs deadline semantics):
    # a block already in flight with a slow peer may be re-requested from
    # a peer whose DeltaQ arrival estimate beats the claimant's by this
    # factor; 0 disables racing (bulk sync never duplicates)
    duplicate_speedup: float = 0.0

    @classmethod
    def bulk_sync(cls) -> "FetchBudget":
        """FetchModeBulkSync: far from the tip — few peers, big batches
        (maximise throughput; duplicate fetches are pure waste here)."""
        return cls(max_blocks_per_request=32,
                   max_in_flight_bytes_per_peer=512 * 1024,
                   max_concurrent_peers=2,
                   max_request_expected_secs=20.0)

    @classmethod
    def deadline(cls) -> "FetchBudget":
        """FetchModeDeadline: near the tip — more peers, small requests,
        tight expected-duration bound (minimise time-to-adoption; the
        block-diffusion deadline of BASELINE.md), and duplicate racing
        against clearly-slower in-flight claims."""
        return cls(max_blocks_per_request=4,
                   max_in_flight_bytes_per_peer=128 * 1024,
                   max_concurrent_peers=8,
                   max_request_expected_secs=2.0,
                   duplicate_speedup=2.0)


class PeerFetchState:
    """Per-peer fetch bookkeeping (ClientState.hs `PeerFetchStatus` +
    request queue + in-flight byte/size tracking)."""

    def __init__(self, peer_id):
        self.peer_id = peer_id
        self.queue = TQueue(label=f"fetch-req-{peer_id}")
        self.in_flight: set[bytes] = set()     # header hashes requested
        self.in_flight_bytes: int = 0          # estimated bytes outstanding
        self.avg_block_bytes: int = 2048       # refined from transfers
        # scan frontier: everything on the candidate up to this point is
        # known-stored, so decision rounds skip it (keeps a long sync from
        # rescanning the fragment from its anchor every round)
        self.done_through: Optional[Point] = None

    @property
    def busy(self) -> bool:
        return bool(self.in_flight)

    def observe_blocks(self, n_blocks: int, n_bytes: int) -> None:
        if n_blocks:
            self.avg_block_bytes = max(
                64, (self.avg_block_bytes + n_bytes // n_blocks) // 2)


def fetch_decisions(
        candidates: Dict[object, object],
        peer_states: Dict[object, PeerFetchState],
        plausible: Callable[[object], bool],
        have_block: Callable[[bytes], bool],
        max_blocks_per_request: Optional[int] = None,
        order_key: Optional[Callable[[object], float]] = None,
        budget: Optional[FetchBudget] = None,
        gsv: Optional[Callable[[object], object]] = None
        ) -> list[FetchRequest]:
    """The pure decision pipeline (Decision.hs:150-184,526).

    candidates: peer -> AnchoredFragment of validated headers (or None).
    plausible:  fragment -> would we prefer this chain over ours?
    have_block: hash -> already stored in the ChainDB?
    gsv:        peer -> PeerGSV tracker (None: no DeltaQ sizing).

    Filter plausible → filter fetched/in-flight → prioritise (longest
    candidate, then cheapest peer by DeltaQ) → size requests within the
    FetchBudget: per-peer in-flight byte cap, network concurrency budget,
    and a DeltaQ bound on each request's expected duration — a slow peer
    gets small requests (or none, when faster peers cover its candidate),
    a fast peer saturates.
    """
    # one source of truth for request sizing: an explicit
    # max_blocks_per_request overrides the budget's field
    if budget is None:
        budget = FetchBudget(
            max_blocks_per_request=max_blocks_per_request or 16)
    elif max_blocks_per_request is not None:
        from dataclasses import replace as _replace
        budget = _replace(budget,
                          max_blocks_per_request=max_blocks_per_request)
    # claimed: hash -> the claiming peer's DeltaQ arrival estimate (inf
    # when unknown).  Deadline mode races a clearly-faster peer against a
    # slow claim; bulk mode treats every claim as final.
    claimed: Dict[bytes, float] = {}
    busy_count = 0
    for peer, ps in peer_states.items():
        tracker = gsv(peer) if gsv is not None else None
        eta = (tracker.expected_fetch_time(
            max(ps.in_flight_bytes, ps.avg_block_bytes))
            if tracker is not None else float("inf"))
        for h in ps.in_flight:
            claimed[h] = min(claimed.get(h, float("inf")), eta)
        queued = _queued(ps.queue)
        for req in queued:
            for h in req.headers:
                claimed[h.hash] = min(claimed.get(h.hash, float("inf")),
                                      eta)
        if ps.busy or queued:
            busy_count += 1

    decisions: list[FetchRequest] = []
    # deterministic peer order: better candidates first, then cheaper peers
    # by DeltaQ expected fetch time (Decision.hs prioritisation), then id
    def head_key(item):
        peer, frag = item
        bn = frag.head_block_no if frag is not None and len(frag) else -1
        dq = order_key(peer) if order_key is not None else 0.0
        return (-bn, dq, str(peer))

    for peer, frag in sorted(candidates.items(), key=head_key):
        if busy_count >= budget.max_concurrent_peers:
            break                        # concurrency budget exhausted
        if frag is None or len(frag) == 0 or not plausible(frag):
            continue
        ps = peer_states.get(peer)
        if ps is None or ps.busy or _queued(ps.queue):
            continue
        # per-peer byte budget + DeltaQ request sizing
        est = ps.avg_block_bytes
        bytes_left = budget.max_in_flight_bytes_per_peer \
            - ps.in_flight_bytes
        if bytes_left < est:
            continue
        cap = min(budget.max_blocks_per_request, max(1, bytes_left // est))
        tracker = gsv(peer) if gsv is not None else None
        if tracker is not None:
            if tracker.expected_fetch_time(est) \
                    > budget.max_request_expected_secs:
                if decisions:
                    # a faster peer is already fetching this round: the
                    # slow peer loses the race entirely (Decision.hs
                    # deadline-mode peer filtering)
                    continue
                # sole source: fetch slowly (one block) rather than
                # starve — a too-slow ONLY peer must still make progress
                cap = 1
            else:
                n = 1
                while n < cap and tracker.expected_fetch_time(
                        (n + 1) * est) <= budget.max_request_expected_secs:
                    n += 1
                cap = n
        # resume the scan at the stored frontier when it is still on the
        # fragment (a rollback may have invalidated it — then rescan)
        blocks = None
        prev_point = frag.anchor
        if ps.done_through is not None:
            blocks = frag.after_point(ps.done_through)
            if blocks is not None:
                prev_point = ps.done_through
            else:
                ps.done_through = None
        if blocks is None:
            blocks = frag.blocks
        # symmetric race comparison: include OUR queue backlog
        # exactly as expected_fetch_time does for the claimant, else a
        # loaded fast peer wins duplicate races its backlog should lose
        my_eta = (tracker.expected_fetch_time(
                      max(ps.in_flight_bytes + est, est))
                  if tracker is not None else float("inf"))
        run: list = []
        start: Optional[Point] = None
        frontier_ok = True               # still in the contiguous stored prefix
        for h in blocks:
            stored = have_block(h.hash)
            other_eta = claimed.get(h.hash)
            needed = not stored and (
                other_eta is None
                # the deadline-mode duplicate race: fetch a claimed block
                # again iff our arrival beats the claim by the configured
                # factor (Decision.hs deadline-mode in-flight-with-other-
                # peers filtering)
                or (budget.duplicate_speedup > 0
                    and my_eta * budget.duplicate_speedup < other_eta))
            if needed:
                if not run:
                    start = prev_point
                run.append(h)
                if len(run) >= cap:
                    break
            elif run:
                break                    # only the first contiguous run
            elif stored and frontier_ok:
                # advance the frontier cache over the stored prefix only —
                # never past an unstored (claimed) block whose fetch may
                # still fail
                ps.done_through = point_of(h)
            # a claimed-by-another-peer block is skipped: a later run may
            # still be assignable to this peer (disjoint parallel fetch)
            if not stored:
                frontier_ok = False
            prev_point = point_of(h)
        if run:
            req = FetchRequest(peer, start, tuple(run),
                               est_bytes=len(run) * est)
            for h in run:
                claimed[h.hash] = min(claimed.get(h.hash, float("inf")),
                                      my_eta)
            decisions.append(req)
            busy_count += 1
    return decisions


def _queued(q: TQueue) -> list:
    """Non-transactional peek at queued requests (cooperative runtime —
    safe between awaits)."""
    out = []
    cons = q._back.value
    while cons is not None:
        item, cons = cons
        out.append(item)
    out.reverse()
    front = []
    cons = q._front.value
    while cons is not None:
        item, cons = cons
        front.append(item)
    return front + out


async def fetch_logic_loop(kernel) -> None:
    """The blockFetchLogic iteration thread (BlockFetch.hs:239): re-runs
    the decision pipeline whenever a candidate, the current chain, or the
    in-flight set changes, and enqueues requests to per-peer clients."""
    from ..utils.tracer import TraceFetchDecision
    prop = getattr(kernel, "propagation", None)
    while True:
        seen = kernel.fetch_wakeup.value
        # fetch MODE (BlockFetchConsensusInterface readFetchMode): far
        # behind the best candidate -> bulk sync; near the tip -> deadline
        our_bn = kernel.chain_db.current_chain.head_block_no
        best_bn = max(
            (c.fragment.head_block_no for c in kernel.candidates.values()
             if c.fragment is not None and len(c.fragment)),
            default=our_bn)
        budget = (FetchBudget.bulk_sync() if best_bn - our_bn > 16
                  else FetchBudget.deadline())
        decisions = fetch_decisions(
            {p: c.fragment for p, c in kernel.candidates.items()},
            kernel.peer_fetch,
            kernel.plausible_candidate,
            kernel.have_block,
            order_key=kernel.fetch_order_key,
            budget=budget,
            gsv=kernel.peer_gsv.get)
        for req in decisions:
            ps = kernel.peer_fetch[req.peer_id]
            ps.in_flight |= {h.hash for h in req.headers}
            ps.in_flight_bytes += req.est_bytes
            if prop is not None:
                for h in req.headers:
                    prop.mark("fetch_decided", h.hash, peer=req.peer_id)
            if kernel.tracers.fetch.active:
                kernel.tracers.fetch.trace(TraceFetchDecision(
                    peer_id=req.peer_id, n_requested=len(req.headers),
                    in_flight_bytes=ps.in_flight_bytes, reason="request"))

            def push(tx, ps=ps, req=req):
                ps.queue.put(tx, req)
            await sim.atomically(push)
        # wait for something to change
        def wait_change(tx, seen=seen):
            if tx.read(kernel.fetch_wakeup) == seen:
                raise Retry()
        await sim.atomically(wait_change)


async def block_fetch_client(session, kernel, peer_id) -> None:
    """Per-peer fetch worker: executes assigned FetchRequests over the
    BlockFetch mini-protocol and feeds blocks into the ChainDB
    (BlockFetch/Client.hs + addFetchedBlock).

    On any failure the peer's in-flight claims are released and the peer is
    dropped from fetch consideration — otherwise its claimed hashes would
    block every other peer from ever re-requesting that chain segment."""
    from .watchdog import WatchdogTimeout
    ps = kernel.peer_fetch[peer_id]
    prop = getattr(kernel, "propagation", None)
    try:
        while True:
            req = await sim.atomically(lambda tx: ps.queue.get(tx))
            try:
                t0 = sim.now()
                # whole-request watchdog (timeLimitsBlockFetch), tightened
                # by the peer's DeltaQ estimate: a measured-fast peer gets
                # a measured-fast deadline instead of the 60s ceiling
                deadline = kernel.time_limits.fetch_deadline(
                    kernel.peer_gsv.get(peer_id),
                    max(req.est_bytes, ps.avg_block_bytes))
                done, blocks = await sim.timeout(
                    deadline, fetch_range(session, req.start, req.end))
                if not done:
                    sim.trace_event(("timeout", "block-fetch", "BFBusy",
                                     peer_id), label="watchdog")
                    raise WatchdogTimeout("block-fetch", "BFBusy", deadline)
                tracker = kernel.peer_gsv.get(peer_id)
                if blocks:
                    total = sum(len(b.bytes) for b in blocks)
                    _FETCH_REQUEST_SECS.observe(sim.now() - t0)
                    if tracker is not None:
                        tracker.observe_transfer(total, sim.now() - t0)
                    ps.observe_blocks(len(blocks), total)
                for b in blocks or ():
                    if prop is not None:
                        prop.mark("body_arrived", b.hash, peer=peer_id)
                    kernel.add_fetched_block(b)
            finally:
                ps.in_flight -= {h.hash for h in req.headers}
                ps.in_flight_bytes = max(0,
                                         ps.in_flight_bytes - req.est_bytes)
            ps.done_through = req.end
            kernel.poke_fetch_logic()
    except sim.AsyncCancelled:
        raise
    except Exception as e:
        sim.trace_event(("block-fetch-kill", kernel.label, peer_id,
                         repr(e)))
        ps.in_flight.clear()
        ps.in_flight_bytes = 0
        kernel.drop_peer(peer_id)
        raise


def block_fetch_server(chain_db):
    """Server peer function streaming ranges from the ChainDB."""
    from ..network.protocols.blockfetch import server_from_blocks

    async def server(session):
        await server_from_blocks(
            session, lambda start, end: chain_db.stream_blocks(start, end))
    return server
