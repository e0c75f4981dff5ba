"""ChainDB — the chain database: selection, followers, iterators, GC.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/ChainDB/
(SURVEY.md §2): facade API (API.hs:117-317 addBlockAsync/getCurrentChain/
followers/iterators/invalid set), chain selection triage add-to-current /
switch-to-fork / store-only (Impl/ChainSel.hs:410-476), candidate
construction via the VolatileDB successor map (Paths.maximalCandidates,
ChainSel.hs:516), candidate validation through the LedgerDB
(Impl/LgrDB.hs:350-400), background copy-to-immutable + snapshot + GC
(Impl/Background.hs:84-102), open-time replay from the newest snapshot
(LedgerDB/OnDisk.hs:277).

A difference from the reference that keeps its semantics: candidate
validation uses consensus/batch.validate_blocks_batched — one device batch
per candidate window instead of the reference's strictly sequential fold.

Ported from `ouroboros_tpu/storage/chaindb.py` (the port imports nothing of
the JAX package). Copied whole. Candidates reach the card through the
backend the DB is given (`backend=None` is the port's `default_backend()`: a
`TorchBackend` on the card, which raises without one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..chain.block import GENESIS_HASH, Point, point_of
from ..chain.fragment import AnchoredFragment
from ..consensus.batch import validate_blocks_batched
from ..consensus.ledger import (
    ExtLedgerRules, ExtLedgerState, OutsideForecastRange,
)
from .fs import FsApi
from .immutabledb import ImmutableDB
from .ledgerdb import DiskPolicy, LedgerDB
from .volatiledb import VolatileDB


@dataclass(frozen=True)
class AddBlockResult:
    """What chain selection did with the block (TraceAddBlockEvent analog)."""
    kind: str          # "extended" | "switched" | "stored" | "invalid" | \
                       # "duplicate" | "too_old"
    new_tip: Point


class Follower:
    """ChainDB follower: a read pointer on the current chain
    (Impl/Follower.hs).  instruction() is pull-based; blocking waits are
    layered on top via the version counter."""

    def __init__(self, db: "ChainDB", fid: int):
        self.db = db
        self.fid = fid
        self.point = db.immutable_tip_point()
        self.needs_rollback = False

    def instruction(self) -> Optional[tuple]:
        """("rollback", Point) | ("forward", block) | None when caught up."""
        db = self.db
        chain = db.current_chain
        if self.needs_rollback:
            self.needs_rollback = False
            return ("rollback", self.point)
        on_volatile = (chain.contains_point(self.point)
                       or self.point == chain.anchor)
        if not on_volatile:
            # behind the immutable anchor (copy_to_immutable advanced it)?
            # stream the immutable chain — those blocks ARE on the chain
            imm_slot = db.immutable.slot_of_hash(self.point.hash)
            if (self.point.is_genesis and db.immutable.tip is not None) \
                    or (imm_slot is not None and imm_slot == self.point.slot):
                nxt = db.immutable.next_after_hash(
                    None if self.point.is_genesis else self.point.hash)
                if nxt is not None:
                    entry, raw = nxt
                    blk = db.block_decode(raw)
                    self.point = point_of(blk)
                    return ("forward", blk)
                return None   # immutable tip == chain anchor: fall through
            # genuinely off-chain (fork switch): roll back to the deepest
            # point still on the chain
            self.point = db._deepest_common(self.point)
            return ("rollback", self.point)
        nxt = db._block_after(self.point)
        if nxt is None:
            return None
        self.point = point_of(nxt)
        return ("forward", nxt)


class ChainDB:
    def __init__(self, ext_rules: ExtLedgerRules, immutable: ImmutableDB,
                 volatile: VolatileDB, ledger_db: LedgerDB,
                 block_decode: Callable[[bytes], Any],
                 backend=None, disk_policy: DiskPolicy = DiskPolicy(),
                 fs: Optional[FsApi] = None,
                 encode_state: Optional[Callable] = None, tracer=None):
        from ..utils.tracer import NOP
        self.tracer = tracer if tracer is not None else NOP
        self.ext_rules = ext_rules
        self.immutable = immutable
        self.volatile = volatile
        self.ledger_db = ledger_db
        self.block_decode = block_decode
        self.backend = backend
        self.disk_policy = disk_policy
        self.fs = fs                          # for ledger snapshots
        self.encode_state = encode_state
        self.k = ext_rules.protocol.security_param
        # current chain: fragment of BLOCKS anchored at the immutable tip
        self.current_chain: AnchoredFragment = AnchoredFragment(
            ledger_db.anchor_point, (),
            anchor_block_no=self._anchor_block_no())
        self.invalid: dict[bytes, str] = {}       # hash -> reason
        self.version = 0                          # bumped on chain change
        self._on_change: list[Callable[[], None]] = []
        self._followers: dict[int, Follower] = {}
        self._next_fid = 0
        self._last_snapshot_slot = -1
        # in-future block buffering (cdbFutureBlocks + Fragment/InFuture.hs):
        # blocks whose slot is past the wall clock (allowing max_clock_skew
        # slots) wait here and re-triage when their slot arrives.  Enabled
        # by giving the DB a clock (current_slot_fn); tools/replay leave it
        # None (no wall clock — nothing is "future").
        self.current_slot_fn: Optional[Callable[[], int]] = None
        self.max_clock_skew_slots: int = 1
        self.future_blocks: dict[bytes, Any] = {}
        # async add-block queue (Background.hs addBlockRunner: ALL chain
        # selection runs on one writer thread)
        self._add_queue: list = []
        self._add_wakeup = None                   # lazily created TVar

    def _anchor_block_no(self) -> int:
        t = self.immutable.tip
        return t.block_no if t else -1

    # -- open: snapshot + replay + initial chain selection --------------------
    @classmethod
    def open(cls, fs: FsApi, ext_rules: ExtLedgerRules,
             encode_state: Callable, decode_state: Callable,
             block_decode: Callable[[bytes], Any],
             chunk_size: int = 100, max_blocks_per_file: int = 50,
             backend=None, disk_policy: DiskPolicy = DiskPolicy(),
             validate_chunks: bool = True, tracer=None) -> "ChainDB":
        immutable = ImmutableDB.open(fs, chunk_size,
                                     validate_all=validate_chunks)
        volatile = VolatileDB.open(fs, max_blocks_per_file)
        k = ext_rules.protocol.security_param

        # resume ledger: newest readable snapshot, else genesis (OnDisk.hs)
        snap = LedgerDB.read_latest_snapshot(fs, decode_state)
        if snap is not None:
            snap_slot, snap_point, ext_state = snap
        else:
            snap_point, ext_state = Point.genesis(), ext_rules.initial_state()

        # replay immutable blocks newer than the snapshot (no crypto)
        start = snap_point.slot + 1
        for entry, raw in immutable.stream(from_slot=max(start, 0)):
            block = block_decode(raw)
            ext_state = ext_rules.tick_then_reapply(ext_state, block)

        imm_tip = immutable.tip
        anchor = Point(imm_tip.slot, imm_tip.hash) if imm_tip \
            else Point.genesis()
        if ext_rules.tip(ext_state) != anchor:
            # snapshot newer than the immutable chain (shouldn't happen
            # with atomic snapshots) — fall back to genesis replay
            ext_state = ext_rules.initial_state()
            for entry, raw in immutable.stream():
                ext_state = ext_rules.tick_then_reapply(
                    ext_state, block_decode(raw))

        ledger_db = LedgerDB(k, anchor, ext_state)
        db = cls(ext_rules, immutable, volatile, ledger_db, block_decode,
                 backend=backend, disk_policy=disk_policy, fs=fs,
                 encode_state=encode_state, tracer=tracer)
        db._initial_chain_selection()
        return db

    def _initial_chain_selection(self) -> None:
        """Best volatile candidate from the immutable tip, re-run to a
        fixpoint as invalid blocks surface (ChainSel.hs:88-99; the invalid
        set is in-memory only, so reopen rediscovers them)."""
        best = self._best_candidate_from(self.current_chain.anchor)
        if best:
            self._try_adopt(self.current_chain.anchor, best)
        self._reselect_fixpoint()

    # -- queries --------------------------------------------------------------
    def tip_point(self) -> Point:
        return self.current_chain.head_point

    def tip_header(self):
        b = self.current_chain.head
        return b.header if b is not None else None

    def immutable_tip_point(self) -> Point:
        return self.current_chain.anchor

    @property
    def current_ledger(self) -> ExtLedgerState:
        return self.ledger_db.current

    def get_block(self, h: bytes) -> Optional[Any]:
        raw = self.volatile.get_block(h)
        if raw is None:
            raw = self.immutable.get_by_hash(h)
        return self.block_decode(raw) if raw is not None else None

    def get_is_invalid(self, h: bytes) -> bool:
        return h in self.invalid

    def contains_point(self, p: Point) -> bool:
        if p.is_genesis:
            return True
        if self.current_chain.contains_point(p) \
                or p == self.current_chain.anchor:
            return True
        slot = self.immutable.slot_of_hash(p.hash)
        return slot is not None and slot == p.slot

    # -- iterators (across Imm + current chain) -------------------------------
    def stream_blocks(self, from_point: Point, to_point: Point) -> list:
        """Blocks on the current chain in (from_point, to_point], resolved
        across ImmutableDB + VolatileDB (Impl/Iterator.hs semantics; used
        by the BlockFetch server)."""
        out = []
        # walk back from to_point to from_point collecting hashes
        cursor = to_point
        rev: list[Point] = []
        while cursor != from_point and not cursor.is_genesis:
            rev.append(cursor)
            blk = self.get_block(cursor.hash)
            if blk is None:
                return []
            prev = blk.prev_hash
            if prev == GENESIS_HASH:
                cursor = Point.genesis()
            else:
                pb = self.get_block(prev)
                if pb is None:
                    # predecessor is in the immutable index only by hash
                    slot = self.immutable.slot_of_hash(prev)
                    if slot is None:
                        return []
                    cursor = Point(slot, prev)
                else:
                    cursor = point_of(pb)
        if cursor != from_point:
            return []
        for p in reversed(rev):
            out.append(self.get_block(p.hash))
        return out

    # -- followers ------------------------------------------------------------
    def new_follower(self) -> Follower:
        f = Follower(self, self._next_fid)
        self._next_fid += 1
        self._followers[f.fid] = f
        return f

    def remove_follower(self, f: Follower) -> None:
        self._followers.pop(f.fid, None)

    def on_change(self, cb: Callable[[], None]) -> None:
        self._on_change.append(cb)

    def _bump(self) -> None:
        self.version += 1
        for cb in self._on_change:
            cb()

    def _deepest_common(self, point: Point) -> Point:
        """Deepest ancestor of `point` still on the current chain (follower
        repositioning after a fork switch)."""
        cursor = point
        while not cursor.is_genesis:
            if self.current_chain.contains_point(cursor) \
                    or cursor == self.current_chain.anchor \
                    or self.immutable.slot_of_hash(cursor.hash) == cursor.slot:
                return cursor
            blk = self.get_block(cursor.hash)
            if blk is None:
                return self.current_chain.anchor
            prev = blk.prev_hash
            if prev == GENESIS_HASH:
                return Point.genesis()
            pb = self.get_block(prev)
            if pb is None:
                return self.current_chain.anchor
            cursor = point_of(pb)
        return self.current_chain.anchor

    def _block_after(self, point: Point) -> Optional[Any]:
        """Next block on the current chain after `point`."""
        chain = self.current_chain
        if point == chain.anchor:
            return chain.blocks[0] if len(chain) else None
        idx = chain._index.get(point.hash)
        if idx is None or idx + 1 >= len(chain):
            return None
        return chain.blocks[idx + 1]

    # -- the add-block pipeline (ChainSel.hs:410-476) -------------------------
    def add_block(self, block: Any) -> AddBlockResult:
        h = block.hash
        if h in self.invalid:
            return AddBlockResult("invalid", self.tip_point())
        if self.volatile.block_info(h) is not None or h in self.immutable:
            return AddBlockResult("duplicate", self.tip_point())
        imm_tip_slot = self.current_chain.anchor.slot
        if block.slot <= imm_tip_slot:
            return AddBlockResult("too_old", self.tip_point())
        if self.current_slot_fn is not None:
            now_slot = self.current_slot_fn()
            if block.slot > now_slot + self.max_clock_skew_slots:
                # from the future (clock skew beyond tolerance): buffer,
                # re-triaged by on_slot_tick (cdbFutureBlocks)
                self.future_blocks[h] = block
                return AddBlockResult("from_future", self.tip_point())
        self.volatile.put_block(h, block.prev_hash, block.slot,
                                block.block_no, block.bytes)
        res = self._chain_selection_for(block)
        if self.tracer.active:
            from ..utils.tracer import TraceAddBlock
            self.tracer.trace(TraceAddBlock(
                kind=res.kind, slot=block.slot, block_no=block.block_no,
                hash=h))
        return res

    def on_slot_tick(self, slot: int) -> list[AddBlockResult]:
        """Re-triage buffered future blocks whose slot has arrived
        (Background.hs's per-slot chain-selection rerun for
        cdbFutureBlocks)."""
        due = [b for h, b in self.future_blocks.items()
               if b.slot <= slot + self.max_clock_skew_slots]
        out = []
        for b in sorted(due, key=lambda b: b.slot):
            self.future_blocks.pop(b.hash, None)
            out.append(self.add_block(b))
        return out

    # -- async add queue (Background.hs:84-102 addBlockRunner) ----------------
    def _queue_wakeup(self):
        if self._add_wakeup is None:
            from ..simharness import TVar
            self._add_wakeup = TVar(0, label="chaindb-add-queue")
        return self._add_wakeup

    def add_block_async(self, block: Any) -> None:
        """Enqueue for the single writer thread (ChainDB.addBlockAsync):
        callers never run chain selection themselves."""
        self._add_queue.append(block)
        wk = self._queue_wakeup()
        try:
            wk.set_notify(wk.value + 1)
        except Exception:
            wk._value = wk.value + 1

    async def add_block_runner(self) -> None:
        """The serialization point: drain the queue, one chain selection
        at a time (the reference's addBlockRunner background thread)."""
        from .. import simharness as sim
        from ..simharness import Retry
        wk = self._queue_wakeup()
        while True:
            while self._add_queue:
                block = self._add_queue.pop(0)
                res = self.add_block(block)
                sim.trace_event(("add-block-async", res.kind, block.slot))
            seen = wk.value

            def wait(tx, seen=seen):
                if tx.read(wk) == seen:
                    raise Retry()
            await sim.atomically(wait)

    def _beats_current(self, cand_view) -> bool:
        """Is `cand_view` strictly preferred over the current chain?  An
        EMPTY current chain loses to any valid candidate (the bare block-
        number sentinel of an empty fragment is not a protocol SelectView
        and must not reach prefer_candidate)."""
        if cand_view is None:
            return False
        head = self.current_chain.head
        if head is None:
            return True
        cur_view = self.ext_rules.protocol.select_view(
            getattr(head, "header", head))
        return self.ext_rules.protocol.prefer_candidate(cur_view, cand_view)

    def _reselect(self) -> bool:
        """One full re-selection pass: every candidate constructible from
        the anchor that beats the current chain, tried best-first from its
        ACTUAL fork point with the current chain.  Returns True if a
        candidate was adopted."""
        import functools
        cur = self.current_chain
        prefer = self.ext_rules.protocol.prefer_candidate
        cands = []
        for path in self._successors_closure(cur.anchor):
            v = self._candidate_select_view(cur.anchor, path)
            if self._beats_current(v):
                cands.append((path, v))
        cands.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if prefer(b[1], a[1])
            else (1 if prefer(a[1], b[1]) else 0)))
        for path, _v in cands:
            fork = cur.anchor
            i = 0
            for b in path:
                if cur.contains_point(point_of(b)):
                    fork = point_of(b)
                    i += 1
                else:
                    break
            if i < len(path) and self._try_adopt(fork, path[i:]):
                return True
        return False

    def _reselect_fixpoint(self) -> bool:
        """Re-run selection until the invalid set stops growing: marking a
        block invalid during validation changes the ranking, so a losing
        candidate may now win (ChainSel.hs re-triage with the updated
        invalid set).  Returns True if any adoption happened."""
        adopted = False
        while True:                      # each retry marks >= 1 new invalid
            before = len(self.invalid)   # block, so bounded by volatile size
            adopted = self._reselect() or adopted
            if len(self.invalid) == before:
                return adopted

    def _chain_selection_for(self, block: Any) -> AddBlockResult:
        before_invalid = len(self.invalid)
        result = self._triage_once(block)
        # only a GROWN invalid set can change the candidate ranking; the
        # common extend/store path skips the full re-selection entirely
        if len(self.invalid) == before_invalid:
            return result
        if self._reselect_fixpoint() and result.kind in ("stored",
                                                         "invalid"):
            return AddBlockResult("switched", self.tip_point())
        if result.kind in ("extended", "switched"):
            return AddBlockResult(result.kind, self.tip_point())
        return result

    def _triage_once(self, block: Any) -> AddBlockResult:
        cur = self.current_chain
        tip = self.tip_point()
        if block.prev_hash == (tip.hash if not tip.is_genesis
                               else GENESIS_HASH):
            # triage 1: extends the current tip — adopt the best path
            # through it (picks up already-stored successors too)
            best = self._best_candidate_from(tip)
            ok = self._try_adopt(tip, best if best else [block])
            kind = "extended" if ok else "invalid"
            return AddBlockResult(kind, self.tip_point())
        # triage 2: reachable from some point on the current fragment?
        import functools
        prefer = self.ext_rules.protocol.prefer_candidate
        # the same candidate head is reachable from several fork points
        # (deeper forks re-walk the current chain) — keep, per head, the
        # SHALLOWEST rollback, then try candidates best-view-first
        by_head: dict[bytes, tuple] = {}
        cache: dict = {block.hash: block}
        for fork_point, blocks in self._candidates_through(block, cache):
            cand_view = self._candidate_select_view(fork_point, blocks)
            if not self._beats_current(cand_view):
                continue
            head = blocks[-1].hash
            depth = self._rollback_depth(fork_point)
            if depth is None:
                continue
            old = by_head.get(head)
            if old is None or depth < old[3]:
                by_head[head] = (fork_point, blocks, cand_view, depth)
        cands = sorted(
            by_head.values(),
            key=functools.cmp_to_key(
                lambda a, b: -1 if prefer(b[2], a[2])
                else (1 if prefer(a[2], b[2]) else a[3] - b[3])))
        for fork_point, blocks, _view, _depth in cands:
            if self._try_adopt(fork_point, blocks):
                return AddBlockResult("switched", self.tip_point())
        return AddBlockResult("stored", self.tip_point())


    def _candidate_select_view(self, fork_point: Point, blocks: Sequence):
        if not blocks:
            return None
        return self.ext_rules.protocol.select_view(
            getattr(blocks[-1], "header", blocks[-1]))

    # -- candidates (Paths.maximalCandidates over the successor map) ----------
    def _decode_cached(self, h: bytes, cache: dict) -> Optional[Any]:
        if h in cache:
            return cache[h]
        raw = self.volatile.get_block(h)
        blk = self.block_decode(raw) if raw is not None else None
        cache[h] = blk
        return blk

    def _successors_closure(self, point: Point,
                            cache: Optional[dict] = None) -> list[list]:
        """All maximal block-paths leaving `point`, via the VolatileDB
        successor map; invalid blocks prune the walk.  Decoded blocks are
        memoized in `cache` (shared across the fork points of one
        add_block call — the candidate hot path).

        The reference walks recursively, one Python frame a block, so a
        path longer than the interpreter's recursion limit (~1000) raises
        RecursionError: a k = 2160 VolatileDB cannot be opened.  This walk
        keeps its own stack and yields the same paths in the same order."""
        if cache is None:
            cache = {}
        out: list[list] = []
        acc: list = []

        def live(h: bytes):
            return iter([s for s in self.volatile.filter_by_predecessor(h)
                         if s not in self.invalid])

        start = point.hash if not point.is_genesis else GENESIS_HASH
        # per open block (the start, then each block of acc): its
        # remaining successors and whether any was decoded
        levels = [[live(start), False]]
        while levels:
            top = levels[-1]
            for s in top[0]:
                blk = self._decode_cached(s, cache)
                if blk is not None:
                    top[1] = True
                    acc.append(blk)
                    levels.append([live(s), False])
                    break
            else:
                levels.pop()
                if not top[1] and acc:
                    out.append(list(acc))
                if levels:
                    acc.pop()
        return out

    def _candidates_through(self, block: Any,
                            cache: Optional[dict] = None
                            ) -> list[tuple[Point, list]]:
        """(fork_point, blocks) candidates containing `block`, forking from
        the newest point on the current fragment (incl. anchor) that is
        an ancestor of `block`.

        The reference walks the successor map from every point of the
        fragment, O(k^2) blocks an add at k blocks, and its caller keeps,
        for each candidate head, the shallowest rollback.  Every deeper
        fork point reaches the same heads through the fragment, so only
        the shallowest is built here: walk back from `block` to the
        fragment, then out along its successors.  Invalid or missing
        ancestors prune the candidate, as they prune the reference's
        walk.

        The walk back reads each ancestor's predecessor from the
        VolatileDB's index and decodes the ancestors only once it has
        reached the fragment: a block stored behind an invalid one (a
        peer serving a chain past a bad body) costs index lookups, not a
        decode of every block back to the invalid one, which made a run
        of such adds O(n^2) decodes."""
        if cache is None:
            cache = {}
        chain = self.current_chain
        anchor = chain.anchor
        anchor_hash = GENESIS_HASH if anchor.is_genesis else anchor.hash
        hashes: list = []
        h = block.prev_hash
        while True:
            if h == anchor_hash:
                fork = anchor
                break
            idx = chain._index.get(h)
            if idx is not None:
                fork = point_of(chain.blocks[idx])
                break
            if h in self.invalid:
                return []
            info = self.volatile.block_info(h)
            if info is None:
                return []
            hashes.append(h)
            h = info.prev_hash
        prefix = [self._decode_cached(x, cache) for x in reversed(hashes)] \
            + [block]
        exts = self._successors_closure(point_of(block), cache)
        return [(fork, prefix + ext) for ext in (exts or [[]])]

    def _best_candidate_from(self, point: Point) -> Optional[list]:
        best, best_view = None, None
        for path in self._successors_closure(point):
            v = self._candidate_select_view(point, path)
            if v is None:
                continue
            if best is None:
                if self._beats_current(v):
                    best, best_view = path, v
            elif self.ext_rules.protocol.prefer_candidate(best_view, v):
                best, best_view = path, v
        return best

    # -- adoption: batched validation + switch --------------------------------
    def _try_adopt(self, fork_point: Point, blocks: Sequence) -> bool:
        """Validate `blocks` from `fork_point` (ONE batched device call via
        validate_blocks_batched) and switch/extend if a valid prefix still
        improves on the current chain (LgrDB.validate + switchTo)."""
        n_rollback = self._rollback_depth(fork_point)
        if n_rollback is None or n_rollback > self.k:
            return False
        base_state = self.ledger_db.current if n_rollback == 0 else None
        # state at the fork point
        if n_rollback > 0:
            st = self.ledger_db.state_at(fork_point)
            if st is None:
                return False
            base_state = st
        res = validate_blocks_batched(self.ext_rules, list(blocks),
                                      base_state, backend=self.backend)
        valid_blocks = list(blocks)[:res.n_valid]
        if res.error is not None and not isinstance(res.error,
                                                    OutsideForecastRange):
            # OutsideForecastRange is retry-later, never invalid: the
            # reference defers such blocks until the chain advances
            # (cf. ChainSync forecast-horizon waiting)
            for b in list(blocks)[res.n_valid:]:
                self.invalid[b.hash] = str(res.error)
                if self.tracer.active:
                    from ..utils.tracer import TraceInvalidBlock
                    self.tracer.trace(TraceInvalidBlock(
                        hash=b.hash, reason=str(res.error)))
        if not valid_blocks and n_rollback > 0:
            return False
        # does the valid prefix still beat the current chain?
        if n_rollback > 0 or res.n_valid < len(blocks):
            cand_view = self._candidate_select_view(fork_point, valid_blocks)
            if not self._beats_current(cand_view):
                return False
        elif not valid_blocks:
            return False
        # switch: truncate to fork point, extend with valid blocks
        new_chain = self.current_chain.copy()
        if not new_chain.truncate_to(fork_point):
            return False
        for b in valid_blocks:
            new_chain.add_block(b)
        ok = self.ledger_db.switch(
            n_rollback,
            lambda st: [(point_of(b), s)
                        for b, s in zip(valid_blocks, res.states)])
        if not ok:
            return False
        old_point = self.tip_point()
        if n_rollback > 0 and self.tracer.active:
            from ..utils.tracer import TraceSwitchedToFork
            self.tracer.trace(TraceSwitchedToFork(
                old_tip_slot=old_point.slot,
                new_tip_slot=new_chain.head_point.slot,
                rollback_depth=n_rollback))
        self.current_chain = new_chain
        self._bump()
        for f in self._followers.values():
            if not (new_chain.contains_point(f.point)
                    or f.point == new_chain.anchor):
                f.point = self._deepest_common(f.point)
                f.needs_rollback = True
        return True

    def _rollback_depth(self, fork_point: Point) -> Optional[int]:
        chain = self.current_chain
        if fork_point == chain.anchor:
            return len(chain)
        idx = chain._index.get(fork_point.hash)
        if idx is None:
            return None
        return len(chain) - (idx + 1)

    # -- background duties (Impl/Background.hs:84-102) ------------------------
    def copy_to_immutable(self) -> int:
        """Move blocks > k deep to the ImmutableDB, advance anchors, GC the
        VolatileDB, and (if due, and the DB was opened with a snapshot
        codec) snapshot the ledger.  Returns #copied."""
        chain = self.current_chain
        excess = len(chain) - self.k
        if excess <= 0:
            return 0
        to_copy = list(chain.blocks[:excess])
        for b in to_copy:
            hdr = getattr(b, "header", b)
            is_ebb = bool(hdr.get("ebb", 0)) if hasattr(hdr, "get") else False
            self.immutable.append_block(b.slot, b.block_no, b.hash,
                                        b.prev_hash, b.bytes, is_ebb=is_ebb)
        new_anchor_blk = to_copy[-1]
        self.current_chain = chain._rebuild(
            point_of(new_anchor_blk), chain.blocks[excess:],
            new_anchor_blk.block_no)
        self.ledger_db.prune_to_slot(new_anchor_blk.slot)
        self.volatile.garbage_collect(new_anchor_blk.slot + 1)
        if self.fs is not None and self.encode_state is not None:
            slot = new_anchor_blk.slot
            if slot - self._last_snapshot_slot >= \
                    self.disk_policy.snapshot_interval_slots:
                LedgerDB.take_snapshot(
                    self.fs, slot, self.ledger_db.anchor_point,
                    self.ledger_db.anchor_state,
                    self.encode_state, self.disk_policy)
                self._last_snapshot_slot = slot
        self._bump()
        return len(to_copy)
