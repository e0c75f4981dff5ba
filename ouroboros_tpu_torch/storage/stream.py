"""Streaming replay engine — disk → decode → verify, restartable.

Reference: the db-analyser replay path (SURVEY.md §3.5): the node opens
LedgerDB from the newest on-disk snapshot (LedgerDB/OnDisk.hs:277) and
streams ImmutableDB chunks through iterators (Impl/Iterator.hs) instead
of materialising the chain; DiskPolicy decides when replay checkpoints
(DiskPolicy.hs).  Our replay so far loaded every block into memory and
started from genesis — fine for a bench chain, not for a million-block
mainnet DB.

This module closes that gap with a third pipeline stage in front of the
producer/consumer replay (consensus/pipeline.py):

    prefetcher (thread)          producer (thread)      consumer (caller)
    --------------------------   --------------------   -----------------
    chunk n+k: ONE whole-file    window w+1: seq pass   window w: drain
      read through the FsApi       packing, prefetch,     install betas
      seam, CBOR decode into       async submit           on_window hook:
      window-sized batches                                  DiskPolicy
      (bounded read-ahead;                                  take_snapshot
       blocks when `depth`
       batches are waiting)

Disk + decode seconds hide behind device verify exactly the way the
host sequential pass does: the prefetcher feeds a third on/off signal
into the shared ProgressTracker ({prefetch busy} ∩ {≥1 window in
flight} accumulates O(1) into ``disk_hidden_secs``), and its work is
span-recorded under the ``disk`` phase so bench/obsreport attribute it
beside host-seq/device.

Era discipline: the engine is protocol-agnostic — a Cardano-composed
DB (eras/cardano.py) replays Byron EBBs through the Shelley translation
in ONE stream because era crossing lives in the hard-fork rules the
sequential pass already drives; the engine merely counts the crossings
it decodes (``replay.stream.era_crossings``).

Restartability: `on_window` fires on the consumer thread only after a
window's proofs all held, so the state it hands over is fully verified
— the engine snapshots it crash-consistently (storage/ledgerdb.py:
temp file + checksum + atomic rename; a corrupt/partial newest snapshot
falls back to the previous one) every `snapshot_interval_slots`.  At
open, `resume=True` restores the newest snapshot whose point is still
on the immutable chain and streams strictly AFTER it: a killed replay
resumes in seconds and reaches a byte-identical final state hash.

The snapshot codec defaults to Python-native serialisation behind the
same ``encode_state``/``decode_state`` seam LedgerDB always had (the
reference CBOR-encodes its ledger state; our era states are plain
frozen dataclasses, so the native codec round-trips them exactly — a
custom CBOR codec plugs into the same two arguments).

Ported from `ouroboros_tpu/storage/stream.py` (the port imports nothing of
the JAX package). Copied whole, but for the snapshot decoder: the
reference unpickles whatever it finds, and a snapshot written by the JAX
package names `ouroboros_tpu.*` classes, so loading it would import that
package.  `pickle_decode` here admits only the port's own classes and the
few standard-library types its states hold; any other snapshot raises,
and `LedgerDB.iter_snapshots` skips it as it skips a corrupt one, so the
replay starts from the next usable snapshot or from genesis.
"""
from __future__ import annotations

import io
import pickle
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from ..consensus.pipeline import ProgressTracker
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import spans as _spans
from .ledgerdb import DiskPolicy, LedgerDB

#: header field carrying the hard-fork era tag (combinator.ERA_FIELD —
#: re-declared here so the storage layer stays import-light; the
#: combinator's tests pin the two equal)
ERA_FIELD = "hfc_era"

# observational stream instruments (live scrape/obsreport); the engine's
# own stats come from per-instance fields so they stay exact even with
# observation disabled.  Counts of chunks/blocks/bytes/eras are pure
# functions of the workload (stable); stall/depth/seconds are
# scheduling- and wall-clock-dependent (unstable).
_CHUNKS = _metrics.counter("replay.stream.chunks_read")
_BLOCKS = _metrics.counter("replay.stream.blocks_decoded")
_BYTES = _metrics.counter("replay.stream.bytes_read")
_ERAS = _metrics.counter("replay.stream.era_crossings")
_SNAPS = _metrics.counter("replay.stream.snapshots_written")
_STALLS = _metrics.counter("replay.stream.prefetch_stalls", stable=False)
_DEPTH = _metrics.gauge("replay.stream.prefetch_depth", stable=False)
_DISK_SECS = _metrics.gauge("replay.stream.disk_secs", stable=False)
_DISK_HIDDEN = _metrics.gauge("replay.stream.disk_hidden_secs",
                              stable=False)
_SNAP_SECS = _metrics.gauge("replay.stream.snapshot_write_secs",
                            stable=False)
_RESTORE_SECS = _metrics.gauge("replay.stream.restore_secs", stable=False)
_RESUME_SLOT = _metrics.gauge("replay.stream.resumed_from_slot")

# load-bearing thread accounting, like the pipeline's producer pair: a
# replay that returns with started != finished leaked its prefetcher
_P_STARTED = _metrics.counter("stream.prefetchers_started", always=True)
_P_FINISHED = _metrics.counter("stream.prefetchers_finished", always=True)

THREAD_NAME = "ouro-stream-prefetch"


def pickle_encode(state: Any) -> bytes:
    return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)


# the globals a snapshot may name besides the port's own classes: the
# containers and numbers of the era states, nothing that runs code
_SNAPSHOT_STDLIB = {
    "builtins": frozenset({"bool", "bytearray", "bytes", "complex", "dict",
                           "float", "frozenset", "int", "list", "set",
                           "slice", "str", "tuple"}),
    "collections": frozenset({"OrderedDict", "deque"}),
    "copyreg": frozenset({"_reconstructor"}),
    "fractions": frozenset({"Fraction"}),
}


class _SnapshotUnpickler(pickle.Unpickler):
    """Resolves only the port's classes and `_SNAPSHOT_STDLIB`; refuses
    every other global before importing its module."""

    def find_class(self, module: str, name: str):
        if module == "ouroboros_tpu_torch" \
                or module.startswith("ouroboros_tpu_torch.") \
                or name in _SNAPSHOT_STDLIB.get(module, ()):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"snapshot names {module}.{name}, which is not a class of "
            f"this package")


def pickle_decode(raw: Any) -> Any:
    return _SnapshotUnpickler(io.BytesIO(bytes(raw))).load()


@dataclass(frozen=True)
class StreamResumed:
    """Typed flight-recorder event: a replay restored from a snapshot
    (arm FLIGHT around a replay to make resume part of any post-mortem,
    e.g. a kill/resume parity mismatch)."""
    slot: int
    point_slot: int
    snapshots_seen: int


class BlockPrefetcher:
    """Bounded read-ahead: a background thread streams (and decodes)
    ImmutableDB chunks into window-sized batches; iterating the
    prefetcher yields decoded blocks, blocking only when the reader is
    genuinely behind the replay.

    Reads are chunk-granular through the FsApi seam (`db.chunk_blocks`:
    one whole-file read per chunk) so a spinning disk sees sequential
    I/O; DBs without the chunk API (the reference-format read view)
    fall back to the per-block iterator, same thread, same bounds.

    Coordination: one Condition guards {batches, stop, eof, error}.
    The thread blocks while `depth` batches are queued (back-pressure),
    the consumer blocks while none are; `close()` wakes and joins the
    thread — the engine calls it in a finally, so an aborted replay
    (first-error-wins, a snapshot-hook kill) never leaks it.  A read or
    decode failure parks on `error` and re-raises on the consumer after
    the already-queued batches drain."""

    def __init__(self, db, decode: Callable[[bytes], Any],
                 window: int = 512, depth: int = 4,
                 tracker: Optional[ProgressTracker] = None,
                 after_hash: Optional[bytes] = None):
        self.db = db
        self.decode = decode
        self.window = max(1, window)
        self.depth = max(1, depth)
        self.tracker = tracker
        self.after_hash = after_hash
        # exact per-instance accounting (engine stats read these; the
        # registry instruments mirror them for live observers)
        self.chunks_read = 0
        self.blocks_decoded = 0
        self.bytes_read = 0
        self.era_crossings = 0
        self.stalls = 0
        self._last_era: Optional[int] = None
        self._cond = threading.Condition()
        self._batches: deque = deque()
        self._stop = False
        self._eof = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run,
                                        name=THREAD_NAME, daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "BlockPrefetcher":
        _P_STARTED.inc()
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop and join the prefetch thread (idempotent)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.ident is not None:
            self._thread.join()

    # -- the reading thread --------------------------------------------------
    def _decode_batch(self, pairs) -> list:
        out = []
        for _entry, raw in pairs:
            b = self.decode(raw)
            hdr = getattr(b, "header", b)
            era = hdr.get(ERA_FIELD) if hasattr(hdr, "get") else None
            if era is not None:
                if self._last_era is not None and era != self._last_era:
                    self.era_crossings += 1
                    _ERAS.inc()
                self._last_era = era
            out.append(b)
        self.blocks_decoded += len(out)
        _BLOCKS.inc(len(out))
        return out

    def _read_decoded(self) -> Iterator[list]:
        """Decoded blocks in chain order, one chunk's worth per step —
        the disk signal (tracker + `disk`-phase spans) brackets exactly
        the read+decode work, never the queue wait."""
        tracker = self.tracker
        chunk_api = hasattr(self.db, "chunk_blocks")
        if chunk_api:
            cursor = self.db.start_after(self.after_hash)
            if cursor is None:
                return
            n0, i0 = cursor
            for n in self.db.chunk_numbers():
                if n < n0:
                    continue
                if tracker is not None:
                    tracker.disk_begin()
                try:
                    with _spans.span("stream.read", cat="disk"):
                        pairs = self.db.chunk_blocks(
                            n, from_index=i0 if n == n0 else 0)
                    self.chunks_read += 1
                    self.bytes_read += sum(len(raw) for _e, raw in pairs)
                    _CHUNKS.inc()
                    _BYTES.inc(sum(len(raw) for _e, raw in pairs))
                    with _spans.span("stream.decode", cat="disk"):
                        blocks = self._decode_batch(pairs)
                finally:
                    if tracker is not None:
                        tracker.disk_end()
                yield blocks
            return
        # generic fallback: per-block iterator (reference-format views);
        # `after_hash` skips the already-replayed prefix
        skipping = self.after_hash is not None
        buf_pairs: list = []
        for entry, raw in self.db.stream():
            if skipping:
                if getattr(entry, "hash", None) == self.after_hash \
                        or getattr(entry, "header_hash",
                                   None) == self.after_hash:
                    skipping = False
                continue
            buf_pairs.append((entry, raw))
            if len(buf_pairs) >= self.window:
                yield self._fallback_decode(buf_pairs)
                buf_pairs = []
        if skipping:
            # the resume point never appeared: yielding nothing would
            # silently report the stale snapshot as the final state
            raise ValueError(
                "resume point is not on the streamed chain (snapshot "
                "outlived the DB?)")
        if buf_pairs:
            yield self._fallback_decode(buf_pairs)

    def _fallback_decode(self, pairs) -> list:
        tracker = self.tracker
        if tracker is not None:
            tracker.disk_begin()
        try:
            self.chunks_read += 1          # one read burst ≈ one chunk
            self.bytes_read += sum(len(raw) for _e, raw in pairs)
            _CHUNKS.inc()
            _BYTES.inc(sum(len(raw) for _e, raw in pairs))
            with _spans.span("stream.decode", cat="disk"):
                return self._decode_batch(pairs)
        finally:
            if tracker is not None:
                tracker.disk_end()

    def _run(self) -> None:
        try:
            buf: list = []
            for blocks in self._read_decoded():
                buf.extend(blocks)
                while len(buf) >= self.window:
                    if not self._put(buf[:self.window]):
                        return
                    buf = buf[self.window:]
            if buf:
                self._put(buf)
        except BaseException as e:   # surfaced on the consumer
            with self._cond:
                self._error = e
                self._cond.notify_all()
        finally:
            _P_FINISHED.inc()
            with self._cond:
                self._eof = True
                self._cond.notify_all()

    def _put(self, batch: list) -> bool:
        """Queue one batch, blocking at the read-ahead bound; False when
        the consumer asked us to stop."""
        with self._cond:
            if len(self._batches) >= self.depth and not self._stop:
                self.stalls += 1
                _STALLS.inc()
                self._cond.wait_for(
                    lambda: self._stop
                    or len(self._batches) < self.depth)
            if self._stop:
                return False
            self._batches.append(batch)
            _DEPTH.set(len(self._batches))
            self._cond.notify_all()
            return True

    # -- the consuming side --------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._batches or self._eof
                    or self._error is not None or self._stop)
                if self._batches:
                    batch = self._batches.popleft()
                    _DEPTH.set(len(self._batches))
                    self._cond.notify_all()
                elif self._error is not None:
                    err, self._error = self._error, None
                    raise err
                else:
                    return                 # eof (or stopped)
            yield from batch               # lock NOT held


@dataclass(frozen=True)
class StreamConfig:
    """Engine knobs.  `read_ahead` is the prefetch bound in windows —
    together with the pipeline's DEPTH it fixes the peak number of
    decoded blocks alive at once to (read_ahead + ~3) * window,
    independent of chain length.  `policy` drives both the snapshot
    cadence during replay and the trim count
    (storage/ledgerdb.DiskPolicy); `take_snapshots=False` makes the
    run read-only on the DB directory (plain validation)."""
    window: int = 512
    read_ahead: int = 4
    policy: DiskPolicy = DiskPolicy()
    resume: bool = True
    take_snapshots: bool = True


@dataclass
class StreamReplayResult:
    """ReplayResult + the stream's own accounting."""
    final_state: Any
    n_valid: int
    error: Optional[Exception]
    stats: dict = field(default_factory=dict)

    @property
    def all_valid(self) -> bool:
        return self.error is None


class StreamingReplayEngine:
    """One replay of one on-disk chain DB: restore, stream, verify,
    checkpoint.  Construct per run (`db_analyser --resume`, bench's
    stream leg, the kill/resume tests); the heavyweight state — key
    caches, compiled programs — lives in the backend and survives
    across engines."""

    def __init__(self, fs, db, rules, decode: Callable[[bytes], Any],
                 backend=None, config: Optional[StreamConfig] = None,
                 encode_state: Callable[[Any], Any] = pickle_encode,
                 decode_state: Callable[[Any], Any] = pickle_decode):
        self.fs = fs
        self.db = db
        self.rules = rules
        self.decode = decode
        self.backend = backend
        self.cfg = config if config is not None else StreamConfig()
        self._enc = encode_state
        self._dec = decode_state
        self.snapshots_written = 0
        self.snapshot_write_secs = 0.0
        self.restore_secs = 0.0

    # -- restore -------------------------------------------------------------
    def restore(self) -> Optional[tuple]:
        """(slot, point, state) of the newest USABLE snapshot: readable
        (checksum holds — ledgerdb skips torn/corrupt ones) AND whose
        point is still on the immutable chain (a snapshot can outlive
        its blocks when startup validation truncated a corrupt tail —
        resuming from it would strand the replay off-chain)."""
        t0 = _spans.monotonic_now()
        seen = 0
        try:
            for slot, point, state in LedgerDB.iter_snapshots(self.fs,
                                                              self._dec):
                seen += 1
                if point.is_genesis or point.hash in self.db:
                    _RESUME_SLOT.set(slot)
                    _flight.FLIGHT.note(
                        StreamResumed(slot, point.slot, seen))
                    return slot, point, state
            return None
        finally:
            self.restore_secs = _spans.monotonic_now() - t0
            _RESTORE_SECS.set(round(self.restore_secs, 6))

    # -- snapshotting ---------------------------------------------------------
    def _take_snapshot(self, point, state) -> None:
        t0 = _spans.monotonic_now()
        with _spans.span("stream.snapshot", cat="disk"):
            LedgerDB.take_snapshot(self.fs, point.slot, point, state,
                                   self._enc, self.cfg.policy)
        self.snapshots_written += 1
        self.snapshot_write_secs += _spans.monotonic_now() - t0
        _SNAPS.inc()
        _SNAP_SECS.set(round(self.snapshot_write_secs, 6))

    # -- the replay ------------------------------------------------------------
    def replay(self) -> StreamReplayResult:
        from ..consensus.batch import replay_blocks_pipelined

        cfg = self.cfg
        restored = self.restore() if cfg.resume else None
        after_hash: Optional[bytes] = None
        state = self.rules.initial_state()
        resumed_from: Optional[int] = None
        if restored is not None:
            resumed_from, point, state = restored
            if not point.is_genesis:
                after_hash = point.hash
        # ETA denominator: O(1) on the native chunk-indexed DB; a
        # reference-format view would pay a full extra read pass for
        # __len__, so it streams without a total
        total = len(self.db) if hasattr(self.db, "chunk_numbers") \
            and after_hash is None else None
        tracker = ProgressTracker(total)
        interval = cfg.policy.snapshot_interval_slots
        # the interval counts from the stream's START (the resume slot,
        # or the initial state's tip for a fresh run) — the first window
        # must not trigger an unconditional full-state serialisation the
        # policy never asked for
        last_snap = {"slot": resumed_from if resumed_from is not None
                     else self.rules.tip(state).slot}

        def on_window(st, _n_done, point):
            if point.slot - last_snap["slot"] >= interval:
                self._take_snapshot(point, st)
                last_snap["slot"] = point.slot

        if not cfg.take_snapshots:
            on_window = None
        pre = BlockPrefetcher(self.db, self.decode, window=cfg.window,
                              depth=cfg.read_ahead, tracker=tracker,
                              after_hash=after_hash).start()
        t0 = _spans.monotonic_now()
        try:
            res = replay_blocks_pipelined(
                self.rules, pre, state, backend=self.backend,
                window=cfg.window, total_blocks=total, tracker=tracker,
                on_window=on_window)
        finally:
            pre.close()
        replay_secs = _spans.monotonic_now() - t0
        if cfg.take_snapshots and res.error is None \
                and res.final_state is not None:
            # tip checkpoint: the next open restores in O(snapshot), no
            # replay at all (skipped when the tip snapshot already
            # exists — a fully-resumed rerun writes nothing)
            tip = self.rules.tip(res.final_state)
            if not tip.is_genesis and last_snap["slot"] != tip.slot:
                self._take_snapshot(tip, res.final_state)
                last_snap["slot"] = tip.slot
        _DISK_SECS.set(round(tracker.disk_secs, 6))
        _DISK_HIDDEN.set(round(tracker.disk_hidden_secs, 6))
        stats = {
            "blocks": res.n_valid,
            "replay_secs": round(replay_secs, 4),
            "chunks_read": pre.chunks_read,
            "blocks_decoded": pre.blocks_decoded,
            "bytes_read": pre.bytes_read,
            "era_crossings": pre.era_crossings,
            "prefetch_stalls": pre.stalls,
            "read_ahead": cfg.read_ahead,
            "disk_secs": round(tracker.disk_secs, 4),
            "disk_hidden_secs": round(tracker.disk_hidden_secs, 4),
            "disk_hidden_frac": round(
                tracker.disk_hidden_secs / tracker.disk_secs, 3)
            if tracker.disk_secs > 0 else 0.0,
            "host_seq_secs": round(tracker.host_secs, 4),
            "host_hidden_secs": round(tracker.hidden_secs, 4),
            "snapshots_written": self.snapshots_written,
            "snapshot_write_secs": round(self.snapshot_write_secs, 4),
            "restore_secs": round(self.restore_secs, 4),
            "resumed_from_slot": resumed_from,
        }
        return StreamReplayResult(res.final_state, res.n_valid,
                                  res.error, stats)


def prefetcher_threads_alive() -> int:
    """Live prefetch threads (leak gates share this with the
    started/finished counter pair, like the pipeline's producer)."""
    return sum(t.name == THREAD_NAME and t.is_alive()
               for t in threading.enumerate())
