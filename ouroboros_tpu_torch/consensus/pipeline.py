"""Threaded producer/consumer replay — true host/device overlap.

A one-thread software pipeline (consensus/batch.py) kept two windows in
flight, but the sequential pass, request packing, and dispatch all ran
on ONE Python thread: while that thread sat inside a blocking drain
(the packed result transfer plus result folding), no host-sequential
work advanced, so host-seq and device time simply ADDED in the bench
breakdown.  SURVEY.md hard parts #3 says the
split is legal — nonce evolution is sequential, but proofs are
state-independent once seeds are derived — so this module puts the host
half on its own thread:

    producer (background thread)      consumer (caller thread)
    ------------------------------    ------------------------------
    window w+1: seq pass              window w: blocking drain
               (nonce evolution,        (ONE packed transfer; with
                envelope checks,         fold=True just a verdict
                proof extraction)        scalar + betas)
               request packing          install carried betas
               key-cache prefetch       release one permit
               async submit  ───────►   first error wins, oldest-first

Coordination protocol (mirrored 1:1 by the sim model explored under
ouro-race in tests/test_replay_pipeline.py):

  * one Condition guards {pending, submitted, drained, stop, done};
  * the producer acquires a PERMIT before each window's sequential
    pass: it waits until ``submitted - drained < DEPTH`` — exactly the
    beta-carry distance.  Window w's submit ships window w+2's betas,
    which the consumer installs when draining w, immediately before the
    producer's sequential pass for w+2 reads them.  Running further
    ahead would silently fall back to per-proof host EC math;
  * the consumer drains oldest-first outside the lock (the blocking
    device wait must not hold it), installs betas, then releases the
    permit;
  * on a drain error the consumer sets ``stop``; the producer observes
    it at the next permit check, so at most one more window is ever
    submitted, and the consumer discards the leftovers with
    finish_window so no device work is leaked;
  * the producer NEVER touches the result: seq counts, the final state
    and any sequential error hand over through the shared state after
    ``done``, and an unexpected producer exception re-raises on the
    caller thread (``crash``).

Scheduling cannot change the outcome: drains are processed in
submission order and the first error wins, so ReplayResult is
byte-identical to the synchronous driver on any chain, valid or not —
tests/test_replay_pipeline.py pins this.

Shared-cache discipline: the producer owns all point-cache fills and
beta-cache reads; the consumer owns beta-cache writes and KES hash-path
outcome writes.  Individual dict operations are GIL-atomic and every
value is a pure function of its key, so a racing read at worst
recomputes; the caches' LRU bookkeeping (recency touches, capacity
eviction) additionally tolerates a concurrent eviction from the other
thread — see precompute._insert / VrfBetaCache._store.  Span trees are per-thread (observe/spans.py): the producer's
``window.host_seq``/``window.submit`` roots and the consumer's
``window.drain`` roots overlap in wall time — which is the point — and
bench.py's ``overlap`` section measures exactly that hiding.

Ported from `ouroboros_tpu/consensus/pipeline.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Optional

from ..chain.block import Point
from ..crypto.backend import GLOBAL_BETA_CACHE, WindowVerdict
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import spans as _spans
from .header_validation import HeaderError
from .ledger import LedgerError, OutsideForecastRange

#: max windows submitted-but-not-drained while a sequential pass runs —
#: the beta-carry distance (window w's device call computes w+2's betas)
DEPTH = 2

# load-bearing thread accounting (always on): a replay that returns with
# started != finished leaked its producer — bench --smoke asserts the
# pair equal after the pipelined parity probe
_STARTED = _metrics.counter("pipeline.producers_started", always=True)
_FINISHED = _metrics.counter("pipeline.producers_finished", always=True)
# observational: windows through the pipeline / producer permit stalls
_WINDOWS = _metrics.counter("pipeline.windows")
_STALLS = _metrics.counter("pipeline.producer_stalls")
# queue-latency instrumentation: submit→drain covers the full
# async residence of a window — dispatch queue + device + transfer —
# the quantity the adaptive batching service will trade off against
# coalescing gain.  Handles pre-bound here (OBS002): observe() is two
# hot-loop calls per window.
_SUBMIT_DRAIN = _metrics.latency_histogram("pipeline.submit_drain_secs")
_WINDOW_BLOCKS = _metrics.histogram("pipeline.window_blocks")

# replay progress gauges (rendered live by tools/obsreport.py --live via
# the scrape endpoint).  blocks_done / windows_in_flight / total are
# deterministic end-state for a fixed workload (stable); rate/ETA/
# hidden-fraction are measured seconds (unstable).
_P_BLOCKS = _metrics.gauge("replay.progress.blocks_done")
_P_TOTAL = _metrics.gauge("replay.progress.total_blocks")
_P_INFLIGHT = _metrics.gauge("replay.progress.windows_in_flight")
_P_RATE = _metrics.gauge("replay.progress.blocks_per_sec", stable=False)
_P_ETA = _metrics.gauge("replay.progress.eta_secs", stable=False)
_P_HIDDEN = _metrics.gauge("replay.progress.hidden_frac", stable=False)
# mesh attribution: devices the in-flight windows shard over
# (1 off-mesh) and the lane padding waste the per-shard bucket rounding
# cost this replay — both read straight off the backend, published so a
# live scrape of a sharded replay names its mesh
_P_DEVICES = _metrics.gauge("replay.progress.devices")
_P_PAD_WASTE = _metrics.gauge("replay.progress.padding_waste_frac")
# streaming-replay disk overlap: disk+decode seconds the
# prefetch thread spent while >= 1 window was in flight on device —
# published live so a scrape of a streaming replay shows whether the
# read-ahead is actually hiding the storage layer
_S_HIDDEN = _metrics.gauge("replay.stream.hidden_frac", stable=False)


class ProgressTracker:
    """Online progress/overlap accounting for one streaming replay,
    published through the registry after every drained window.

    Exactness without history: hidden host-seq time is the measure of
    {host sequential pass active} ∩ {≥1 window in flight}.  Both are
    on/off signals with O(1) transitions (host edges from the producer,
    in-flight edges from submit/drain), so the intersection accumulates
    in a scalar — no interval lists to keep, which matters at
    million-block scale.  The streaming replay (storage/stream.py) adds
    a third on/off signal with the same discipline: {prefetch thread
    reading/decoding} ∩ {≥1 window in flight} accumulates into
    disk_hidden_secs, so the engine can report how many storage seconds
    the read-ahead hid behind device verify.  ETA uses the blocks/sec
    observed so far; total_blocks is optional (an unbounded stream has
    progress but no ETA)."""

    __slots__ = ("t0", "total", "blocks", "host_secs", "hidden_secs",
                 "disk_secs", "disk_hidden_secs", "_lock", "_inflight",
                 "_host_since", "_both_since", "_disk_since",
                 "_disk_both_since")

    def __init__(self, total_blocks: Optional[int] = None):
        self.t0 = _spans.monotonic_now()
        self.total = total_blocks
        self.blocks = 0
        self.host_secs = 0.0
        self.hidden_secs = 0.0
        self.disk_secs = 0.0
        self.disk_hidden_secs = 0.0
        self._lock = threading.Lock()
        self._inflight = 0
        self._host_since: Optional[float] = None
        self._both_since: Optional[float] = None
        self._disk_since: Optional[float] = None
        self._disk_both_since: Optional[float] = None
        _P_TOTAL.set(total_blocks if total_blocks is not None else 0)
        _P_BLOCKS.set(0)
        _P_INFLIGHT.set(0)

    # -- producer edges ------------------------------------------------------
    def host_begin(self) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            self._host_since = now
            if self._inflight:
                self._both_since = now

    def host_end(self) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            if self._host_since is not None:
                self.host_secs += now - self._host_since
                self._host_since = None
            if self._both_since is not None:
                self.hidden_secs += now - self._both_since
                self._both_since = None

    # -- prefetch-thread edges (streaming replay) ----------------------------
    def disk_begin(self) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            self._disk_since = now
            if self._inflight:
                self._disk_both_since = now

    def disk_end(self) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            if self._disk_since is not None:
                self.disk_secs += now - self._disk_since
                self._disk_since = None
            if self._disk_both_since is not None:
                self.disk_hidden_secs += now - self._disk_both_since
                self._disk_both_since = None

    # -- consumer edges ------------------------------------------------------
    def window_submitted(self) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            self._inflight += 1
            if self._inflight == 1:
                if self._host_since is not None:
                    self._both_since = now
                if self._disk_since is not None:
                    self._disk_both_since = now

    def window_drained(self, n_blocks: int) -> None:
        now = _spans.monotonic_now()
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                if self._both_since is not None:
                    self.hidden_secs += now - self._both_since
                    self._both_since = None
                if self._disk_both_since is not None:
                    self.disk_hidden_secs += now - self._disk_both_since
                    self._disk_both_since = None
            self.blocks += n_blocks
            blocks, inflight = self.blocks, self._inflight
            host, hidden = self.host_secs, self.hidden_secs
            disk, disk_hidden = self.disk_secs, self.disk_hidden_secs
        elapsed = now - self.t0
        rate = blocks / elapsed if elapsed > 0 else 0.0
        _P_BLOCKS.set(blocks)
        _P_INFLIGHT.set(inflight)
        _P_RATE.set(round(rate, 3))
        if self.total and rate > 0:
            _P_ETA.set(round(max(0, self.total - blocks) / rate, 3))
        _P_HIDDEN.set(round(hidden / host, 4) if host > 0 else 0.0)
        if disk > 0:
            _S_HIDDEN.set(round(disk_hidden / disk, 4))


class _Shared:
    """Producer/consumer handoff state; every field below is guarded by
    ``cond`` except the producer-private ones it publishes only before
    setting ``done``."""

    __slots__ = ("cond", "pending", "submitted", "drained", "stop",
                 "done", "crash", "seq_error", "seq_done", "final_state",
                 "progress")

    def __init__(self):
        self.cond = threading.Condition()
        # (start, sub, reqs, owner, n_seq, t_submit, state_after, point)
        self.pending: deque = deque()
        self.progress: Optional[ProgressTracker] = None
        self.submitted = 0
        self.drained = 0
        self.stop = False               # consumer: error seen, stop producing
        self.done = False               # producer: no more submissions
        self.crash: Optional[BaseException] = None
        self.seq_error: Optional[Exception] = None
        self.seq_done = 0               # blocks past the sequential pass
        self.final_state: Any = None


def _produce(shared: _Shared, ext_rules, block_iter, ext_state, backend,
             window: int, fold: bool) -> None:
    """Producer body: sequential pass + packing + async submit per
    window, permit-gated to the beta-carry depth."""
    protocol, ledger = ext_rules.protocol, ext_rules.ledger
    submit = backend.submit_window

    def next_window():
        w = list(itertools.islice(block_iter, window))
        return w or None

    try:
        # bounded look-ahead: ahead[0] = current window, ahead[1:] = the
        # two windows whose beta proofs may already be in flight
        ahead: deque = deque()
        for _ in range(3):
            w = next_window()
            if w is None:
                break
            ahead.append(([getattr(b, "header", b) for b in w], w))
        if ahead:
            # windows 0 and 1 ride a plain prefetch; window w's device
            # call then carries window w+2's betas
            protocol.prefetch_window(
                [h for hs, _w in list(ahead)[:2] for h in hs], backend)

        st = ext_state
        while ahead:
            with shared.cond:
                if not (shared.stop
                        or shared.submitted - shared.drained < DEPTH):
                    _STALLS.inc()
                    with _spans.span("producer.stall", cat="stall"):
                        shared.cond.wait_for(
                            lambda: shared.stop or
                            shared.submitted - shared.drained < DEPTH)
                if shared.stop:
                    return
            headers_w, blk_window = ahead.popleft()
            nxt = next_window()
            if nxt is not None:
                ahead.append(([getattr(b, "header", b) for b in nxt],
                              nxt))
            reqs: list = []
            owner: list[int] = []
            seq_error: Optional[Exception] = None
            n_seq_w = 0
            progress = shared.progress
            if progress is not None:
                progress.host_begin()
            with _spans.span("window.host_seq", cat="host-seq"):
                for i, b in enumerate(blk_window):
                    try:
                        rs, st = _seq_block_step(protocol, ledger, st, b)
                    except OutsideForecastRange as e:
                        # retry-later, never invalid (see
                        # validate_blocks_batched)
                        seq_error = e
                        break
                    except Exception as e:
                        seq_error = (e if isinstance(e, (HeaderError,
                                                         LedgerError))
                                     else LedgerError(str(e)))
                        break
                    reqs.extend(rs)
                    owner.extend([i] * len(rs))
                    n_seq_w += 1
            if progress is not None:
                progress.host_end()
            # carry betas for the window TWO ahead (ahead[1] after the
            # pop): the consumer installs them at drain time, which the
            # permit above orders before that window's sequential pass
            next_proofs = (protocol.vrf_proofs_of(ahead[1][0])
                           if len(ahead) > 1 and seq_error is None else ())
            next_proofs = [p for p in next_proofs
                           if p not in GLOBAL_BETA_CACHE]
            sub = (submit(reqs, next_proofs, fold=True) if fold
                   else submit(reqs, next_proofs))
            _WINDOWS.inc()
            _WINDOW_BLOCKS.observe(n_seq_w)
            if progress is not None:
                progress.window_submitted()
            # the window's post-prefix state + tip point ride the entry:
            # once this window DRAINS clean, `st` is fully verified up to
            # `pt` — the consumer hands the pair to on_window (the
            # streaming engine's snapshot seam).  A window that died on
            # a genuine sequential validation failure carries NO point:
            # its prefix precedes an invalid block and both drivers
            # refuse to checkpoint it (retry-later horizon waits DO
            # checkpoint — their prefix is on the canonical chain)
            pt = (Point(headers_w[n_seq_w - 1].slot,
                        headers_w[n_seq_w - 1].hash)
                  if n_seq_w and (seq_error is None
                                  or isinstance(seq_error,
                                                OutsideForecastRange))
                  else None)
            with shared.cond:
                shared.pending.append(
                    (shared.seq_done, sub, reqs, owner, n_seq_w,
                     _spans.monotonic_now(), st, pt))
                shared.submitted += 1
                shared.seq_done += n_seq_w
                shared.cond.notify_all()
            if seq_error is not None:
                shared.seq_error = seq_error
                break
        shared.final_state = st
    except BaseException as e:      # submit/seq machinery broke: hand the
        shared.crash = e            # exception to the caller thread
    finally:
        with shared.cond:
            shared.done = True
            shared.cond.notify_all()


def _drain(backend, entry) -> tuple:
    """Finish one window's device call; install its carried betas.
    Returns (error, n_valid): error None when every proof held, else
    n_valid is the global index of the first bad block."""
    start, sub, reqs, owner, n_seq_w, t_submit, _st, _pt = entry
    # named distinctly from jax_backend's inner "window.drain" span:
    # bench._rep_overlap pairs submits and drains positionally by name,
    # and a second same-named interval per drain would break the zip.
    # This outer span exists for EVERY async backend (the flight
    # recorder must show drains even on stub/CPU backends); phase
    # totals stay correct because self-time attribution subtracts the
    # nested inner span.
    with _spans.span("pipeline.drain", cat="device"):
        ok, betas = backend.finish_window(sub)
    _SUBMIT_DRAIN.observe(_spans.monotonic_now() - t_submit)
    if betas:
        GLOBAL_BETA_CACHE.store_many(betas.keys(), betas.values())
    if isinstance(ok, WindowVerdict):
        # device-folded form: the first failing request index directly
        # (owner maps are non-decreasing, so the first bad request is
        # also the first bad block)
        bad, first_bad = ok.first_bad, n_seq_w
        if bad is not None:
            first_bad = owner[bad]
    else:
        first_bad, bad = n_seq_w, None
        for j, good in enumerate(ok):
            if not good and owner[j] < first_bad:
                first_bad, bad = owner[j], j
    if bad is not None:
        return LedgerError(
            f"proof {type(reqs[bad]).__name__} failed for block "
            f"{start + first_bad}"), start + first_bad
    return None, start + n_seq_w


def replay_threaded(ext_rules, blocks, ext_state, backend,
                    window: int = 512,
                    total_blocks: Optional[int] = None,
                    tracker: Optional[ProgressTracker] = None,
                    on_window=None):
    """Run the producer/consumer pipeline to completion; returns the
    same ReplayResult the synchronous driver would (batch.py re-exports
    this as the submit_window path of replay_blocks_pipelined).

    `total_blocks` (len(blocks) when the caller knows it) feeds the
    progress tracker's ETA; a streaming replay without it still reports
    blocks/sec, windows in flight and the hidden fraction.  `tracker`
    lets a caller share one ProgressTracker with other pipeline stages
    (the streaming engine's prefetch thread feeds its disk signal into
    the same tracker).  `on_window(state, n_done, point)` runs on the
    consumer thread after each window drains CLEAN: `state` is the
    fully verified state after that window's prefix and `point` its tip
    — the snapshot seam.  An exception it raises stops the replay
    through the normal first-error-wins teardown (producer joined,
    in-flight windows discarded via finish_window) and re-raises on the
    caller."""
    from .batch import ReplayResult

    if total_blocks is None and hasattr(blocks, "__len__"):
        total_blocks = len(blocks)
    fold = bool(getattr(backend, "supports_window_fold", False))
    # the sharded backend (parallel/sharded_verify.py) drives this SAME
    # driver: the producer's packing pads window w+1 to the per-shard
    # bucket shape (backend._pad rounds to a mesh multiple) while window
    # w's sharded composite drains, and the fold verdict is already the
    # cross-shard minimum — nothing here branches on mesh size, but the
    # mesh is attributed for live observers
    _P_DEVICES.set(int(getattr(backend, "n_shards", 1)))
    stats_fn = getattr(backend, "padding_stats", None)
    pad0 = stats_fn() if stats_fn is not None else None
    shared = _Shared()
    shared.progress = (tracker if tracker is not None
                       else ProgressTracker(total_blocks))
    t = threading.Thread(
        target=_run_producer,
        args=(shared, ext_rules, iter(blocks), ext_state, backend,
              window, fold),
        name="ouro-replay-producer", daemon=True)
    _STARTED.inc()
    t.start()
    error: Optional[Exception] = None
    n_ok = 0
    try:
        while True:
            with shared.cond:
                shared.cond.wait_for(
                    lambda: shared.pending or shared.done)
                if not shared.pending:
                    break               # done and fully drained
                entry = shared.pending.popleft()
            err, n = _drain(backend, entry)      # blocking, lock NOT held
            with shared.cond:
                shared.drained += 1
                shared.cond.notify_all()
            shared.progress.window_drained(entry[4])
            if err is not None:
                error, n_ok = err, n
                break
            if on_window is not None and entry[7] is not None:
                # every proof up to entry's tip point has now held —
                # entry[6] is a durable resume point.  A hook failure
                # (snapshot write error, a test's injected kill) rides
                # the consumer-exception path below: producer joined,
                # leftovers discarded, exception re-raised
                on_window(entry[6], n, entry[7])
    finally:
        # wake a permit-blocked producer and wait it out — the pipeline
        # must never leak its thread, least of all on an error path
        with shared.cond:
            shared.stop = True
            shared.cond.notify_all()
        t.join()
        # discard anything submitted after the first error (or after a
        # consumer-side exception): the async device work must complete
        for entry in shared.pending:
            backend.finish_window(entry[1])
        shared.pending.clear()
        if stats_fn is not None:
            # THIS replay's windows only (since=): a long-lived backend
            # must not smear earlier replays' padding into the gauge
            _P_PAD_WASTE.set(
                stats_fn(since=pad0).get("waste_frac", 0.0))
    if shared.crash is not None:
        # unhandled producer error: the flight ring holds the last
        # spans/metric deltas before the crash — dump before re-raising
        _flight.FLIGHT.dump_on_failure(
            f"replay producer crash: {shared.crash!r}")
        raise shared.crash
    if error is not None:
        # ReplayResult failure (first error wins): a crash-proof record
        # of the moments before the bad window, for offline triage
        _flight.FLIGHT.dump_on_failure(
            f"replay failed at block {n_ok}: {error}")
        return ReplayResult(None, n_ok, error)
    if shared.seq_error is not None:
        # the valid prefix (incl. the drained proofs) is fully verified:
        # resumable when the error is retry-later
        resume = (shared.final_state
                  if isinstance(shared.seq_error, OutsideForecastRange)
                  else None)
        if resume is None:
            # genuine sequential validation failure (retry-later horizon
            # waits are normal operation, not flight-dump material)
            _flight.FLIGHT.dump_on_failure(
                f"replay failed at block {shared.seq_done}: "
                f"{shared.seq_error}")
        return ReplayResult(resume, shared.seq_done, shared.seq_error)
    return ReplayResult(shared.final_state, shared.seq_done, None)


def _run_producer(*args) -> None:
    try:
        _produce(*args)
    finally:
        _FINISHED.inc()


# placed at the bottom to avoid a circular import at module load
# (batch.py imports replay_threaded; we only need its seq step)
from .batch import _seq_block_step  # noqa: E402
