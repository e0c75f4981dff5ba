"""Batched window validation — the point of the framework.

The reference validates strictly sequentially (`ledgerDbPushMany` fold,
LedgerDB/InMemory.hs:429-449; per-header validate in the ChainSync client,
MiniProtocol/ChainSync/Client.hs:792).  Per SURVEY.md §2 "The TPU-relevant
gap", every VRF/KES/Ed25519 proof in a window of headers/blocks is
*independent* once the cheap sequential inputs (nonces, ticked states) are
derived.  This module does the split:

  pass 1 (host, sequential, cheap)  envelope checks + tick + reupdate fold,
                                    collecting proof obligations per header
  pass 2 (device, one batch)        all proofs verified together
  result                            valid prefix + states, or first failure

This is the `lax.scan` (sequential state) + vmapped-verify (parallel proofs)
decomposition of SURVEY.md §7 P3, with the scan on host because chain state
is pointer-heavy, and the FLOP-heavy group math on device.

Ported from `ouroboros_tpu/consensus/batch.py` (the port imports nothing
of the JAX package). Copied whole. On the card the windows go through
`TorchBackend` (crypto/torch_backend.py); the JAX package's backends named
below are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..crypto.backend import CryptoBackend, default_backend
from .header_validation import (
    HeaderError, HeaderState, validate_envelope, revalidate_header,
)
from .ledger import (
    ExtLedgerRules, ExtLedgerState, LedgerError, OutsideForecastRange,
)
from .protocol import ConsensusProtocol, _verify_mixed


@dataclass
class BatchValidationResult:
    """Valid prefix of the window.

    states[i] is the state *after* headers[i]; len(states) == n_valid.
    error explains why headers[n_valid] failed (None if all valid).
    """
    states: list
    n_valid: int
    error: Optional[Exception]

    @property
    def all_valid(self) -> bool:
        return self.error is None

    @property
    def final_state(self):
        return self.states[-1] if self.states else None


def _seq_header_pass(protocol: ConsensusProtocol, headers: Sequence[Any],
                     header_state: HeaderState,
                     ledger_view_for: Callable[[int, Any], Any]):
    """Pass 1 (host, sequential, cheap): envelope + tick + reupdate fold,
    collecting proof obligations per header.  Shared by the direct
    batched path below and the VerifyService-coalesced path
    (crypto/batching.validate_headers_coalesced) so the two can never
    drift.  Returns (states, proofs, owner, seq_error, n_seq)."""
    states: list[HeaderState] = []
    proofs: list = []
    owner: list[int] = []          # proofs[j] belongs to headers[owner[j]]
    seq_error: Optional[Exception] = None
    n_seq = 0                      # headers that passed the sequential pass

    st = header_state
    for i, h in enumerate(headers):
        try:
            view = ledger_view_for(i, h)
            validate_envelope(h, st, protocol)
            ticked = protocol.tick_chain_dep_state(
                st.chain_dep_state, view, h.slot)
            protocol.sequential_checks(ticked, h, view)
            reqs = protocol.extract_proofs(ticked, h, view)
            st = revalidate_header(protocol, view, h, st)
        except OutsideForecastRange as e:
            # not a validation failure: the caller must wait for the chain
            # to advance (ChainSync forecast-horizon waiting)
            seq_error = e
            break
        except Exception as e:
            seq_error = e if isinstance(e, HeaderError) else HeaderError(str(e))
            break
        proofs.extend(reqs)
        owner.extend([i] * len(reqs))
        states.append(st)
        n_seq += 1
    return states, proofs, owner, seq_error, n_seq


def _merge_header_verdicts(headers: Sequence[Any], states: list,
                           proofs: list, owner: list, ok: Sequence,
                           seq_error: Optional[Exception],
                           n_seq: int) -> BatchValidationResult:
    """Fold the proof verdict vector back into the valid prefix (the
    other half shared with the coalesced path)."""
    first_bad = n_seq
    bad_proof: Optional[int] = None
    for j, good in enumerate(ok):
        if not good and owner[j] < first_bad:
            first_bad, bad_proof = owner[j], j

    if bad_proof is not None:
        err: Optional[Exception] = HeaderError(
            f"proof {type(proofs[bad_proof]).__name__} failed for header "
            f"index {first_bad} (slot {headers[first_bad].slot})")
    else:
        err = seq_error
    return BatchValidationResult(states[:first_bad], first_bad, err)


def validate_headers_batched(
        protocol: ConsensusProtocol,
        headers: Sequence[Any],
        header_state: HeaderState,
        ledger_view_for: Callable[[int, Any], Any],
        backend: Optional[CryptoBackend] = None) -> BatchValidationResult:
    """Validate a window of headers with one device batch for all proofs.

    Equivalent to folding validate_header, but ~window-size× fewer device
    round trips.  `ledger_view_for(i, header)` supplies the ledger view for
    header i (from forecasts during sync, or the tip view during replay).
    """
    backend = backend or default_backend()
    protocol.prefetch_window(headers, backend)
    states, proofs, owner, seq_error, n_seq = _seq_header_pass(
        protocol, headers, header_state, ledger_view_for)

    # one device batch for every proof in the window
    ok = _verify_mixed(backend, proofs) if proofs else []
    return _merge_header_verdicts(headers, states, proofs, owner, ok,
                                  seq_error, n_seq)


def _seq_block_step(protocol: ConsensusProtocol, ledger, st: ExtLedgerState,
                    b: Any) -> tuple[list, ExtLedgerState]:
    """One block of the sequential pass: envelope + cheap checks + proof
    extraction + optimistic reapply.  Shared by the synchronous and the
    pipelined drivers.  Raises on any sequential failure."""
    header = getattr(b, "header", b)
    view = ledger.forecast_view(st.ledger, header.slot)
    validate_envelope(header, st.header, protocol)
    ticked_dep = protocol.tick_chain_dep_state(
        st.header.chain_dep_state, view, header.slot)
    protocol.sequential_checks(ticked_dep, header, view)
    ticked_ledger = ledger.tick(st.ledger, b.slot)
    ledger.sequential_checks(ticked_ledger, b)
    reqs = (protocol.extract_proofs(ticked_dep, header, view)
            + ledger.extract_proofs(ticked_ledger, b))
    return reqs, ExtLedgerState(
        ledger.reapply_block(ticked_ledger, b),
        revalidate_header(protocol, view, header, st.header))


def validate_blocks_batched(
        ext_rules: ExtLedgerRules,
        blocks: Sequence[Any],
        ext_state: ExtLedgerState,
        backend: Optional[CryptoBackend] = None) -> BatchValidationResult:
    """Full-block analog: header proofs + body witness proofs (the
    reference's BBODY Ed25519 multi-verify) in one batch.  The replay/
    candidate-validation hot path (ChainSel.hs:775-808, OnDisk.hs:277),
    batched."""
    backend = backend or default_backend()
    protocol, ledger = ext_rules.protocol, ext_rules.ledger
    protocol.prefetch_window([getattr(b, "header", b) for b in blocks],
                             backend)
    states: list[ExtLedgerState] = []
    proofs: list = []
    owner: list[int] = []
    seq_error: Optional[Exception] = None
    n_seq = 0

    st = ext_state
    for i, b in enumerate(blocks):
        try:
            reqs, st = _seq_block_step(protocol, ledger, st, b)
        except OutsideForecastRange as e:
            # not a validation failure: the caller must retry once the
            # chain advances (the reference never marks such a block
            # invalid — same special case as validate_headers_batched)
            seq_error = e
            break
        except Exception as e:
            seq_error = (e if isinstance(e, (HeaderError, LedgerError))
                         else LedgerError(str(e)))
            break
        proofs.extend(reqs)
        owner.extend([i] * len(reqs))
        states.append(st)
        n_seq += 1

    ok = _verify_mixed(backend, proofs) if proofs else []
    first_bad = n_seq
    bad_proof = None
    for j, good in enumerate(ok):
        if not good and owner[j] < first_bad:
            first_bad, bad_proof = owner[j], j

    if bad_proof is not None:
        err: Optional[Exception] = LedgerError(
            f"proof {type(proofs[bad_proof]).__name__} failed for block "
            f"index {first_bad} (slot {blocks[first_bad].slot})")
    else:
        err = seq_error
    return BatchValidationResult(states[:first_bad], first_bad, err)


@dataclass
class ReplayResult:
    """Outcome of a pipelined replay: final state only (a mainnet-scale
    replay cannot keep per-block states), global valid-block count, first
    error.

    On OutsideForecastRange — retry-later, not a validation failure —
    final_state is the state after the valid prefix, so the caller can
    resume the replay from there once the chain advances; on a genuine
    validation failure final_state is None."""
    final_state: Any
    n_valid: int
    error: Optional[Exception]

    @property
    def all_valid(self) -> bool:
        return self.error is None


def replay_blocks_pipelined(
        ext_rules: ExtLedgerRules,
        blocks,
        ext_state: ExtLedgerState,
        backend: Optional[CryptoBackend] = None,
        window: int = 512,
        total_blocks=None,
        tracker=None,
        on_window=None) -> ReplayResult:
    """Producer/consumer-pipelined replay: a background producer thread
    runs window w+1's sequential pass, request packing and async submit
    WHILE the caller thread blocks on window w's device results — host
    and device time genuinely overlap instead of adding (a one-thread
    pipeline interleaved both halves, so they could not).  Window
    w's device call also computes the VRF betas window w+2's sequential
    pass will need, installed at drain time; the producer's permit gate
    keeps it exactly within that beta-carry distance
    (consensus/pipeline.py has the protocol).

    `blocks` may be any iterable — windows are consumed with a bounded
    look-ahead, so a mainnet-scale replay streams without buffering the
    chain.

    The sequential pass advances optimistically via reapply (no crypto);
    if a window's proof batch later fails, the replay aborts with the
    failing block's global index — the db-analyser/LgrDB replay semantics
    (OnDisk.hs:277), where any invalid block invalidates the run.

    The two in-flight windows are double-buffered on device: each
    window's input arrays are donated to its fused program
    (JaxBackend._window_composite), so on the warm path XLA reuses the
    previous window's buffers instead of allocating fresh ones, and the
    cross-window precomputation cache (crypto/precompute.py) means a
    warm window ships no per-key decompression or table-build work at
    all — only the ladders themselves.  On backends with
    `supports_window_fold` the drain is a device-folded WindowVerdict
    (one scalar pair) instead of a per-proof vector.

    A ShardedJaxBackend (parallel/sharded_verify.py) rides this same
    driver unchanged: the producer pads each window to the
    per-shard bucket shape, the window composite shard_maps the packed
    cores over the mesh, and the fold verdict's min-reduction already
    spans shards — first-error-wins is preserved because the failing
    request INDEX, not a per-shard flag, is what crosses the link.
    `bench.py --mesh N` and the multichip dryrun are the measured
    entry points.

    `on_window(state, n_done, point)` fires after each window is FULLY
    verified — the streaming engine's snapshot seam (identical contract
    on the threaded and the synchronous fallback drivers); `tracker`
    shares one pipeline ProgressTracker across stages.

    Falls back to the synchronous windowed driver on backends without
    submit_window."""
    import itertools

    from ..chain.block import Point

    backend = backend or default_backend()
    submit = getattr(backend, "submit_window", None)

    if submit is None:
        block_iter = iter(blocks)
        st = ext_state
        done = 0
        while True:
            w = list(itertools.islice(block_iter, window))
            if not w:
                break
            # the synchronous validate IS this driver's in-flight
            # window: bracketing it keeps the shared tracker honest —
            # the streaming engine's prefetch thread genuinely overlaps
            # it (disk_hidden accrues), and the live progress gauges
            # advance per window instead of freezing for the whole run
            if tracker is not None:
                tracker.window_submitted()
            n_ok = 0
            try:
                res = validate_blocks_batched(ext_rules, w, st,
                                              backend=backend)
                n_ok = res.n_valid
            finally:
                if tracker is not None:
                    tracker.window_drained(n_ok)
            done += res.n_valid
            # hook parity with the threaded driver: a window that died
            # on a PROOF failure yields no checkpoint (the threaded
            # drain cannot attribute a partial prefix), while a
            # retry-later horizon wait still checkpoints its verified
            # prefix on both drivers
            if on_window is not None and res.n_valid \
                    and (res.all_valid
                         or isinstance(res.error, OutsideForecastRange)):
                last = getattr(w[res.n_valid - 1], "header",
                               w[res.n_valid - 1])
                on_window(res.states[-1], done, Point(last.slot,
                                                      last.hash))
            if not res.all_valid:
                resume = (res.final_state or st
                          if isinstance(res.error, OutsideForecastRange)
                          else None)
                return ReplayResult(resume, done, res.error)
            st = res.final_state
        return ReplayResult(st, done, None)

    from .pipeline import replay_threaded
    return replay_threaded(ext_rules, blocks, ext_state, backend,
                           window=window, total_blocks=total_blocks,
                           tracker=tracker,
                           on_window=on_window)  # total from len() too
