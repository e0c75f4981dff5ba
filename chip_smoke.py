#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ouroboros_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit.  Phases:

1. the card (name and power limit from nvidia-smi) and the build of the
   nine CUDA kernels from ouroboros_tpu_torch/csrc/;
2. each kernel against its plain PyTorch version on the card, at the
   main path's lane counts (Ed25519 4096, VRF 2048, betas 2048, KES jobs
   8192; the full Ed25519 verify on the same 4096 requests with A-side
   tampers added; the four chain kernels on the field microbenchmark's
   4096 lanes at the longer chain of mul and of dbl) with tampered
   lanes, compared exactly; ed25519_split, vrf_verify, gamma8,
   ed25519_verify and kes_hash (several threads a lane) again on the
   first n - 3 of those lanes; a sample of lanes against the CPU
   references (ed25519_ref, vrf_ref), and every KES job against hashlib
   (tampered: a Merkle node, a digest's last word, a message's first
   word); kes_hash also on 65536 random jobs, against its plain version
   and hashlib, a quarter of them tampered in each of those ways and in
   the digest's first word;
3. kernel times, CUDA events around the wrapper call (`ms`, median of 7
   after a warm-up, the host time of the launch included), the host time
   of one wrapper call alone (`host_us`, device.host_us: median of 200,
   the card idle at each call), the plain versions' times, the verdict
   fold's and the per-key fill's times, and each kernel's bound: per-lane
   32-bit integer multiply-adds counted from the plain version's field
   products (for the chains, k times microbench_field.OPS_PER_STEP), over
   the card's integer rate (kes_hash: blake2b.INT_OPS, the fewest simple
   32-bit instructions a check needs, over the SM's issue rate), or its
   bytes over the memory rate, whichever is larger;
4. the main path: `validate.drive` over six 1024-block windows of 1024
   pools, two in flight with fold=True: windows 0-2 valid, window 3 with
   a flipped witness signature, window 4 with a VRF proof held against
   another input (only the device fold's challenge check sees it),
   window 5 with a bad KES Merkle node (a cold path in a KES-warm
   window).  Each window's first bad request must be the one the CPU
   references find, which also check a sample of every window and the
   betas; each of the four window kernels must have launched there.  The
   path runs three times back to back, each on a fresh backend, to show
   the spread of its rate beside the process's CPU seconds in each run;
5. the Shelley replay: a chain forged in memory (chainsynth.py: 2304
   blocks, 2 pools, f = 4/5, epoch length 600, two transactions a block,
   k = 2160, KES depth 6) replayed from genesis through
   `replay_blocks_pipelined` on a fresh TorchBackend at 1024-block
   windows (the producer's sequential header/ledger pass, fold=True, two
   windows in flight), three times with a cleared beta cache: every
   block valid and the final ledger state_hash the forger's; each of the
   four window kernels must launch in each run.  Then four tampered
   chains, each stopping at its block: a KES signature flipped at 1500
   (the proof failure wins over the envelope break at 1501), a witness
   flipped before block 2100's header was forged (its proof), block 700
   dropped (a sequential error), and a witness flipped after block 300
   was forged (its proof; no body hash is checked, so the later windows
   stay valid and go in behind it), every window each run submitted
   finished; and 64 requests of each window of
   the valid chain (their sequential pass rerun on the host) with the
   tampered blocks' requests, verified on the card as the port's
   CpuRefBackend verifies them;
6. the disk replay: phase 5's chain written to disk by the port's
   db_synth (`write_chain`, chunks of 100 slots, in the native and the
   reference format; its config.json must be what the db_synth CLI
   writes for those arguments) and replayed from there by db_analyser's
   `analysis_validate` (`--validate full --backend torch --window 1024
   --read-ahead 4`: the prefetch thread reads and decodes chunks while
   earlier windows verify), three times from the native DB and once
   from the reference one, then once each at a read-ahead of 1 and 2
   windows, each to the forger's state_hash with a cleared beta cache,
   a fresh backend and each of the four window kernels launched; a run
   with snapshots every 600 slots, a resumed
   reopen that replays nothing, and a replay killed at its second drain
   and resumed on a fresh TorchBackend to the same hash; a 2,100-block
   Byron->Shelley DB (db_synth's cardano chain, epoch length 500, the
   fork at block 1001 of the first window) replayed across its fork to
   `--validate reapply`'s state_hash; and a copy of the native DB with a
   witness byte of block 300 flipped in its chunk and the block's CRC
   recomputed, which must stop at block 300 with a proof error, every
   window it submitted finished;
7. the serve path (a caught-up node): ed25519_split, vrf_verify and
   kes_hash held exactly against their plain versions on the first 128
   and 256 lanes of phase 2's inputs (a flush's widths); then
   `serve.sim_legs` (bench.py's three modeled legs in virtual time, its
   gates) and `serve.card_legs` on phase 5's chain: VerifyService over a
   fresh TorchBackend under the real-clock IO runtime, CppBackend the
   fallback, the break-even table calibrated first; the saturated
   (about 4,000 requests), light-load, back-pressure and mempool legs,
   which must pass `serve.check_card`: every verdict CppBackend's (a
   sample CpuRefBackend's), no dispatch error, no device batch without a
   launch, the three kernels launched in the saturated leg, no device
   batch under light load, back-pressure waits with every verdict
   delivered, the mempool's admissions the synchronous path's, no leaked
   task;
8. the multi-device path (parallel/) on this one card, two shards on
   cuda:0, each on a CUDA stream of the mesh's: phase 5's chain replayed
   three times through `ShardedTorchBackend` (2048 Ed25519 and 1024 VRF
   lanes a shard of a full window) to the forger's state_hash, each run
   in turns with a single-device run of the same chain, each sharded
   run's ed25519_split, vrf_verify, gamma8 and kes_hash launches twice
   phase 5's; phase 5's tampered chains, each stopping at phase 5's
   block with its error; phase 4's six windows over two and over three
   shards (shard widths no power of two), each submit's packed buffer
   (KES lanes included) byte for byte the one a single launch a kernel
   gives at the same padding on a backend as cold, each kernel launched
   once a shard, the folded first bad requests phase 4's;
   `sharded_batch_verify` on phase 2's 4096 full-verify requests equal to
   `batch_verify_ed25519`, ed25519_verify launched once a shard; and
   `multichip.dryrun_multichip` with its scaling report over the two
   shards;
9. the standalone batch-verify path: `perf_probe --old` at 4096 Ed25519
   and 2048 VRF lanes (split and full Ed25519 verify, VRF verify, betas;
   each row asserts that every lane verifies), where ed25519_verify and
   the three kernels the probe drives must launch;
10. the field microbenchmark path: field_chain, field_chain_lp (mul and
   sqr), point_chain and point_chain_x4 each held exactly against its
   plain version on the card for every operation at both of its chain
   lengths, at every lane count the microbenchmark runs (4096, the JAX
   script's, and 65536) and on the first n - 3 of each, and 16 lanes of
   each chain against Python integers (edwards.py's formulas mod p);
   then `microbench_field --ops
   --e2e` at 4096 lanes (one warp an SM for the one-thread kernels) and
   `--ops` at 65536 (sixteen), where each of the four must launch; last,
   each of the nine kernels' own device time from torch.profiler
   (`device_ms`, median of 7 after two warm-ups), kes_hash's at 65536
   lanes too, and the three serve kernels' at 128 and 256 lanes
   (`serve_device_ms`), after every path whose rate is measured, so
   that no profiling runs before them.  Every
   per-operation time and device_ms must come from a profiler trace that
   held exactly the kernel's launches, never from CUDA events, which hold
   host time.  After them one more replay of phase 5's valid chain runs
   under torch.profiler for the card's busy seconds: its some hundred
   thousand traced kernels could reach a later trace, so it comes last;
11. a `main_path` JSON line, a `microbench_field` JSON line (the
   per-operation rows at both lane counts), a `replay` JSON line
   (blocks/s, proofs/s, the producer's host_seq and submit seconds with
   the fill and fold inside it, and the consumer's drain seconds, per
   window of each run; the launches per kernel; the profiled run's
   busy seconds; the forging seconds; the card), a `disk_replay` JSON
   line (per run blocks/s, proofs/s, the stream's stats, the spans of
   the producer, the consumer and the prefetch thread's reads and
   decoding, and the launches per kernel; the snapshot, resume, kill,
   Cardano and tampered runs; the Cardano DB's cuts; the card), a
   `serve` JSON line (`sim` and `card`: per leg requests, proofs/s,
   makespan, p50/p95/p99 latency, deadline misses, the service's stats
   and batch-size and batch-bucket histograms, launches, leaked tasks;
   the break-even table; the card), a `sharded` JSON line (blocks/s and
   proofs/s of each sharded run beside the single-device run in turns
   with it and phase 5's of this call, spans,
   launches, padding_stats, the tampered chains, the windows' lanes and
   verdicts at two and three shards, MULTICHIP_OBS less its metrics
   snapshot and MESH_SCALING, the card), a `kernels` JSON line
   (each
   kernel's launches are those of its path: the main path's, the
   probe's for ed25519_verify, the microbenchmark's for the chains, and
   for the four window kernels the replay's first run's as
   `replay_launches` and the first native disk replay's as
   `disk_replay_launches`; every kernel's launches in the serve path's
   saturated leg as `serve_launches`, and in the first sharded replay
   (for ed25519_verify, the sharded batch verify) as
   `sharded_launches`; its
   launch shape as threads_per_lane and block; kes_hash's 65536-lane
   row under `wide`), the card line, and as
   the last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

SEED = 0
WINDOWS = 6
WINDOW = 1024
POOLS = 1024
# window -> (block, windowgen's tamper function, position in the block)
TAMPERS = {3: (517, "tamper_witness", "FIRST_WITNESS"),
           4: (300, "tamper_vrf_alpha", "LEADER_VRF"),
           5: (700, "tamper_kes_node", "KES_SIG")}
RUNS = 3                     # back-to-back runs of the main path
SAMPLE = 16                  # blocks per window held against the CPU refs
# H100 SXM: HBM3 at 3.35 TB/s (NVIDIA data sheet); the integer rates are
# microbench_field.int_rate's
HBM_BYTES_PER_S = 3.35e12
# kes_hash's lane count where the card is full (csrc_compare's too)
KES_WIDE = 65536
# the kernels each path must launch
MAIN_PATH = ("ed25519_split", "vrf_verify", "gamma8", "kes_hash")
PROBE_PATH = ("ed25519_split", "ed25519_verify", "vrf_verify", "gamma8")
PROBE_ARGS = ["--reps", "5", "--n-ed", "4096", "--n-vrf", "2048", "--old"]
# the kernels of several threads a lane, checked at a ragged lane count too
RAGGED = ("ed25519_split", "vrf_verify", "gamma8", "ed25519_verify",
          "kes_hash")
# the field microbenchmark's lane counts (the JAX script's, and sixteen
# times it) and its runs at them
CHAIN_LANES = (4096, 65536)
CHAIN_SAMPLE = 16            # lanes of each chain held against Python ints
MB_RUNS = (["--ops", "--e2e", "--lanes", str(CHAIN_LANES[0])],
           ["--ops", "--lanes", str(CHAIN_LANES[1])])
# the replay: bench.py's flagship widths (2 pools, f = 4/5, epoch length
# 600, two transactions a block, window 1024), cut to two full windows
# and a 256-block third, at KES depth 6
REPLAY_BLOCKS = 2304
REPLAY_KES_DEPTH = 6
REPLAY_RUNS = 3
REPLAY_SAMPLE = 64           # requests per window held against CpuRef
REPLAY_EPOCH = 600
# tampered chains: name -> (block, what fails there)
REPLAY_TAMPERS = {"kes_sig": (1500, "proof"), "witness": (2100, "proof"),
                  "dropped": (700, "sequential"),
                  "witness_post": (300, "proof")}
# the disk replay: the replay's chain in db_synth's default chunks of 100
# slots, in both on-disk formats, streamed with db_analyser's default
# read-ahead of four windows; the native DB replayed three times
FORMATS = ("native", "reference")
DISK_CHUNK = 100
DISK_READ_AHEAD = 4
DISK_READ_AHEAD_SWEEP = (1, 2)   # one native run at each, after the three
DISK_RUNS = 3
DISK_SNAPSHOT_EVERY = 600    # slots: one epoch
DISK_KILL_AT = 2             # the drain that stops the killed replay
DISK_TAMPER_AT = 300         # the block whose witness is flipped on disk
# the Byron->Shelley DB: db_synth's default epoch length (500), so the
# fork (epoch 2) falls at block 1001, inside the first window; cut from
# bench.py's 10,000 blocks to two full windows and a 52-block third
CARDANO_BLOCKS = 2100
CARDANO_EPOCH = 500
CARDANO_CHUNK = 100
# the serve path: a flush's lane counts (the padding ladder's first two
# rungs at max_batch 256), bench.py's serve seed, the saturated leg's
# full scale
SERVE_LANES = (128, 256)
SERVE_SEED = 7
SERVE_SCALE = 1.0
# the multi-device path on one card: shards on cuda:0, each on a stream of
# its own; phase 5's replay over SHARDS, phase 4's windows over each of
# SHARD_COUNTS (three: shard widths that are no power of two)
SHARDS = 2
SHARD_COUNTS = (2, 3)


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def from_profiler(src: str) -> bool:
    """Whether a time's label (device.kernel_ms's, or two of them joined
    by '/') says it came from a trace that held exactly the kernel's
    launches."""
    return all(re.fullmatch(r"profiler( \(trace \d+ of \d+\))?", s)
               for s in src.split("/"))


def chain_int(op: str, x: int, y: int, k: int, ed) -> int:
    """The chain kernels' function on one lane in Python integers mod p:
    a field operation k times, or from P = (x, y, x, y) k doublings or
    additions of P with edwards.py's formulas, and X + Y + Z + T."""
    p = ed.P
    if op in ("dbl", "addc"):
        P0 = Q = (x, y, x, y)
        for _ in range(k):
            Q = ed.pt_double(Q) if op == "dbl" else ed.pt_add(Q, P0)
        return sum(Q) % p
    for _ in range(k):
        x = {"mul": x * y, "sqr": x * x, "add": x + y, "carry": x}[op] % p
    return x


def _finished_replay(label: str, ext, blocks, backend) -> tuple:
    """replay.replay_once through `backend`, with every window it
    submitted required to be finished (read back, its event passed) when
    it returns: the first-error teardown finishes windows past a failing
    one too.  Returns (replay_once's dict, the number of windows
    submitted)."""
    from ouroboros_tpu_torch import replay

    finished = []
    finish = backend.finish_window
    backend.finish_window = lambda st, f=finish: finished.append(st) or f(st)
    r = replay.replay_once(ext, blocks, backend, WINDOW)
    if len(finished) != backend.padding_stats()["windows"] or any(
            st["event"] is not None and not st["event"].query()
            for st in finished):
        raise AssertionError(f"replay of {label} left a window unfinished")
    return r, len(finished)


def replay_phase(card: str) -> tuple:
    """Phase 5: forge the chain, replay it on the card (valid three
    times, then each tampered chain), hold a sample of each window's
    requests against the port's CpuRefBackend.  Returns the `replay`
    line's dict, (ext, chain, the forger's state_hash) for the later
    phases and the profiled run at the end, and the tampered chains."""
    import numpy as np

    from ouroboros_tpu_torch import chainsynth, replay
    from ouroboros_tpu_torch.consensus.batch import _seq_block_step
    from ouroboros_tpu_torch.consensus.header_validation import HeaderError
    from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
    from ouroboros_tpu_torch.consensus.ledger import LedgerError
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.eras.shelley import KES_FIELD

    t = time.perf_counter()
    ext, chain, forged, variant = chainsynth.forge_shelley(
        REPLAY_BLOCKS, epoch_length=REPLAY_EPOCH, kes_depth=REPLAY_KES_DEPTH,
        bad_witness_at=REPLAY_TAMPERS["witness"][0])
    forge_s = time.perf_counter() - t
    want_hash = forged.ledger.state_hash()
    log(f"replay: forged {len(chain)} blocks in {forge_s:.3f} s (KES depth "
        f"{REPLAY_KES_DEPTH}, {chain[-1].slot + 1} slots)")
    runs = []
    for run in range(REPLAY_RUNS):
        backend = TorchBackend()
        K.reset_launches()
        r = replay.replay_once(ext, chain, backend, WINDOW)
        r["launches"] = dict(K.LAUNCHES)
        res = r["result"]
        if not res.all_valid or res.n_valid != len(chain) or \
                res.final_state.ledger.state_hash() != want_hash:
            raise AssertionError(
                f"replay run {run}: n_valid {res.n_valid} of {len(chain)}, "
                f"error {res.error!r}, or a state_hash not the forger's")
        missing = [k for k in MAIN_PATH if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in the replay: "
                                 f"{missing}")
        runs.append(r)
        sp = r["spans"]
        log(f"replay run {run}: {r['blocks_per_s']:.1f} blocks/s, "
            f"{r['proofs_per_s']:.1f} proofs/s ({r['seconds']:.3f} s), "
            f"state_hash == forger's; host_seq {sum(sp['window.host_seq']):.3f}"
            f" s, submit {sum(sp['window.submit']):.3f} s (fill "
            f"{sum(sp['precompute.fill']):.3f}, fold "
            f"{sum(sp['window.fold']):.3f}), drain "
            f"{sum(sp['pipeline.drain']):.3f} s; launches {r['launches']}")

    # the tampered chains
    b = REPLAY_TAMPERS["kes_sig"][0]
    sig = bytearray(chain[b].header.get(KES_FIELD))
    sig[8] ^= 1
    kes_bad = ProtocolBlock(
        chain[b].header.with_fields(**{KES_FIELD: bytes(sig)}),
        chain[b].body)
    d = REPLAY_TAMPERS["dropped"][0]
    w = REPLAY_TAMPERS["witness"][0]
    # a witness flipped after forging: the replay checks no body hash, so
    # the header and every later block stay valid and the producer runs
    # ahead of the failing window
    p = REPLAY_TAMPERS["witness_post"][0]
    tx = chain[p].body[0]
    (vk, wsig), = tx.witnesses
    post = ProtocolBlock(chain[p].header, (dataclasses.replace(
        tx, witnesses=((vk, wsig[:40] + bytes([wsig[40] ^ 1])
                        + wsig[41:]),)),) + chain[p].body[1:])
    chains = {"kes_sig": chain[:b] + [kes_bad] + chain[b + 1:],
              "witness": chain[:w] + [variant],
              "dropped": chain[:d] + chain[d + 1:],
              "witness_post": chain[:p] + [post] + chain[p + 1:]}
    tampered = {}
    for name, blocks in chains.items():
        at, kind = REPLAY_TAMPERS[name]
        r, n_sub = _finished_replay(f"the {name} chain", ext, blocks,
                                    TorchBackend())
        res = r["result"]
        err = res.error
        proof = isinstance(err, LedgerError) and "proof" in str(err)
        seq = isinstance(err, HeaderError)
        if res.n_valid != at or res.final_state is not None or \
                not (proof if kind == "proof" else seq):
            raise AssertionError(f"replay of the {name} chain: n_valid "
                                 f"{res.n_valid}, expected {at} with a "
                                 f"{kind} error; got {err!r}")
        tampered[name] = {"n_valid": res.n_valid, "error": repr(err),
                          "seconds": r["seconds"],
                          "windows_submitted": n_sub}
        log(f"replay {name}: stopped at block {res.n_valid} ({err!r}); "
            f"{n_sub} windows submitted, all finished")

    # a sample of every window's requests, and the tampered blocks', on
    # the card against the CPU reference
    protocol, ledger = ext.protocol, ext.ledger
    st = ext.initial_state()
    windows: list = []
    extra: dict = {}
    for i, blk in enumerate(chain):
        if i % WINDOW == 0:
            windows.append([])
        for name, bad in (("kes_sig", kes_bad), ("witness", variant)):
            if i == REPLAY_TAMPERS[name][0]:
                extra[name] = _seq_block_step(protocol, ledger, st, bad)[0]
        reqs, st = _seq_block_step(protocol, ledger, st, blk)
        windows[-1].extend(reqs)
    rng = np.random.default_rng(SEED)
    card_be, cpu = TorchBackend(), CpuRefBackend()
    n_sampled = n_false = 0
    for wi, reqs in enumerate(windows):
        pick = sorted(rng.choice(len(reqs), REPLAY_SAMPLE, replace=False))
        sample = [reqs[j] for j in pick]
        if wi == len(windows) - 1:
            sample += extra["kes_sig"] + extra["witness"]
        want = cpu.verify_mixed(sample)
        got = card_be.verify_mixed(sample)
        if got != want:
            raise AssertionError(f"replay window {wi}: the card's verdicts "
                                 f"on {len(sample)} requests != CpuRef")
        n_sampled += len(sample)
        n_false += want.count(False)
    if n_false != 2:
        raise AssertionError(f"{n_false} sampled requests failed; the two "
                             f"tampered ones should, and only they")
    log(f"replay: {n_sampled} sampled requests (the tampered blocks' "
        f"included) == CpuRefBackend")
    return {
        "blocks": len(chain), "window": WINDOW,
        "kes_depth": REPLAY_KES_DEPTH, "forge_s": forge_s,
        "blocks_per_s": [r["blocks_per_s"] for r in runs],
        "proofs_per_s": [r["proofs_per_s"] for r in runs],
        "seconds": [r["seconds"] for r in runs],
        "host_seq_s": [r["spans"]["window.host_seq"] for r in runs],
        "submit_s": [r["spans"]["window.submit"] for r in runs],
        "fill_s": [r["spans"]["precompute.fill"] for r in runs],
        "fold_s": [r["spans"]["window.fold"] for r in runs],
        "drain_s": [r["spans"]["pipeline.drain"] for r in runs],
        "launches": [r["launches"] for r in runs],
        "tampered": tampered, "sampled_requests": n_sampled,
        "card": card}, (ext, chain, want_hash), chains


class HardStop(BaseException):
    """The disk phase's kill: not an Exception, so nothing between the
    drain and the caller swallows it."""


def _stream_run(label: str, fn, device) -> dict:
    """One replay from disk (fn() gives db_analyser's JSON record, or a
    StreamReplayResult) with a cleared beta cache, its launches counted
    from 0 and its spans recorded: the main path's and the prefetch
    thread's."""
    from ouroboros_tpu_torch import replay
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE

    GLOBAL_BETA_CACHE.clear()
    K.reset_launches()
    out, seconds, spans = replay.recording(
        fn, replay.SPANS + replay.DISK_SPANS)
    return {"label": label, "out": out, "seconds": seconds,
            "spans": {k: sum(v) for k, v in spans.items()},
            "launches": dict(K.LAUNCHES)}


def _missing_kernels(run) -> list:
    """The main path's kernels a replay that verified blocks never
    launched."""
    return [k for k in MAIN_PATH if run["launches"][k] == 0]


def disk_phase(card: str, ext, chain, want_hash: bytes,
               device=None) -> dict:
    """Phase 6: phase 5's chain written to disk with the port's db_synth
    and replayed from there with its db_analyser (the streaming engine:
    the prefetch thread's reads and decoding, the producer's pass, the
    card's windows); snapshots, a resumed reopen and a kill resumed on a
    fresh backend; a Byron->Shelley DB across its hard fork; a DB with a
    witness byte flipped in a chunk.  Returns the `disk_replay` line."""
    import io
    import shutil
    import tempfile

    from ouroboros_tpu_torch import db_analyser, db_synth
    from ouroboros_tpu_torch.consensus.ledger import LedgerError
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.storage import (
        DiskPolicy, ImmutableDB, IoFS, StreamConfig, StreamingReplayEngine,
        crc32)
    from ouroboros_tpu_torch.storage.immutabledb import SecondaryEntry
    from ouroboros_tpu_torch.storage.stream import prefetcher_threads_alive
    from ouroboros_tpu_torch.utils import cbor

    def validate(d, mode="full", read_ahead=DISK_READ_AHEAD, **kw):
        db, rules, decode, cfg = db_analyser.load_db(d)
        return db_analyser.analysis_validate(
            db, rules, decode, "torch", mode, WINDOW, io.StringIO(),
            hdr_proofs=db_analyser.HEADER_PROOFS[cfg["protocol"]],
            db_dir=d, read_ahead=read_ahead, device=device, **kw)

    def check(run, want, n):
        rec = run["out"]
        if rec["state_hash"] != want.hex() or rec["blocks"] != n:
            raise AssertionError(
                f"disk replay {run['label']}: {rec['blocks']} blocks, "
                f"state_hash {rec['state_hash']}, expected {n} blocks and "
                f"{want.hex()}")
        if n and _missing_kernels(run):
            raise AssertionError(f"disk replay {run['label']}: kernels not "
                                 f"launched: {_missing_kernels(run)}")
        st = rec["stream"]
        log(f"disk replay {run['label']}: {rec['blocks']} blocks in "
            f"{run['seconds']:.3f} s ({rec['blocks'] / run['seconds']:.1f} "
            f"blocks/s, {rec['proofs'] / run['seconds']:.1f} proofs/s), "
            f"state_hash == {'forger' if want == want_hash else 'reapply'}"
            f"'s; disk {st['disk_secs']} s, hidden {st['disk_hidden_frac']}"
            f", {st['chunks_read']} chunks, {st['prefetch_stalls']} "
            f"stalls, host_seq {st['host_seq_secs']} s; spans "
            + ", ".join(f"{k} {v:.3f}" for k, v in run["spans"].items())
            + f"; launches {run['launches']}")
        return run

    tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    try:
        # -- the Shelley DB, both formats, from phase 5's chain
        dirs = {fmt: os.path.join(tmp, fmt) for fmt in FORMATS}
        t = time.perf_counter()
        config = db_synth.shelley_config(ext, DISK_CHUNK)
        for fmt, d in dirs.items():
            db_synth.write_chain(d, config, chain, fmt,
                                 epoch_length=REPLAY_EPOCH)
        write_s = time.perf_counter() - t
        cli = db_synth.shelley_config_for(db_synth.parser().parse_args([
            "--out", tmp, "--protocol", "shelley", "--blocks",
            str(REPLAY_BLOCKS), "--epoch-length", str(REPLAY_EPOCH),
            "--kes-depth", str(REPLAY_KES_DEPTH), "--chunk-size",
            str(DISK_CHUNK)]))
        for d in dirs.values():
            with open(os.path.join(d, "config.json")) as fh:
                if json.load(fh) != json.loads(json.dumps(cli)):
                    raise AssertionError(f"{d}/config.json is not what "
                                         f"db_synth writes for its "
                                         f"arguments")
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _d, fs in os.walk(dirs["native"]) for f in fs)
        log(f"disk: wrote {len(chain)} blocks in both formats in "
            f"{write_s:.3f} s ({size} bytes native, chunks of "
            f"{DISK_CHUNK} slots); config.json == db_synth's")
        runs = [check(_stream_run(f"native {i}",
                                  lambda: validate(dirs["native"]), device),
                      want_hash, len(chain))
                for i in range(DISK_RUNS)]
        runs.append(check(_stream_run(
            "reference", lambda: validate(dirs["reference"]), device),
            want_hash, len(chain)))
        # a read-ahead shorter than the chain leaves chunks to decode
        # while windows are in flight: what disk_hidden_frac measures
        ahead = [check(_stream_run(
            f"native, read-ahead {k}",
            lambda k=k: validate(dirs["native"], read_ahead=k), device),
            want_hash, len(chain)) for k in DISK_READ_AHEAD_SWEEP]

        # -- snapshots, a resumed reopen, a kill resumed on a fresh backend
        snap_dir = os.path.join(tmp, "snap")
        shutil.copytree(dirs["native"], snap_dir)
        snap = check(_stream_run("snapshots", lambda: validate(
            snap_dir, snapshot_every=DISK_SNAPSHOT_EVERY), device),
            want_hash, len(chain))
        if snap["out"]["stream"]["snapshots_written"] < 2:
            raise AssertionError("the snapshot run wrote fewer than two "
                                 "snapshots")
        reopen = check(_stream_run("resumed reopen", lambda: validate(
            snap_dir, resume=True), device), want_hash, 0)
        if reopen["out"]["stream"]["resumed_from_slot"] != chain[-1].slot:
            raise AssertionError("the resumed reopen did not restore the "
                                 "tip")
        kill_dir = os.path.join(tmp, "kill")
        shutil.copytree(dirs["native"], kill_dir)

        class KillBackend(TorchBackend):
            drains = 0

            def finish_window(self, st):
                self.drains += 1
                if self.drains == DISK_KILL_AT:
                    raise HardStop(f"hard stop at drain {self.drains}")
                return super().finish_window(st)

        def engine(d, backend, resume):
            db, rules, decode, _cfg = db_analyser.load_db(d)
            return StreamingReplayEngine(
                IoFS(d), db, rules, decode, backend=backend,
                config=StreamConfig(
                    window=WINDOW, read_ahead=DISK_READ_AHEAD,
                    policy=DiskPolicy(
                        snapshot_interval_slots=DISK_SNAPSHOT_EVERY),
                    resume=resume))

        killed = engine(kill_dir, KillBackend(device), False)
        try:
            _stream_run("kill", killed.replay, device)
            raise AssertionError("the replay ran past its kill")
        except HardStop:
            pass
        if killed.snapshots_written < 1 or prefetcher_threads_alive():
            raise AssertionError("the kill left no snapshot, or a live "
                                 "prefetch thread")
        resumed = _stream_run("resumed after the kill", engine(
            kill_dir, TorchBackend(device), True).replay, device)
        res = resumed["out"]
        if not res.all_valid or not 0 < res.n_valid < len(chain) or \
                res.final_state.ledger.state_hash() != want_hash:
            raise AssertionError(f"resume after the kill: n_valid "
                                 f"{res.n_valid}, error {res.error!r}, or "
                                 f"a state_hash not the forger's")
        if _missing_kernels(resumed):
            raise AssertionError(f"resume after the kill: kernels not "
                                 f"launched: {_missing_kernels(resumed)}")
        kill = {"at_drain": DISK_KILL_AT,
                "snapshots_written": killed.snapshots_written,
                "resumed_from_slot": res.stats["resumed_from_slot"],
                "resumed_blocks": res.n_valid,
                "resumed_seconds": resumed["seconds"],
                "stream": res.stats, "spans_s": resumed["spans"],
                "launches": resumed["launches"]}
        log(f"disk replay killed at drain {DISK_KILL_AT} after "
            f"{killed.snapshots_written} snapshots; resumed from slot "
            f"{res.stats['resumed_from_slot']} on a fresh backend: "
            f"{res.n_valid} blocks to the forger's state_hash "
            f"({resumed['seconds']:.3f} s); launches "
            f"{resumed['launches']}")
        if prefetcher_threads_alive():
            raise AssertionError("a prefetch thread outlived its replay")

        # -- the Byron->Shelley DB
        card_dir = os.path.join(tmp, "cardano")
        t = time.perf_counter()
        info = db_synth.synth_cardano(db_synth.parser().parse_args([
            "--out", card_dir, "--protocol", "cardano", "--eras",
            "byron-shelley", "--blocks", str(CARDANO_BLOCKS),
            "--epoch-length", str(CARDANO_EPOCH)]))
        forge_s = time.perf_counter() - t
        reapply = validate(card_dir, mode="reapply")
        want_card = bytes.fromhex(reapply["state_hash"])
        cardano = check(_stream_run("cardano", lambda: validate(card_dir),
                                    device), want_card, CARDANO_BLOCKS)
        fork_slot = info["fork_epoch"] * CARDANO_EPOCH
        db = ImmutableDB.open(IoFS(card_dir), CARDANO_CHUNK,
                              validate_all=False)
        fork_block = sum(1 for e, _raw in db.stream() if e.slot < fork_slot)
        if cardano["out"]["stream"]["era_crossings"] < 1 or \
                fork_block >= WINDOW:
            raise AssertionError(f"the Cardano replay crossed "
                                 f"{cardano['out']['stream']['era_crossings']}"
                                 f" eras, fork at block {fork_block}")
        log(f"disk: forged the Byron->Shelley DB in {forge_s:.3f} s "
            f"({CARDANO_BLOCKS} blocks, epoch length {CARDANO_EPOCH}, fork "
            f"at slot {fork_slot}, block {fork_block}); reapply "
            f"{reapply['secs']} s")

        # -- a witness byte flipped in a chunk, its CRC recomputed
        bad_dir = os.path.join(tmp, "tampered")
        shutil.copytree(dirs["native"], bad_dir)
        at = DISK_TAMPER_AT
        db = ImmutableDB.open(IoFS(bad_dir), DISK_CHUNK)
        n = db.chunk_of(chain[at].slot)
        sec = os.path.join(bad_dir, "immutable", f"{n:05d}.secondary")
        raw_idx = open(sec, "rb").read()
        entries, pos = [], 0
        while pos < len(raw_idx):
            obj, used = cbor.loads_prefix(raw_idx[pos:])
            entries.append(SecondaryEntry.decode(obj))
            pos += used
        j = next(i for i, e in enumerate(entries) if e.hash == chain[at].hash)
        e = entries[j]
        path = os.path.join(bad_dir, "immutable", f"{n:05d}.chunk")
        data = bytearray(open(path, "rb").read())
        wsig = chain[at].body[0].witnesses[0][1]
        off = data.find(wsig, e.offset, e.offset + e.size)
        if off < 0:
            raise AssertionError("the witness is not in the block's bytes")
        data[off + 40] ^= 1
        open(path, "wb").write(bytes(data))
        entries[j] = dataclasses.replace(e, crc=crc32(
            bytes(data[e.offset:e.offset + e.size])))
        open(sec, "wb").write(b"".join(cbor.dumps(x.encode())
                                       for x in entries))
        if len(ImmutableDB.open(IoFS(bad_dir), DISK_CHUNK)) != len(chain):
            raise AssertionError("a validating open truncated the "
                                 "tampered DB")
        backend = TorchBackend(device)
        finished = []
        finish = backend.finish_window
        backend.finish_window = lambda st, f=finish: \
            finished.append(st) or f(st)
        bad = _stream_run("tampered", engine(bad_dir, backend, False).replay,
                          device)
        res = bad["out"]
        if res.n_valid != at or res.final_state is not None or not (
                isinstance(res.error, LedgerError)
                and "proof" in str(res.error)):
            raise AssertionError(f"the tampered DB: n_valid {res.n_valid}, "
                                 f"expected {at} with a proof error; got "
                                 f"{res.error!r}")
        if len(finished) != backend.padding_stats()["windows"] or any(
                st["event"] is not None and not st["event"].query()
                for st in finished):
            raise AssertionError("the tampered DB's replay left a window "
                                 "unfinished")
        log(f"disk replay tampered (a witness byte of block {at} in chunk "
            f"{n}, its CRC recomputed; a validating open keeps every "
            f"block): stopped at block {res.n_valid} ({res.error!r}); "
            f"{len(finished)} windows submitted, all finished")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row(run):
        rec = run["out"]
        return {"label": run["label"], "blocks": rec["blocks"],
                "proofs": rec["proofs"], "seconds": run["seconds"],
                "blocks_per_s": rec["blocks"] / run["seconds"],
                "proofs_per_s": rec["proofs"] / run["seconds"],
                "stream": rec["stream"], "spans_s": run["spans"],
                "launches": run["launches"]}

    return {
        "blocks": len(chain), "window": WINDOW, "chunk_slots": DISK_CHUNK,
        "read_ahead": DISK_READ_AHEAD, "write_s": write_s,
        "runs": [row(r) for r in runs],
        "read_ahead_runs": [row(r) for r in ahead],
        "snapshots": row(snap), "resumed_reopen": row(reopen),
        "kill": kill,
        "cardano": dict(row(cardano), forge_s=forge_s,
                        epoch_length=CARDANO_EPOCH, fork_block=fork_block,
                        reapply_s=reapply["secs"],
                        cuts={"blocks": [10_000, CARDANO_BLOCKS]}),
        "tampered": {"block": at, "chunk": n, "n_valid": res.n_valid,
                     "error": repr(res.error),
                     "windows_submitted": len(finished)},
        "card": card}


def serve_phase(card: str, ext, chain, inputs: dict, max_err: dict) -> dict:
    """Phase 7: the serve path's kernels at a flush's widths against their
    plain versions, then serve.py's sim legs and its card legs on phase
    5's chain, which must pass serve.check_card.  Returns the `serve`
    line's dict."""
    import torch

    from ouroboros_tpu_torch import serve
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

    for name in serve.SERVE_KERNELS:
        for n in SERVE_LANES:
            args = [a[..., :n].contiguous() for a in inputs[name]]
            got = getattr(K, name)(*args)
            want = K.KERNELS[name].plain(*args)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err[name] = max(max_err[name], err)
            if tuple(got.shape) != tuple(want.shape) or err != 0:
                raise AssertionError(f"{name}: kernel != plain version on "
                                     f"{n} lanes (max abs err {err})")
        log(f"{name}: kernel == plain version on "
            f"{' and '.join(map(str, SERVE_LANES))} lanes (tolerance 0)")
    t = time.perf_counter()
    sim = serve.sim_legs(SERVE_SEED, SERVE_SCALE)
    if not sim["ok"]:
        raise AssertionError(f"serve sim legs failed their gates: {sim}")
    sat = sim["saturated"]
    log(f"serve sim: saturated {sat['requests']} requests, makespan "
        f"{sat['makespan_secs']} s, {sat['vs_unbatched_cpu']}x the "
        f"unbatched CPU; light load {sim['light_load']['device_batches']} "
        f"device batches; back-pressure waits "
        f"{sim['backpressure']['backpressure_waits']} "
        f"({time.perf_counter() - t:.3f} s)")
    t = time.perf_counter()
    out = serve.card_legs(ext, chain, TorchBackend(), SERVE_SEED,
                          SERVE_SCALE, log=log)
    bad = serve.check_card(out, on_card=True)
    if bad:
        raise AssertionError(f"serve card legs: {bad}")
    seconds = time.perf_counter() - t
    log(f"serve card: every check passed ({seconds:.3f} s); CppBackend "
        f"verdicts {out['cpp_verdicts_s']:.3f} s for {out['requests']} "
        f"requests, CpuRef sample of {out['cpu_ref_sample']} equal")
    return {"sim": sim, "card": out, "seconds": seconds, "card_name": card}


def sharded_phase(card: str, ext, chain, want_hash: bytes, chains: dict,
                  rp: dict, windows, bad_req: dict, main_runs,
                  ed_f) -> dict:
    """Phase 8: the multi-device path on one card, its shards on the
    mesh's streams.  (a) phase 5's chain through `ShardedTorchBackend`
    over ["cuda:0"] * 2, three runs, each in turns with a single-device
    run (single first in even runs), and the tampered chains, each
    stopping as phase 5's did; per sharded run every window kernel
    launches d times phase 5's first run's count.  (b, c) phase 4's six
    windows over two and three shards: each submit's unfolded packed
    buffer byte for byte the one a single launch a kernel gives at the
    same padding (TorchBackend._launch_lanes on the same host arrays, on
    a second backend whose KES cache is as cold), KES lanes in some
    window, each kernel launched once a shard, the folded verdicts phase
    4's (TorchBackend's, held to the CPU references there).  (d) sharded_batch_verify at phase 2's full-verify
    requests == kernels.batch_verify_ed25519, ed25519_verify launched
    once a shard.  (e) multichip.dryrun_multichip and its scaling report
    over ["cuda:0"] * 2.  Returns the `sharded` line's dict."""
    import functools
    import io
    from contextlib import redirect_stdout

    from ouroboros_tpu_torch import multichip
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import VrfReq
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.parallel import (ShardedTorchBackend, make_mesh,
                                              sharded_batch_verify)

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0"] * SHARDS)
    # (a) the full-width sharded replay, in turns with a single-device run
    # of the same chain (single first in even runs), so that the two are
    # compared within this phase, on this host's state
    single = rp["launches"][0]
    runs, singles = [], []
    for run in range(REPLAY_RUNS):
        for sharded in ((False, True) if run % 2 == 0 else (True, False)):
            backend = ShardedTorchBackend(mesh) if sharded else TorchBackend()
            K.reset_launches()
            r, _n = _finished_replay("the valid chain", ext, chain,
                                     backend)
            r["launches"] = dict(K.LAUNCHES)
            r["padding"] = backend.padding_stats()
            res = r["result"]
            if not res.all_valid or res.n_valid != len(chain) or \
                    res.final_state.ledger.state_hash() != want_hash:
                raise AssertionError(
                    f"replay run {run} (sharded: {sharded}): n_valid "
                    f"{res.n_valid}, error {res.error!r}, or a state_hash "
                    f"not the forger's")
            got = {k: r["launches"][k] for k in MAIN_PATH}
            want = {k: single[k] * (SHARDS if sharded else 1)
                    for k in MAIN_PATH}
            if got != want or 0 in want.values():
                raise AssertionError(f"replay run {run} (sharded: "
                                     f"{sharded}): launches {got}, "
                                     f"expected {want}")
            (runs if sharded else singles).append(r)
        sh, sd = runs[-1], singles[-1]
        log(f"sharded replay run {run} (mesh {SHARDS} x cuda:0): "
            f"{sh['blocks_per_s']:.1f} blocks/s, {sh['proofs_per_s']:.1f} "
            f"proofs/s ({sh['seconds']:.3f} s), state_hash == forger's; "
            f"single-device {'after' if run % 2 else 'before'} it "
            f"{sd['blocks_per_s']:.1f} blocks/s, phase 5's "
            f"{rp['blocks_per_s'][run]:.1f}; launches {sh['launches']}; "
            f"spans sharded " + ", ".join(
                f"{k} {sum(v):.3f}" for k, v in sh["spans"].items())
            + "; single " + ", ".join(
                f"{k} {sum(v):.3f}" for k, v in sd["spans"].items()))
    tampered = {}
    for name, blocks in chains.items():
        r, n_sub = _finished_replay(f"the {name} chain, sharded", ext,
                                    blocks, ShardedTorchBackend(mesh))
        res = r["result"]
        ref = rp["tampered"][name]
        if res.n_valid != ref["n_valid"] or repr(res.error) != ref["error"] \
                or res.final_state is not None:
            raise AssertionError(f"sharded replay of the {name} chain: "
                                 f"n_valid {res.n_valid}, {res.error!r}; "
                                 f"phase 5: {ref}")
        tampered[name] = {"n_valid": res.n_valid, "error": repr(res.error),
                          "windows_submitted": n_sub}
        log(f"sharded replay {name}: stopped at block {res.n_valid} as "
            f"phase 5 did ({res.error!r}); {n_sub} windows, all finished")

    # (b, c) phase 4's windows, sharded and unsharded
    def delta(before):
        return {k: v - before[k] for k, v in K.LAUNCHES.items()
                if v != before[k]}

    window_rows = {}
    for d in SHARD_COUNTS:
        # three backends as cold, each given every window in order: the
        # sharded one, one launch a kernel, and the folded one
        dmesh = make_mesh(devices=["cuda:0"] * d)
        sb, one, sf = (ShardedTorchBackend(dmesh) for _ in range(3))
        one._launch_lanes = functools.partial(TorchBackend._launch_lanes,
                                              one)
        rows = []
        for w, blocks in enumerate(windows):
            reqs = [r for b in blocks for r in b]
            nxt = ([r.proof for b in windows[w + 1] for r in b
                    if isinstance(r, VrfReq)] if w + 1 < len(windows) else [])
            packed = []
            for backend, per in ((sb, d), (one, 1)):
                before = dict(K.LAUNCHES)
                st = backend.submit_window(reqs, nxt)
                ok, _betas = backend.finish_window(st)
                want = {k: per for k, n in zip(MAIN_PATH, (
                    st["ne"], st["nv"], st["nb"], st["nk"])) if n}
                if delta(before) != want:
                    raise AssertionError(f"window {w} over {d} shards: "
                                         f"launches {delta(before)}, "
                                         f"expected {want}")
                packed.append(st["host"].numpy().tobytes())
            if packed[0] != packed[1]:
                raise AssertionError(f"window {w} over {d} shards: packed "
                                     f"buffer != one launch a kernel's")
            verdict, _b = sf.finish_window(sf.submit_window(reqs, nxt,
                                                            fold=True))
            first = main_runs[0]["windows"][w]["first_bad_request"]
            if verdict.first_bad != first or first != bad_req.get(w) or \
                    ok.count(False) and ok.index(False) != first:
                raise AssertionError(f"window {w} over {d} shards: first "
                                     f"bad {verdict.first_bad}, phase 4 "
                                     f"{first}, CPU reference "
                                     f"{bad_req.get(w)}")
            rows.append({"window": w, "lanes": {k: st[k] for k in
                                                ("ne", "nv", "nb", "nk")},
                         "first_bad_request": verdict.first_bad})
        if not any(r["lanes"]["nk"] for r in rows):
            raise AssertionError(f"phase 4's windows over {d} shards "
                                 f"carried no KES lanes")
        window_rows[str(d)] = {"rows": rows,
                               "padding": sb.padding_stats()}
        log(f"phase 4's {len(windows)} windows over {d} x cuda:0: packed "
            f"buffers (KES lanes too) == one launch a kernel's, each kernel "
            f"once a shard, "
            f"first bad requests == phase 4's; lanes "
            f"{[r['lanes'] for r in rows]}")

    # (d) the sharded full verify at phase 2's requests
    vks, msgs, sigs = ([getattr(x, f) for x in ed_f]
                       for f in ("vk", "msg", "sig"))
    K.reset_launches()
    got = sharded_batch_verify(vks, msgs, sigs, mesh)
    bv_launches = dict(K.LAUNCHES)
    want = K.batch_verify_ed25519(vks, msgs, sigs)
    if got != want or bv_launches != {**{k: 0 for k in K.KERNELS},
                                      "ed25519_verify": SHARDS}:
        raise AssertionError(f"sharded_batch_verify on {len(vks)} lanes != "
                             f"batch_verify_ed25519, or launches "
                             f"{bv_launches}")
    log(f"sharded_batch_verify: {len(vks)} lanes == batch_verify_ed25519 "
        f"({want.count(False)} rejected), ed25519_verify launched "
        f"{SHARDS} times")

    # (e) the port's multichip entry points
    buf = io.StringIO()
    with redirect_stdout(buf):
        obs, scaling = multichip.dryrun_multichip(
            SHARDS, devices=["cuda:0"] * SHARDS)
    log(buf.getvalue().rstrip())
    seconds = time.perf_counter() - t_phase
    log(f"sharded phase: {seconds:.3f} s")
    obs.pop("metrics")          # the full snapshot stays in the log line
    return {
        "mesh": [str(d) for d in mesh.devices], "blocks": len(chain),
        "window": WINDOW, "seconds": seconds,
        "blocks_per_s": [r["blocks_per_s"] for r in runs],
        "proofs_per_s": [r["proofs_per_s"] for r in runs],
        "run_seconds": [r["seconds"] for r in runs],
        "single_device_blocks_per_s": [r["blocks_per_s"] for r in singles],
        "single_device_proofs_per_s": [r["proofs_per_s"] for r in singles],
        "phase5_blocks_per_s": rp["blocks_per_s"],
        "phase5_proofs_per_s": rp["proofs_per_s"],
        "spans_s": [{k: sum(v) for k, v in r["spans"].items()}
                    for r in runs],
        "single_device_spans_s": [{k: sum(v) for k, v in r["spans"].items()}
                                  for r in singles],
        "launches": [r["launches"] for r in runs],
        "padding": [r["padding"] for r in runs],
        "tampered": tampered, "windows": window_rows,
        "batch_verify": {"lanes": len(vks), "launches": bv_launches},
        "multichip_obs": obs, "mesh_scaling": scaling, "card": card}


def replay_profiled(ext, chain) -> dict:
    """One more replay of the valid chain under torch.profiler, apart from
    the timed runs: the card's busy seconds and the kernels that took
    them.  It traces some hundred thousand kernels, whose records can
    reach a later trace, so it runs after every other profiled
    measurement."""
    from ouroboros_tpu_torch import device as D
    from ouroboros_tpu_torch import replay
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

    prof, busy_s, top = D.profiled(
        lambda: replay.replay_once(ext, chain, TorchBackend(), WINDOW), True)
    if prof["result"].n_valid != len(chain):
        raise AssertionError(f"profiled replay: n_valid "
                             f"{prof['result'].n_valid}")
    log(f"replay (profiled run): card busy {busy_s:.4f} s of "
        f"{prof['seconds']:.3f} s; by device ms: "
        + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top[:6]))
    return {"seconds": prof["seconds"], "device_busy_s": busy_s,
            "device_top": top}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ouroboros_tpu_torch import device as D
        from ouroboros_tpu_torch import (microbench_field, perf_probe, serve,
                                         validate, windowgen)
        from ouroboros_tpu_torch.crypto import (
            blake2b as B2, ed25519 as E, ed25519_ref, edwards as ed,
            field as F, kernels as K, vrf as V, vrf_ref)
        from ouroboros_tpu_torch.crypto.backend import (
            CpuRefBackend, Ed25519Req, VrfReq)
        from ouroboros_tpu_torch.crypto.torch_backend import (
            TorchBackend, fold_window)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import hashlib

    import numpy as np

    # -- 1. card and build -------------------------------------------------
    card = smi("name,power.limit")
    log("card:", card)
    t = time.perf_counter()
    K.library()
    log(f"build seconds: {time.perf_counter() - t:.3f}")
    for entry in K.BUILD_LOG:
        for line in entry.splitlines():
            if line.startswith("==") or "registers" in line or \
                    "stack frame" in line and "bytes spill" in line:
                log("  " + line.strip())
    dev = torch.device("cuda")
    mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = microbench_field.int_rate(dev, mhz)
    # Blake2b's adds, xors and rotations are simple operations, bounded
    # at the SM's issue rate as a chain's add is
    issue_rate = microbench_field.int_rate(dev, mhz, "add")

    # -- data ---------------------------------------------------------------
    workers = os.cpu_count() or 1
    t = time.perf_counter()
    windows = windowgen.make_windows(SEED, WINDOWS, WINDOW, POOLS, workers)
    log(f"data generation seconds: {time.perf_counter() - t:.3f} "
        f"({workers} workers, {WINDOWS} x {WINDOW} blocks)")

    # -- 2. kernels against their plain versions ----------------------------
    aux = TorchBackend()
    reqs0 = [r for b in windows[0] for r in b]
    (ed_reqs, _eo, vrf_reqs, _vo, kes_msgs, kes_exps, _kc,
     _n) = aux._split_mixed_device(reqs0)
    bad_R = next(y for y in range(2, 100)
                 if ed.decompress(y.to_bytes(32, "little")) is None)
    bad_pt = bad_R.to_bytes(32, "little")
    L_bytes = ed.L.to_bytes(32, "little")

    def edit(r, **kw):
        return type(r)(**{**r.__dict__, **kw})
    ed_t = list(ed_reqs)
    ed_t[1] = edit(ed_t[1], sig=ed_t[1].sig[:50] + bytes([ed_t[1].sig[50] ^ 4])
                   + ed_t[1].sig[51:])                     # flipped byte
    ed_t[2] = edit(ed_t[2], sig=ed_t[2].sig[:32] + L_bytes)   # s >= L
    ed_t[3] = edit(ed_t[3], sig=bad_pt + ed_t[3].sig[32:])    # R off curve
    vrf_t = list(vrf_reqs)
    vrf_t[1] = edit(vrf_t[1], alpha=b"wrong alpha")
    vrf_t[2] = edit(vrf_t[2], proof=bad_pt + vrf_t[2].proof[32:])
    vrf_t[3] = edit(vrf_t[3], proof=vrf_t[3].proof[:48] + L_bytes)
    beta_t = [r.proof for b in windows[1] for r in b if isinstance(r, VrfReq)]
    beta_t[1] = bad_pt + beta_t[1][32:]
    beta_t[2] = bytes([beta_t[2][0] ^ 1]) + beta_t[2][1:]
    kes_m, kes_e = list(kes_msgs), list(kes_exps)
    kes_m[1] = bytes(32) + kes_m[1][32:]                      # bad node
    kes_e[2] = kes_e[2][:31] + bytes([kes_e[2][31] ^ 1])   # last word
    kes_m[3] = bytes([kes_m[3][0] ^ 1]) + kes_m[3][1:]     # first word
    # the full verify decompresses A too: lanes the split kernel never sees
    rf = int.from_bytes(hashlib.sha256(b"forged").digest(), "little") % ed.L
    forged = ed.compress(ed.scalar_mult(rf, ed.BASE)) + \
        rf.to_bytes(32, "little")
    ed_f = list(ed_t)
    ed_f[4] = edit(ed_f[4], vk=bad_pt)                        # A off curve
    ed_f[5] = edit(ed_f[5], vk=(1 | 1 << 255).to_bytes(32, "little"),
                   sig=forged)              # y = 1, sign 1: x = 0, no A
    ed_f[6] = edit(ed_f[6], vk=(ed.P - 1).to_bytes(32, "little"))  # order 2
    ed_f[7] = edit(ed_f[7], vk=ed.P.to_bytes(32, "little"))   # y_A = p
    ed_f[8] = edit(ed_f[8], vk=(1).to_bytes(32, "little"),
                   sig=forged)              # the identity: (R, s = r) holds
    pad = aux._pad(len(ed_f)) - len(ed_f)
    full_arrays, full_parse = E.prepare_words_batch(
        [x.vk for x in ed_f] + [bytes(32)] * pad,
        [x.msg for x in ed_f] + [b""] * pad,
        [x.sig for x in ed_f] + [bytes(64)] * pad)

    ed_host, ed_ok = aux._prep_ed(ed_t, aux._pad(len(ed_t)))
    vrf_host, (v_ok, v_gok, v_sok, v_pf) = aux._prep_vrf(
        vrf_t, aux._pad(len(vrf_t)))
    beta_host, beta_dec = aux._prep_betas(beta_t, aux._pad(len(beta_t)))
    kes_host = aux._prep_kes_hash(kes_m, kes_e, aux._pad(len(kes_m)))
    with torch.cuda.stream(aux._stream):
        ed_args, vrf_args, beta_args, kes_args = (
            tuple(aux._dev(a) for a in host)
            for host in (ed_host, vrf_host, beta_host, kes_host))
    torch.cuda.synchronize()
    inputs = {"ed25519_split": ed_args, "vrf_verify": vrf_args,
              "gamma8": beta_args, "kes_hash": kes_args,
              "ed25519_verify": tuple(torch.from_numpy(a).to(dev)
                                      for a in full_arrays)}
    # the chain kernels at the JAX shape, the longer chain of mul and dbl
    chains = [name for name, _o, _k in microbench_field.CHAINS]
    ma, mb = microbench_field.inputs(CHAIN_LANES[0], dev)
    for name, ops, (_k1, k2) in microbench_field.CHAINS:
        inputs[name] = (ma, mb, ops[0], k2)
    lanes = {k: v[0].shape[-1] for k, v in inputs.items()}
    log("lanes (each path's widths):", lanes)
    wrappers = {name: getattr(K, name) for name in K.KERNELS}
    outputs, max_err = {}, {}
    for name, args in inputs.items():
        got = wrappers[name](*args)
        want = K.KERNELS[name].plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err[name] = err
        if tuple(got.shape) != tuple(want.shape) or err != 0:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        outputs[name] = got.cpu().numpy()
        log(f"{name}: kernel == plain version on {lanes[name]} lanes "
            f"(integer outputs, compared exactly: tolerance 0)")
    # the multi-thread kernels at a lane count no block size divides: the
    # first n - 3 lanes of the same inputs, tampered lanes included
    for name in RAGGED:
        n = lanes[name] - 3
        args = [a[..., :n].contiguous() for a in inputs[name]]
        got = wrappers[name](*args)
        want = K.KERNELS[name].plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        if tuple(got.shape) != tuple(want.shape) or err != 0 or \
                not np.array_equal(got.cpu().numpy(), outputs[name][:n]):
            raise AssertionError(f"{name}: kernel != plain version on the "
                                 f"first {n} lanes (max abs err {err})")
        log(f"{name}: kernel == plain version on the first {n} lanes "
            f"(tolerance 0)")
    # a sample of lanes against the CPU references
    ed_got = outputs["ed25519_split"]
    for j in list(range(32)):
        r = ed_t[j]
        ok = bool(ed_got[j]) and bool(ed_ok[j])
        if ok != ed25519_ref.verify(r.vk, r.msg, r.sig):
            raise AssertionError(f"ed25519_split lane {j} != ed25519_ref")
    full_got = outputs["ed25519_verify"]
    for j in range(32):
        r = ed_f[j]
        ok = bool(full_got[j]) and bool(full_parse[j])
        if ok != ed25519_ref.verify(r.vk, r.msg, r.sig):
            raise AssertionError(f"ed25519_verify lane {j} != ed25519_ref")
    if any(full_got[j] and full_parse[j] for j in range(1, 8)) \
            or not full_parse[5] or not full_got[8]:
        raise AssertionError("ed25519_verify: a tampered lane passed, or "
                             "the identity key's forgery failed")
    oks, betas = V._finish(outputs["vrf_verify"], v_ok, v_gok, v_sok, v_pf,
                           32)
    for j in range(32):
        r = vrf_t[j]
        if oks[j] != vrf_ref.verify(r.vk, r.alpha, r.proof):
            raise AssertionError(f"vrf_verify lane {j} != vrf_ref")
    g8 = V._finish_betas(outputs["gamma8"], beta_dec, 32)
    for j in range(32):
        try:
            want = vrf_ref.proof_to_hash(beta_t[j])
        except ValueError:
            want = None
        if g8[j] != want:
            raise AssertionError(f"gamma8 lane {j} != vrf_ref.proof_to_hash")
    kes_got = outputs["kes_hash"]
    for j, (m, e) in enumerate(zip(kes_m, kes_e)):
        if bool(kes_got[j]) != (hashlib.blake2b(m, digest_size=32).digest()
                                == e):
            raise AssertionError(f"kes_hash lane {j} != hashlib")
    if ed_got[1] or ed_ok[2] or ed_got[3] or oks[1] or oks[2] or oks[3] \
            or g8[1] is not None or any(kes_got[1:4]):
        raise AssertionError("a tampered lane passed")
    log(f"sample lanes == CPU references, all {len(kes_m)} KES jobs == "
        f"hashlib (tampered lanes rejected)")
    # kes_hash where the card is full: random jobs, lane j valid for
    # j % 4 == 0, else the digest's last word, the message's first word or
    # the digest's first word changed
    rng = np.random.default_rng(SEED)
    wm = rng.integers(0, 256, (KES_WIDE, 64), dtype=np.uint8)
    we = np.stack([np.frombuffer(hashlib.blake2b(
        m.tobytes(), digest_size=32).digest(), np.uint8) for m in wm])
    we[1::4, 31] ^= 0x80
    wm[2::4, 0] ^= 1
    we[3::4, 0] ^= 1
    kes_wide = (torch.from_numpy(B2.msg_words(wm)).to(dev),
                torch.from_numpy(B2.digest_words(we)).to(dev))
    got = K.kes_hash(*kes_wide)
    want = B2.check_block64(*kes_wide)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    max_err["kes_hash"] = max(max_err["kes_hash"], err)
    if err != 0 or got.cpu().tolist() != [int(j % 4 == 0)
                                          for j in range(KES_WIDE)]:
        raise AssertionError(f"kes_hash on {KES_WIDE} lanes: kernel != "
                             f"plain version or hashlib (max abs err {err})")
    log(f"kes_hash: kernel == plain version == hashlib on {KES_WIDE} "
        f"lanes (tolerance 0)")

    # -- 3. times and bounds --------------------------------------------------
    report = []
    for name, args in inputs.items():
        ms = D.event_ms(lambda: wrappers[name](*args))
        host_us = D.host_us(lambda: wrappers[name](*args))
        plain_ms = D.event_ms(lambda: K.KERNELS[name].plain(*args), reps=5)
        n = lanes[name]
        if name == "kes_hash":
            ops = n * B2.INT_OPS
        elif name in chains:
            ops = microbench_field.int_ops(args[2], args[3], n)
        else:
            one = [a[..., :1].cpu() for a in args]
            F.COUNTS.update(mul=0, sqr=0)
            K.KERNELS[name].plain(*one)
            ops = n * (100 * F.COUNTS["mul"] + 55 * F.COUNTS["sqr"])
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if torch.is_tensor(a)) + outputs[name].nbytes
        ops_ms = ops / (issue_rate if name == "kes_hash" else int_rate) \
            * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain = {"chain": f"{args[2]}, k = {args[3]}"} if name in chains \
            else {}
        report.append({
            "name": name, "route": "cuda", "source": K.KERNELS[name].source,
            "replaces": K.KERNELS[name].replaces,
            "threads_per_lane": K.KERNELS[name].threads_per_lane,
            "block": K.KERNELS[name].block, "launches": 0,
            "max_abs_err": max_err[name], "ms": ms, "host_us": host_us,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, **chain})
        log(f"{name}: {ms:.4f} ms kernel (events), {host_us:.2f} us host "
            f"a call, {plain_ms:.3f} ms plain, bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({ops} int ops, {nbytes} "
            f"bytes), {n} lanes"
            + (f" ({chain['chain']})" if chain else ""))
    packed = torch.cat([
        K.ed25519_split(*ed_args).to(torch.uint8),
        K.vrf_verify(*vrf_args).reshape(-1),
        K.gamma8(*beta_args).reshape(-1),
        K.kes_hash(*kes_args).to(torch.uint8)])
    ne, nv, nb, nk = (lanes[k] for k in MAIN_PATH)
    own = [torch.arange(n, dtype=torch.int32, device=dev) for n in (ne, nv)]
    gam = torch.from_numpy(np.ascontiguousarray(v_pf[:, :32])).to(dev)
    cb = torch.from_numpy(np.ascontiguousarray(v_pf[:, 32:48])).to(dev)
    fold_ms = D.event_ms(lambda: fold_window(packed, ne, nv, nb, nk, own[0],
                                          own[1], gam, cb), reps=5)
    wit = [r.vk for b in windows[0] for r in b[windowgen.FIRST_WITNESS:]]
    yw, sgn, _ok = E._decode_compressed(
        np.frombuffer(b"".join(wit), np.uint8).reshape(-1, 32))
    ya = F.limbs_from_words(torch.from_numpy(yw).to(dev))
    sg = torch.from_numpy(sgn).to(dev)
    fill_ms = D.event_ms(lambda: E.a128_core(ya, sg), reps=5)
    log(f"fold (torch ops, {ne}/{nv}/{nb}/{nk} lanes): {fold_ms:.3f} ms; "
        f"a128 fill (torch ops, {len(wit)} keys): {fill_ms:.3f} ms")

    # -- 4. the main path -----------------------------------------------------
    bad_req = {}
    for w, (b, fn, pos) in TAMPERS.items():
        windows[w][b] = getattr(windowgen, fn)(windows[w][b])
        bad_req[w] = b * windowgen.REQS_PER_BLOCK + getattr(windowgen, pos)
    runs = []
    for run in range(RUNS):
        backend = TorchBackend()
        K.reset_launches()
        cpu0 = time.process_time()
        res = validate.drive(windows, backend)
        res.update(launches=dict(K.LAUNCHES),
                   cpu_s=time.process_time() - cpu0)
        runs.append(res)
        log(f"run {run}: {res['blocks_per_s']:.1f} blocks/s, "
            f"{res['proofs_per_s']:.1f} proofs/s ({res['seconds']:.3f} s "
            f"wall, {res['cpu_s']:.3f} s process CPU), "
            f"launches {res['launches']}")
        for r in res["windows"]:
            want = bad_req.get(r["window"])
            if r["first_bad_request"] != want:
                raise AssertionError(
                    f"run {run} window {r['window']}: first bad request "
                    f"{r['first_bad_request']}, expected {want}")
        missing = [k for k in MAIN_PATH if res["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
    res = runs[0]
    launches = res["launches"]
    for r in res["windows"]:
        log(f"window {r['window']}: {r['blocks']} blocks, {r['requests']} "
            f"requests, first bad block {r['first_bad_block']} (request "
            f"{r['first_bad_request']}), submit {r['submit_s']:.4f} s, "
            f"wait {r['wait_s']:.4f} s")
    # the port's CPU oracle: every tampered block fails at exactly the
    # request the card reported, and a sample of each window passes
    cpu = CpuRefBackend()
    n_checked = 0
    for wi, blocks in enumerate(windows):
        tb = TAMPERS.get(wi, (None,))[0]
        picks = sorted({0, len(blocks) - 1,
                        *range(1, len(blocks), len(blocks) // SAMPLE)}
                       | ({tb} if tb is not None else set()))
        for bi in picks:
            ok = cpu.verify_mixed(blocks[bi])
            n_checked += 1
            fails = [bi * windowgen.REQS_PER_BLOCK + i
                     for i, o in enumerate(ok) if not o]
            if fails != ([bad_req[wi]] if bi == tb else []):
                raise AssertionError(f"CPU reference fails requests {fails} "
                                     f"of window {wi} block {bi}")
    proofs = [r.proof for wi in range(1, WINDOWS)
              for r in windows[wi][7] if isinstance(r, VrfReq)]
    proofs += [r.proof for r in windows[2][1000] if isinstance(r, VrfReq)]
    for run in runs:
        for p in proofs:
            if run["betas"].get(p) != vrf_ref.proof_to_hash(p):
                raise AssertionError("beta != vrf_ref.proof_to_hash")
    log(f"main path: {res['blocks_per_s']:.1f} blocks/s, "
        f"{res['proofs_per_s']:.1f} proofs/s over {WINDOWS} windows "
        f"({res['seconds']:.3f} s); first bad requests == CPU references "
        f"({n_checked} blocks checked), {len(proofs)} betas == vrf_ref "
        f"in each of {RUNS} runs")

    # -- 5. the Shelley replay ------------------------------------------------
    rp, replayed, tampered_chains = replay_phase(card)

    # -- 6. the disk replay ---------------------------------------------------
    dr = disk_phase(card, *replayed)

    # -- 7. the serve path ----------------------------------------------------
    sv = serve_phase(card, *replayed[:2], inputs, max_err)

    # -- 8. the multi-device path --------------------------------------------
    sh = sharded_phase(card, *replayed, tampered_chains, rp, windows,
                       bad_req, runs, ed_f)

    # -- 9. the standalone batch-verify path --------------------------------
    K.reset_launches()
    t = time.perf_counter()
    probe_rows = perf_probe.main(PROBE_ARGS)
    probe_launches = dict(K.LAUNCHES)
    log(f"perf_probe {' '.join(PROBE_ARGS)}: {time.perf_counter() - t:.3f} "
        f"s, launches {probe_launches}")
    missing = [k for k in PROBE_PATH if probe_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the probe's path: "
                             f"{missing}")

    # -- 10. the field microbenchmark path ----------------------------------
    # every (lanes, op, k) its runs launch, and the first n - 3 lanes of
    # each lane count, exactly against the plain versions; a sample of the
    # JAX shape's lanes against Python integers
    for n_all in CHAIN_LANES:
        a, b = microbench_field.inputs(n_all, dev)
        for name, ops, ks in microbench_field.CHAINS:
            for op in ops:
                for k in ks:
                    full = None
                    for n in (n_all, n_all - 3):
                        args = (a[:, :n].contiguous(), b[:, :n].contiguous(),
                                op, k)
                        got = wrappers[name](*args)
                        want = K.KERNELS[name].plain(*args)
                        torch.cuda.synchronize()
                        err = int((got.long() - want.long()).abs().max())
                        max_err[name] = max(max_err[name], err)
                        if tuple(got.shape) != tuple(want.shape) or \
                                err != 0 or (full is not None and not
                                             torch.equal(got, full[:, :n])):
                            raise AssertionError(
                                f"{name} {op}, k = {k}: kernel != plain "
                                f"version on {n} lanes (max abs err {err})")
                        full = got if full is None else full
                    if n_all != CHAIN_LANES[0]:
                        continue
                    ints = [chain_int(op, x, y, k, ed) for x, y in
                            zip(F.unpack(a[:, :CHAIN_SAMPLE]),
                                F.unpack(b[:, :CHAIN_SAMPLE]))]
                    if F.unpack(full[:, :CHAIN_SAMPLE]) != ints:
                        raise AssertionError(f"{name} {op}, k = {k}: lanes "
                                             f"!= Python integers (edwards.py "
                                             f"mod p)")
            log(f"{name}: kernel == plain version for {', '.join(ops)} at "
                f"k = {ks[0]} and {ks[1]} on {n_all} lanes and the first "
                f"{n_all - 3} (tolerance 0)"
                + (f"; {CHAIN_SAMPLE} lanes == Python integers"
                   if n_all == CHAIN_LANES[0] else ""))
    K.reset_launches()
    t = time.perf_counter()
    mb_runs = [microbench_field.main(argv) for argv in MB_RUNS]
    mb_launches = dict(K.LAUNCHES)
    log(f"microbench_field {' / '.join(' '.join(r) for r in MB_RUNS)}: "
        f"{time.perf_counter() - t:.3f} s, launches {mb_launches}")
    missing = [name for name, _o, _k in microbench_field.CHAINS
               if mb_launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the microbenchmark's "
                             f"path: {missing}")
    # every kernel's own device time, at the shapes of its row above
    for entry in report:
        name = entry["name"]
        args = inputs[name]
        entry["device_ms"], entry["device_ms_from"] = D.kernel_ms(
            lambda: wrappers[name](*args), f"{name}_kernel")
        log(f"{name}: {entry['device_ms']:.4f} ms device "
            f"({entry['device_ms_from']}), {entry['ms']:.4f} ms events")
    # the serve path's kernels at a flush's widths
    for entry in report:
        name = entry["name"]
        if name not in serve.SERVE_KERNELS:
            continue
        entry["serve_device_ms"], entry["serve_device_ms_from"] = {}, {}
        for n in SERVE_LANES:
            args = [a[..., :n].contiguous() for a in inputs[name]]
            ms, src = D.kernel_ms(lambda: wrappers[name](*args),
                                  f"{name}_kernel")
            entry["serve_device_ms"][str(n)] = ms
            entry["serve_device_ms_from"][str(n)] = src
        log(f"{name}: device ms at " + ", ".join(
            f"{n} lanes {ms:.4f}" for n, ms
            in entry["serve_device_ms"].items()))
    wide_ms, wide_from = D.kernel_ms(lambda: K.kes_hash(*kes_wide),
                                     "kes_hash_kernel")
    kes_entry = next(e for e in report if e["name"] == "kes_hash")
    kes_entry["wide"] = {
        "lanes": KES_WIDE, "device_ms": wide_ms, "device_ms_from": wide_from,
        "bound_ms": KES_WIDE * B2.INT_OPS / issue_rate * 1e3}
    log(f"kes_hash: {wide_ms:.4f} ms device ({wide_from}) on {KES_WIDE} "
        f"lanes, bound {kes_entry['wide']['bound_ms']:.4f} ms")
    # differenced per-operation times and the device column are the
    # kernels' own durations from clean traces, never CUDA events, which
    # hold host time
    not_dev = [f"{r['kernel']} {r['op']} at {r['lanes']} lanes"
               for run in mb_runs for r in run["ops"]
               if not from_profiler(r["time_from"])]
    not_dev += [r["name"] for r in mb_runs[0]["e2e"]
                if r["time_from"] != "host"
                and not from_profiler(r["time_from"])]
    not_dev += [e["name"] for e in report
                if not from_profiler(e["device_ms_from"])]
    not_dev += [f"{e['name']} at {n} lanes" for e in report
                for n, src in e.get("serve_device_ms_from", {}).items()
                if not from_profiler(src)]
    if not from_profiler(wide_from):
        not_dev.append(f"kes_hash at {KES_WIDE} lanes")
    if not_dev:
        raise AssertionError(f"device times not from the profiler: "
                             f"{not_dev}")
    rp["profiled"] = replay_profiled(*replayed[:2])

    # -- 11. report -----------------------------------------------------------
    serve_launches = sv["card"]["saturated"]["launches"]
    for entry in report:
        name = entry["name"]
        entry["max_abs_err"] = max_err[name]
        entry["serve_launches"] = serve_launches[name]
        entry["sharded_launches"] = (sh["batch_verify"]["launches"][name]
                                     if name == "ed25519_verify"
                                     else sh["launches"][0][name])
        if name in MAIN_PATH:
            entry["path"], entry["launches"] = "main", launches[name]
            entry["replay_launches"] = rp["launches"][0][name]
            entry["disk_replay_launches"] = dr["runs"][0]["launches"][name]
        elif name in PROBE_PATH:
            entry["path"] = "perf_probe --old"
            entry["launches"] = probe_launches[name]
        else:
            entry["path"] = "microbench_field --ops"
            entry["launches"] = mb_launches[name]
    print(json.dumps({"main_path": {
        "fold_ms": fold_ms, "a128_fill_ms": fill_ms,
        "blocks_per_s": [r["blocks_per_s"] for r in runs],
        "proofs_per_s": [r["proofs_per_s"] for r in runs],
        "seconds": [r["seconds"] for r in runs],
        "cpu_s": [r["cpu_s"] for r in runs],
        "submit_s": [r["submit_s"] for r in res["windows"]],
        "wait_s": [r["wait_s"] for r in res["windows"]]},
        "perf_probe": {name: row["per_s"]
                       for name, row in probe_rows.items()}}))
    print(json.dumps({"microbench_field": {
        "clock_max_sm_mhz": mb_runs[0]["clock_max_sm_mhz"],
        "ops": [r for run in mb_runs for r in run["ops"]],
        "e2e": mb_runs[0]["e2e"]}}))
    print(json.dumps({"replay": rp}))
    print(json.dumps({"disk_replay": dr}))
    print(json.dumps({"serve": sv}))
    print(json.dumps({"sharded": sh}))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
