#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ouroboros_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit.  Phases:

1. the card (name and power limit from nvidia-smi) and the build of the
   ten CUDA kernels from ouroboros_tpu_torch/csrc/;
2. each kernel against its plain PyTorch version on the card, at the
   main path's lane counts (Ed25519 4096, VRF 2048, betas 2048, KES jobs
   8192; the full Ed25519 verify on the same 4096 requests with A-side
   tampers added; the four chain kernels on the field microbenchmark's
   4096 lanes at the longer chain of mul and of dbl; the verdict fold,
   window_fold, over the four window kernels' packed buffer, its first
   failing request also against the host's) with tampered lanes,
   compared exactly; ed25519_split, vrf_verify, gamma8,
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
   the card idle at each call), the plain versions' times (the fold's is
   the torch-op fold), the per-key fill's time, and each kernel's bound:
   per-lane 32-bit integer multiply-adds counted from the plain version's
   field products (for the chains, k times microbench_field.OPS_PER_STEP),
   over the card's integer rate (kes_hash: blake2b.INT_OPS, the fewest
   simple 32-bit instructions a check needs, and window_fold: fold.INT_OPS
   a VRF lane, over the SM's issue rate), or its bytes over the memory
   rate, whichever is larger;
4. the main path: `validate.drive` over six 1024-block windows of 1024
   pools, two in flight with fold=True: windows 0-2 valid, window 3 with
   a flipped witness signature, window 4 with a VRF proof held against
   another input (only the device fold's challenge check sees it),
   window 5 with a bad KES Merkle node (a cold path in a KES-warm
   window).  Each window's first bad request must be the one the CPU
   references find, which also check a sample of every window and the
   betas; each of the four window kernels and the fold must have
   launched there.  The path runs three times back to back, each on a
   fresh backend, to show the spread of its rate beside the process's
   CPU seconds in each run;
5. the Shelley replay: a chain forged in memory (chainsynth.py: 2304
   blocks, 2 pools, f = 4/5, epoch length 600, two transactions a block,
   k = 2160, KES depth 6) replayed from genesis through
   `replay_blocks_pipelined` on a fresh TorchBackend at 1024-block
   windows (the producer's sequential header/ledger pass, fold=True, two
   windows in flight), three times with a cleared beta cache: every
   block valid and the final ledger state_hash the forger's; each of the
   four window kernels and the fold must launch in each run.  Then four
   tampered chains, each stopping at its block: a KES signature flipped
   at 1500 (the proof failure wins over the envelope break at 1501), a
   witness flipped before block 2100's header was forged (its proof),
   block 700 dropped (a sequential error), and a witness flipped after
   block 300 was forged (its proof; no body hash is checked, so the
   later windows stay valid and go in behind it), every window each run
   submitted finished; and 64 requests of each window of the valid
   chain (their sequential pass rerun on the host) with the tampered
   blocks' requests, verified on the card as the port's CpuRefBackend
   verifies them;
6. the disk replay: phase 5's chain written to disk by the port's
   db_synth (`write_chain`, chunks of 100 slots, in the native and the
   reference format; its config.json must be what the db_synth CLI
   writes for those arguments) and replayed from there by db_analyser's
   `analysis_validate` (`--validate full --backend torch --window 1024
   --read-ahead 4`: the prefetch thread reads and decodes chunks while
   earlier windows verify), three times from the native DB and once
   from the reference one, then once each at a read-ahead of 1 and 2
   windows, each to the forger's state_hash with a cleared beta cache,
   a fresh backend and each of the four window kernels and the fold
   launched; a run with snapshots every 600 slots, a resumed
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
9. the chain database (storage/chaindb.py), every run on a fresh
   TorchBackend with a cleared beta cache: phase 5's chain left on disk
   as a running ChainDB leaves it (blocks 0-143 in an ImmutableDB, the
   k = 2160 blocks 144-2303 in a VolatileDB) and restarted three times by
   `ChainDB.open` (the immutable replay, then the initial selection, which
   validates the 2160-block candidate in one `validate_blocks_batched`
   call, about 8,600 Ed25519 and 4,300 VRF lanes) to the forger's
   state_hash, each of the four window kernels launched; the same over
   phase 5's KES-flipped-at-1500 and witness-flipped-at-300 chains, the
   tip the block before the tampered one and the tip and invalid set a
   ChainDB over CppBackend's on a copy of the files (the witness flip
   keeps the block's hash, so every later block is invalid; the KES flip
   changes it, so the later blocks are orphans no candidate reaches and
   only the tampered one is invalid); the tip followed from block 2000,
   304 `add_block`s each `extended`, `copy_to_immutable` after each as
   the node's background does, their latency p50/p95/max, to the forger's
   state_hash; and forks under BFT (Byron mainnet's seven genesis
   delegates, k = 2160, one witnessed transaction a block): a 2400-block
   chain added in order, fork A (100 back, 101 long: `switched` at its
   last block with one 101-block validation), fork B (rooted 20 blocks
   below the immutable tip: stored, never adopted), fork C (50 back, 60
   long, its 30th header signed by another delegate: stored, never
   adopted, its candidate's blocks from the 30th invalid), every result,
   the tip, the chain and the invalid set equal to a ChainDB over
   CppBackend fed the same sequence, ed25519_split launched;
10. the node-to-node sync path (node/, network/): two NodeKernels in
   the port's simulator, wired by `connect_nodes` (0.05 s a link) with
   the Shelley codecs, both clocks a slot past the chain's tip.  A fresh
   follower on a new TorchBackend syncs phase 5's chain from a server
   over phase 9's layout (blocks 0-143 immutable, 144-2303 volatile),
   ChainSync's window 32, to the forger's state_hash, each of the four
   window kernels launched; a server of blocks 0-1500 of the
   KES-flipped chain, where the follower's ChainSync must raise
   ChainSyncClientError on the window that holds block 1500 (its ChainDB
   keeps what BlockFetch had adopted by then), and one of the
   witness-flipped-at-300 chain, where the follower's ChainDB must reject
   block 300 and stay at 299, each follower's tip, invalid set and error
   those of a follower on CppBackend; last a follower synced to block
   1999, then given a VerifyService (serve.py's config, the break-even
   table calibrated against CppBackend) while blocks 2000-2303 are added
   to the server one at a time: each header flushes alone through
   `validate_headers_coalesced`, to the forger's state_hash.  The bad
   peers' and the last follower run on the first one's backend, its key
   cache warm;
11. the diffusion slice (node/diffusion.py with the snockets, the
   subscription workers, the error policies and the node-to-client
   server; the chaos ThreadNet): under the real-clock IO runtime, every
   node's slots 2 ms long so that its clock stands past the chain's last
   slot once the servers are up, three server NodeKernels each holding
   phase 5's chain in an ImmutableDB behind `run_data_diffusion` on a
   loopback TCP port; a fresh follower at genesis on a new TorchBackend
   (ChainSync's window 32, the production watchdog limits, a mempool, a
   local address on a Unix socket) subscribes to all three and syncs to
   the forger's state_hash, each of the four window kernels launched,
   every block added once, no watchdog event, no suspension, no failed
   thread; a wallet on the local socket reads the tip and the state hash
   and submits 64 transactions and 8 with a flipped witness, each
   verdict CppBackend's, ed25519_split launched; a second fresh follower
   on the first's backend loses a server (its diffusion, kernel and
   connections stopped) once its tip passes block 1000 and reaches the
   state_hash from the other two, the lost peer suspended as
   `default_node_policies` judges its ending; then the reference's two
   chaos configurations (tests/test_chaos.py's `chaos_config(1)`,
   tests/test_netobs.py's `_fleet_config()`) in the simulator, each with
   every node on one fresh TorchBackend and again on CppBackend: equal
   fault events, chains and fleet reports, the tests' own checks on both,
   the four window kernels launched in each card run;
12. the protocols and tools (network/cddl.py, the TxSubmission2, Hello,
   LocalTxMonitor and TipSample protocols, graft_entry.py, ping.py,
   obsreport.py): the compile-probe entry's r3 verify form, 128 x True
   on its own batch, and on a second batch of the same key with eight
   lanes tampered `ed25519_ref`'s verdicts and the `ed25519_verify`
   kernel's, its time beside the kernel's; a Mempool over a fresh
   TorchBackend admitting 512 wallet transactions and rejecting 64 with
   a flipped witness (ed25519_split launched), CppBackend's verdicts,
   relayed over a Mux bearer pair by TxSubmission2 (Hello first) into a
   second card Mempool in the same order with CppBackend's verdicts,
   monitored by LocalTxMonitor byte for byte, and TipSample's tips from
   phase 11's follower's ChainDB, each on its chain; phase 11's server 0
   on a loopback TCP port, `python -m ouroboros_tpu_torch.ping` against
   it (exit 0, the version and five RTTs), a fresh follower on a card
   TorchBackend syncing the first 512 blocks through a bearer tap, the
   four window kernels launched, every Handshake, ChainSync, BlockFetch
   and TxSubmission message it carried matching the reference's grammar
   (`cddl.grammar`), none mismatched; the port's ScrapeServer scraped
   meanwhile; obsreport's renders of phase 11's fleet report, the scrape
   and phase 8's MULTICHIP_OBS line, each with its section headers; ~30
   s;
13. the reference's conformance surface (tests/test_real_header.py,
   test_external_conformance.py, test_cardano_threadnet.py and
   test_threadnet_scale.py), each run on a fresh TorchBackend: the golden
   Shelley header made by the real Cardano crypto stack (libsodium
   ECVRF, Sum6 KES, Ed25519; vendored below) parsed, re-encoded byte for
   byte and validated through `SC.validate_header`, the four window
   kernels launched; its OCert tiled to 4096 lanes of ed25519_split and
   ed25519_verify, its two VRF certificates to 2048 of vrf_verify, its
   KES path's Blake2b jobs to 8192 of kes_hash and the two libsodium
   proofs to 2048 of gamma8, every 7th lane tampered (another field each
   time), each kernel exactly its plain version, every lane the CPU
   references' verdict (ed25519_ref, vrf_ref, hashlib), every tampered
   lane rejected, every untampered beta the libsodium output,
   `batch_verify_ed25519` and `vrf.batch_betas` on the same lanes; the
   reference's Byron PBFT -> Shelley TPraos network (3 nodes, 10-slot
   epochs, the fork at epoch 2 by a ledger update proposal, seed 23) and
   its era ladder on to Allegra and Mary (seed 7), on the card and on
   CppBackend: per node the same block hashes, era tags and encoded
   final ExtLedgerState, the reference's checks on both, the four
   window kernels launched; the restart configuration (4 mock-Praos
   nodes, 60 slots, two restarts from their own files) and the rekeying
   cases (24 blocks across a mid-run rekey, a counter jump and a stale
   certificate each refused) the same on both; per leg the wall, the
   card calls' count and seconds, and the launches; ~35 s;
14. the port's bench, `bench.smoke(device="cuda")`
   (ouroboros_tpu_torch/bench.py, the reference's `bench.py --smoke`): an
   8-block chain forged by the port's db_synth and replayed on CppBackend
   and on a TorchBackend with a floor of 16 lanes to the same state_hash;
   the mixed-batch verdicts (every primitive, tampered) in fold and
   vector form equal CpuRefBackend's, and a warm probe that fills no key
   and runs no KES job; the VRF spread probe; the observation probes
   (registry snapshot, zero writes and spans when disabled, the scrape
   endpoint, the mux's disabled path); perfgate over BENCH_GPU_r*.json;
   the sharded replay on two shards of the card over a valid, a tampered
   and a truncated chain, equal to CppBackend's; `serve.sim_legs(7,
   0.5)`; the disk stream with snapshots and a resumed reopen.  Every
   gate of the smoke must pass, and each of the four window kernels must
   launch in it; ~30 s;
15. the standalone batch-verify path: `perf_probe --old` at 4096 Ed25519
   and 2048 VRF lanes (split and full Ed25519 verify, VRF verify, betas;
   each row asserts that every lane verifies), where ed25519_verify and
   the three kernels the probe drives must launch;
16. the field microbenchmark path: field_chain, field_chain_lp (mul and
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
17. a `main_path` JSON line, a `microbench_field` JSON line (the
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
   snapshot and MESH_SCALING, the card), a `chaindb` JSON line (per
   restart its seconds and blocks/s split into the immutable replay and
   the initial selection, the fill and submit seconds inside it, its
   validations and launches; the tampered restarts and CppBackend's
   seconds; the followed tip's add latencies, seconds and blocks/s; the
   forks' seconds per segment on both backends, validations and
   launches; the phase's launches; the card), a `node` JSON line (leg
   1's seconds, blocks/s, flush count, sizes and ms p50/p95/max, add ms,
   the wall split into header flushes, ChainDB adds and the rest, and
   launches; each bad peer's tip, invalid set, error, seconds and
   launches on both backends; leg 3's sync, adoption ms p50/p95/max, the
   service's device and CPU fallback batches, the break-even table and
   launches, the server's adds counted apart; the phase's launches, the
   followers' only; the card), a `diffusion` JSON line (leg 1's seconds,
   blocks/s, flushes, their sizes and ms p50/p95/max, add ms, the wall
   split into header flushes, ChainDB adds and the rest, the blocks
   fetched from each peer, each connection's mux bytes, the longest card
   call, and launches, beside phase 10's leg 1; the wallet's submission
   ms and launches; the lost peer's leg: seconds, fetched per peer
   before and after, the suspension and redials; each chaos
   configuration's seconds on both backends and launches; the phase's
   launches; the card), a `protocols` JSON line (the entry's prepare and
   call seconds, the r3 form's and ed25519_verify's ms on 128 lanes; the
   mempool leg's admitted, rejected, seconds on the card and on
   CppBackend, relayed, monitored and the sampled tips; the ping's
   result, the sync's seconds and block, the tap's SDUs and messages a
   protocol, the CDDL mismatches (0); the renders; the phase's launches;
   the card), a `conformance` JSON line (leg 1's lanes, tampered lanes
   and errors; each network's heads, era tags, seconds on both backends,
   card calls and their seconds; the restart and rekeying legs' the
   same; the phase's launches; the card), a `bench_smoke` JSON line
   (the smoke's result, its seconds and the phase's launches), a
   `kernels` JSON line (each
   kernel's launches are those of its path: the main path's, the
   probe's for ed25519_verify, the microbenchmark's for the chains, and
   for the four window kernels the replay's first run's as
   `replay_launches` and the first native disk replay's as
   `disk_replay_launches`; every kernel's launches in the serve path's
   saturated leg as `serve_launches`, and in the first sharded replay
   (for ed25519_verify, the sharded batch verify) as
   `sharded_launches`, in the chain database phase as
   `chaindb_launches`, in the node phase as `node_launches`, in the
   diffusion phase as `diffusion_launches`, in the protocols phase as
   `protocols_launches`, in the conformance phase's counted calls
   (not its comparisons) as `conformance_launches`, and in the bench's
   smoke as `bench_launches`; its
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
# the kernels each path must launch: a replay's windows the four window
# kernels and the fold; a window verified without the fold (ChainDB's
# validate_blocks_batched, a serve flush's verify_mixed) the four alone
MAIN_PATH = ("ed25519_split", "vrf_verify", "gamma8", "kes_hash",
             "window_fold")
UNFOLDED_PATH = MAIN_PATH[:4]
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
# the chain database: phase 5's chain left on disk as a running ChainDB
# leaves it, k = 2160 (mainnet's security parameter) in the VolatileDB
# and the rest in the ImmutableDB; restarted RESTART_RUNS times, then over
# two of phase 5's tampered chains against CppBackend; following the tip
# from block FOLLOW_FROM; forks under BFT with Byron mainnet's seven
# genesis delegates
CHAINDB_IMMUTABLE = REPLAY_BLOCKS - 2160
RESTART_RUNS = 3
RESTART_TAMPERED = ("kes_sig", "witness_post")
FOLLOW_FROM = 2000
BFT_NODES = 7
BFT_K = 2160
BFT_MAIN = 2400
# fork name -> (blocks back from the tip it branches at, length, the
# 1-based block signed by the wrong delegate or None); fork B is rooted
# BFT_DEEP blocks below the k-deep immutable tip
BFT_FORKS = {"A": (100, 101, None), "C": (50, 60, 30)}
BFT_B_LEN, BFT_DEEP = 30, 20
# the node-to-node sync path: two NodeKernels in the simulator, wired as
# ThreadNet wires them (0.05 s a link), both clocks a slot past the
# chain's tip; a run that has not finished by NODE_VIRTUAL_LIMIT_S
# virtual seconds fails
NODE_DELAY = 0.05
NODE_SLOT_S = 1.0
NODE_POLL_S = 0.05
NODE_VIRTUAL_LIMIT_S = 3600.0
# the diffusion slice under the real-clock IO runtime: DIFF_PEERS servers
# on loopback TCP; slots of DIFF_SLOT_S, so that the clock passes the
# chain's last slot (2,924) some 6 s after the runtime starts (at 1 s
# slots every block would be from the future); a sync that has not
# reached the tip in DIFF_LIMIT_S wall seconds fails
DIFF_PEERS = 3
DIFF_SLOT_S = 0.002
DIFF_POLL_S = 0.01
DIFF_LIMIT_S = 300.0
DIFF_LOSE_AT = 1000          # leg 3: a server stopped once the tip passes it
WALLET_VALID, WALLET_FLIPPED = 64, 8

# the protocols and tools phase (12)
PROTO_VALID, PROTO_FLIPPED = 512, 64   # leg 2's wallet transactions
PROTO_SYNC_BLOCKS = 512                # leg 3: the prefix synced over a tap
PING_COUNT = 5
TXSUBMISSION2_WINDOW = 10
LOCAL_TXMONITOR_NUM = 9                # node-to-client numbering
TIPSAMPLE_NUM = 10
PROTO_TX_OFFERED = 8                   # leg 3: the follower's mempool
TIP_REQUESTS = ((8, 0), (16, 1000), (4, 2500))   # (n, from slot)
PROTO_LIMIT_S = 120.0

# the conformance phase (13): the golden Shelley header of the reference's
# ouroboros-consensus-shelley-test/test/golden/ShelleyNodeToNodeVersion1/
# Header, made by the real Cardano crypto stack (libsodium ECVRF, Sum6 KES,
# Ed25519; tests/test_real_header.py vendors the same bytes), and its two
# VRF certificates' libsodium outputs (tests/test_external_conformance.py)
GOLDEN_HEADER_HEX = (
    "d8185903e4828f03095820bb30a42c1e62f0afda5f0a4e8a562f7a13a24cea00ee81917b"
    "86b89e801314aa58208a88e3dd7409f195fd52db2d3cba5d72ca6709bf1d94121bf37488"
    "01b40f6f5c58208a88e3dd7409f195fd52db2d3cba5d72ca6709bf1d94121bf3748801b4"
    "0f6f5c8258404fefc7c718693b57c87170ceba220382afbdd148c0a53b4a009ca63ad1f1"
    "01483a6170c83a77f23d362a68dcb502802df7f98fa4f7a78b4082b211530e1234305850"
    "f770f6769ae9871d42b970fc6254bb927c2181fff45897f241bd72221d86d33c8df64c0a"
    "3c8cbb9aa52fef191d7202465c52df8d33727a38c7dc5d40864d753348a340f8afcbb3bb"
    "05d4a03f16b1080d825840fe682775f0fa232e909ddc9ec3210ea7a0ee6514cd8b081519"
    "0a08f7cef3985463152e10dfad9ed6c09b641b6c1824498e77814a7c12e03096a63cd620"
    "56446358500951ed3ef2065e4196d008b50a63bb3e2bdc9a64df67eff4e230b35429291d"
    "ef476684114e074357a5c834bf79eacf583b6fe9fcd1d17f3719a31de97aa4da5e4630b0"
    "5421359e0b6e4a9bd76c6b920b1909295820e7151e54578da8534352744c8ae184da9383"
    "6aae349d81755199ef8cd91272fc5820d298da3803eb9958f01c02e73f2410f2f9bb2ecb"
    "c346526b1b76772e1bdd7db500005840940f8a3696847e4a238705bdd27a345086282067"
    "b9bc5cb7b69847ca8756085844d576f59ab056c169a504320cc1eab4c11fd529482b3c57"
    "da6fa96d44635b0802005901c09a407cf27c08d92c740f86d8463ad755ae4c7cbcc6c2ed"
    "4a2b845daf4b250e2e36323a14af6a58a4ec614943f661daace19fbf6371693140ef1794"
    "06fd0c9d00cc6a5ab5c9b40f817c715df558af7d07b6186f0ccf31715ec2fb00980730ac"
    "166af657e6670608afe1bf651d496e01b1c7ff1eb44614d8cfd1b7e32b2c2939349236cc"
    "0ada145d8d8d7ad919ef1e60c8bbad31dbedf9f395849705a00c14a8785106aae31f55ab"
    "c5b1f2089cbef16d9401f158704c1e4f740f7125cfc700a99d97d0332eacb33e4bbc8dab"
    "2872ec2b3df9e113addaebd156bfc64fdfc732614d2aedd10a58a34993b7b08c822af3aa"
    "615b6bbb9b267bc902e4f1075e194aed084ca18f8bcde1a6b094bf3f5295a0d454c0a083"
    "ed5b74f7092fc0a7346c03979a30eeea76d686e512ba48d21544ba874886cdd166cbf275"
    "b11f1f3881f4c4277c09a24b88fc6168f4578267bdc9d62cb9b78b8dfc888ccce226a177"
    "725f39e7d50930552861d1e88b7898971c780dc3b773321ba1854422b5cecead7d50e777"
    "83050eeae2cd9595b9cd91681c72e5d53bb7d12f28dec9b2847ee70a3d7781fb1133aea3"
    "b169f536ff5945ec0a76950e51beded0627bb78120617a2f0842e50e39")
NONCE_OUT = bytes.fromhex(
    "4fefc7c718693b57c87170ceba220382afbdd148c0a53b4a009ca63ad1f10148"
    "3a6170c83a77f23d362a68dcb502802df7f98fa4f7a78b4082b211530e123430")
LEADER_OUT = bytes.fromhex(
    "fe682775f0fa232e909ddc9ec3210ea7a0ee6514cd8b0815190a08f7cef39854"
    "63152e10dfad9ed6c09b641b6c1824498e77814a7c12e03096a63cd620564463")
NONCE_PROOF = bytes.fromhex(
    "f770f6769ae9871d42b970fc6254bb927c2181fff45897f241bd72221d86d33c"
    "8df64c0a3c8cbb9aa52fef191d7202465c52df8d33727a38c7dc5d40864d7533"
    "48a340f8afcbb3bb05d4a03f16b1080d")
LEADER_PROOF = bytes.fromhex(
    "0951ed3ef2065e4196d008b50a63bb3e2bdc9a64df67eff4e230b35429291def"
    "476684114e074357a5c834bf79eacf583b6fe9fcd1d17f3719a31de97aa4da5e"
    "4630b05421359e0b6e4a9bd76c6b920b")
GOLDEN_LANES = {"ed25519_split": 4096, "ed25519_verify": 4096,
                "vrf_verify": 2048, "gamma8": 2048, "kes_hash": 8192}
GOLDEN_TAMPER_EVERY = 7      # lane j is tampered where j % 7 == 6
# the reference's cross-era networks (tests/test_cardano_threadnet.py):
# 3 nodes, 10-slot epochs, Byron PBFT into Shelley TPraos at epoch 2
CARDANO_NET = {"fork": {"seed": 23, "run_s": 31.0, "ladder": False},
               "ladder": {"seed": 7, "run_s": 39.0, "ladder": True}}
CARDANO_NET_NODES, CARDANO_NET_EPOCH, CARDANO_NET_FORK = 3, 10, 2


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
            want = {k: single[k] * (SHARDS if sharded and k != "window_fold"
                                    else 1)
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
                want = {k: per for k, n in zip(UNFOLDED_PATH, (
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
        "multichip_obs": obs, "mesh_scaling": scaling, "card": card,
        "multichip_log": buf.getvalue()}


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _ms(xs):
    """p50, p95 and max of seconds `xs`, in ms (None for none)."""
    return {"p50": _pct(xs, 0.50) * 1e3, "p95": _pct(xs, 0.95) * 1e3,
            "max": max(xs) * 1e3} if xs else None


def chaindb_phase(card: str, ext, chain, want_hash: bytes,
                  chains: dict) -> dict:
    """Phase 9: the chain database on the card, every run on a fresh
    TorchBackend with a cleared beta cache.  Leg 1: phase 5's chain left
    on disk (blocks 0-143 in an ImmutableDB, the k = 2160 blocks 144-2303
    in a VolatileDB through put_block) and opened by ChainDB.open: the
    immutable replay, then the initial selection, which must validate the
    2160-block candidate in one validate_blocks_batched call to the
    forger's state_hash, each of the four window kernels launched; three
    times, then over phase 5's KES-flipped-at-1500 and
    witness-flipped-at-300 chains, each held to a ChainDB over CppBackend
    opened on a copy of the same files.  Leg 2: the VolatileDB holding
    blocks 144-1999, blocks 2000-2303 added one at a time (each
    `extended`, copy_to_immutable after each, as the node's background
    does) to the forger's state_hash.  Leg 3: a 2400-block BFT chain of
    seven delegates (k = 2160, MockLedger with one witnessed transaction
    a block) added in order, then fork A (a switch with one 101-block
    validation), fork B (rooted deeper than k: never adopted) and fork C
    (a wrong signature at its 30th block: never adopted, its candidate's
    blocks from there invalid), every result, tip, chain and invalid set
    equal to a ChainDB over CppBackend fed the same sequence.  Returns the
    `chaindb` line's dict; `launches` is the phase's own count."""
    import hashlib
    import shutil
    import tempfile

    from ouroboros_tpu_torch import chainsynth, replay
    from ouroboros_tpu_torch.chain import point_of
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       make_header)
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.consensus.protocols import Bft, bft_sign_header
    from ouroboros_tpu_torch.crypto import ed25519_ref
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.ledgers import (MockLedger, Tx, TxIn, TxOut,
                                             make_tx)
    from ouroboros_tpu_torch.storage import IoFS, chaindb as CDB
    from ouroboros_tpu_torch.storage.stream import (pickle_decode,
                                                    pickle_encode)
    from ouroboros_tpu_torch.utils import cbor

    class TimedChainDB(CDB.ChainDB):
        """ChainDB whose open records its initial selection's seconds."""

        def _initial_chain_selection(self):
            t = time.perf_counter()
            super()._initial_chain_selection()
            self.selection_s = time.perf_counter() - t

    # each candidate validation's block count, and the seconds inside
    # validate_blocks_batched (the rest of a selection is the ChainDB's
    # own: the successor walks that decode volatile blocks, the switch)
    calls: list = []
    validate_s = [0.0]
    real_validate = CDB.validate_blocks_batched

    def counted(ext_rules, blocks, st, backend=None):
        calls.append(len(blocks))
        t = time.perf_counter()
        try:
            return real_validate(ext_rules, blocks, st, backend=backend)
        finally:
            validate_s[0] += time.perf_counter() - t

    def pt(p):
        return (p.slot, p.hash.hex())

    t_phase = time.perf_counter()
    totals = {k: 0 for k in K.LAUNCHES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaindb_")
    CDB.validate_blocks_batched = counted
    try:
        def on_disk(name, blocks, n_imm, copy=False):
            d = os.path.join(tmp, name)
            chainsynth.write_chaindb(IoFS(d), blocks, n_imm)
            if copy:
                shutil.copytree(d, d + "-cpp")
            return d

        def restart(d, backend):
            """ChainDB.open on `d` with a cleared beta cache and the
            launches counted from 0: (db, its record)."""
            GLOBAL_BETA_CACHE.clear()
            K.reset_launches()
            del calls[:]
            validate_s[0] = 0.0
            db, seconds, spans = replay.recording(
                lambda: chainsynth.open_chaindb(IoFS(d), ext, backend,
                                                db_cls=TimedChainDB),
                ("window.submit", "precompute.fill", "window.fold"))
            launches = dict(K.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            return db, {
                "seconds": seconds, "selection_s": db.selection_s,
                "immutable_replay_s": seconds - db.selection_s,
                "validate_s": validate_s[0],
                "fill_s": sum(spans["precompute.fill"]),
                "submit_s": sum(spans["window.submit"]),
                "validate_calls": list(calls),
                "blocks_per_s": len(chain) / seconds,
                "selection_blocks_per_s": (len(chain) - CHAINDB_IMMUTABLE)
                / db.selection_s,
                "launches": launches}

        # -- leg 1: a restart with a full VolatileDB
        n_vol = len(chain) - CHAINDB_IMMUTABLE
        d = on_disk("restart", chain, CHAINDB_IMMUTABLE)
        runs = []
        for run in range(RESTART_RUNS):
            db, rec = restart(d, TorchBackend())
            missing = [k for k in UNFOLDED_PATH
                       if rec["launches"][k] == 0]
            if db.tip_point() != point_of(chain[-1]) or db.invalid or \
                    db.current_ledger.ledger.state_hash() != want_hash or \
                    rec["validate_calls"] != [n_vol] or missing:
                raise AssertionError(
                    f"chaindb restart {run}: tip {pt(db.tip_point())}, "
                    f"{len(db.invalid)} invalid, validations "
                    f"{rec['validate_calls']}, kernels not launched "
                    f"{missing}, or a state_hash not the forger's")
            runs.append(rec)
            log(f"chaindb restart {run}: {rec['seconds']:.3f} s "
                f"({rec['blocks_per_s']:.1f} blocks/s): immutable replay "
                f"of {CHAINDB_IMMUTABLE} blocks {rec['immutable_replay_s']:.3f}"
                f" s, initial selection {rec['selection_s']:.3f} s "
                f"({rec['selection_blocks_per_s']:.1f} blocks/s; one "
                f"{n_vol}-block validation {rec['validate_s']:.3f} s, its "
                f"submit {rec['submit_s']:.3f} s, fill {rec['fill_s']:.3f} "
                f"s); "
                f"tip block {len(chain) - 1}, state_hash == forger's; "
                f"launches {rec['launches']}")
        tampered = {}
        for name in RESTART_TAMPERED:
            blocks = chains[name]
            at = REPLAY_TAMPERS[name][0]
            d = on_disk(name, blocks, CHAINDB_IMMUTABLE, copy=True)
            db, rec = restart(d, TorchBackend())
            t = time.perf_counter()
            GLOBAL_BETA_CACHE.clear()
            ref = chainsynth.open_chaindb(IoFS(d + "-cpp"), ext, CppBackend())
            cpp_s = time.perf_counter() - t
            # the witness flip keeps block `at`'s hash, so every later
            # block is on the failed candidate; the KES flip changes it,
            # so the later blocks are orphans no candidate reaches
            bad = blocks[at:] if name == "witness_post" else [blocks[at]]
            if db.tip_point() != point_of(blocks[at - 1]) or \
                    set(db.invalid) != {b.hash for b in bad} or \
                    (pt(db.tip_point()), dict(db.invalid)) != \
                    (pt(ref.tip_point()), dict(ref.invalid)) or \
                    db.current_ledger.ledger.state_hash() != \
                    ref.current_ledger.ledger.state_hash():
                raise AssertionError(
                    f"chaindb restart over the {name} chain: tip "
                    f"{pt(db.tip_point())}, {len(db.invalid)} invalid; "
                    f"CppBackend's tip {pt(ref.tip_point())}, "
                    f"{len(ref.invalid)} invalid")
            rec.update(tip_block=at - 1, invalid=len(db.invalid),
                       cpp_seconds=cpp_s)
            tampered[name] = rec
            log(f"chaindb restart over the {name} chain: tip block "
                f"{at - 1}, {len(db.invalid)} invalid, == CppBackend's "
                f"(validations {rec['validate_calls']}); {rec['seconds']:.3f}"
                f" s, CppBackend {cpp_s:.3f} s; launches {rec['launches']}")

        # -- leg 2: following the tip
        d = on_disk("follow", chain[:FOLLOW_FROM], CHAINDB_IMMUTABLE)
        db, opened = restart(d, TorchBackend())
        if db.tip_point() != point_of(chain[FOLLOW_FROM - 1]):
            raise AssertionError(f"chaindb follow: opened at "
                                 f"{pt(db.tip_point())}")
        K.reset_launches()
        add_s, bg_s, copied = [], 0.0, 0
        t_leg = time.perf_counter()
        for b in chain[FOLLOW_FROM:]:
            t = time.perf_counter()
            r = db.add_block(b)
            add_s.append(time.perf_counter() - t)
            if r.kind != "extended":
                raise AssertionError(f"chaindb follow: block {b.block_no} "
                                     f"{r.kind}, expected extended")
            t = time.perf_counter()
            copied += db.copy_to_immutable()
            bg_s += time.perf_counter() - t
        leg_s = time.perf_counter() - t_leg
        follow_launches = dict(K.LAUNCHES)
        for k, v in follow_launches.items():
            totals[k] += v
        if db.tip_point() != point_of(chain[-1]) or \
                db.current_ledger.ledger.state_hash() != want_hash:
            raise AssertionError("chaindb follow: tip or state_hash not the "
                                 "forger's")
        n_add = len(chain) - FOLLOW_FROM
        follow = {
            "open": opened, "adds": n_add, "seconds": leg_s,
            "blocks_per_s": n_add / leg_s,
            "add_ms": {"p50": _pct(add_s, 0.50) * 1e3,
                       "p95": _pct(add_s, 0.95) * 1e3,
                       "max": max(add_s) * 1e3},
            "copy_to_immutable_s": bg_s, "copied": copied,
            "launches": follow_launches}
        log(f"chaindb follow: opened on blocks 0-{FOLLOW_FROM - 1} in "
            f"{opened['seconds']:.3f} s, then {n_add} adds, each extended, "
            f"in {leg_s:.3f} s ({follow['blocks_per_s']:.1f} blocks/s); add "
            f"ms p50 {follow['add_ms']['p50']:.3f}, p95 "
            f"{follow['add_ms']['p95']:.3f}, max {follow['add_ms']['max']:.3f}"
            f"; copy_to_immutable {bg_s:.3f} s ({copied} copied); "
            f"state_hash == forger's; launches {follow_launches}")

        # -- leg 3: forks under BFT
        t = time.perf_counter()
        sks = [hashlib.sha256(b"bft-delegate-%d" % i).digest()
               for i in range(BFT_NODES)]
        owner_sk = hashlib.sha256(b"bft-owner").digest()
        owner = ed25519_ref.public_key(owner_sk)
        bft = ExtLedgerRules(
            Bft([ed25519_ref.public_key(sk) for sk in sks], k=BFT_K),
            MockLedger({owner: 1000}))

        def branch(root, txid, n, slot0, bad_at=None):
            out = []
            for i in range(n):
                slot = slot0 + i
                tx = make_tx([TxIn(txid, 0)], [TxOut(owner, 1000)],
                             [owner_sk])
                leader = slot % BFT_NODES
                h = make_header(root.header if root else None, slot, (tx,),
                                issuer=leader)
                signer = (leader + 1) % BFT_NODES if i + 1 == bad_at \
                    else leader
                root, txid = ProtocolBlock(bft_sign_header(sks[signer], h),
                                           (tx,)), tx.txid
                out.append((root, txid))
            return out

        main = branch(None, MockLedger.GENESIS_TXID, BFT_MAIN, 0)
        back_a, len_a, _ = BFT_FORKS["A"]
        fork_a = branch(*main[-1 - back_a], len_a, BFT_MAIN)
        b_root = main[BFT_MAIN - BFT_K - BFT_DEEP]
        slot = BFT_MAIN + len_a
        fork_b = branch(*b_root, BFT_B_LEN, slot)
        back_c, len_c, bad_c = BFT_FORKS["C"]
        slot += BFT_B_LEN
        fork_c = branch(*fork_a[-1 - back_c], len_c, slot, bad_at=bad_c)
        forge_s = time.perf_counter() - t

        def bft_db(name, backend):
            return CDB.ChainDB.open(
                IoFS(os.path.join(tmp, name)), bft, pickle_encode,
                pickle_decode,
                lambda raw: ProtocolBlock.decode(cbor.loads(raw),
                                                 tx_decode=Tx.decode),
                backend=backend)

        dbs = {"torch": bft_db("bft", TorchBackend()),
               "cpp": bft_db("bft-cpp", CppBackend())}
        results = {"torch": [], "cpp": []}
        seconds, validations, switch_s = {}, {}, {}
        K.reset_launches()
        for seg, blocks in (("main", main), ("A", fork_a), ("B", fork_b),
                            ("C", fork_c)):
            for which, cdb in dbs.items():
                del calls[:]
                t = time.perf_counter()
                for b, _ in blocks:
                    t_add = time.perf_counter()
                    r = cdb.add_block(b)
                    last_add_s = time.perf_counter() - t_add
                    results[which].append((seg, r.kind, pt(r.new_tip)))
                    cdb.copy_to_immutable()
                seconds.setdefault(seg, {})[which] = time.perf_counter() - t
                validations.setdefault(seg, {})[which] = list(calls)
                if seg == "A":
                    switch_s[which] = last_add_s
            if seg == "main" and dbs["torch"].immutable_tip_point().slot \
                    < b_root[0].slot:
                raise AssertionError("chaindb forks: fork B's root is not "
                                     "below the immutable tip")
        bft_launches = dict(K.LAUNCHES)
        for k, v in bft_launches.items():
            totals[k] += v
        got = {which: (results[which], pt(cdb.tip_point()),
                       [pt(p) for p in cdb.current_chain.points()],
                       dict(cdb.invalid)) for which, cdb in dbs.items()}
        kinds = {seg: [k for s, k, _t in results["torch"] if s == seg]
                 for seg in ("main", "A", "B", "C")}
        db = dbs["torch"]
        bad_hash = fork_c[bad_c - 1][0].hash
        if got["torch"] != got["cpp"] or \
                validations["A"]["torch"] != [len_a] or \
                validations["C"]["torch"] != [back_c + 1] or \
                set(kinds["main"]) != {"extended"} or \
                kinds["A"] != ["stored"] * (len_a - 1) + ["switched"] or \
                set(kinds["B"]) != {"stored"} or \
                set(kinds["C"]) != {"stored"} or \
                db.tip_point() != point_of(fork_a[-1][0]) or \
                bad_hash not in db.invalid or \
                bft_launches["ed25519_split"] == 0:
            raise AssertionError(
                f"chaindb forks: results "
                f"{ {seg: sorted(set(k)) for seg, k in kinds.items()} }, "
                f"validations {validations}, tip {pt(db.tip_point())}, {len(db.invalid)} invalid, "
                f"== CppBackend's: {got['torch'] == got['cpp']}, "
                f"launches {bft_launches}")
        n_bft = sum(len(x) for x in (main, fork_a, fork_b, fork_c))
        forks = {
            "nodes": BFT_NODES, "k": BFT_K, "blocks": n_bft,
            "forge_s": forge_s, "seconds": seconds,
            "main_blocks_per_s": BFT_MAIN / seconds["main"]["torch"],
            "switch_add_s": switch_s,
            "validations": {seg: v["torch"] for seg, v in validations.items()
                            if seg != "main"},
            "invalid": len(db.invalid),
            "immutable_tip_slot": db.immutable_tip_point().slot,
            "launches": bft_launches}
        log(f"chaindb forks (BFT, {BFT_NODES} delegates, k = {BFT_K}): "
            f"{n_bft} blocks forged in {forge_s:.3f} s; main chain of "
            f"{BFT_MAIN} adds {seconds['main']['torch']:.3f} s "
            f"({forks['main_blocks_per_s']:.1f} blocks/s; CppBackend "
            f"{seconds['main']['cpp']:.3f} s); fork A switched at its "
            f"{len_a}th block in {switch_s['torch'] * 1e3:.3f} ms "
            f"(CppBackend {switch_s['cpp'] * 1e3:.3f} ms; "
            f"{seconds['A']['torch']:.3f} s for its {len_a} adds), fork B "
            f"stored, fork C stored with "
            f"{len(db.invalid)} invalid; every result, the tip, the chain "
            f"and the invalid set == CppBackend's; launches {bft_launches}")
    finally:
        CDB.validate_blocks_batched = real_validate
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"chaindb phase: {phase_s:.3f} s")
    return {
        "seconds": phase_s,
        "restart": {"blocks": len(chain), "immutable": CHAINDB_IMMUTABLE,
                    "volatile": n_vol, "runs": runs, "tampered": tampered},
        "follow": follow, "forks": forks, "launches": totals, "card": card}


def _thread_failures(*kernels) -> list:
    """(node, thread, exception) of every finished thread of `kernels`
    that raised; a cancelled thread is no failure."""
    from ouroboros_tpu_torch import simharness as sim
    out = []
    for k in kernels:
        for t in k._threads:
            if not t.done:
                continue
            try:
                t.poll()
            except sim.AsyncCancelled:
                pass
            except BaseException as e:
                out.append((k.label, t.label, e))
    return out


def node_phase(card: str, ext, chain, want_hash: bytes,
               chains: dict) -> dict:
    """Phase 10: the node-to-node sync path (node/, network/) on the
    card.  Two NodeKernels in the port's simulator, wired by
    `connect_nodes(follower, server, delay=NODE_DELAY)` (the handshake,
    then ChainSync, BlockFetch and KeepAlive over one mux bearer each
    way), the blocks carried as CBOR by the Shelley decoders
    (`ProtocolHeader.decode`, `ProtocolBlock.decode` with
    `ShelleyTx.decode`).  Both clocks stand past the chain's tip: the
    simulation sleeps until the slot after the chain's last before the
    kernels start, so no block is from the future (the future-block rule
    is unchanged).  A card call takes no virtual time: every time here
    is wall time.

    Leg 1: a server over phase 9's layout (blocks 0-143 immutable, the
    k = 2160 blocks 144-2303 volatile, opened on its own backend first)
    and a fresh follower at genesis on a new backend with a cleared beta
    cache, `chain_sync_window` the kernel's 32, run until the tips are
    equal: the follower's ledger at the forger's state_hash, each of the
    four window kernels launched.  Leg 2: a server whose ImmutableDB
    holds a tampered chain (ChainDB.open replays immutable blocks without
    crypto, so it serves it): blocks 0-1500 of the KES-flipped chain,
    where the follower's ChainSync must raise ChainSyncClientError on the
    window that holds block 1500; and the witness-flipped-at-300 chain,
    whose headers are valid, where the follower's ChainDB must reject
    block 300 and stay at 299.  Each follower runs on the card's backend
    and again on CppBackend over the same server; the two agree on the
    tip, the invalid set and the error.  Leg 3: a server over blocks
    0-1999, the follower synced to its tip, then a VerifyService over
    the follower's backend (serve.py's card legs' config, the break-even
    table calibrated first against CppBackend) set as its
    `verify_service`, and blocks 2000-2303 added to the server's ChainDB
    one at a time, each after the chain's own slot gap in virtual time:
    each header reaches the follower after MsgAwaitReply and flushes
    alone through `validate_headers_coalesced`; the follower ends at the
    forger's state_hash.  Legs 2 and 3 run on leg 1's follower backend,
    its key cache warm with the chain's KES keys (a node that has synced
    once), and every server on one backend of its own; each follower
    starts with a cleared beta cache.  Returns the `node` line's dict;
    `launches` is the phase's own count (the followers' only: leg 3's
    server adds are counted apart)."""
    from ouroboros_tpu_torch import chainsynth, serve
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.chain import point_of
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    from ouroboros_tpu_torch.crypto import batching
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.node import (BlockchainTime,
                                          ChainSyncClientError, NodeKernel,
                                          connect_nodes)
    from ouroboros_tpu_torch.node import chain_sync as CS
    from ouroboros_tpu_torch.observe import metrics
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.utils.tracer import NodeTracers, Tracer

    kes_at = REPLAY_TAMPERS["kes_sig"][0]
    wit_at = REPLAY_TAMPERS["witness_post"][0]
    n_imm, n_sync = CHAINDB_IMMUTABLE, FOLLOW_FROM

    def block_obj(obj):
        return ProtocolBlock.decode(obj, tx_decode=ShelleyTx.decode)

    def kernel(db, label, backend, tracers=None):
        return NodeKernel(db, ext.ledger, None, BlockchainTime(NODE_SLOT_S),
                          label=label, backend=backend,
                          header_decode=ProtocolHeader.decode,
                          block_decode_obj=block_obj,
                          tx_decode=ShelleyTx.decode, tracers=tracers)

    def open_db(blocks, n_immutable, backend):
        fs = MockFS()
        chainsynth.write_chaindb(fs, blocks, n_immutable)
        return chainsynth.open_chaindb(fs, ext, backend)

    def pt(p):
        return (p.slot, p.hash.hex())

    # the header flushes and the follower's adds, timed where they run
    flushes: list = []                  # (headers, seconds) a direct flush
    coalesced: list = []                # headers a flush through the service
    real_batched = CS.validate_headers_batched
    real_coalesced = batching.validate_headers_coalesced

    def timed_batched(protocol, headers, *a, **kw):
        t = time.perf_counter()
        try:
            return real_batched(protocol, headers, *a, **kw)
        finally:
            flushes.append((len(headers), time.perf_counter() - t))

    async def counted_coalesced(protocol, headers, *a, **kw):
        coalesced.append(len(headers))
        return await real_coalesced(protocol, headers, *a, **kw)

    flush_hist = metrics.registry().get("chainsync.flush_headers")

    def run_pair(sdb, fdb, fbackend, done, script=None):
        """One sim.run: the server's and the follower's kernels, started
        once the clock stands past the chain's tip and wired; `script`
        (if any) runs first, then the run polls `done(server, follower)`
        every NODE_POLL_S virtual seconds.  Returns the run's record:
        wall and virtual seconds, the follower's add seconds and
        ChainSync window, every thread failure, the flush histogram's
        delta."""
        rec = {"add_s": [], "validated": []}
        del flushes[:], coalesced[:]
        h0 = flush_hist.snapshot_value()

        async def main():
            await sim.sleep((chain[-1].slot + 1) * NODE_SLOT_S - sim.now())
            server = kernel(sdb, "server", sdb.backend)
            follower = kernel(fdb, "follower", fbackend, NodeTracers(
                chain_sync=Tracer(rec["validated"].append)))
            real_add = fdb.add_block

            def timed_add(block):
                t = time.perf_counter()
                try:
                    return real_add(block)
                finally:
                    rec["add_s"].append(time.perf_counter() - t)
            fdb.add_block = timed_add
            server.start()
            follower.start()
            rec["window"] = follower.chain_sync_window
            rec["t0"], v0 = time.perf_counter(), sim.now()
            connect_nodes(follower, server, delay=NODE_DELAY)
            try:
                if script is not None:
                    await script(server, follower, rec)
                while not done(server, follower):
                    if sim.now() - v0 > NODE_VIRTUAL_LIMIT_S:
                        raise AssertionError(
                            f"node: follower at {pt(fdb.tip_point())} after "
                            f"{NODE_VIRTUAL_LIMIT_S} virtual s; failures "
                            f"{_thread_failures(server, follower)}")
                    await sim.sleep(NODE_POLL_S)
                rec.update(wall_s=time.perf_counter() - rec["t0"],
                           virtual_s=sim.now() - v0,
                           failures=_thread_failures(server, follower))
            finally:
                del fdb.add_block
                server.stop()
                follower.stop()

        CS.validate_headers_batched = timed_batched
        batching.validate_headers_coalesced = counted_coalesced
        try:
            sim.run(main(), seed=SEED)
        finally:
            CS.validate_headers_batched = real_batched
            batching.validate_headers_coalesced = real_coalesced
        h1 = flush_hist.snapshot_value()
        rec["flush_headers_hist"] = {
            "count": h1["count"] - h0["count"],
            "buckets": {e: c - h0["buckets"].get(e, 0)
                        for e, c in h1["buckets"].items()
                        if c - h0["buckets"].get(e, 0)}}
        rec["flushes"] = list(flushes)
        rec["coalesced"] = list(coalesced)
        return rec

    def follower_db(backend):
        GLOBAL_BETA_CACHE.clear()
        return open_db([], 0, backend)

    def synced(server, follower):
        return follower.chain_db.tip_point() == server.chain_db.tip_point()

    def expect_failures(rec, allowed):
        """Every thread failure must be one `allowed` names: (node,
        thread label, exception type, a fragment of its message)."""
        bad = [f for f in rec["failures"]
               if not any(f[0] == n and f[1] == lab and isinstance(f[2], ty)
                          and frag in str(f[2])
                          for n, lab, ty, frag in allowed)]
        if bad:
            raise AssertionError(f"node: unexpected thread failures {bad}")

    # the server's own ChainSync client, wired by connect_nodes in the
    # other direction, finds no intersection with a follower at genesis
    # and ends: the one failure every run has
    no_isect = ("server", "server->follower.connect-i",
                ChainSyncClientError, "no intersection")
    t_phase = time.perf_counter()
    totals = {k: 0 for k in K.LAUNCHES}

    def count(launches):
        for k, v in launches.items():
            totals[k] += v

    # -- leg 1: sync from genesis
    server_backend = TorchBackend()
    t = time.perf_counter()
    sdb = open_db(chain, n_imm, server_backend)
    open_s = time.perf_counter() - t
    if sdb.tip_point() != point_of(chain[-1]):
        raise AssertionError(f"node: server opened at {pt(sdb.tip_point())}")
    fbackend = TorchBackend()
    fdb = follower_db(fbackend)
    K.reset_launches()
    rec = run_pair(sdb, fdb, fbackend, synced)
    launches = dict(K.LAUNCHES)
    count(launches)
    expect_failures(rec, [no_isect])
    missing = [k for k in UNFOLDED_PATH if launches[k] == 0]
    if fdb.tip_point() != point_of(chain[-1]) or fdb.invalid or \
            fdb.current_ledger.ledger.state_hash() != want_hash or missing:
        raise AssertionError(
            f"node leg 1: follower at {pt(fdb.tip_point())}, "
            f"{len(fdb.invalid)} invalid, kernels not launched {missing}, "
            f"or a state_hash not the forger's")
    flush_total = sum(s for _n, s in rec["flushes"])
    add_total = sum(rec["add_s"])
    sync = {
        "blocks": len(chain), "server_immutable": n_imm,
        "server_open_s": open_s, "seconds": rec["wall_s"],
        "virtual_s": rec["virtual_s"],
        "blocks_per_s": len(chain) / rec["wall_s"],
        "flushes": len(rec["flushes"]),
        "flush_sizes": [n for n, _s in rec["flushes"]],
        "flush_headers_hist": rec["flush_headers_hist"],
        "flush_ms": _ms([s for _n, s in rec["flushes"]]),
        "adds": len(rec["add_s"]), "add_ms": _ms(rec["add_s"]),
        "split_s": {"header_flushes": flush_total, "chaindb_adds": add_total,
                    "rest": rec["wall_s"] - flush_total - add_total},
        "launches": launches}
    log(f"node leg 1: {len(chain)} blocks synced from genesis in "
        f"{rec['wall_s']:.3f} s ({sync['blocks_per_s']:.1f} blocks/s; "
        f"{rec['virtual_s']:.2f} virtual s), state_hash == forger's; "
        f"{sync['flushes']} ChainSync flushes (sizes "
        f"{sorted(set(sync['flush_sizes']))}), ms a flush p50 "
        f"{sync['flush_ms']['p50']:.3f} p95 {sync['flush_ms']['p95']:.3f} "
        f"max {sync['flush_ms']['max']:.3f}; wall split: header flushes "
        f"{flush_total:.3f} s, {sync['adds']} ChainDB adds {add_total:.3f} "
        f"s, the rest {sync['split_s']['rest']:.3f} s; server opened in "
        f"{open_s:.3f} s; launches {launches}")

    # -- leg 2: a bad peer, on the card's backend and on CppBackend
    def bad_peer(name, blocks, done, allowed):
        t = time.perf_counter()
        sdb = open_db(blocks, len(blocks), server_backend)
        open_s = time.perf_counter() - t
        if sdb.tip_point() != point_of(blocks[-1]):
            raise AssertionError(f"node leg 2 {name}: server opened at "
                                 f"{pt(sdb.tip_point())}")
        got = {}
        for which, be in (("card", fbackend), ("cpp", CppBackend())):
            fdb = follower_db(be)
            K.reset_launches()
            rec = run_pair(sdb, fdb, be, done)
            launches = dict(K.LAUNCHES)
            if which == "card":
                count(launches)
            expect_failures(rec, allowed)
            kills = [f[2] for f in rec["failures"]
                     if f[0] == "follower"]
            got[which] = {
                "tip": pt(fdb.tip_point()),
                "tip_block": fdb.current_chain.head_block_no,
                "invalid": sorted(h.hex() for h in fdb.invalid),
                "error": [f"{type(e).__name__}: {e}" for e in kills],
                "validated_to_slot": rec["validated"][-1].slot
                if rec["validated"] else None,
                "seconds": rec["wall_s"], "virtual_s": rec["virtual_s"],
                "flushes": len(rec["flushes"]),
                "adds": len(rec["add_s"]), "launches": launches,
                "state_hash": fdb.current_ledger.ledger.state_hash().hex()}
        same = all(got["card"][k] == got["cpp"][k]
                   for k in ("tip", "invalid", "error", "state_hash"))
        if not same:
            raise AssertionError(f"node leg 2 {name}: the card's follower "
                                 f"{got['card']} != CppBackend's "
                                 f"{got['cpp']}")
        return {"server_blocks": len(blocks), "server_open_s": open_s,
                **got}

    kes_chain = chains["kes_sig"][:kes_at + 1]
    leg2 = {}
    leg2["kes_sig"] = bad_peer(
        "kes_sig", kes_chain,
        lambda s, f: any(t.label == "follower->server.connect-i" and t.done
                         for t in f._threads) and not f.chain_db._add_queue,
        [no_isect, ("follower", "follower->server.connect-i",
                    ChainSyncClientError, "invalid header from peer")])
    r = leg2["kes_sig"]["card"]
    if len(r["error"]) != 1 or "invalid header" not in r["error"][0] or \
            r["tip_block"] > kes_at - 1 or \
            r["validated_to_slot"] != chain[kes_at - 1].slot:
        raise AssertionError(f"node leg 2 kes_sig: {r}")
    wit_chain = chains["witness_post"]
    leg2["witness_post"] = bad_peer(
        "witness_post", wit_chain,
        lambda s, f: not f.chain_db._add_queue and all(
            f.have_block(b.hash) for b in wit_chain[-1:]),
        [no_isect])
    r = leg2["witness_post"]["card"]
    if r["tip_block"] != wit_at - 1 or r["error"] or \
            wit_chain[wit_at].hash.hex() not in r["invalid"] or \
            r["tip"] != pt(point_of(wit_chain[wit_at - 1])):
        raise AssertionError(f"node leg 2 witness_post: {r}")
    for name, r in leg2.items():
        log(f"node leg 2 {name}: server of {r['server_blocks']} immutable "
            f"blocks opened in {r['server_open_s']:.3f} s; follower tip "
            f"block {r['card']['tip_block']}, {len(r['card']['invalid'])} "
            f"invalid, errors {r['card']['error']}; == CppBackend's; "
            f"{r['card']['seconds']:.3f} s, CppBackend "
            f"{r['cpp']['seconds']:.3f} s; launches {r['card']['launches']}")

    # -- leg 3: caught up, the coalesced path
    sdb = open_db(chain[:n_sync], n_imm, server_backend)
    cpu = CppBackend()
    t = time.perf_counter()
    break_even = batching.calibrate_break_even(
        fbackend, cpu, fbackend.device_kind, bucket=serve.CALIBRATION_BUCKET,
        persist=False)
    cal_s = time.perf_counter() - t
    fdb = follower_db(fbackend)
    adopted: list = []          # (wall, the follower's tip block) a change
    fdb.on_change(lambda: adopted.append(
        (time.perf_counter(), fdb.current_chain.head_block_no)))
    leg3 = {"server_blocks": n_sync, "server_adds": len(chain) - n_sync,
            "calibration_s": cal_s, "break_even": break_even.snapshot()}
    server_launches = {k: 0 for k in K.LAUNCHES}

    async def follow_tip(server, follower, rec):
        while not synced(server, follower):
            await sim.sleep(NODE_POLL_S)
        rec["sync_s"] = time.perf_counter() - rec["t0"]
        rec["sync_launches"] = dict(K.LAUNCHES)
        rec["sync_flushes"] = len(flushes)
        rec["sync_adds"] = len(rec["add_s"])
        K.reset_launches()
        svc = serve._service(fbackend, cpu, break_even,
                             serve.SATURATED_CONFIG)
        await svc.start()
        follower.verify_service = svc
        rec["added_at"] = {}
        prev = chain[n_sync - 1]
        for b in chain[n_sync:]:
            await sim.sleep((b.slot - prev.slot) * NODE_SLOT_S)
            prev = b
            before = dict(K.LAUNCHES)
            rec["added_at"][b.block_no] = time.perf_counter()
            r = server.chain_db.add_block(b)
            for k, v in K.LAUNCHES.items():
                server_launches[k] += v - before[k]
            if r.kind != "extended":
                raise AssertionError(f"node leg 3: the server's add of block "
                                     f"{b.block_no} {r.kind}")
        while not synced(server, follower):
            await sim.sleep(NODE_POLL_S)
        await svc.stop()
        rec["service"] = dict(svc.stats)
        rec["batch_sizes"] = dict(svc.batch_sizes)

    K.reset_launches()
    rec = run_pair(sdb, fdb, fbackend, synced, follow_tip)
    follow_launches = {k: v - server_launches[k]
                       for k, v in K.LAUNCHES.items()}
    count(rec["sync_launches"])
    count(follow_launches)
    expect_failures(rec, [no_isect])
    svc = rec["service"]
    n_add = len(chain) - n_sync
    if fdb.tip_point() != point_of(chain[-1]) or fdb.invalid or \
            fdb.current_ledger.ledger.state_hash() != want_hash or \
            sum(rec["coalesced"]) < n_add or svc["flushes"] == 0:
        raise AssertionError(
            f"node leg 3: follower at {pt(fdb.tip_point())}, "
            f"{len(fdb.invalid)} invalid, coalesced flushes "
            f"{rec['coalesced']}, service {svc}, or a state_hash not the "
            f"forger's")
    # an add's latency: to the first chain change that put the
    # follower's tip at or past the added block
    lat = [next(w for w, bn in adopted if bn >= block_no) - t
           for block_no, t in rec["added_at"].items()]
    leg3.update(
        sync_s=rec["sync_s"], sync_flushes=rec["sync_flushes"],
        sync_launches=rec["sync_launches"],
        seconds=rec["wall_s"] - rec["sync_s"],
        adoption_ms=_ms(lat), coalesced_flushes=len(rec["coalesced"]),
        coalesced_sizes=sorted(set(rec["coalesced"])),
        direct_flushes_caught_up=len(rec["flushes"]) - rec["sync_flushes"],
        service=svc, batch_sizes={str(k): v for k, v
                                  in sorted(rec["batch_sizes"].items())},
        follower_adds=len(rec["add_s"]) - rec["sync_adds"],
        follower_add_ms=_ms(rec["add_s"][rec["sync_adds"]:]),
        launches=follow_launches,
        server_launches=server_launches)
    log(f"node leg 3: synced to block {n_sync - 1} in {rec['sync_s']:.3f} s "
        f"({rec['sync_flushes']} flushes), then {n_add} blocks added to the "
        f"server one at a time: adoption ms p50 "
        f"{leg3['adoption_ms']['p50']:.3f}, p95 "
        f"{leg3['adoption_ms']['p95']:.3f}, max "
        f"{leg3['adoption_ms']['max']:.3f}; {len(rec['coalesced'])} flushes "
        f"through validate_headers_coalesced (sizes "
        f"{leg3['coalesced_sizes']}); the service's {svc['flushes']} "
        f"flushes: {svc['device_batches']} device batches, "
        f"{svc['fallback_batches']} CPU fallback batches; state_hash == "
        f"forger's; launches {follow_launches} (the server's adds "
        f"{server_launches})")
    phase_s = time.perf_counter() - t_phase
    log(f"node phase: {phase_s:.3f} s")
    return {"seconds": phase_s, "delay_s": NODE_DELAY,
            "slot_length_s": NODE_SLOT_S, "window": rec["window"],
            "clock": "slot after the chain's tip at start",
            "codecs": "ProtocolHeader.decode, ProtocolBlock.decode with "
                      "ShelleyTx.decode",
            "sync": sync, "bad_peer": leg2, "caught_up": leg3,
            "launches": totals, "card": card}


def _chaos_configs() -> dict:
    """The reference's two chaos configurations, exactly as its tests
    define them, from the port's classes: `chaos_config(1)`
    (tests/test_chaos.py:40-56: 3 nodes in a mesh, 30 slots, drops,
    stalls, disconnects and one partition) and `_fleet_config()`
    (tests/test_netobs.py:276-284: 10 nodes in a ring, a partition into
    halves)."""
    from ouroboros_tpu_torch.simharness import FaultSpec, Partition
    from ouroboros_tpu_torch.testing import ChaosConfig, ThreadNetConfig
    half = tuple(f"node{i}" for i in range(5))
    other = tuple(f"node{i}" for i in range(5, 10))
    return {
        "chaos_config(1)": ChaosConfig(
            net=ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.5, seed=1,
                                topology="mesh"),
            spec=FaultSpec(jitter=0.05, drop_prob=0.02, stall_prob=0.01,
                           stall_for=4.0, disconnect_prob=0.01),
            partitions=(Partition(10.0, 16.0,
                                  (("node0",), ("node1", "node2"))),),
            settle_slots=15, error_scale=0.5),
        "_fleet_config()": ChaosConfig(
            net=ThreadNetConfig(n_nodes=10, n_slots=8, k=10, f=0.5, seed=7,
                                topology="ring"),
            spec=FaultSpec(jitter=0.04, drop_prob=0.01),
            partitions=(Partition(3.0, 5.0, (half, other)),),
            settle_slots=6, error_scale=0.5)}


def _chaos_checks(name: str, r) -> list:
    """The reference tests' own assertions on one chaos run
    (test_chaos_net_converges_and_recovers, and the fleet half of
    test_ten_node_chaos_fleet_report_and_replay_identity); the ones that
    fail."""
    bad = []
    if r.failures:
        bad.append(f"failures {r.failures}")
    if name == "chaos_config(1)":
        heights = [c.head_block_no for c in r.chains]
        if not r.common_prefix_ok(10):
            bad.append(f"no common prefix, heights {heights}")
        if min(heights) < 3:
            bad.append(f"no progress, heights {heights}")
        if not r.fault_events or not any(e.kind == "fault"
                                         for e in r.trace):
            bad.append("no fault injected")
        if not r.watchdog_events():
            bad.append("no watchdog fired")
        if not r.suspensions():
            bad.append("no peer demoted")
        if not r.demoted_then_repromoted():
            bad.append("no peer re-promoted")
        return bad
    fleet = r.fleet or {}
    ad, mux = fleet.get("adoption", {}), fleet.get("mux", {})
    if fleet.get("nodes") != [f"node{i}" for i in range(10)]:
        bad.append(f"fleet nodes {fleet.get('nodes')}")
    elif not (ad["blocks"] > 0 and ad["time_to_50"]["n"] > 0
              and ad["time_to_95"]["n"] > 0
              and 0 < ad["time_to_95"]["p50"]
              and ad["time_to_50"]["p50"] <= ad["time_to_95"]["p50"]):
        bad.append(f"adoption {ad}")
    if not mux or sum(m["ingress_bytes"] for m in mux.values()) > \
            sum(m["egress_bytes"] for m in mux.values()) or \
            not any(m["egress_bytes"] > 0 for m in mux.values()):
        bad.append("mux accounting")
    if not fleet.get("per_edge_delivery"):
        bad.append("no per-edge delivery")
    return bad


def diffusion_phase(card: str, ext, chain, want_hash: bytes,
                    node_sync: dict) -> dict:
    """Phase 11: the diffusion slice (node/diffusion.py, network/
    {snocket,socket_bearer,subscription,error_policy}.py,
    node/node_to_client.py, the chaos ThreadNet) on the card.

    Legs 1-3 run in one `sim.io_run`, the real-clock IO runtime, every
    node with slots of DIFF_SLOT_S.  DIFF_PEERS servers each hold phase
    5's chain in an ImmutableDB (the first replayed without crypto, the
    others opened from its ledger snapshot at the tip, as a restarted node
    opens) and run `run_data_diffusion(kernel,
    DiffusionArguments(addresses=[("127.0.0.1", 0)]), TcpSnocket())`; the
    ephemeral ports are read from `d.listeners[0].addr`.  Leg 1: a fresh
    follower at genesis on a new TorchBackend with a cleared beta cache,
    the kernel's `chain_sync_window` of 32 and the production
    NodeTimeLimits, a Mempool over the Shelley ledger, runs
    `run_data_diffusion` with the servers as `ip_producers`
    (`ip_valency` 3, initiator-only) and a local address on a
    UnixSnocket, until its tip is the chain's: its ledger at the forger's
    state_hash, each of the four window kernels launched, every block
    added once, no watchdog event, no suspension, no failed thread.  Leg
    2: a wallet on that local address (`connect_local_client_via`)
    queries the tip and the state hash, then submits WALLET_VALID
    transactions and WALLET_FLIPPED with a flipped witness
    (`chainsynth.wallet_txs`) one at a time; every verdict must be a
    Mempool's over CppBackend on the same transactions, and ed25519_split
    must launch.  Leg 3: a second fresh follower on leg 1's backend (its
    key cache warm, the beta cache cleared) syncs from the same servers;
    once its tip passes block DIFF_LOSE_AT, server 0's diffusion and
    kernel stop and its connections close, as its process's exit would
    close them; the follower reaches the tip and the state_hash from the
    other two, and its subscription worker records the lost peer's
    ending as `default_node_policies` judges it (a suspension of the
    consumer, not of the peer).  Leg 4 runs the reference's two chaos
    configurations in the simulator, each once with every node on one
    fresh card TorchBackend (the ThreadNet factory's backend replaced
    through `testing.threadnet.OpensslBackend`, as the port's ThreadNet
    test replaces it) and once on CppBackend: equal fault events, chains
    and fleet reports, the reference tests' assertions on each, and the
    four window kernels launched in each card run.  Returns the
    `diffusion` line's dict; `launches` is the phase's own count."""
    import collections
    import shutil
    import tempfile

    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.chain import point_of
    from ouroboros_tpu_torch.chain.block import Point
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    from ouroboros_tpu_torch.consensus.mempool import Mempool
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.network.error_policy import (
        default_node_policies, eval_error_policies)
    from ouroboros_tpu_torch.network.snocket import TcpSnocket, UnixSnocket
    from ouroboros_tpu_torch.node import BlockchainTime, NodeKernel
    from ouroboros_tpu_torch.node import chain_sync as CS
    from ouroboros_tpu_torch.node.diffusion import (
        INITIATOR_ONLY, DiffusionArguments, connect_local_client_via,
        run_data_diffusion)
    from ouroboros_tpu_torch.observe import netmetrics
    from ouroboros_tpu_torch.observe.propagation import PropagationTracker
    from ouroboros_tpu_torch.simharness import runtime
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.storage.ledgerdb import LedgerDB
    from ouroboros_tpu_torch.storage.stream import pickle_encode
    from ouroboros_tpu_torch.testing import run_chaos_threadnet
    from ouroboros_tpu_torch.testing import threadnet as TN

    class ServerTcp(TcpSnocket):
        """TcpSnocket whose listeners remember the bearers they accept,
        so that stopping a server closes its connections as its process's
        exit would."""

        def __init__(self):
            self.accepted = []

        async def listen(self, addr):
            lst = await super().listen(addr)
            accept = lst.accept

            async def remembering():
                bearer, remote = await accept()
                self.accepted.append(bearer)
                return bearer, remote
            lst.accept = remembering
            return lst

    def block_obj(obj):
        return ProtocolBlock.decode(obj, tx_decode=ShelleyTx.decode)

    def kernel(db, label, backend, mempool=None):
        return NodeKernel(db, ext.ledger, mempool,
                          BlockchainTime(DIFF_SLOT_S), label=label,
                          backend=backend,
                          header_decode=ProtocolHeader.decode,
                          block_decode_obj=block_obj,
                          tx_decode=ShelleyTx.decode)

    def pt(p):
        return (p.slot, p.hash.hex())

    tip = point_of(chain[-1])
    t_phase = time.perf_counter()
    totals = {k: 0 for k in K.LAUNCHES}

    def count(launches):
        for k, v in launches.items():
            totals[k] += v

    # the header flushes, and every card call of the followers' backend,
    # timed where they run: each blocks the event loop that serves every
    # peer while it runs
    flushes: list = []                  # (headers, seconds)
    calls: list = []                    # (method, seconds)
    real_batched = CS.validate_headers_batched

    def timed_batched(protocol, headers, *a, **kw):
        t = time.perf_counter()
        try:
            return real_batched(protocol, headers, *a, **kw)
        finally:
            flushes.append((len(headers), time.perf_counter() - t))

    fbackend = TorchBackend()
    for name in ("verify_mixed", "vrf_betas_batch", "verify_ed25519_batch"):
        def timed(*a, _real=getattr(fbackend, name), _name=name, **kw):
            t = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                calls.append((_name, time.perf_counter() - t))
        setattr(fbackend, name, timed)
    _ext, pools = chainsynth.shelley_setup(
        REPLAY_BLOCKS, epoch_length=REPLAY_EPOCH, kes_depth=REPLAY_KES_DEPTH)
    sock_dir = tempfile.mkdtemp(prefix="ouro-diffusion-")
    local_path = os.path.join(sock_dir, "node.sock")
    out: dict = {}

    async def main():
        rt = runtime.current()
        rt.collect_trace = True
        # -- the servers
        server_backend = TorchBackend()
        servers = []
        t = time.perf_counter()
        snap = None
        for i in range(DIFF_PEERS):
            fs = MockFS()
            chainsynth.write_chaindb(fs, chain, len(chain))
            if snap is not None:
                LedgerDB.take_snapshot(fs, chain[-1].slot, *snap,
                                       pickle_encode)
            db = chainsynth.open_chaindb(fs, ext, server_backend)
            if db.tip_point() != tip:
                raise AssertionError(f"diffusion: server {i} opened at "
                                     f"{pt(db.tip_point())}")
            snap = (db.tip_point(), db.current_ledger)
            k = kernel(db, f"server{i}", server_backend)
            k.start()
            snk = ServerTcp()
            d = await run_data_diffusion(
                k, DiffusionArguments(addresses=[("127.0.0.1", 0)]), snk)
            servers.append({"kernel": k, "diffusion": d, "snocket": snk,
                            "addr": d.listeners[0].addr})
        out["servers_open_s"] = time.perf_counter() - t
        addrs = [s["addr"] for s in servers]
        peer_of = {f"{lab}->{a}": i for i, a in enumerate(addrs)
                   for lab in ("follower", "follower2")}
        # every node's clock must stand past the chain's last slot
        wait = (chain[-1].slot + 2) * DIFF_SLOT_S - sim.now()
        out["clock_wait_s"] = max(wait, 0.0)
        await sim.sleep(wait)

        async def sync(label, mempool=False, local=None, lose_at=None,
                       kernels=UNFOLDED_PATH):
            """One follower from genesis to the chain's tip; its record.
            Each of `kernels` must launch (a warm key cache ships no KES
            jobs: the paths it has finished)."""
            GLOBAL_BETA_CACHE.clear()
            fdb = chainsynth.open_chaindb(MockFS(), ext, fbackend)
            mp = Mempool(ext.ledger, lambda: (fdb.current_ledger.ledger,
                                              fdb.tip_point()),
                         backend=fbackend) if mempool else None
            add_s, added = [], collections.Counter()
            real_add = fdb.add_block

            def timed_add(block):
                t = time.perf_counter()
                try:
                    return real_add(block)
                finally:
                    add_s.append(time.perf_counter() - t)
                    added[block.hash] += 1
            fdb.add_block = timed_add
            follower = kernel(fdb, label, fbackend, mp)
            follower.propagation = PropagationTracker(
                node=label, cap=len(chain) + 64)
            netmetrics.reset_run_scope()
            n_trace = len(rt.trace)
            del flushes[:], calls[:]
            K.reset_launches()
            slot0 = follower.btime.current.value
            follower.start()
            d = await run_data_diffusion(
                follower, DiffusionArguments(
                    ip_producers=addrs, ip_valency=DIFF_PEERS,
                    mode=INITIATOR_ONLY, local_address=local),
                TcpSnocket(), local_snocket=UnixSnocket())
            endings = []                # (addr, exception) a connection
            for w in d.workers:
                def recording(addr, exc, _real=w._on_conn_end):
                    endings.append((addr, exc))
                    return _real(addr, exc)
                w._on_conn_end = recording
            t0 = time.perf_counter()

            def fetched():
                per = collections.Counter(
                    peer_of.get(follower.propagation.stage_peer(
                        b.hash, "body_arrived")) for b in chain)
                return [per[i] for i in range(DIFF_PEERS)]
            lost = None
            while fdb.tip_point() != tip:
                if time.perf_counter() - t0 > DIFF_LIMIT_S:
                    raise AssertionError(
                        f"diffusion {label}: at {pt(fdb.tip_point())} after "
                        f"{DIFF_LIMIT_S} s; failures "
                        f"{_thread_failures(follower)}")
                if lose_at is not None and lost is None and \
                        fdb.current_chain.head_block_no >= lose_at:
                    s0 = servers[0]
                    s0["diffusion"].stop()
                    s0["kernel"].stop()
                    for b in s0["snocket"].accepted:
                        b.close()
                    lost = {"at_block": fdb.current_chain.head_block_no,
                            "at_s": time.perf_counter() - t0,
                            "at_runtime_s": sim.now(),
                            "fetched_before": fetched()}
                await sim.sleep(DIFF_POLL_S)
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            events = rt.trace[n_trace:]
            rec = {
                "fdb": fdb, "kernel": follower, "diffusion": d,
                "mempool": mp, "wall_s": wall,
                "blocks_per_s": len(chain) / wall,
                "flushes": len(flushes),
                "flush_sizes": sorted({n for n, _s in flushes}),
                "flush_ms": _ms([s for _n, s in flushes]),
                "adds": len(add_s), "add_ms": _ms(add_s),
                "split_s": {"header_flushes": sum(s for _n, s in flushes),
                            "chaindb_adds": sum(add_s)},
                "blocks_added_twice": sum(1 for c in added.values()
                                          if c > 1),
                "fetched_per_peer": fetched(),
                "card_calls": len(calls),
                "card_call_max_ms": max(s for _n, s in calls) * 1e3,
                "card_call_s": sum(s for _n, s in calls),
                "longest_card_call": max(calls, key=lambda c: c[1])[0],
                "mux": {k: {f: v[f] for f in ("ingress_bytes",
                                              "egress_bytes")}
                        for k, v in netmetrics.mux_accounting().items()
                        if k.startswith(label + "->")},
                "slot_ticks_per_node": follower.btime.current.value - slot0,
                "watchdog": [p for _t, lab, p in events
                             if lab == "watchdog"],
                "suspensions": [p for _t, lab, p in events
                                if lab == "subscription"
                                and p[1] == "suspend"],
                "dials": [p for _t, lab, p in events
                          if lab == "subscription" and p[1] == "dial"],
                "failures": [(n, tl, repr(e)) for n, tl, e
                             in _thread_failures(follower)],
                "launches": launches, "lost": lost, "endings": endings,
                "worker": d.workers[0]}
            rec["split_s"]["rest"] = wall - rec["split_s"]["header_flushes"] \
                - rec["split_s"]["chaindb_adds"]
            if fdb.invalid or \
                    fdb.current_ledger.ledger.state_hash() != want_hash:
                raise AssertionError(f"diffusion {label}: {len(fdb.invalid)} "
                                     f"invalid, or a state_hash not the "
                                     f"forger's")
            # a lost peer's connection threads end with its connection
            lost_id = f"{label}->{addrs[0]}" if lost is not None else None
            rec["failures"] = [f for f in rec["failures"]
                               if lost_id is None
                               or not f[1].startswith(lost_id)]
            missing = [k for k in kernels if launches[k] == 0]
            if missing or rec["blocks_added_twice"] or rec["failures"] or \
                    len(added) != len(chain):
                raise AssertionError(
                    f"diffusion {label}: kernels not launched {missing}, "
                    f"{rec['blocks_added_twice']} blocks added twice, "
                    f"{len(added)} of {len(chain)} blocks added, failures "
                    f"{rec['failures']}")
            return rec

        def stop(rec):
            rec["kernel"].stop()
            rec["diffusion"].stop()

        # -- leg 1: a fresh relay from three peers
        rec = await sync("follower", mempool=True, local=local_path)
        count(rec["launches"])
        if rec["watchdog"] or rec["suspensions"] or rec["endings"] or \
                len(rec["dials"]) != DIFF_PEERS:
            raise AssertionError(
                f"diffusion leg 1: watchdog events {rec['watchdog']}, "
                f"suspensions {rec['suspensions']}, connection endings "
                f"{rec['endings']}, dials {rec['dials']}")
        out["leg1"] = rec
        log(f"diffusion leg 1: {len(chain)} blocks from {DIFF_PEERS} TCP "
            f"peers in {rec['wall_s']:.3f} s ({rec['blocks_per_s']:.1f} "
            f"blocks/s), state_hash == forger's; {rec['flushes']} flushes "
            f"(sizes {rec['flush_sizes']}), ms p50 "
            f"{rec['flush_ms']['p50']:.3f} p95 {rec['flush_ms']['p95']:.3f} "
            f"max {rec['flush_ms']['max']:.3f}; adds ms p50 "
            f"{rec['add_ms']['p50']:.3f} max {rec['add_ms']['max']:.3f}; "
            f"split {rec['split_s']}; fetched per peer "
            f"{rec['fetched_per_peer']}; longest card call "
            f"{rec['card_call_max_ms']:.3f} ms ({rec['longest_card_call']}); "
            f"launches {rec['launches']}")

        # -- leg 2: a wallet on the local socket
        fdb, mp = rec["fdb"], rec["mempool"]
        client = await connect_local_client_via(
            UnixSnocket(), local_path,
            (rec["kernel"].network_magic, block_obj))
        if client is None:
            raise AssertionError("diffusion leg 2: handshake refused")
        got_tip = Point.decode(await client.query(["tip"]))
        got_hash = await client.query(["state-hash"])
        txs = chainsynth.wallet_txs(pools, fdb.current_ledger.ledger,
                                    WALLET_VALID, WALLET_FLIPPED)
        ledger_at_tip = fdb.current_ledger.ledger
        ref = Mempool(ext.ledger, lambda: (ledger_at_tip, tip),
                      backend=CppBackend())
        want = []
        for tx in txs:
            added, rejected = ref.try_add_txs([tx])
            want.append(None if added else str(rejected[0][1]))
        K.reset_launches()
        verdicts, sub_s = [], []
        for tx in txs:
            t = time.perf_counter()
            verdicts.append(await client.submit_tx(tx))
            sub_s.append(time.perf_counter() - t)
        launches = dict(K.LAUNCHES)
        count(launches)
        client.mux.stop()
        ok_valid = want[:WALLET_VALID] == [None] * WALLET_VALID
        ok_bad = all(v is not None for v in want[WALLET_VALID:])
        if got_tip != tip or got_hash != want_hash or verdicts != want or \
                not ok_valid or not ok_bad or ("ed25519_split" in MAIN_PATH
                                               and launches["ed25519_split"]
                                               == 0) or \
                len(mp.get_snapshot().entries) != WALLET_VALID:
            raise AssertionError(
                f"diffusion leg 2: tip {pt(got_tip)}, state hash "
                f"{got_hash == want_hash}, verdicts {verdicts} != "
                f"CppBackend's {want}, launches {launches}")
        out["leg2"] = {"tip": pt(got_tip), "state_hash": got_hash.hex(),
                       "submitted": len(txs), "accepted": WALLET_VALID,
                       "rejected": sorted(set(want[WALLET_VALID:])),
                       "submit_ms": _ms(sub_s), "launches": launches}
        log(f"diffusion leg 2: wallet tip and state hash == forger's; "
            f"{len(txs)} submissions, verdicts == CppBackend's "
            f"({WALLET_VALID} accepted, {WALLET_FLIPPED} rejected: "
            f"{out['leg2']['rejected']}), ms p50 "
            f"{out['leg2']['submit_ms']['p50']:.3f} p95 "
            f"{out['leg2']['submit_ms']['p95']:.3f} max "
            f"{out['leg2']['submit_ms']['max']:.3f}; launches {launches}")
        stop(rec)

        # -- leg 3: a peer lost mid-sync
        rec = await sync("follower2", lose_at=DIFF_LOSE_AT,
                         kernels=[k for k in UNFOLDED_PATH
                                  if k != "kes_hash"])
        count(rec["launches"])
        lost, w = rec["lost"], rec["worker"]
        lost_addr = addrs[0]
        ends = [e for a, e in rec["endings"] if a == lost_addr]
        susp = [p for p in rec["suspensions"] if p[2] == lost_addr]
        verdicts = [eval_error_policies(default_node_policies(), e)
                    for e in ends if e is not None]
        # each suspension is the policy's verdict on the ending the worker
        # saw, its duration the verdict's doubled per earlier failure and
        # jittered (the first ending: no exponent); a redial, if the sync
        # outlasts the first window, is refused and suspended the same way
        if lost is None or not ends or len(verdicts) != len(ends) or \
                len(susp) != len(ends) or any(
                    p[3] != v.kind or p[5] != n or not (
                        v.duration * 2 ** (n - 1) <= p[4]
                        <= v.duration * 2 ** (n - 1) * (1 + w.jitter))
                    for n, (p, v) in enumerate(zip(susp, verdicts), 1)) or \
                w.states[lost_addr].fail_count != len(ends) or \
                any(a != lost_addr for a, _e in rec["endings"]):
            raise AssertionError(
                f"diffusion leg 3: lost {lost}, connection endings "
                f"{rec['endings']}, suspensions {susp} (default_node_"
                f"policies: {verdicts}), fetched {rec['fetched_per_peer']}")
        verdict = verdicts[0]
        redials = [p for p in rec["dials"] if p[2] == lost_addr][1:]
        rec.update(lost_addr=str(lost_addr), ending=repr(ends[0]),
                   policy=[verdict.kind, verdict.duration],
                   suspension=list(susp[0]), redials=len(redials),
                   fetched_after=[a - b for a, b in zip(
                       rec["fetched_per_peer"], lost["fetched_before"])])
        if rec["fetched_after"][0] or not sum(rec["fetched_after"]):
            raise AssertionError(f"diffusion leg 3: fetched after the loss "
                                 f"{rec['fetched_after']}")
        out["leg3"] = rec
        log(f"diffusion leg 3: server 0 stopped at block "
            f"{lost['at_block']} ({lost['at_s']:.3f} s); the follower at "
            f"the tip and the forger's state_hash in {rec['wall_s']:.3f} s; "
            f"fetched per peer before {lost['fetched_before']}, after "
            f"{rec['fetched_after']}; the lost peer's ending "
            f"{rec['ending']}, suspension {rec['suspension']}, redials "
            f"{len(redials)}; watchdog events {len(rec['watchdog'])}; "
            f"launches {rec['launches']}")
        stop(rec)
        for s in servers[1:]:
            s["diffusion"].stop()
            s["kernel"].stop()
            for b in s["snocket"].accepted:
                b.close()
        await sim.sleep(0.05)

    CS.validate_headers_batched = timed_batched
    try:
        t = time.perf_counter()
        sim.io_run(main())
        io_s = time.perf_counter() - t
    finally:
        CS.validate_headers_batched = real_batched
        shutil.rmtree(sock_dir, ignore_errors=True)
    follower_db = out["leg1"]["fdb"]
    for leg in ("leg1", "leg3"):
        for key in ("fdb", "kernel", "diffusion", "mempool", "worker"):
            out[leg].pop(key, None)
        out[leg]["endings"] = [[str(a), repr(e)]
                               for a, e in out[leg]["endings"]]
        out[leg]["watchdog"] = len(out[leg]["watchdog"])
        out[leg]["suspensions"] = [list(p) for p in out[leg]["suspensions"]]
        out[leg]["dials"] = len(out[leg]["dials"])
    l1, n1 = out["leg1"], node_sync
    out["leg1"]["beside_phase_10"] = {
        "tcp_3_peers_io_runtime": {k: l1[k] for k in ("wall_s",
                                                      "blocks_per_s",
                                                      "flushes")},
        "sim_1_peer": {"wall_s": n1["seconds"],
                       "blocks_per_s": n1["blocks_per_s"],
                       "flushes": n1["flushes"]},
        "flush_ms_p50": [l1["flush_ms"]["p50"], n1["flush_ms"]["p50"]],
        "add_ms_p50": [l1["add_ms"]["p50"], n1["add_ms"]["p50"]]}
    log(f"diffusion leg 1 beside phase 10's leg 1 (the same chain, one "
        f"peer, the simulator): {l1['wall_s']:.3f} s against "
        f"{n1['seconds']:.3f} s, {l1['flushes']} flushes against "
        f"{n1['flushes']}")

    # -- leg 4: the chaos ThreadNet on the card and on CppBackend
    chaos, fleets = {}, {}
    real_backend = TN.OpensslBackend
    for name, cfg in _chaos_configs().items():
        runs = {}
        for which in ("card", "cpp"):
            backend = TorchBackend() if which == "card" else CppBackend()
            TN.OpensslBackend = lambda: backend
            K.reset_launches()
            t = time.perf_counter()
            try:
                r = run_chaos_threadnet(cfg)
            finally:
                TN.OpensslBackend = real_backend
            runs[which] = (r, time.perf_counter() - t, dict(K.LAUNCHES))
        (rc, sc, lc), (rp, sp, _lp) = runs["card"], runs["cpp"]
        count(lc)
        fleets[name] = rc.fleet
        same = {"fault_events": rc.fault_events == rp.fault_events,
                "chains": [[p.encode() for p in c.points()]
                           for c in rc.chains]
                == [[p.encode() for p in c.points()] for c in rp.chains],
                "fleet": json.dumps(rc.fleet, sort_keys=True)
                == json.dumps(rp.fleet, sort_keys=True)}
        bad = {w: _chaos_checks(name, r) for w, (r, _s, _l) in runs.items()}
        missing = [k for k in UNFOLDED_PATH if lc[k] == 0]
        if not all(same.values()) or any(bad.values()) or missing:
            first = next((i for i, (a, b) in enumerate(zip(rc.trace,
                                                           rp.trace))
                          if repr(a) != repr(b)), None)
            raise AssertionError(
                f"diffusion leg 4 {name}: card == CppBackend {same} (first "
                f"diverging trace event {first}: "
                f"{rc.trace[first] if first is not None else None} / "
                f"{rp.trace[first] if first is not None else None}); "
                f"failed checks {bad}; kernels not launched {missing}")
        chaos[name] = {
            "nodes": cfg.net.n_nodes, "slots": cfg.net.n_slots,
            "heights": [c.head_block_no for c in rc.chains],
            "fault_events": len(rc.fault_events),
            "watchdog_events": len(rc.watchdog_events()),
            "suspensions": len(rc.suspensions()),
            "repromoted": len(rc.demoted_then_repromoted()),
            "card_s": sc, "cpp_s": sp, "launches": lc}
        log(f"diffusion leg 4 {name}: card == CppBackend (fault events, "
            f"chains, fleet report), the tests' checks pass on both; "
            f"{sc:.3f} s on the card, {sp:.3f} s on CppBackend; heights "
            f"{chaos[name]['heights']}; launches {lc}")
    phase_s = time.perf_counter() - t_phase
    log(f"diffusion phase: {phase_s:.3f} s")
    return {"seconds": phase_s, "io_run_s": io_s, "slot_length_s": DIFF_SLOT_S,
            "peers": DIFF_PEERS, "servers_open_s": out["servers_open_s"],
            "clock_wait_s": out["clock_wait_s"],
            "sync": out["leg1"], "wallet": out["leg2"],
            "peer_lost": out["leg3"], "chaos": chaos,
            "launches": totals, "card": card,
            "follower_db": follower_db, "fleets": fleets}


def _tx_bytes(tx) -> bytes:
    from ouroboros_tpu_torch.utils import cbor
    return cbor.dumps(tx.encode())


class _BytesReader:
    """A Mempool reader whose lookup gives a transaction's wire bytes, as
    TxSubmission's outbound side sends them (node/tx_submission.py)."""

    def __init__(self, reader):
        self.reader = reader

    def next_ids(self, n):
        return self.reader.next_ids(n)

    def lookup(self, txid):
        tx = self.reader.lookup(txid)
        return None if tx is None else _tx_bytes(tx)


class _SnapshotMonitor:
    """LocalTxMonitor's view of a Mempool: its server asks for
    `snapshot_txs()` and `wait_for_new(seen)`, which the Mempool has not;
    this adapter reads `get_snapshot()`."""

    def __init__(self, mempool):
        self.mempool = mempool
        self._bytes: dict = {}          # txid -> wire bytes

    def snapshot_txs(self) -> list:
        return [self._bytes.get(e.txid) or self._bytes.setdefault(
            e.txid, _tx_bytes(e.tx))
            for e in self.mempool.get_snapshot().entries]

    async def wait_for_new(self, seen: int) -> None:
        from ouroboros_tpu_torch import simharness as sim
        while len(self.mempool.get_snapshot().entries) <= seen:
            await sim.sleep(0.01)


class _TapBearer:
    """A bearer that keeps every SDU it reads and writes, (direction,
    protocol number, mode, payload) in order, and adds no delay."""

    def __init__(self, inner, log: list):
        self.inner = inner
        self.log = log

    async def read(self):
        sdu = await self.inner.read()
        self.log.append(("in", sdu.num, sdu.mode, sdu.payload))
        return sdu

    async def write(self, sdu):
        self.log.append(("out", sdu.num, sdu.mode, sdu.payload))
        await self.inner.write(sdu)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _cddl_check(log: list) -> tuple:
    """Decode the tapped SDU payloads, one byte stream a (direction,
    protocol, mode), into messages and check each against the reference's
    grammar (`cddl.grammar` at tests/test_cddl_conformance.py's leaf
    instantiations).  Returns ({protocol: messages}, [mismatches],
    {protocol: bytes left undecoded at the end of the capture})."""
    from ouroboros_tpu_torch.network import cddl
    from ouroboros_tpu_torch.network import node_to_node as n2n
    from ouroboros_tpu_torch.utils import cbor
    g = cddl.grammar(header_hash=cddl.bstr, tx_id=cddl.bstr,
                     transaction=cddl.bstr, reject_reason=cddl.tstr)
    rules = {n2n.HANDSHAKE_NUM: ("handshake", g["handshake"]),
             n2n.CHAINSYNC_NUM: ("chainsync", g["chainsync"](cddl.any_)),
             n2n.BLOCKFETCH_NUM: ("blockfetch", g["blockfetch"](cddl.any_)),
             n2n.TXSUBMISSION_NUM: ("txsubmission", g["txsubmission"])}
    streams: dict = {}
    for direction, num, mode, payload in log:
        streams.setdefault((direction, num, mode), bytearray()).extend(
            payload)
    counts = {name: 0 for name, _r in rules.values()}
    mismatches, left = [], {}
    for (direction, num, mode), data in sorted(streams.items()):
        if num not in rules:
            continue                # keep-alive: no CDDL in the grammar
        name, rule = rules[num]
        data, pos = bytes(data), 0
        while pos < len(data):
            try:
                obj, used = cbor.loads_prefix(data[pos:])
            except cbor.CBORTruncated:
                break               # the capture ended inside a message
            pos += used
            counts[name] += 1
            try:
                rule.check(obj)
            except cddl.Mismatch as e:
                mismatches.append((name, direction, str(e)[:200]))
        if pos < len(data):
            left[f"{name} {direction} {mode}"] = len(data) - pos
    return counts, mismatches, left


def protocols_phase(card: str, ext, chain, want_hash: bytes, follower_db,
                    fleet: dict, multichip_tail: str, dev=None) -> dict:
    """Phase 12: the node's remaining protocols and the operator tools on
    the card.  Leg 1: `graft_entry.entry()`'s r3 verify form (128
    signatures by one key) gives 128 x True through `ed25519.finalize`; a
    second batch of 128 from the same key with eight lanes tampered (a
    flipped message byte, a flipped signature byte, s >= L, a
    non-canonical R, an R off the curve, a small-order A, a short
    signature, a long key) gives, through the r3 form, `ed25519_ref`'s
    verdicts and the `ed25519_verify` kernel's (`ed25519.batch_verify`);
    the r3 form's CUDA-event time beside the kernel's on the same 128
    valid lanes.  Leg 2: a Mempool over a fresh TorchBackend admits
    `chainsynth.wallet_txs(pools, ledger at the tip, PROTO_VALID,
    PROTO_FLIPPED)` (ed25519_split launched), every verdict a CppBackend
    Mempool's; over one port Mux bearer pair in the simulator,
    TxSubmission2 (Hello first) relays it into a second card Mempool,
    the txids in the same order and the verdicts a CppBackend Mempool's
    on the relayed transactions; LocalTxMonitor collects every admitted
    transaction through `_SnapshotMonitor`, the bytes the snapshot's;
    TipSample samples TIP_REQUESTS from a tip source over `follower_db`
    (phase 11's follower's ChainDB), every tip on its chain.  Leg 3,
    under the real-clock IO runtime: phase 11's server 0 (phase 5's chain
    in an ImmutableDB behind `run_data_diffusion` on a loopback TCP port,
    a card TorchBackend), a `ScrapeServer` over the process registry on
    another; `python -m ouroboros_tpu_torch.ping 127.0.0.1 PORT --count
    PING_COUNT` exits 0 with the negotiated version and PING_COUNT RTTs;
    a fresh follower on a new TorchBackend syncs the first
    PROTO_SYNC_BLOCKS blocks through a bearer tap, each of the four
    window kernels launched, and every Handshake, ChainSync, BlockFetch
    and TxSubmission message the tap saw matches the reference's grammar
    (zero mismatches); the scrape is fetched with `scrape()`.  Leg 4:
    obsreport renders phase 11's fleet report (`render_fleet`), the
    scrape (`render_live`) and phase 8's MULTICHIP_OBS line
    (`render_multichip` over `load_multichip` of a round file holding
    its log), each with its section headers.  Returns the `protocols`
    line's dict; `launches` is the phase's own count.  `dev` is the card
    unless a rehearsal on the CPU names another device."""
    import asyncio
    import functools
    import tempfile

    from ouroboros_tpu_torch import chainsynth, graft_entry, obsreport
    from ouroboros_tpu_torch import device as D
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.chain import Tip, point_of
    from ouroboros_tpu_torch.chain.block import Point
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    from ouroboros_tpu_torch.consensus.mempool import Mempool
    from ouroboros_tpu_torch.crypto import ed25519 as E
    from ouroboros_tpu_torch.crypto import ed25519_ref, edwards as ed
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.network import node_to_node as n2n
    from ouroboros_tpu_torch.network.mux import (INITIATOR, RESPONDER,
                                                 CodecChannel, Mux,
                                                 bearer_pair)
    from ouroboros_tpu_torch.network.protocols import (
        localtxmonitor as ltm, tipsample as tsp, txsubmission2 as tx2)
    from ouroboros_tpu_torch.network.snocket import TcpSnocket
    from ouroboros_tpu_torch.network.typed import CLIENT, SERVER, Session
    from ouroboros_tpu_torch.node import BlockchainTime, NodeKernel
    from ouroboros_tpu_torch.node.diffusion import (
        INITIATOR_ONLY, DiffusionArguments, run_data_diffusion)
    from ouroboros_tpu_torch.observe import export
    from ouroboros_tpu_torch.observe.scrape import ScrapeServer, scrape
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.utils import cbor
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    totals = {k: 0 for k in K.LAUNCHES}

    def count(launches):
        for k, v in launches.items():
            totals[k] += v
    out: dict = {}

    # -- leg 1: the compile-probe entry -------------------------------------
    K.reset_launches()
    t = time.perf_counter()
    fn, args = graft_entry.entry(device=dev)
    prep_s = time.perf_counter() - t
    if any(a.device != args[0].device or a.device.type != dev.type
           for a in args):
        raise AssertionError("graft entry: example args not on the device")
    t = time.perf_counter()
    entry_ok = E.finalize(*fn(*args), [True] * graft_entry.N)
    call_s = time.perf_counter() - t
    if entry_ok != [True] * graft_entry.N:
        raise AssertionError(f"graft entry: {entry_ok.count(False)} of "
                             f"{graft_entry.N} lanes rejected")
    vks, msgs, sigs = graft_entry.entry_batch()
    bad_R = next(y for y in range(2, 100)
                 if ed.decompress(y.to_bytes(32, "little")) is None)
    msgs[1] = bytes([msgs[1][0] ^ 1]) + msgs[1][1:]
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 4]) + sigs[2][41:]
    sigs[3] = sigs[3][:32] + ed.L.to_bytes(32, "little")       # s >= L
    sigs[4] = (ed.P + 1).to_bytes(32, "little") + sigs[4][32:]  # y_R >= p
    sigs[5] = bad_R.to_bytes(32, "little") + sigs[5][32:]      # R off curve
    vks[6] = (ed.P - 1).to_bytes(32, "little")                 # order 2
    sigs[7] = sigs[7][:63]                                     # short sig
    vks[8] = vks[8] + b"\x00"                                  # long key
    arrays, valid = E.prepare_batch(vks, msgs, sigs, device=dev)
    r3 = E.finalize(*E.verify_core(*arrays), valid)
    ref = [ed25519_ref.verify(a, m, s) for a, m, s in zip(vks, msgs, sigs)]
    kern = E.batch_verify(vks, msgs, sigs, device=dev)
    launches = dict(K.LAUNCHES)
    count(launches)
    if r3 != ref or kern != ref or ref.count(False) != 8 or \
            ("ed25519_verify" in PROBE_PATH
             and launches["ed25519_verify"] == 0):
        raise AssertionError(
            f"protocols leg 1: r3 verdicts {r3 == ref}, ed25519_verify's "
            f"{kern == ref} against ed25519_ref ({ref.count(False)} "
            f"rejected), launches {launches}")
    words, _ok = E.prepare_words_batch(*graft_entry.entry_batch())
    wargs = tuple(torch.from_numpy(a).to(dev) for a in words)
    r3_ms = D.event_ms(lambda: fn(*args), reps=5)
    kernel_ms = D.event_ms(lambda: K.ed25519_verify(*wargs))
    out["leg1"] = {"lanes": graft_entry.N, "prepare_s": prep_s,
                   "first_call_s": call_s, "r3_ms": r3_ms,
                   "ed25519_verify_ms": kernel_ms,
                   "tampered": 8, "launches": launches}
    log(f"protocols leg 1: graft entry {graft_entry.N} x True; the "
        f"tampered batch's r3 verdicts == ed25519_ref == ed25519_verify "
        f"(8 rejected); r3 form {r3_ms:.3f} ms, ed25519_verify "
        f"{kernel_ms:.4f} ms on {graft_entry.N} lanes (CUDA events); "
        f"prepare {prep_s:.3f} s; launches {launches}")

    # -- leg 2: the mempool protocols ----------------------------------------
    _ext, pools = chainsynth.shelley_setup(
        REPLAY_BLOCKS, epoch_length=REPLAY_EPOCH, kes_depth=REPLAY_KES_DEPTH)
    tip = follower_db.tip_point()
    if tip != point_of(chain[-1]):
        raise AssertionError("protocols: phase 11's follower is not at the "
                             "chain's tip")
    ledger = follower_db.current_ledger.ledger
    txs = chainsynth.wallet_txs(pools, ledger, PROTO_VALID, PROTO_FLIPPED)

    def mempool(backend):
        return Mempool(ext.ledger, lambda: (ledger, tip), backend=backend)

    def verdicts(mp, batch):
        added, rejected = mp.try_add_txs(batch)
        why = {id(tx): str(e) for tx, e in rejected}
        return [why.get(id(tx)) for tx in batch], added

    K.reset_launches()
    t = time.perf_counter()
    mp1 = mempool(TorchBackend())
    got1, added1 = verdicts(mp1, txs)
    admit_s = time.perf_counter() - t
    t = time.perf_counter()
    want1, _a = verdicts(mempool(CppBackend()), txs)
    admit_cpp_s = time.perf_counter() - t
    n_in = len(mp1.get_snapshot().entries)
    if got1 != want1 or any(v is not None for v in got1[:PROTO_VALID]) or \
            any(v is None for v in got1[PROTO_VALID:]):
        raise AssertionError(f"protocols leg 2: admission verdicts "
                             f"{got1 == want1} against CppBackend's, "
                             f"{n_in} admitted")
    mp2 = mempool(TorchBackend())
    relayed, got2 = [], []

    def sink(raw):
        tx = ShelleyTx.decode(cbor.loads(raw))
        relayed.append(tx)
        got2.append(verdicts(mp2, [tx])[0][0])

    tips, monitored, relay_s = [], [], {}
    chain_blocks = follower_db.stream_blocks(Point.genesis(), tip)

    async def tip_source(slot, after):
        floor = slot if after is None else max(slot, after.point.slot + 1)
        b = next(b for b in chain_blocks if b.slot >= floor)
        return Tip(point_of(b), b.block_no)

    async def relay():
        ba, bb = bearer_pair()
        ma, mb = Mux(ba, "proto.a"), Mux(bb, "proto.b")
        ma.start()
        mb.start()

        def session(mux, num, mode, mod, role):
            return Session(mod.SPEC, role,
                           CodecChannel(mux.channel(num, mode), mod.CODEC))
        t0 = time.perf_counter()
        outbound = sim.spawn(tx2.outbound_from_mempool(
            session(ma, n2n.TXSUBMISSION_NUM, INITIATOR, tx2, CLIENT),
            _BytesReader(mp1.reader())), label="tx2.out")
        await tx2.inbound_collect(
            session(mb, n2n.TXSUBMISSION_NUM, RESPONDER, tx2, SERVER),
            sink, window=TXSUBMISSION2_WINDOW)
        await outbound.wait()
        relay_s["txsubmission2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = sim.spawn(ltm.server_from_mempool(
            session(mb, LOCAL_TXMONITOR_NUM, RESPONDER, ltm, SERVER),
            _SnapshotMonitor(mp2)), label="ltm.server")
        monitored.extend(await ltm.client_collect(
            session(ma, LOCAL_TXMONITOR_NUM, INITIATOR, ltm, CLIENT),
            len(mp2.get_snapshot().entries)))
        await server.wait()
        relay_s["localtxmonitor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = sim.spawn(tsp.server_from_tip_source(
            session(mb, TIPSAMPLE_NUM, RESPONDER, tsp, SERVER),
            tip_source), label="tipsample.server")
        tips.extend(await tsp.client_sample(
            session(ma, TIPSAMPLE_NUM, INITIATOR, tsp, CLIENT),
            TIP_REQUESTS))
        await server.wait()
        relay_s["tipsample"] = time.perf_counter() - t0
        ma.stop()
        mb.stop()

    sim.run(relay())
    launches = dict(K.LAUNCHES)
    count(launches)
    cpp2 = mempool(CppBackend())
    want2 = [verdicts(cpp2, [tx])[0][0] for tx in relayed]
    ids1 = [e.txid for e in mp1.get_snapshot().entries]
    ids2 = [e.txid for e in mp2.get_snapshot().entries]
    snap = _SnapshotMonitor(mp2).snapshot_txs()
    bad_tips = [(n, str(t.point)) for n, r in zip(TIP_REQUESTS, tips)
                for t in r if not follower_db.contains_point(t.point)
                or follower_db.get_block(t.point.hash).block_no
                != t.block_no]
    if ids2 != ids1 or got2 != want2 or monitored != snap or \
            monitored != _SnapshotMonitor(mp1).snapshot_txs() or \
            [len(r) for r in tips] != [n for n, _s in TIP_REQUESTS] or \
            bad_tips or ("ed25519_split" in MAIN_PATH
                         and launches["ed25519_split"] == 0):
        raise AssertionError(
            f"protocols leg 2: relayed txids in order {ids2 == ids1} "
            f"({len(ids2)} of {len(ids1)}), verdicts == CppBackend's "
            f"{got2 == want2}, monitored == snapshot {monitored == snap} "
            f"({len(monitored)}), tips {[len(r) for r in tips]}, off the "
            f"chain {bad_tips}, launches {launches}")
    out["leg2"] = {
        "submitted": len(txs), "admitted": n_in,
        "capacity_bytes": mp1.capacity_bytes, "bytes_used": mp1.bytes_used,
        "rejected": sorted(set(v for v in got1 if v is not None)),
        "admit_s": admit_s, "admit_cpp_s": admit_cpp_s,
        "relayed": len(relayed), "relay_s": relay_s,
        "monitored": len(monitored),
        "tips": [[t.point.slot, t.block_no] for r in tips for t in r],
        "launches": launches}
    log(f"protocols leg 2: {len(txs)} wallet transactions, {n_in} admitted "
        f"({mp1.bytes_used} of {mp1.capacity_bytes} bytes), "
        f"{len(txs) - n_in} rejected, verdicts == CppBackend's "
        f"({admit_s:.3f} s on the card, {admit_cpp_s:.3f} s on "
        f"CppBackend); TxSubmission2 relayed {len(relayed)} in order, "
        f"verdicts == CppBackend's; LocalTxMonitor {len(monitored)} == the "
        f"snapshot's bytes; TipSample {[len(r) for r in tips]} tips on the "
        f"follower's chain; seconds {relay_s}; launches {launches}")

    # -- leg 3: ping, the scrape and the CDDL check of a real sync ----------
    GLOBAL_BETA_CACHE.clear()
    cbackend = TorchBackend()
    tap_log: list = []
    root = os.path.dirname(os.path.abspath(__file__))

    class TapTcp(TcpSnocket):
        def __init__(self):
            self.bearers = []

        async def connect(self, addr):
            b = _TapBearer(await super().connect(addr), tap_log)
            self.bearers.append(b)
            return b

    class ServerTcp(TcpSnocket):
        def __init__(self):
            self.accepted = []

        async def listen(self, addr):
            lst = await super().listen(addr)
            accept = lst.accept

            async def remembering():
                bearer, remote = await accept()
                self.accepted.append(bearer)
                return bearer, remote
            lst.accept = remembering
            return lst

    def kernel(db, label, backend, mp=None):
        return NodeKernel(db, ext.ledger, mp, BlockchainTime(DIFF_SLOT_S),
                          label=label, backend=backend,
                          header_decode=ProtocolHeader.decode,
                          block_decode_obj=lambda o: ProtocolBlock.decode(
                              o, tx_decode=ShelleyTx.decode),
                          tx_decode=ShelleyTx.decode)

    async def serve_and_sync():
        t0 = time.perf_counter()
        fs = MockFS()
        chainsynth.write_chaindb(fs, chain, len(chain))
        sbackend = TorchBackend()
        sdb = chainsynth.open_chaindb(fs, ext, sbackend)
        server = kernel(sdb, "server", sbackend, Mempool(
            ext.ledger, lambda: (sdb.current_ledger.ledger,
                                 sdb.tip_point()), backend=sbackend))
        server.start()
        snk = ServerTcp()
        d = await run_data_diffusion(
            server, DiffusionArguments(addresses=[("127.0.0.1", 0)]), snk)
        addr = d.listeners[0].addr
        scraper = ScrapeServer(TcpSnocket(), ("127.0.0.1", 0))
        await scraper.start()
        out["servers_open_s"] = time.perf_counter() - t0
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        ping = await loop.run_in_executor(None, functools.partial(
            subprocess.run, [sys.executable, "-m", "ouroboros_tpu_torch.ping",
                             addr[0], str(addr[1]), "--count",
                             str(PING_COUNT)],
            capture_output=True, text=True, timeout=60, cwd=root))
        out["ping_s"] = time.perf_counter() - t0
        out["ping_rc"], out["ping_stdout"] = ping.returncode, ping.stdout
        out["ping_stderr"] = ping.stderr[-2000:]
        wait = (chain[-1].slot + 2) * DIFF_SLOT_S - sim.now()
        out["clock_wait_s"] = max(wait, 0.0)
        await sim.sleep(wait)
        fdb = chainsynth.open_chaindb(MockFS(), ext, cbackend)
        mp = Mempool(ext.ledger, lambda: (fdb.current_ledger.ledger,
                                          fdb.tip_point()), backend=cbackend)
        follower = kernel(fdb, "cddl-follower", cbackend, mp)
        K.reset_launches()
        t0 = time.perf_counter()
        follower.start()
        tap = TapTcp()
        fd = await run_data_diffusion(
            follower, DiffusionArguments(ip_producers=[addr], ip_valency=1,
                                         mode=INITIATOR_ONLY), tap)
        while fdb.current_chain.head_block_no < PROTO_SYNC_BLOCKS - 1:
            if time.perf_counter() - t0 > PROTO_LIMIT_S:
                raise AssertionError(
                    f"protocols leg 3: at block "
                    f"{fdb.current_chain.head_block_no} after "
                    f"{PROTO_LIMIT_S} s; failures "
                    f"{_thread_failures(follower)}")
            await sim.sleep(0.005)
        out["sync_s"] = time.perf_counter() - t0
        out["synced_to"] = fdb.current_chain.head_block_no
        # transactions valid at the follower's tip, which its TxSubmission
        # outbound offers the server: ids, then bodies on the wire
        added, _r = mp.try_add_txs(chainsynth.wallet_txs(
            pools, fdb.current_ledger.ledger, PROTO_TX_OFFERED))
        out["offered"] = len(added)
        t1 = time.perf_counter()
        while not any(d == "out" and num == n2n.TXSUBMISSION_NUM
                      and p[:2] == b"\x82\x03" for d, num, _m, p in tap_log):
            if time.perf_counter() - t1 > 30.0:
                raise AssertionError("protocols leg 3: no MsgReplyTxs on "
                                     "the wire in 30 s")
            await sim.sleep(0.005)
        out["launches"] = dict(K.LAUNCHES)
        out["invalid"] = len(fdb.invalid)
        out["stopped_at"] = fdb.current_chain.head_block_no
        out["on_chain"] = fdb.tip_point() == point_of(
            chain[out["stopped_at"]])
        out["failures"] = [(n, tl, repr(e)) for n, tl, e
                           in _thread_failures(follower)]
        follower.stop()
        fd.stop()
        for b in tap.bearers:
            b.close()
        out["scrape"] = await scrape(TcpSnocket(), scraper.listener.addr)
        await scraper.stop()
        server.stop()
        d.stop()
        for b in snk.accepted:
            b.close()
        await sim.sleep(0.05)

    t = time.perf_counter()
    sim.io_run(serve_and_sync())
    io_s = time.perf_counter() - t
    launches = out.pop("launches")
    count(launches)
    missing = [k for k in UNFOLDED_PATH if launches[k] == 0]
    try:
        ping = json.loads(out["ping_stdout"].strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        ping = {}
    if out["ping_rc"] != 0 or not ping.get("ok") or \
            ping.get("probes") != PING_COUNT or not ping.get("version"):
        raise AssertionError(f"protocols leg 3: ping exited "
                             f"{out['ping_rc']}: {out['ping_stdout']!r} "
                             f"{out['ping_stderr']!r}")
    counts, mismatches, left = _cddl_check(tap_log)
    if mismatches or missing or out["invalid"] or not out["on_chain"] or \
            out["failures"] or not all(counts.values()) or \
            out["offered"] != PROTO_TX_OFFERED:
        raise AssertionError(
            f"protocols leg 3: {len(mismatches)} CDDL mismatches "
            f"{mismatches[:5]}, messages {counts}, kernels not launched "
            f"{missing}, {out['invalid']} invalid, tip on the chain "
            f"{out['on_chain']}, failures {out['failures']}")
    out["leg3"] = {
        "ping": ping, "ping_s": out.pop("ping_s"),
        "servers_open_s": out.pop("servers_open_s"),
        "clock_wait_s": out.pop("clock_wait_s"),
        "sync_s": out.pop("sync_s"), "synced_to": out.pop("synced_to"),
        "stopped_at": out.pop("stopped_at"), "tx_offered": out.pop("offered"),
        "io_run_s": io_s, "sdus": len(tap_log),
        "cddl_messages": counts, "cddl_mismatches": len(mismatches),
        "undecoded_tail_bytes": left, "launches": launches}
    for k in ("ping_rc", "ping_stdout", "ping_stderr", "invalid",
              "on_chain", "failures"):
        out.pop(k)
    log(f"protocols leg 3: ping version {ping.get('version')}, probes "
        f"{ping.get('probes')} rtt ms min {ping.get('rtt_min_ms')} avg "
        f"{ping.get('rtt_avg_ms')} max {ping.get('rtt_max_ms')}; a fresh "
        f"follower synced to block {out['leg3']['synced_to']} in "
        f"{out['leg3']['sync_s']:.3f} s over a tap of "
        f"{len(tap_log)} SDUs: {counts} messages, 0 CDDL mismatches "
        f"(undecoded at the capture's end {left}); launches {launches}")

    # -- leg 4: obsreport on the card's own output -----------------------------
    renders = {}
    renders["fleet"] = obsreport.render_fleet(fleet)
    renders["live"] = obsreport.render_live(
        export.parse_prometheus_text(out.pop("scrape")))
    with tempfile.TemporaryDirectory(prefix="ouro-protocols-") as tmp:
        path = os.path.join(tmp, "MULTICHIP_r01.json")
        with open(path, "w") as f:
            json.dump({"n_devices": SHARDS, "rc": 0, "ok": True,
                       "tail": multichip_tail}, f)
        mc = obsreport.load_multichip(path)
    renders["multichip"] = obsreport.render_multichip(mc)
    headers = {
        "fleet": ("fleet telemetry:", "block adoption", "per-peer mux"),
        "live": ("replay progress", "latency/size histograms"),
        "multichip": (f"multichip dryrun: {SHARDS} devices, rc=0 (green)",
                      "compile attribution",
                      "sharded pipelined replay")}
    absent = {k: [h for h in hs if h not in renders[k]]
              for k, hs in headers.items()}
    if any(absent.values()):
        raise AssertionError(f"protocols leg 4: headers missing {absent}")
    out["leg4"] = {k: {"lines": v.count("\n"), "headers": list(headers[k])}
                   for k, v in renders.items()}
    for k, v in renders.items():
        log(f"protocols leg 4, obsreport {k}:")
        for line in v.rstrip().splitlines():
            log("  " + line)
    phase_s = time.perf_counter() - t_phase
    log(f"protocols phase: {phase_s:.3f} s")
    return {"seconds": phase_s, "entry": out["leg1"], "mempool": out["leg2"],
            "sync": out["leg3"], "renders": out["leg4"],
            "launches": totals, "card": card}


def protocols_alone() -> dict:
    """Phase 12 alone, on the card: phase 5's chain forged, a ChainDB
    holding it in place of phase 11's follower's, `_fleet_config()` run
    on a fresh TorchBackend for its fleet report, and
    `multichip.dryrun_multichip` over two shards of cuda:0 for its log.
    Prints and returns the `protocols` line's dict.

        python3 -c "import chip_smoke; chip_smoke.protocols_alone()"
    """
    import io
    from contextlib import redirect_stdout

    from ouroboros_tpu_torch import chainsynth, multichip
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.testing import run_chaos_threadnet
    from ouroboros_tpu_torch.testing import threadnet as TN

    card = smi("name,power.limit")
    log("card:", card)
    K.library()
    ext, chain, forged = chainsynth.forge_shelley(
        REPLAY_BLOCKS, epoch_length=REPLAY_EPOCH, kes_depth=REPLAY_KES_DEPTH)
    fs = MockFS()
    chainsynth.write_chaindb(fs, chain, len(chain))
    db = chainsynth.open_chaindb(fs, ext, TorchBackend())
    real = TN.OpensslBackend
    backend = TorchBackend()
    TN.OpensslBackend = lambda: backend
    try:
        fleet = run_chaos_threadnet(_chaos_configs()["_fleet_config()"]).fleet
    finally:
        TN.OpensslBackend = real
    buf = io.StringIO()
    with redirect_stdout(buf):
        multichip.dryrun_multichip(SHARDS, devices=["cuda:0"] * SHARDS)
    pr = protocols_phase(card, ext, chain, forged.ledger.state_hash(), db,
                         fleet, buf.getvalue())
    print(json.dumps({"protocols": pr}))
    return pr


def cardano_port(backend):
    """The port's side of the reference's cross-era network
    (tests/test_cardano_threadnet.py:36-146) with every node on `backend`:
    a namespace with the names `cardano_network` reads from that test
    module, so the JAX package's own module can stand in its place."""
    import types

    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.chain.block import Point
    from ouroboros_tpu_torch.consensus.hardfork.combinator import (
        ERA_FIELD, HardForkState, hfc_forge)
    from ouroboros_tpu_torch.consensus.header_validation import (
        AnnTip, HeaderState)
    from ouroboros_tpu_torch.consensus.headers import ProtocolHeader
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerState
    from ouroboros_tpu_torch.consensus.mempool import Mempool
    from ouroboros_tpu_torch.eras.byron import (
        CERT_UPDATE, ByronLedgerState, ByronTx, byron_sign_header,
        make_byron_tx)
    from ouroboros_tpu_torch.eras.cardano import (
        BYRON, SHELLEY, cardano_block_decode, cardano_setup)
    from ouroboros_tpu_torch.eras.shelley import (
        ShelleyLedgerState, ShelleyTx, TPraosState, forge_tpraos_fields)
    from ouroboros_tpu_torch.node import (BlockForging, NodeKernel,
                                          connect_nodes)
    from ouroboros_tpu_torch.node.blockchain_time import (
        HardForkBlockchainTime)
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.storage.chaindb import ChainDB
    from ouroboros_tpu_torch.utils import cbor

    def enc_state(ext):
        led, dep = ext.ledger, ext.header.chain_dep_state
        if led.era == BYRON:
            led_obj = [BYRON, [[list(e) for e in led.inner.utxo],
                               list(led.inner.delegates), led.inner.slot,
                               led.inner.tip.encode(),
                               led.inner.update_epoch]]
        else:
            s = led.inner
            led_obj = [SHELLEY, [
                [[t, i, a, m, [list(av) for av in assets]]
                 for t, i, a, m, assets in s.utxo],
                [[a, p] for a, p in s.delegs],
                [[p, v] for p, v in s.pools],
                s.epoch,
                [[p, st, v] for p, st, v in s.snap_mark],
                [[p, st, v] for p, st, v in s.snap_set],
                s.slot, s.tip.encode()]]
        if dep.era == BYRON:
            dep_obj = [BYRON, list(dep.inner)]
        else:
            t = dep.inner
            dep_obj = [SHELLEY, [t.epoch, t.eta0, t.eta_v, t.eta_c,
                                 [list(c) for c in t.counters]]]
        tip = ext.header.tip
        return [led_obj, list(led.transitions),
                None if tip is None else [tip.slot, tip.block_no, tip.hash,
                                          int(tip.is_ebb)],
                dep_obj, list(dep.transitions)]

    def dec_state(obj):
        led_obj, led_tr, tip_obj, dep_obj, dep_tr = obj
        if int(led_obj[0]) == BYRON:
            u, d, slot, tipenc, upd = led_obj[1]
            inner = ByronLedgerState(
                tuple((bytes(t), int(i), bytes(a), int(m))
                      for t, i, a, m in u),
                tuple(bytes(x) for x in d), int(slot),
                Point.decode(tipenc), int(upd))
        else:
            u, dl, pl, ep, sm, ss, slot, tipenc = led_obj[1]
            inner = ShelleyLedgerState(
                tuple((bytes(t), int(i), bytes(a), int(m),
                       tuple((bytes(x), int(q)) for x, q in assets))
                      for t, i, a, m, assets in u),
                tuple((bytes(a), bytes(p)) for a, p in dl),
                tuple((bytes(p), bytes(v)) for p, v in pl),
                int(ep),
                tuple((bytes(p), int(s), bytes(v)) for p, s, v in sm),
                tuple((bytes(p), int(s), bytes(v)) for p, s, v in ss),
                int(slot), Point.decode(tipenc))
        led = HardForkState(int(led_obj[0]), inner,
                            tuple(int(t) for t in led_tr))
        if int(dep_obj[0]) == BYRON:
            dep_inner = tuple(int(x) for x in dep_obj[1])
        else:
            ep, e0, ev, ec, cs = dep_obj[1]
            dep_inner = TPraosState(int(ep), bytes(e0), bytes(ev),
                                    bytes(ec),
                                    tuple((bytes(p), int(c))
                                          for p, c in cs))
        dep = HardForkState(int(dep_obj[0]), dep_inner,
                            tuple(int(t) for t in dep_tr))
        tip = None if tip_obj is None else AnnTip(
            int(tip_obj[0]), int(tip_obj[1]), bytes(tip_obj[2]),
            bool(tip_obj[3]))
        return ExtLedgerState(led, HeaderState(tip, dep))

    def block_decode(raw):
        return cardano_block_decode(cbor.loads(raw))

    def tx_decode(obj):
        # Byron txs (3 body fields + wits) against Shelley's (5 + wits)
        return ByronTx.decode(obj) if len(obj) == 4 \
            else ShelleyTx.decode(obj)

    def make_node(i, eras, rules, nodes):
        db = ChainDB.open(MockFS(), rules, enc_state, dec_state,
                          block_decode, backend=backend)
        ledger = rules.ledger
        mempool = Mempool(ledger, lambda db=db: (db.current_ledger.ledger,
                                                 db.tip_point()),
                          backend=backend)
        node = nodes[i]

        def tpraos_forge(p, proof, hdr, n=node):
            return forge_tpraos_fields(p, n["hot_key"], n["can_be_leader"],
                                       proof, hdr)

        # TPraos leadership and forging serve every Shelley-family era
        cbl = {BYRON: i}
        forges = {BYRON: lambda p, proof, hdr, n=node: byron_sign_header(
            n["delegate_sk"], hdr)}
        for era_ix in range(SHELLEY, len(eras)):
            cbl[era_ix] = node["can_be_leader"]
            forges[era_ix] = tpraos_forge
        forging = BlockForging(issuer=i, can_be_leader=cbl,
                               forge=hfc_forge(eras, forges))
        btime = HardForkBlockchainTime(
            lambda db=db, ledger=ledger:
                ledger.summary(db.current_ledger.ledger))
        return NodeKernel(
            db, ledger, mempool, btime, [forging], label=f"cardano{i}",
            backend=backend, chain_sync_window=8,
            header_decode=ProtocolHeader.decode,
            block_decode_obj=cardano_block_decode, tx_decode=tx_decode)

    return types.SimpleNamespace(
        sim=sim, cbor=cbor, ERA_FIELD=ERA_FIELD, CERT_UPDATE=CERT_UPDATE,
        make_byron_tx=make_byron_tx, cardano_setup=cardano_setup,
        connect_nodes=connect_nodes, _enc_state=enc_state,
        _dec_state=dec_state, _block_decode=block_decode,
        _make_node=make_node)


def cardano_network(m, ladder: bool = False) -> list:
    """The reference's cross-era network (tests/test_cardano_threadnet.py
    :157 `test_real_era_network_crosses_fork`, or :212's era ladder with
    Allegra and Mary one and two epochs after the fork), built from `m`
    (`cardano_port(backend)`, or that test module for the JAX package):
    3 nodes in a mesh, a Byron update proposal at 0.5 s announcing the
    fork, run to about slot 40 (55 for the ladder).  Returns per node
    (current chain, the immutable blocks' era tags, current ledger, the
    immutable blocks' hashes); a thread that failed raises."""
    cfg = CARDANO_NET["ladder" if ladder else "fork"]
    kw = dict(allegra_epoch=CARDANO_NET_FORK + 1,
              mary_epoch=CARDANO_NET_FORK + 2) if ladder else {}
    eras, rules, nodes = m.cardano_setup(
        CARDANO_NET_NODES, epoch_length=CARDANO_NET_EPOCH, **kw)
    sim = m.sim

    async def main():
        kernels = [m._make_node(i, eras, rules, nodes)
                   for i in range(CARDANO_NET_NODES)]
        for k in kernels:
            k.start()
        for i in range(CARDANO_NET_NODES):
            for j in range(i + 1, CARDANO_NET_NODES):
                m.connect_nodes(kernels[i], kernels[j], delay=0.02)
        # the fork is announced through the ledger: a Byron update
        # proposal submitted to one node's mempool and diffused
        upd = m.make_byron_tx(
            inputs=[], outputs=[],
            certs=[(m.CERT_UPDATE, CARDANO_NET_FORK.to_bytes(8, "big"),
                    b"")],
            signing_keys=[nodes[0]["genesis_sk"]])
        await sim.sleep(0.5)
        accepted, _rej = kernels[0].mempool.try_add_txs([upd])
        if not accepted:
            raise AssertionError("update proposal rejected by the mempool")
        await sim.sleep(cfg["run_s"])
        out = []
        for k in kernels:
            imm = [m._block_decode(raw)
                   for _entry, raw in k.chain_db.immutable.stream()]
            out.append((k.chain_db.current_chain.copy(),
                        [b.header.get(m.ERA_FIELD) for b in imm],
                        k.chain_db.current_ledger, [b.hash for b in imm]))
            for t in k._threads:
                try:
                    t.poll()
                except sim.AsyncCancelled:
                    pass
                except BaseException as e:
                    raise AssertionError(
                        f"{k.label}/{t.label} failed: {e!r}") from e
            k.stop()
        return out

    return sim.run(main(), seed=cfg["seed"])


def cardano_digest(m, results) -> list:
    """Per node: the hashes of its chain's blocks (the immutable prefix's
    decoded from storage), their era tags and its final ExtLedgerState
    as `m._enc_state`'s CBOR bytes; what two runs must share."""
    return [{"hashes": [h.hex() for h in imm_hashes]
             + [b.hash.hex() for b in chain.blocks],
             "tags": imm_tags + [b.header.get(m.ERA_FIELD)
                                 for b in chain.blocks],
             "state": m.cbor.dumps(m._enc_state(ext)).hex(),
             "head": chain.head_block_no}
            for chain, imm_tags, ext, imm_hashes in results]


def cardano_checks(results, ladder: bool) -> list:
    """The reference tests' own assertions on one network's results; the
    ones that fail."""
    from ouroboros_tpu_torch.consensus.hardfork.combinator import ERA_FIELD
    from ouroboros_tpu_torch.eras.cardano import BYRON, MARY, SHELLEY
    last = MARY if ladder else SHELLEY
    transitions = tuple(range(CARDANO_NET_FORK,
                              CARDANO_NET_FORK + last - BYRON))
    bad = []
    for n, (chain, imm_tags, ext, _imm) in enumerate(results):
        tags = imm_tags + [b.header.get(ERA_FIELD) for b in chain.blocks]
        if set(tags) != set(range(BYRON, last + 1)) or tags != sorted(tags):
            bad.append(f"node {n}: era tags {tags}")
        if (ext.ledger.era, ext.ledger.transitions) != (last, transitions):
            bad.append(f"node {n}: era {ext.ledger.era}, transitions "
                       f"{ext.ledger.transitions}")
        if any(b.slot < CARDANO_NET_FORK * CARDANO_NET_EPOCH
               for b in chain.blocks if b.header.get(ERA_FIELD) != BYRON):
            bad.append(f"node {n}: a block past Byron before the fork slot")
    heads = [r[0].head_block_no for r in results]
    if max(heads) - min(heads) > 2 or (not ladder and min(heads) < 10):
        bad.append(f"heads {heads}")
    return bad


def _flip(b: bytes, i: int, bit: int = 1) -> bytes:
    return b[:i] + bytes([b[i] ^ bit]) + b[i + 1:]


def _tile(bases: list, tampers: tuple, n: int) -> tuple:
    """n lanes cycling through `bases`; lane j with j % 7 == 6 takes
    tamper (j // 7) % len(tampers) of its base, so every tamper meets
    every base.  Returns (lanes, tampered flags)."""
    every = GOLDEN_TAMPER_EVERY
    lanes, bad = [], []
    for j in range(n):
        x = bases[j % len(bases)]
        hit = j % every == every - 1
        lanes.append(tampers[(j // every) % len(tampers)](x) if hit else x)
        bad.append(hit)
    return lanes, bad


class _CardCalls:
    """Wraps a backend's batch methods to sum the host's seconds inside
    them (outermost calls only), which on TorchBackend is the time the
    node waited on the card."""
    METHODS = ("verify_ed25519_batch", "verify_vrf_batch", "verify_kes_batch",
               "vrf_betas_batch", "verify_mixed", "submit_window",
               "finish_window")

    def __init__(self, backend):
        self.calls, self.secs, self._depth = 0, 0.0, 0
        for name in self.METHODS:
            if hasattr(backend, name):
                setattr(backend, name, self._timed(getattr(backend, name)))

    def _timed(self, fn):
        def call(*a, **kw):
            self._depth += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.calls += 1
                    self.secs += time.perf_counter() - t
        return call


def _launched(before: dict) -> dict:
    from ouroboros_tpu_torch.crypto import kernels as K
    return {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}


def golden_leg(dev) -> dict:
    """Phase 13 leg 1: the golden Shelley header's bytes through the
    port.  Parsed and re-encoded byte for byte, validated through
    `SC.validate_header` on a fresh TorchBackend; then its OCert Ed25519
    request tiled to 4096 lanes, its two VRF certificates to 2048, its
    Sum6 KES path's Blake2b jobs to 8192 and the two libsodium proofs to
    2048 lanes of gamma8, every 7th lane tampered (a different field in
    turn), each kernel held exactly against its plain version and every
    lane's verdict against the CPU references (ed25519_ref, vrf_ref,
    hashlib), every tampered lane rejected and every untampered beta the
    libsodium output; `kernels.batch_verify_ed25519` and `vrf.batch_betas`
    on the same lanes as a caller runs them.  Launches counted are those
    of validate_header and the two batch calls, not of the comparisons.
    The tiled lanes hold a handful of distinct inputs, so each CPU
    reference runs once an input (functools.cache)."""
    import dataclasses
    import functools
    import hashlib

    import torch

    from ouroboros_tpu_torch.crypto import (ed25519 as E, ed25519_ref,
                                            edwards as ed, kernels as K,
                                            vrf as V, vrf_ref)
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.eras import shelley_cbor as SC

    t_leg = time.perf_counter()
    cuda = dev.type == "cuda"
    alphas = tuple(hashlib.blake2b(bytes([i]), digest_size=32).digest()
                   for i in (0, 1))
    raw = bytes.fromhex(GOLDEN_HEADER_HEX)
    hdr = SC.parse_header(raw)
    b = hdr.body
    if (b.block_no, b.slot) != (3, 9) or hdr.to_wrapped_cbor() != raw or \
            (b.nonce_vrf.output, b.nonce_vrf.proof, b.leader_vrf.output,
             b.leader_vrf.proof) != (NONCE_OUT, NONCE_PROOF, LEADER_OUT,
                                     LEADER_PROOF):
        raise AssertionError("golden header: parse or re-encoding differs")
    counted = dict(K.LAUNCHES)
    t = time.perf_counter()
    if not SC.validate_header(hdr, *alphas, TorchBackend(dev)):
        raise AssertionError("golden header rejected by TorchBackend")
    validate_s = time.perf_counter() - t
    validate_launches = _launched(counted)
    if cuda and any(validate_launches[k] == 0 for k in UNFOLDED_PATH):
        raise AssertionError(f"golden header: a window kernel did not "
                             f"launch {validate_launches}")
    log(f"conformance leg 1: the golden Shelley header parses, re-encodes "
        f"byte for byte and validates through TorchBackend in "
        f"{validate_s:.3f} s, launches {validate_launches}")
    vrf_nonce, vrf_leader, kes_req, ocert = SC.header_proof_requests(
        hdr, *alphas)
    aux = TorchBackend(dev)
    edit = dataclasses.replace
    L_bytes = ed.L.to_bytes(32, "little")
    bad_pt = next(y for y in range(2, 100)
                  if ed.decompress(y.to_bytes(32, "little")) is None
                  ).to_bytes(32, "little")
    max_err, rows = {}, {}

    def exact(name, host):
        with aux._on_stream():
            args = tuple(aux._dev(a) for a in host)
        got = getattr(K, name)(*args)
        want = K.KERNELS[name].plain(*args)
        if cuda:
            torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err[name] = err
        if tuple(got.shape) != tuple(want.shape) or err:
            raise AssertionError(f"golden {name}: kernel != plain version "
                                 f"(max abs err {err})")
        return got.cpu().numpy()

    def agree(name, got, want, bad, expect=None):
        """Every lane's verdict the reference's, every tampered lane
        rejected, every untampered lane accepted (or its beta the
        libsodium output)."""
        wrong = [j for j in range(len(got)) if got[j] != want[j]]
        if expect is None:
            passed = [j for j in range(len(got)) if bad[j] and got[j]]
            failed = [j for j in range(len(got)) if not bad[j]
                      and not got[j]]
        else:
            passed = [j for j in range(len(got))
                      if bad[j] and got[j] == expect[j]]
            failed = [j for j in range(len(got))
                      if not bad[j] and got[j] != expect[j]]
        if wrong or passed or failed:
            raise AssertionError(
                f"golden {name}: lanes unlike the CPU reference "
                f"{wrong[:8]}, tampered lanes passed {passed[:8]}, valid "
                f"lanes failed {failed[:8]}")
        rows[name] = {"lanes": len(got), "tampered": sum(bad)}
        log(f"golden {name}: kernel == plain version on {len(got)} lanes "
            f"(tolerance 0), every lane == the CPU reference, "
            f"{sum(bad)} tampered lanes rejected")

    # Ed25519: the OCert, through the split kernel and the full verify
    n = GOLDEN_LANES["ed25519_split"]
    ed_lanes, ed_bad = _tile([ocert], (
        lambda r: edit(r, msg=_flip(r.msg, 0)),
        lambda r: edit(r, sig=_flip(r.sig, 0)),          # R
        lambda r: edit(r, sig=_flip(r.sig, 40)),         # s
        lambda r: edit(r, vk=_flip(r.vk, 3)),            # A
        lambda r: edit(r, sig=r.sig[:32] + L_bytes)), n)  # s >= L
    ed_ref = functools.cache(ed25519_ref.verify)
    want = [ed_ref(r.vk, r.msg, r.sig) for r in ed_lanes]
    host, ok = aux._prep_ed(ed_lanes, n)
    got = exact("ed25519_split", host).astype(bool) & ok
    agree("ed25519_split", list(got), want, ed_bad)
    n = GOLDEN_LANES["ed25519_verify"]
    vks, msgs, sigs = ([getattr(r, f) for r in ed_lanes[:n]]
                       for f in ("vk", "msg", "sig"))
    arrays, parse = E.prepare_words_batch(vks, msgs, sigs)
    got = exact("ed25519_verify", arrays).astype(bool) & parse
    agree("ed25519_verify", list(got), want[:n], ed_bad[:n])
    before = dict(K.LAUNCHES)
    batch = K.batch_verify_ed25519(vks, msgs, sigs, device=dev)
    batch_launches = _launched(before)
    if batch != list(got):
        raise AssertionError("golden: batch_verify_ed25519 != the kernel's "
                             "lanes")
    # ECVRF: both certificates, through vrf_verify
    n = GOLDEN_LANES["vrf_verify"]
    vrf_lanes, vrf_bad = _tile([vrf_nonce, vrf_leader], (
        lambda r: edit(r, alpha=r.alpha + b"!"),
        lambda r: edit(r, proof=_flip(r.proof, 0)),      # Gamma
        lambda r: edit(r, proof=_flip(r.proof, 33)),     # c
        lambda r: edit(r, proof=_flip(r.proof, 50)),     # s
        lambda r: edit(r, vk=_flip(r.vk, 1))), n)        # Y
    vrf_ref_ok = functools.cache(vrf_ref.verify)
    want = [vrf_ref_ok(r.vk, r.alpha, r.proof) for r in vrf_lanes]
    host, (p_ok, g_ok, s_ok, pf) = aux._prep_vrf(vrf_lanes, n)
    oks, betas = V._finish(exact("vrf_verify", host), p_ok, g_ok, s_ok, pf,
                           n)
    agree("vrf_verify", oks, want, vrf_bad)
    outs = [NONCE_OUT, LEADER_OUT]
    if any(betas[j] != outs[j % 2] for j in range(n) if not vrf_bad[j]):
        raise AssertionError("golden vrf_verify: an untampered beta is not "
                             "the libsodium output")
    # betas: the two libsodium proofs through gamma8
    n = GOLDEN_LANES["gamma8"]
    proofs, beta_bad = _tile([NONCE_PROOF, LEADER_PROOF], (
        lambda p: _flip(p, 0),                           # another Gamma
        lambda p: bad_pt + p[32:],                       # Gamma off curve
        lambda p: _flip(p, 31, 0x80)), n)                # Gamma's sign

    def beta_of(p):
        try:
            return vrf_ref.proof_to_hash(p)
        except ValueError:
            return None
    beta_ref = functools.cache(beta_of)
    host, dec = aux._prep_betas(proofs, n)
    got = V._finish_betas(exact("gamma8", host), dec, n)
    expect = [outs[j % 2] for j in range(n)]
    agree("gamma8", got, [beta_ref(p) for p in proofs], beta_bad, expect)
    before = dict(K.LAUNCHES)
    batch = V.batch_betas(proofs, device=dev)
    batch_launches = {k: v + batch_launches[k]
                      for k, v in _launched(before).items()}
    if batch != got:
        raise AssertionError("golden: vrf.batch_betas != the kernel's lanes")
    # Sum6 KES: the signature's Merkle path as Blake2b jobs, through
    # kes_hash (its leaf signature is one more Ed25519 request)
    n = GOLDEN_LANES["kes_hash"]
    _e, _eo, _v, _vo, kes_msgs, kes_exps, _kc, _n = \
        aux._split_mixed_device([kes_req])
    jobs, kes_bad = _tile(list(zip(kes_msgs, kes_exps)), (
        lambda j: (_flip(j[0], 0), j[1]),                # message's first
        lambda j: (j[0], _flip(j[1], 31)),               # digest's last
        lambda j: (_flip(j[0], 40), j[1])), n)           # a Merkle node
    kes_ref = functools.cache(lambda m, e: hashlib.blake2b(
        m, digest_size=32).digest() == e)
    host = aux._prep_kes_hash([m for m, _e in jobs], [e for _m, e in jobs],
                              n)
    got = exact("kes_hash", host).astype(bool)
    agree("kes_hash", list(got), [kes_ref(m, e) for m, e in jobs], kes_bad)
    rows["kes_hash"]["jobs"] = len(kes_msgs)
    leg_s = time.perf_counter() - t_leg
    log(f"conformance leg 1: {leg_s:.3f} s")
    return {"seconds": leg_s, "validate_s": validate_s, "lanes": rows,
            "max_abs_err": max_err,
            "launches": {k: validate_launches[k] + batch_launches[k]
                         for k in K.LAUNCHES}}


def cardano_leg(dev) -> dict:
    """Phase 13 leg 2: the reference's two cross-era networks, each on a
    fresh TorchBackend and on CppBackend; per node the block hashes, era
    tags and encoded final ExtLedgerState equal, the reference's checks
    met on both, each of the four window kernels launched on the card."""
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

    out = {}
    for name, cfg in CARDANO_NET.items():
        runs = {}
        for which in ("card", "cpp"):
            backend = TorchBackend(dev) if which == "card" else CppBackend()
            calls = _CardCalls(backend)
            m = cardano_port(backend)
            before = dict(K.LAUNCHES)
            t = time.perf_counter()
            res = cardano_network(m, cfg["ladder"])
            runs[which] = {"wall_s": time.perf_counter() - t,
                           "calls": calls.calls, "call_s": calls.secs,
                           "launches": _launched(before),
                           "digest": cardano_digest(m, res),
                           "failed_checks": cardano_checks(res,
                                                           cfg["ladder"])}
        card, cpp = runs["card"], runs["cpp"]
        missing = [k for k in UNFOLDED_PATH if card["launches"][k] == 0] \
            if dev.type == "cuda" else []
        same = card["digest"] == cpp["digest"]
        if not same or card["failed_checks"] or cpp["failed_checks"] or \
                missing:
            raise AssertionError(
                f"conformance leg 2 {name}: card == CppBackend {same}; "
                f"failed checks {card['failed_checks']} / "
                f"{cpp['failed_checks']}; kernels not launched {missing}")
        heads = [d["head"] for d in card["digest"]]
        out[name] = {
            "heads": heads, "era_tags": card["digest"][0]["tags"],
            "card_s": card["wall_s"], "card_calls": card["calls"],
            "card_call_s": card["call_s"], "cpp_s": cpp["wall_s"],
            "cpp_call_s": cpp["call_s"], "launches": card["launches"]}
        log(f"conformance leg 2 {name}: {CARDANO_NET_NODES} nodes, card == "
            f"CppBackend (block hashes, era tags, encoded final state of "
            f"every node), the reference's checks pass on both; heads "
            f"{heads}; {card['wall_s']:.3f} s on the card ({card['calls']} "
            f"card calls, {card['call_s']:.3f} s), {cpp['wall_s']:.3f} s "
            f"on CppBackend; launches {card['launches']}")
    return out


def rekey_setup():
    """tests/test_threadnet_scale.py's rekeying configuration: two pools,
    k = 3, f = 1/2, 30-slot epochs, 8-slot KES periods at depth 4.
    Returns (cfg, protocol, ledger, pools, ExtLedgerRules)."""
    from fractions import Fraction

    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.eras.shelley import (TPraosConfig,
                                                  shelley_genesis_setup)
    cfg = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=30,
                       slots_per_kes_period=8, kes_depth=4,
                       max_kes_evolutions=14)
    protocol, ledger, pools = shelley_genesis_setup(2, cfg, seed=b"rekey")
    return cfg, protocol, ledger, pools, ExtLedgerRules(protocol, ledger)


def forge_span(protocol, ledger, ext, pools, state, prev, start_slot,
               n_blocks, backend):
    """Forge n_blocks from start_slot on, the first of `pools` that leads
    a slot signing it, each block applied to `state` through `backend`
    (a header the OCert rules refuse raises HeaderError).  Returns
    (blocks, state, last header, next slot)."""
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       make_header)
    from ouroboros_tpu_torch.eras.shelley import forge_tpraos_fields
    blocks = []
    slot = start_slot
    while len(blocks) < n_blocks:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            h = make_header(prev, slot, (), issuer=0)
            h = forge_tpraos_fields(protocol, p["hot_key"],
                                    p["can_be_leader"], lead, h)
            blk = ProtocolBlock(h, ())
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
        slot += 1
    return blocks, state, prev, slot


def rekey(cfg, pools, ix, at_slot, counter):
    """Issue pool ix a fresh KES key and an OCert at `counter`, starting
    at the KES period of `at_slot`."""
    import hashlib
    from dataclasses import replace

    from ouroboros_tpu_torch.consensus.protocols.praos import HotKey
    from ouroboros_tpu_torch.crypto import kes
    from ouroboros_tpu_torch.eras.shelley import make_ocert
    p = pools[ix]
    key = kes.KesSignKey(cfg.kes_depth, hashlib.blake2b(
        b"rekey-seed:%d:%d" % (ix, counter), digest_size=32).digest())
    ocert = make_ocert(p["keys"].cold_sk, key.verification_key,
                       counter=counter,
                       kes_period_start=at_slot // cfg.slots_per_kes_period)
    pools[ix] = dict(p, hot_key=HotKey(key),
                     can_be_leader=replace(p["can_be_leader"], ocert=ocert))


def rekey_runs(backend) -> dict:
    """The three rekeying cases of tests/test_threadnet_scale.py on
    `backend`: a pool rekeyed at counter 1 mid-run (24 blocks, replayed
    from genesis by `validate_blocks_batched`), a jump to counter 2 and a
    stale counter-0 certificate once counter 1 is on the chain, each of
    the last two refused.  Returns what two backends must share."""
    import copy

    from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
    from ouroboros_tpu_torch.consensus.header_validation import HeaderError
    cfg, protocol, ledger, pools, ext = rekey_setup()
    b1, state, prev, slot = forge_span(protocol, ledger, ext, pools,
                                       ext.initial_state(), None, 0, 12,
                                       backend)
    rekey(cfg, pools, 0, slot, 1)
    b2, _state, _prev, _slot = forge_span(protocol, ledger, ext, pools,
                                          state, prev, slot, 12, backend)
    res = validate_blocks_batched(ext, b1 + b2, ext.initial_state(),
                                  backend=backend)
    pid = pools[0]["can_be_leader"].pool_id
    out = {"hashes": [b.hash.hex() for b in b1 + b2],
           "all_valid": res.all_valid,
           "state_hash": res.final_state.ledger.state_hash().hex(),
           "counter": res.final_state.header.chain_dep_state.counter_of(pid)}
    for case, counter in (("jump", 2), ("stale", 1)):
        cfg, protocol, ledger, pools, ext = rekey_setup()
        stale = dict(pools[0], hot_key=copy.deepcopy(pools[0]["hot_key"]))
        _b, state, prev, slot = forge_span(protocol, ledger, ext, pools,
                                           ext.initial_state(), None, 0, 6,
                                           backend)
        rekey(cfg, pools, 0, slot, counter)
        pid = pools[0]["can_be_leader"].pool_id
        while case == "stale" and \
                state.header.chain_dep_state.counter_of(pid) != 1:
            _b, state, prev, slot = forge_span(protocol, ledger, ext, pools,
                                               state, prev, slot, 1, backend)
        try:
            forge_span(protocol, ledger, ext,
                       [pools[0] if case == "jump" else stale], state, prev,
                       slot, 1, backend)
        except HeaderError as e:
            out[case] = str(e)
        else:
            out[case] = None
    return out


def restart_leg(dev) -> dict:
    """Phase 13 leg 3: the restart configuration with every node on one
    fresh TorchBackend and on CppBackend (equal chains and encoded
    ledgers, the reference's checks met), and the rekeying cases on both
    (equal blocks and final state, counter 1 recorded, the counter jump
    and the stale certificate refused with the same errors)."""
    from ouroboros_tpu_torch.crypto import kernels as K
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    from ouroboros_tpu_torch.testing import ThreadNetConfig, run_threadnet
    from ouroboros_tpu_torch.testing import threadnet as TN
    from ouroboros_tpu_torch.utils import cbor

    # tests/test_threadnet_scale.py's: 4 mock-Praos nodes in a mesh for 60
    # slots, node 1 restarted from its own files at slot 25, node 2 at 40
    cfg = ThreadNetConfig(n_nodes=4, n_slots=60, k=8, f=0.5, seed=11,
                          restart_plan=((25, 1), (40, 2)))
    runs = {}
    real = TN.OpensslBackend
    for which in ("card", "cpp"):
        backend = TorchBackend(dev) if which == "card" else CppBackend()
        calls = _CardCalls(backend)
        TN.OpensslBackend = lambda: backend
        before = dict(K.LAUNCHES)
        t = time.perf_counter()
        try:
            r = run_threadnet(cfg)
        finally:
            TN.OpensslBackend = real
        heads = [c.head_block_no for c in r.chains]
        runs[which] = {
            "wall_s": time.perf_counter() - t, "calls": calls.calls,
            "call_s": calls.secs, "launches": _launched(before),
            "heads": heads,
            "chains": [[p.encode() for p in c.points()] for c in r.chains],
            "ledgers": [cbor.dumps(TN.PraosNetworkFactory.enc_state(x))
                        for x in r.ledgers],
            "ok": not r.failures and r.common_prefix_ok(cfg.k)
            and r.min_length() >= 15 and max(heads) - min(heads) <= 3}
    card, cpp = runs["card"], runs["cpp"]
    missing = [k for k in UNFOLDED_PATH if card["launches"][k] == 0] \
        if dev.type == "cuda" else []
    same = (card["chains"], card["ledgers"]) == (cpp["chains"],
                                                 cpp["ledgers"])
    if not same or not card["ok"] or not cpp["ok"] or missing:
        raise AssertionError(
            f"conformance leg 3 restarts: card == CppBackend {same}, the "
            f"reference's checks {card['ok']} / {cpp['ok']}, heads "
            f"{card['heads']} / {cpp['heads']}; kernels not launched "
            f"{missing}")
    log(f"conformance leg 3 restarts: {cfg.n_nodes} nodes, {cfg.n_slots} "
        f"slots, restarts {cfg.restart_plan}: card == CppBackend (chains, "
        f"encoded ledgers), heads {card['heads']}; {card['wall_s']:.3f} s "
        f"on the card ({card['calls']} card calls, {card['call_s']:.3f} "
        f"s), {cpp['wall_s']:.3f} s on CppBackend; launches "
        f"{card['launches']}")
    rk = {}
    for which in ("card", "cpp"):
        backend = TorchBackend(dev) if which == "card" else CppBackend()
        calls = _CardCalls(backend)
        before = dict(K.LAUNCHES)
        t = time.perf_counter()
        rk[which] = {"result": rekey_runs(backend),
                     "wall_s": time.perf_counter() - t,
                     "calls": calls.calls, "call_s": calls.secs,
                     "launches": _launched(before)}
    got, want = rk["card"]["result"], rk["cpp"]["result"]
    if got != want or not got["all_valid"] or got["counter"] != 1 or \
            "jumps past" not in (got["jump"] or "") or \
            "regressed" not in (got["stale"] or ""):
        raise AssertionError(f"conformance leg 3 rekeying: card {got}, "
                             f"CppBackend {want}")
    log(f"conformance leg 3 rekeying: {len(got['hashes'])} blocks across a "
        f"rekey valid, counter 1 recorded, the jump ({got['jump']!r}) and "
        f"the stale certificate ({got['stale']!r}) refused, card == "
        f"CppBackend; {rk['card']['wall_s']:.3f} s on the card "
        f"({rk['card']['calls']} card calls, {rk['card']['call_s']:.3f} s),"
        f" {rk['cpp']['wall_s']:.3f} s on CppBackend; launches "
        f"{rk['card']['launches']}")
    return {"restart": {
                "nodes": cfg.n_nodes, "slots": cfg.n_slots,
                "restart_plan": [list(x) for x in cfg.restart_plan],
                "heads": card["heads"], "card_s": card["wall_s"],
                "card_calls": card["calls"], "card_call_s": card["call_s"],
                "cpp_s": cpp["wall_s"], "cpp_call_s": cpp["call_s"],
                "launches": card["launches"]},
            "rekey": {
                "blocks": len(got["hashes"]), "jump": got["jump"],
                "stale": got["stale"], "card_s": rk["card"]["wall_s"],
                "card_calls": rk["card"]["calls"],
                "card_call_s": rk["card"]["call_s"],
                "cpp_s": rk["cpp"]["wall_s"],
                "cpp_call_s": rk["cpp"]["call_s"],
                "launches": rk["card"]["launches"]}}


def conformance_phase(card: str, dev) -> dict:
    """Phase 13: the reference's conformance surface on the card (the
    golden header's bytes through the window kernels, the cross-era
    networks, restarts and rekeying).  Returns the `conformance` line's
    dict; launches are those of the counted calls of the three legs."""
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    t_phase = time.perf_counter()
    GLOBAL_BETA_CACHE.clear()
    golden = golden_leg(dev)
    nets = cardano_leg(dev)
    scale = restart_leg(dev)
    legs = [golden] + list(nets.values()) + list(scale.values())
    totals = {k: sum(leg["launches"][k] for leg in legs)
              for k in golden["launches"]}
    phase_s = time.perf_counter() - t_phase
    log(f"conformance phase: {phase_s:.3f} s, launches {totals}")
    return {"seconds": phase_s, "golden": golden, "cardano": nets, **scale,
            "launches": totals, "card": card}


def conformance_alone() -> dict:
    """Phase 13 alone, on the card; prints and returns the `conformance`
    line's dict.

        python3 -c "import chip_smoke; chip_smoke.conformance_alone()"
    """
    import torch

    from ouroboros_tpu_torch.crypto import kernels as K
    card = smi("name,power.limit")
    log("card:", card)
    K.library()
    cf = conformance_phase(card, torch.device("cuda"))
    print(json.dumps({"conformance": cf}))
    return cf


def bench_phase(card: str) -> dict:
    """Phase 14: the port's bench smoke on the card.  Every gate of
    `bench.smoke` must pass (it raises SystemExit otherwise) and each of
    the four window kernels must launch in it.  Returns the `bench_smoke`
    line's dict."""
    from ouroboros_tpu_torch import bench
    from ouroboros_tpu_torch.crypto import kernels as K
    t_phase = time.perf_counter()
    K.reset_launches()
    res = bench.smoke(device="cuda")
    launches = dict(K.LAUNCHES)
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the bench smoke: "
                             f"{missing}")
    phase_s = time.perf_counter() - t_phase
    log(f"bench phase: {phase_s:.3f} s, launches {launches}")
    return {"seconds": phase_s, "smoke": res, "launches": launches,
            "card": card}


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
            field as F, fold as FD, kernels as K, vrf as V, vrf_ref)
        from ouroboros_tpu_torch.crypto.backend import (
            CpuRefBackend, Ed25519Req, VrfReq)
        from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
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
    # the verdict fold over the four kernels' packed buffer, as a window
    # has it: each lane owned by its own request (the Ed25519 lanes first),
    # lanes the host parse rejected and padding at FOLD_SENT
    ne, nv, nb, nk = (inputs[k][0].shape[-1] for k in UNFOLDED_PATH)
    fold_packed = torch.cat([
        K.ed25519_split(*ed_args).to(torch.uint8),
        K.vrf_verify(*vrf_args).reshape(-1),
        K.gamma8(*beta_args).reshape(-1),
        K.kes_hash(*kes_args).to(torch.uint8)])
    ed_own = np.where([k < len(ed_t) and ed_ok[k] for k in range(ne)],
                      np.arange(ne), FD.FOLD_SENT)
    vrf_own = np.where([j < len(vrf_t) and v_ok[j] for j in range(nv)],
                       ne + np.arange(nv), FD.FOLD_SENT)
    inputs["window_fold"] = (fold_packed, ne, nv, nb, nk, *(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (ed_own.astype(np.int32), vrf_own.astype(np.int32),
                  v_pf[:, :32], v_pf[:, 32:48])))
    # the chain kernels at the JAX shape, the longer chain of mul and dbl
    chains = [name for name, _o, _k in microbench_field.CHAINS]
    ma, mb = microbench_field.inputs(CHAIN_LANES[0], dev)
    for name, ops, (_k1, k2) in microbench_field.CHAINS:
        inputs[name] = (ma, mb, ops[0], k2)
    lanes = {k: v[0].shape[-1] for k, v in inputs.items()}
    lanes["window_fold"] = ne + nv
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
    # the fold's first failing request: the lowest lane the host parse
    # passed and the card failed, the VRF challenge checked on the host
    oks_all, _b = V._finish(outputs["vrf_verify"], v_ok, v_gok, v_sok, v_pf,
                            len(vrf_t))
    want_bad = min([FD.FOLD_SENT]
                   + [k for k in range(len(ed_t)) if ed_ok[k]
                      and not ed_got[k]]
                   + [ne + j for j in range(len(vrf_t)) if v_ok[j]
                      and not oks_all[j]])
    got_bad = int.from_bytes(outputs["window_fold"][:4].tobytes(), "little")
    if got_bad != want_bad:
        raise AssertionError(f"window_fold: first failing request "
                             f"{got_bad}, the host's {want_bad}")
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
        elif name == "window_fold":
            ops = nv * FD.INT_OPS
        elif name in chains:
            ops = microbench_field.int_ops(args[2], args[3], n)
        else:
            one = [a[..., :1].cpu() for a in args]
            F.COUNTS.update(mul=0, sqr=0)
            K.KERNELS[name].plain(*one)
            ops = n * (100 * F.COUNTS["mul"] + 55 * F.COUNTS["sqr"])
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if torch.is_tensor(a)) + outputs[name].nbytes
        ops_ms = ops / (issue_rate if name in ("kes_hash", "window_fold")
                        else int_rate) * 1e3
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
    fold_ms = next(e["plain_ms"] for e in report
                   if e["name"] == "window_fold")
    wit = [r.vk for b in windows[0] for r in b[windowgen.FIRST_WITNESS:]]
    yw, sgn, _ok = E._decode_compressed(
        np.frombuffer(b"".join(wit), np.uint8).reshape(-1, 32))
    ya = F.limbs_from_words(torch.from_numpy(yw).to(dev))
    sg = torch.from_numpy(sgn).to(dev)
    fill_ms = D.event_ms(lambda: E.a128_core(ya, sg), reps=5)
    log(f"fold's plain version (torch ops, {ne}/{nv}/{nb}/{nk} lanes): "
        f"{fold_ms:.3f} ms; a128 fill (torch ops, {len(wit)} keys): "
        f"{fill_ms:.3f} ms")

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

    # -- 9. the chain database ----------------------------------------------
    cd = chaindb_phase(card, *replayed, tampered_chains)

    # -- 10. the node-to-node sync path -------------------------------------
    nd = node_phase(card, *replayed, tampered_chains)

    # -- 11. the diffusion slice ---------------------------------------------
    df = diffusion_phase(card, *replayed, nd["sync"])

    # -- 12. the protocols and tools ------------------------------------------
    pr = protocols_phase(card, *replayed, df.pop("follower_db"),
                         df.pop("fleets")["_fleet_config()"],
                         sh.pop("multichip_log"))

    # -- 13. the reference's conformance surface ----------------------------
    cf = conformance_phase(card, dev)
    for name, err in cf["golden"]["max_abs_err"].items():
        max_err[name] = max(max_err[name], err)

    # -- 14. the port's bench ------------------------------------------------
    bp = bench_phase(card)

    # -- 15. the standalone batch-verify path -------------------------------
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

    # -- 16. the field microbenchmark path ----------------------------------
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

    # -- 17. report -----------------------------------------------------------
    serve_launches = sv["card"]["saturated"]["launches"]
    for entry in report:
        name = entry["name"]
        entry["max_abs_err"] = max_err[name]
        entry["serve_launches"] = serve_launches[name]
        entry["chaindb_launches"] = cd["launches"][name]
        entry["node_launches"] = nd["launches"][name]
        entry["diffusion_launches"] = df["launches"][name]
        entry["protocols_launches"] = pr["launches"][name]
        entry["conformance_launches"] = cf["launches"][name]
        entry["bench_launches"] = bp["launches"][name]
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
    print(json.dumps({"chaindb": cd}))
    print(json.dumps({"node": nd}))
    print(json.dumps({"diffusion": df}))
    print(json.dumps({"protocols": pr}))
    print(json.dumps({"conformance": cf}))
    print(json.dumps({"bench_smoke": bp}))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
