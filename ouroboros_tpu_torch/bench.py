"""Benchmark: the Shelley-path db-validate replay on the card against the
sequential CPU baseline.

    python -m ouroboros_tpu_torch.bench [--smoke] [--serve [--serve-seed 7]]
        [--mesh N] [--device cuda|cpu]

Prints ONE JSON line:
  {"metric": "shelley_replay_proofs_per_sec", "value": N,
   "unit": "proofs/s", "vs_baseline": N, ...}

Workload: a TPraos chain of BLOCKS blocks (TXS transactions a block, 2
pools, f = 4/5, epoch length EPOCH_LEN, KES depth 10), forged by
`python -m ouroboros_tpu_torch.db_synth` into a temporary directory and
read back through `db_analyser.load_db`.  Each header carries 2 ECVRF
proofs, 1 KES signature and 1 OCert Ed25519 signature; each body its
transaction witnesses.  The chain is replayed through
`consensus/batch.py:replay_blocks_pipelined` in windows of WINDOW blocks
with full proof verification, and the final `state_hash` is held equal
across backends.

Baseline: the same replay on `CppBackend` (crypto/cpp_backend.py: one
core of C++ Ed25519 and ECVRF).  If it cannot be built the bench raises;
there is no step down to another CPU backend.

Measurement: CPU_REPS baseline replays; the kernel library built (or
loaded) and the card brought up, outside every clock (`build_secs`);
then one `TimingBackend(TorchBackend(device))`: warm-up 1, which is cold
and fills the backend's per-key cache (its wall time is
`cold_replay_secs`; `cold` splits it by phase from its spans and gives
the fills' own seconds), warm-up 2, which is warm, then REPS timed replays, each with the beta
cache cleared and spans recorded.  Each rep's state hash must equal the
baseline's, and the reps must run no per-key fill: `warm_extra_fills`
is read from that backend's own cache (`jb.cache.device_fills`), since
each `TorchBackend` keeps a cache of its own where the JAX package
shares one process-wide cache.  The cyclic GC is off inside each timed
rep and the card is synchronised before it.

Beside the replay: the three primitives (4096 Ed25519, 2048 VRF and
4096 KES depth-6 requests on a fresh backend), a `stream` leg (the same
chain from disk through `storage/stream.py`, read-ahead 4, a snapshot
every EPOCH_LEN slots, then a resumed reopen) and, with `--mesh N`, a
`sharded` leg over `ShardedTorchBackend` on N devices (on `[device] * N`,
N shards on one card, where fewer cards are present).

`--smoke` is the small parity gate (8 blocks, window 8, one replay on
the CPU baseline and one on `TorchBackend(device, min_bucket=16)`, with
the probes of the reference's smoke); `--serve` runs the serve path's
simulated legs (`serve.sim_legs`) and prints the `verify_service_serve`
line.  The serve path's card legs are `python -m
ouroboros_tpu_torch.serve`.

Runs on the CUDA card unless `--device cpu` (or `device="cpu"`) is
given; without a card it raises before it forges anything.

Ported from `bench.py` (the port imports nothing of the JAX package, of
`tools/` or of that file).  Changed:

- the line's `kernel_choices` is `kernel_launches`: the launches of each
  CUDA kernel over the timed reps (`crypto/kernels.LAUNCHES`), beside
  `kernel_launches_cold`, warm-up 1's.  In the warm reps every KES hash
  path is served from the cache, so `kes_hash` launches in the cold run
  only;
- `device` holds the card's name, power limit in W and count
  (`nvidia-smi --query-gpu=name,power.limit`); `build_secs`,
  `cold_replay_secs` (warm-up 1's wall time, by the reps' clock), `cold`,
  `blocks`, `proofs`, `cpu_reps`, `synth_secs` (the forging seconds) and
  `warm_extra_fills` are written out;
- there is no `vrf_attribution`: its note explains a regression of the
  JAX package's rounds by its autotune keys and the TPU host's link;
- there is no `--retune` and no tuner freeze: the port has no tuner;
- history is read from `BENCH_GPU_r*.json` only, never from the TPU's
  `BENCH_r*.json` or `MULTICHIP_r*.json`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from . import device as device_mod
from .observe.spans import PHASES as PHASE_ORDER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 10k blocks in windows of 1024: per window one packed submit carrying the
# VRF batch, the Ed25519 batch (OCert + KES leaves + witnesses), the cold
# KES paths and the next window's betas, overlapped with the host pass
BLOCKS = 10000
TXS = 2
WINDOW = 1024
EPOCH_LEN = 600
KES_DEPTH = 10
# every timed quantity is the median of REPS repetitions with its spread
REPS = 5
CPU_REPS = 2
SPREAD_WARN = 0.30
# the primitives' batch sizes: the window's Ed25519 and VRF lanes, and
# the KES requests of the reference's primitive
PRIM_ED, PRIM_VRF, PRIM_KES = 4096, 2048, 4096

ROUND_GLOB = "BENCH_GPU_r*.json"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def median_spread(vals):
    """(median, spread) where spread = (max-min)/median."""
    med = statistics.median(vals)
    return med, ((max(vals) - min(vals)) / med if med else 0.0)


def check_spread(name, vals):
    med, spread = median_spread(vals)
    if spread > SPREAD_WARN:
        # the min rides along: close to the median, the spread is a slow
        # tail; the median close to the max, the warm path is unstable
        log(f"WARNING: {name} spread {100 * spread:.0f}% over {len(vals)} "
            f"reps exceeds {100 * SPREAD_WARN:.0f}% — treat the median "
            f"with suspicion, prefer min {min(vals):.3f}s vs median "
            f"{med:.3f}s (vals: {[round(v, 3) for v in vals]})")
    return med, spread


def _rep_phase_totals(observe, roots, rep_secs: float) -> dict:
    """One timed rep's seconds per phase from its drained span forest.
    `other` is the rep wall time no span claimed."""
    totals = observe.phase_totals(roots)
    out = {ph: round(totals.get(ph, 0.0), 4) for ph in PHASE_ORDER}
    claimed = sum(totals.values())
    out["other"] = round(max(0.0, rep_secs - claimed), 4)
    return out


def _phase_variance(rep_phases) -> dict:
    """Cross-rep stats per phase + the phase with the largest spread,
    ranked by absolute spread (max-min seconds): the phase that moved
    the rep totals most."""
    if not rep_phases:
        return {}
    per_phase = {}
    for ph in list(PHASE_ORDER) + ["other"]:
        vals = [d.get(ph, 0.0) for d in rep_phases]
        med, spread = median_spread(vals)
        per_phase[ph] = {"median": round(med, 4),
                         "min": round(min(vals), 4),
                         "max": round(max(vals), 4),
                         "spread_secs": round(max(vals) - min(vals), 4),
                         "spread_rel": round(spread, 3)}
    dominant = max(per_phase, key=lambda p: per_phase[p]["spread_secs"])
    return {"per_phase": per_phase, "dominant_phase": dominant,
            "dominant_spread_secs": per_phase[dominant]["spread_secs"]}


def _rep_overlap(observe, roots) -> dict:
    """One timed rep's host/device overlap from its span forest:

    * host_seq_secs       — the producer's sequential pass (union of
      `window.host_seq` spans);
    * device_secs         — the consumer's blocking drains (union of
      `window.drain` spans);
    * host_hidden_secs    — host-seq time that ran while a window was in
      flight (k-th submit start .. k-th drain end; drains are FIFO);
    * hidden_frac         — host_hidden_secs / host_seq_secs;
    * producer_stall_secs — producer time parked on the permit gate.
    """
    sp = observe.spans
    host = sp.merge_intervals(sp.intervals_of(roots,
                                              name="window.host_seq"))
    drains = sorted(sp.intervals_of(roots, name="window.drain"))
    subs = sorted(sp.intervals_of(roots, name="window.submit"))
    inflight = [(s[0], d[1]) for s, d in zip(subs, drains) if d[1] > s[0]]
    stall = sp.merge_intervals(sp.intervals_of(roots, cat="stall"))
    host_total = sum(t1 - t0 for t0, t1 in host)
    hidden = sp.overlap_seconds(host, inflight)
    return {
        "host_seq_secs": round(host_total, 4),
        "device_secs": round(sum(t1 - t0 for t0, t1 in
                                 sp.merge_intervals(drains)), 4),
        "host_hidden_secs": round(hidden, 4),
        "hidden_frac": round(hidden / host_total, 3) if host_total else 0.0,
        "producer_stall_secs": round(sum(t1 - t0 for t0, t1 in stall), 4),
    }


def _overlap_summary(rep_overlaps) -> dict:
    """Cross-rep medians of the per-rep overlap attribution."""
    if not rep_overlaps:
        return {}
    out = {"per_rep": rep_overlaps}
    for k in ("host_seq_secs", "device_secs", "host_hidden_secs",
              "hidden_frac", "producer_stall_secs"):
        out[k + "_median"] = round(
            statistics.median(r[k] for r in rep_overlaps), 4)
    return out


def bench_rounds():
    """Every recorded BENCH_GPU_r*.json as (round_no, parsed-result
    dict), ascending (a round file's `parsed` unwrapped, unreadable files
    skipped).  The TPU's BENCH_r*.json are not read."""
    out = []
    for path in glob.glob(os.path.join(REPO, ROUND_GLOB)):
        m = re.search(r"BENCH_GPU_r(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        out.append((int(m.group(1)), data.get("parsed", data)))
    return sorted(out, key=lambda r: r[0])


def previous_bench():
    """The latest recorded round, or None."""
    rounds = bench_rounds()
    return rounds[-1] if rounds else None


def synth_chain(tmp: str, extra: tuple = ()) -> str:
    """Forge the chain with the port's db_synth in a subprocess; returns
    its directory.  `extra` arguments come last and win."""
    d = os.path.join(tmp, "chain")
    t0 = time.time()
    args = ["--out", d, "--protocol", "shelley", "--blocks", str(BLOCKS),
            "--txs-per-block", str(TXS), "--epoch-length", str(EPOCH_LEN),
            "--pools", "2", "--f", "4/5", "--kes-depth", str(KES_DEPTH),
            *extra]
    r = subprocess.run([sys.executable, "-m", "ouroboros_tpu_torch.db_synth",
                        *args], capture_output=True, text=True, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit(f"synth failed: {r.stderr[-2000:]}")
    log(f"synth: {BLOCKS} blocks in {time.time() - t0:.0f}s")
    return d


def load(db_dir):
    """(rules, blocks) of a db_synth directory, every block decoded."""
    from .db_analyser import load_db
    db, rules, decode, _cfg = load_db(db_dir)
    blocks = [decode(raw) for _entry, raw in db.stream()]
    return rules, blocks


def load_stream_ctx(db_dir):
    """(fs, db, rules, decode) for the streaming engine — the on-disk
    half of what `load` materialises in memory."""
    from .db_analyser import load_db
    from .storage import IoFS
    db, rules, decode, _cfg = load_db(db_dir)
    return IoFS(db_dir), db, rules, decode


def _verified(oks, what: str):
    if not all(oks):
        raise SystemExit(f"{what}: a valid request was rejected")


def _same_hash(got, want, what: str):
    if got != want:
        raise SystemExit(f"{what}: state hash parity violated")


def replay(rules, blocks, backend, window: int):
    """Full-validation pipelined replay; returns (secs, state_hash,
    n_proofs)."""
    from .consensus.batch import replay_blocks_pipelined
    ext = rules.initial_state()
    proofs = sum(4 + sum(len(tx.witnesses) for tx in b.body)
                 for b in blocks)
    t0 = time.perf_counter()
    res = replay_blocks_pipelined(rules, blocks, ext, backend=backend,
                                  window=window)
    if not res.all_valid:
        raise SystemExit(f"replay failed at block {res.n_valid}: "
                         f"{res.error}")
    secs = time.perf_counter() - t0
    return secs, res.final_state.ledger.state_hash(), proofs


class TimingBackend:
    """Wraps a CryptoBackend, accumulating wall time by seam:

    * device_secs   — blocking waits: finish_window drains plus the
      synchronous batch verifies;
    * dispatch_secs — submit_window: host packing + launches, on the
      producer thread, overlapped with the consumer's drain.

    Each field has a single writer thread (dispatch: producer, device:
    consumer), so the unlocked accumulation is race-free.  The pipeline
    reads its backend's attributes by name, so the proxy passes the
    rest through."""

    _DEVICE_CALLS = ("verify_ed25519_batch", "verify_vrf_batch",
                     "verify_kes_batch", "verify_mixed",
                     "vrf_betas_batch", "finish_window")

    def __init__(self, inner):
        self._inner = inner
        self.device_secs = 0.0
        self.dispatch_secs = 0.0
        self.name = inner.name

    def _timed(self, fn, field, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        setattr(self, field,
                getattr(self, field) + time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name == "submit_window":
            return lambda *a, **kw: self._timed(attr, "dispatch_secs",
                                                *a, **kw)
        if name in self._DEVICE_CALLS:
            return lambda *a, **kw: self._timed(attr, "device_secs",
                                                *a, **kw)
        return attr


def _device_fence():
    """Wait for all the card's queued work (every stream: the backend's
    and its cache's fill stream), so a timed rep inherits nothing in
    flight.  No-op where CUDA was never initialised."""
    from .observe.spans import device_fence
    device_fence()


def _timed_reps(fn, reps=None, warmup=1):
    """Run fn() `warmup` untimed times, then `reps` timed reps with a
    fence before each; return the wall-times.  Each rep's host garbage is
    collected before the next rep's fence, and the cyclic GC is off
    inside the timed region, so a collection pause never lands in a
    rep."""
    import gc
    for _ in range(warmup):
        fn()
    vals = []
    gc_was_enabled = gc.isenabled()
    try:
        for _ in range(reps or REPS):
            _device_fence()
            gc.collect()
            gc.disable()
            t0 = time.perf_counter()
            fn()
            vals.append(time.perf_counter() - t0)
            if gc_was_enabled:
                gc.enable()
    finally:
        if gc_was_enabled:
            gc.enable()
    return vals


def bench_primitives(jb):
    """Primitive batch throughputs on the device, median of REPS with
    spread.  Signing runs in worker processes (windowgen) before any
    timing."""
    import hashlib

    from . import windowgen
    from .crypto import ed25519_ref, kes, vrf_ref
    from .crypto.backend import Ed25519Req, KesReq, VrfReq
    workers = os.cpu_count() or 1
    out = {}
    # Ed25519
    n = PRIM_ED
    sk = hashlib.sha256(b"bench-ed").digest()
    vk = ed25519_ref.public_key(sk)
    msgs = [b"m%06d" % i for i in range(n)]
    reqs = [Ed25519Req(vk, m, s) for m, s in
            zip(msgs, windowgen.signatures(sk, msgs, workers))]

    def run_ed():
        _verified(jb.verify_ed25519_batch(reqs), "ed25519 primitive")
    run_ed()
    vals = _timed_reps(run_ed)
    med, spread = check_spread("ed25519 primitive", vals)
    out["ed25519_batch_per_sec"] = round(n / med, 1)
    out["ed25519_batch_per_sec_best"] = round(n / min(vals), 1)
    out["ed25519_spread"] = round(spread, 3)
    # VRF
    nv = PRIM_VRF
    vsk = hashlib.sha256(b"bench-vrf").digest()
    vvk = vrf_ref.public_key(vsk)
    alphas = [b"a%d" % i for i in range(nv)]
    vreqs = [VrfReq(vvk, a, p) for a, p in
             zip(alphas, windowgen.proofs(vsk, alphas, workers))]

    def run_vrf():
        _verified(jb.verify_vrf_batch(vreqs), "vrf primitive")
        _device_fence()
    run_vrf()
    vals = _timed_reps(run_vrf)
    med, spread = check_spread("vrf primitive", vals)
    out["vrf_batch_per_sec"] = round(nv / med, 1)
    out["vrf_batch_per_sec_best"] = round(nv / min(vals), 1)
    out["vrf_spread"] = round(spread, 3)
    # KES at depth 6, period 0: hash path on the card once, then warm
    nk = PRIM_KES
    kseed = hashlib.sha256(b"bench-kes").digest()
    ksk = kes.KesSignKey(6, kseed)
    kmsgs = [b"m%d" % i for i in range(nk)]
    kreqs = [KesReq(6, ksk.verification_key, 0, m, s) for m, s in
             zip(kmsgs, windowgen.kes_signatures(kseed, kmsgs, workers))]

    def run_kes():
        _verified(jb.verify_kes_batch(kreqs), "kes primitive")
    run_kes()
    vals = _timed_reps(run_kes)
    med, spread = check_spread("kes primitive", vals)
    out["kes_batch_per_sec"] = round(nk / med, 1)
    out["kes_batch_per_sec_best"] = round(nk / min(vals), 1)
    out["kes_spread"] = round(spread, 3)
    return out


def compare_previous(prim):
    """Log primitive deltas vs the latest recorded round and return them
    for the output JSON ({} when no history)."""
    prev = previous_bench()
    if not prev:
        return {}
    rnd, doc = prev
    old = doc.get("primitives") or {}
    ratios = {}
    for k in ("ed25519_batch_per_sec", "vrf_batch_per_sec",
              "kes_batch_per_sec"):
        if k in old and k in prim and old[k]:
            delta = prim[k] / old[k]
            ratios[k] = round(delta, 3)
            log(f"vs BENCH_GPU_r{rnd:02d} {k}: {old[k]:.0f} -> "
                f"{prim[k]:.0f} ({delta:.2f}x)")
    return {"vs_round": rnd, "ratios": ratios}


def _cpu_backend():
    """The sequential CPU baseline: CppBackend, built with g++ at first
    use.  Raises if it cannot be built."""
    from .crypto.cpp_backend import CppBackend
    return CppBackend()


def _device_info(dev) -> dict:
    """The card's name, power limit (W) and count, as nvidia-smi reads
    them; on the CPU, its name only."""
    import torch
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    name, limit = torch.cuda.get_device_name(dev), None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
        smi_name, smi_limit = (x.strip() for x in out.split(",", 1))
        name, limit = smi_name, float(smi_limit.split()[0])
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return {"name": name, "power_limit_w": limit,
            "count": torch.cuda.device_count()}


def _launches_since(before: dict) -> dict:
    """Each CUDA kernel's launches since `before` (a LAUNCHES copy)."""
    from .crypto import kernels as K
    return {k: K.LAUNCHES[k] - before.get(k, 0) for k in K.LAUNCHES}


def _start_device(dev, K) -> None:
    """Build (or load) the kernel library and bring the card up, so that
    neither lands in a timed replay.  No-op on the CPU."""
    import torch
    if dev.type != "cuda":
        return
    K.library()
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)


def _span_secs(observe, roots, name: str) -> float:
    """Seconds covered by the spans called `name` in a drained forest."""
    sp = observe.spans
    return sum(t1 - t0 for t0, t1 in
               sp.merge_intervals(sp.intervals_of(roots, name=name)))


def _smoke_verdict_parity(jb):
    """Mixed-batch verdict parity vs the pure-Python oracle, with
    corruptions of every primitive (bad sig / wrong alpha / tampered
    Merkle node / wrong period / truncated KES bytes), in fold and in
    vector form.  Then the warm probe without another window: the host
    split and the key assembly must serve everything from the backend's
    cache.  Returns (parity_ok, fold_ok, warm_fill_dispatches,
    warm_kes_jobs, reqs)."""
    import hashlib

    from .crypto import ed25519_ref, kes, vrf_ref
    from .crypto.backend import (
        CpuRefBackend, Ed25519Req, KesReq, VrfReq, WindowVerdict,
    )
    cache = jb.cache
    sk = hashlib.sha256(b"smoke-ed").digest()
    vk = ed25519_ref.public_key(sk)
    vsk = hashlib.sha256(b"smoke-vrf").digest()
    vvk = vrf_ref.public_key(vsk)
    ksk = kes.KesSignKey(4, hashlib.sha256(b"smoke-kes").digest())
    kvk = ksk.verification_key
    reqs = [Ed25519Req(vk, b"m0", ed25519_ref.sign(sk, b"m0")),
            Ed25519Req(vk, b"bad", ed25519_ref.sign(sk, b"good")),
            VrfReq(vvk, b"a0", vrf_ref.prove(vsk, b"a0")),
            VrfReq(vvk, b"bad-alpha", vrf_ref.prove(vsk, b"a1"))]
    good = ksk.sign(b"kmsg")
    tam = kes.KesSig(good.leaf_sig,
                     ((good.merkle[0][0], bytes(32)),) + good.merkle[1:])
    reqs += [KesReq(4, kvk, 0, b"kmsg", good.to_bytes()),
             KesReq(4, kvk, 0, b"kmsg", tam.to_bytes()),
             KesReq(4, kvk, 1, b"kmsg", good.to_bytes()),
             KesReq(4, kvk, 0, b"kmsg", b"\x00" * 7)]
    for period in (1, 2):
        ksk.evolve()
        reqs.append(KesReq(4, kvk, period, b"p%d" % period,
                           ksk.sign(b"p%d" % period).to_bytes()))
    want = CpuRefBackend().verify_mixed(reqs)
    # fold form first, while the KES paths are cold
    verdict, _b = jb.finish_window(jb.submit_window(reqs, fold=True))
    fold_ok = (isinstance(verdict, WindowVerdict)
               and verdict.first_bad == (want.index(False)
                                         if False in want else None))
    # the fold run cached the KES path outcomes; cold again for the
    # vector form
    cache._kes.clear()
    got = jb.verify_mixed(reqs)                               # cold
    fills = cache.device_fills
    (eds, _eo, _vrfs, _vo, kes_msgs, _ex, checks, _n) = \
        jb._split_mixed_device(reqs)
    point_vks = [r.vk for r in reqs if not isinstance(r, KesReq)] + \
        [e.vk for e in eds]
    cache.assemble(point_vks)
    warm_fills = cache.device_fills - fills
    return (got == want, fold_ok, warm_fills,
            len(kes_msgs) + len(checks), reqs)


def smoke(blocks: int = 8, window: int = 8, device=None):
    """Small parity-only replay gate: synth a small TPraos chain, replay
    it once on the CPU baseline and once on `TorchBackend(device,
    min_bucket=16)` (1 rep, no timing assertions), assert state-hash
    parity, key reuse during the replay, mixed-batch verdict parity with
    a zero-warm-work probe, and the probes below.  Returns the result
    dict; raises SystemExit when a gate fails.

    On the CPU the plain forms run on one intra-op thread: their tensors
    are a few lanes wide, and a thread pool shared with other processes
    made the VRF spread probe's reps vary by 25-40 % (1-2 % on one
    thread, and faster)."""
    global BLOCKS, TXS, EPOCH_LEN
    dev = device_mod.resolve(device)
    import torch

    from . import observe
    from .crypto.torch_backend import TorchBackend
    from .crypto import kernels as K
    from .observe import metrics as _om

    old = (BLOCKS, TXS, EPOCH_LEN)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    # empty bodies and depth-4 KES keep the windows small
    BLOCKS, TXS, EPOCH_LEN = blocks, 0, 500
    tmp = tempfile.mkdtemp(prefix="bench-smoke-")
    try:
        chain = synth_chain(tmp, extra=("--kes-depth", "4"))
        rules, blocks_l = load(chain)
        cpu = _cpu_backend()
        _clear_beta_cache()
        _, cpu_hash, n_proofs = replay(rules, blocks_l, cpu, window)
        launches0 = dict(K.LAUNCHES)
        jb = TorchBackend(dev, min_bucket=16)
        fills0 = jb.cache.device_fills
        _clear_beta_cache()
        # the pipelined path with the fold, spans recorded: the overlap
        # attribution must be well formed at this size too
        started0 = _om.counter("pipeline.producers_started",
                               always=True).value
        observe.spans.RECORDER.enable()
        try:
            observe.spans.RECORDER.drain()
            _, dev_hash, _ = replay(rules, blocks_l, jb, window)
            overlap_probe = _rep_overlap(observe,
                                         observe.spans.RECORDER.drain())
        finally:
            observe.spans.RECORDER.disable()
        producers_run = _om.counter("pipeline.producers_started",
                                    always=True).value - started0
        leaked = _smoke_producer_leak()
        # 2 pools: every window past the first runs on cached keys
        replay_fills = jb.cache.device_fills - fills0
        hash_ok = cpu_hash == dev_hash
        verdict_ok, fold_ok, warm_fills, warm_jobs, parity_reqs = \
            _smoke_verdict_parity(jb)
        snapshot_ok, disabled_writes, disabled_spans = \
            _smoke_observe(jb, parity_reqs)
        vrf_probe = _smoke_vrf_spread(jb)
        scrape_ok, scrape_leaked, scrape_q = _smoke_scrape()
        net_probe = _smoke_net_disabled()
        perfgate_ok, _perfgate_verdict = _smoke_perfgate()
        sharded_probe = _smoke_sharded_replay(rules, blocks_l, dev)
        serve_probe = _smoke_serve()
        stream_probe = _smoke_stream(chain, jb, cpu_hash)
        result = {"metric": "bench_smoke", "value": 1.0,
                  "device": str(dev),
                  "blocks": len(blocks_l), "proofs": n_proofs,
                  "state_hash_parity": bool(hash_ok),
                  "verdict_parity": bool(verdict_ok),
                  "fold_verdict_parity": bool(fold_ok),
                  "pipelined_producers_run": int(producers_run),
                  "producer_threads_leaked": int(leaked),
                  "overlap_probe": overlap_probe,
                  "vrf_spread_probe": vrf_probe,
                  "replay_fill_dispatches": int(replay_fills),
                  "warm_device_fills": int(warm_fills),
                  "warm_kes_jobs": int(warm_jobs),
                  "observe_snapshot_parses": bool(snapshot_ok),
                  "disabled_registry_writes": int(disabled_writes),
                  "disabled_spans_recorded": int(disabled_spans),
                  "scrape_roundtrip": bool(scrape_ok),
                  "scrape_threads_leaked": int(scrape_leaked),
                  "scrape_submit_drain_quantiles": scrape_q,
                  "net_disabled_probe": net_probe,
                  "perfgate_ok": bool(perfgate_ok),
                  "sharded_replay_smoke": sharded_probe,
                  "serve_probe": serve_probe,
                  "stream_probe": stream_probe,
                  "kernel_launches": _launches_since(launches0),
                  "precompute": jb.cache.stats()}
        if not (hash_ok and verdict_ok and fold_ok
                and producers_run >= 1 and leaked == 0
                and overlap_probe["host_seq_secs"] > 0
                and vrf_probe["ok"]
                and warm_fills == 0
                and warm_jobs == 0 and replay_fills <= 3
                and snapshot_ok and disabled_writes == 0
                and disabled_spans == 0
                and scrape_ok and scrape_leaked == 0
                and net_probe["ok"]
                and perfgate_ok and sharded_probe["ok"]
                and serve_probe["ok"] and stream_probe["ok"]):
            result["value"] = 0.0
            print(json.dumps(result))
            raise SystemExit(f"bench --smoke parity failure: {result}")
        print(json.dumps(result))
        return result
    finally:
        BLOCKS, TXS, EPOCH_LEN = old
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)


def _smoke_producer_leak() -> int:
    """Still-alive replay producer threads: the started/finished counter
    pair plus a live-thread sweep."""
    import threading

    from .observe import metrics as _om
    started = _om.counter("pipeline.producers_started", always=True).value
    finished = _om.counter("pipeline.producers_finished",
                           always=True).value
    alive = sum(t.name == "ouro-replay-producer" and t.is_alive()
                for t in threading.enumerate())
    return (started - finished) + alive


# scheduler/OS noise floor for the smoke spread gate: the threshold
# relaxes by floor/median, so reps of a second or more are held to 0.30
# and the CPU's sub-second reps to the noise they sit in
_SPREAD_NOISE_FLOOR_SECS = 0.15


def _smoke_vrf_spread(jb, reps: int = 5, rounds: int = 3) -> dict:
    """Fenced, GC-disciplined reps of the warm VRF primitive must show a
    bounded spread.  The best of `rounds` wins; threshold = 0.30 +
    noise_floor/median."""
    import hashlib

    from .crypto import vrf_ref
    from .crypto.backend import VrfReq
    vsk = hashlib.sha256(b"smoke-spread").digest()
    vvk = vrf_ref.public_key(vsk)
    reqs = [VrfReq(vvk, b"s%d" % i, vrf_ref.prove(vsk, b"s%d" % i))
            for i in range(8)]

    def run():
        _verified(jb.verify_vrf_batch(reqs), "vrf spread probe")
    run()
    best = None
    for _ in range(rounds):
        med, spread = median_spread(_timed_reps(run, reps=reps, warmup=0))
        allowed = SPREAD_WARN + _SPREAD_NOISE_FLOOR_SECS / max(med, 1e-9)
        if best is None or spread - allowed < best[0] - best[1]:
            best = (spread, allowed, med)
        if spread < allowed:
            break
    spread, allowed, med = best
    return {"ok": bool(spread < allowed), "spread": round(spread, 3),
            "allowed": round(allowed, 3), "median_secs": round(med, 4),
            "reps": reps}


def _smoke_observe(jb, probe_reqs):
    """1. the registry snapshot round-trips and its Prometheus exposition
    parses; 2. with observation disabled, a fully instrumented window
    makes zero gated registry writes and records zero spans.  The KES
    outcomes are made cold first, so the probe window also runs the
    Blake2b jobs.  Returns (snapshot_ok, disabled_writes,
    disabled_spans)."""
    from . import observe

    jb.cache._kes.clear()
    reg = observe.metrics.registry()
    rec = observe.spans.RECORDER
    try:
        snap = json.loads(reg.snapshot_json())
        prom = observe.export.parse_prometheus_text(
            observe.export.prometheus_text(reg))
        snapshot_ok = isinstance(snap, dict) and len(prom) >= len(snap)
    except Exception as e:
        log(f"observe snapshot failed to parse: {e!r}")
        snapshot_ok = False
    was_reg, was_rec = reg.enabled, rec.enabled
    reg.disable()
    rec.disable()
    try:
        writes0, roots0 = reg.data_writes, len(rec.roots)
        jb.verify_mixed(probe_reqs)
        with observe.span("probe", cat="sync"):
            pass
        disabled_writes = reg.data_writes - writes0
        disabled_spans = len(rec.roots) - roots0
    finally:
        reg.enabled, rec.enabled = was_reg, was_rec
    return snapshot_ok, disabled_writes, disabled_spans


def _smoke_scrape():
    """Serve the process registry over the project's snocket/SDU
    transport inside the simulator, scrape it, and re-derive latency
    quantiles: the replay that just ran filled
    `pipeline.submit_drain_secs`, so p50/p95/p99 come back finite and
    ordered, and the sim winds down with zero leaked threads.  Returns
    (ok, leaked_threads, quantiles)."""
    from . import simharness as sim
    from .network.snocket import SimSnocket
    from .observe import export
    from .observe.scrape import PeriodicEmitter, ScrapeServer, scrape

    emitted = []

    async def main():
        sn = SimSnocket()
        srv = await ScrapeServer(sn, "metrics").start()
        em = await PeriodicEmitter(1.0, emitted.append).start()
        text = await scrape(sn, "metrics")
        await sim.sleep(2.5)
        await srv.stop()
        await em.stop()
        return text

    text, trace = sim.run_trace(main())
    leaked = len(sim.leaked_threads(trace))
    try:
        parsed = export.parse_prometheus_text(text)
        q = export.prom_histogram_quantiles(
            parsed, "ouro_pipeline_submit_drain_secs")
        ok = (parsed.get("ouro_pipeline_submit_drain_secs_count", 0) > 0
              and 0 < q["p50"] <= q["p95"] <= q["p99"]
              and len(emitted) >= 2)
    except Exception as e:
        log(f"scrape smoke failed to parse: {e!r}")
        ok, q = False, {}
    return ok, leaked, q


def _smoke_net_disabled():
    """With metrics off, SDUs pumped through a mux pair in the simulator
    make zero gated registry writes and zero label formats, and the
    per-peer accounting object is never built."""
    from . import simharness as sim
    from .network.mux import Mux, bearer_pair
    from .observe import metrics as _om
    from .observe import netmetrics as _net

    reg = _om.REGISTRY
    was = reg.enabled
    reg.disable()
    try:
        writes0 = reg.data_writes
        formats0 = _net.LABEL_FORMATS.value
        io_built = []

        async def main():
            ba, bb = bearer_pair(sdu_size=1024)
            ma, mb = Mux(ba, "smoke-net-a"), Mux(bb, "smoke-net-b")
            ma.start()
            mb.start()
            cha = ma.channel(2, 0)
            chb = mb.channel(2, 1)
            await cha.send(b"x" * 4096)
            got = b""
            while len(got) < 4096:
                got += await chb.recv()
            io_built.append((ma._io, mb._io))
            ma.stop()
            mb.stop()
            return len(got)

        n = sim.run(main(), seed=1)
        writes = reg.data_writes - writes0
        formats = _net.LABEL_FORMATS.value - formats0
        built = any(io is not None for pair in io_built for io in pair)
        return {"ok": bool(writes == 0 and formats == 0
                           and not built and n == 4096),
                "sdu_bytes": int(n),
                "disabled_net_writes": int(writes),
                "disabled_label_formats": int(formats),
                "mux_io_built": bool(built)}
    finally:
        reg.enabled = was


def _smoke_perfgate():
    """The trajectory and serve gates over the recorded BENCH_GPU_r*.json
    rounds: a recorded round that regressed fails the smoke.  With no
    round recorded it passes with a note.  The JAX package's
    BENCH_r*.json and MULTICHIP_r*.json are not read."""
    from .perfgate import check_serve, check_trajectory
    paths = sorted(glob.glob(os.path.join(REPO, ROUND_GLOB)))
    if not paths:
        return True, {"checks": [], "note": "no recorded rounds"}
    verdict = check_trajectory(paths)
    sv = check_serve(paths)
    verdict["serve"] = sv
    verdict["ok"] = verdict["ok"] and sv["ok"]
    if not verdict["ok"]:
        log(f"perfgate FAILED: {json.dumps(verdict['checks'])} "
            f"{json.dumps(sv['checks'])}")
    return verdict["ok"], verdict


def _smoke_sharded_replay(rules, blocks_l, device, mesh_n: int = 2,
                          window: int = 4):
    """Over `mesh_n` shards of `device`, the threaded sharded
    ReplayResult must equal the CPU baseline's on a valid, a tampered
    and a truncated chain, with zero leaked producer threads."""
    from .consensus.batch import replay_blocks_pipelined
    from .consensus.headers import ProtocolBlock
    from .eras.shelley import KES_FIELD
    from .parallel import ShardedTorchBackend, make_mesh

    def tamper(blks, ix):
        blk = blks[ix]
        sig = bytearray(blk.header.get(KES_FIELD))
        sig[3] ^= 1
        out = list(blks)
        out[ix] = ProtocolBlock(
            blk.header.with_fields(**{KES_FIELD: bytes(sig)}), blk.body)
        return out

    devices = [device] * mesh_n
    sb = ShardedTorchBackend(make_mesh(devices=devices), min_bucket=16)
    cpu = _cpu_backend()
    variants = [list(blocks_l), tamper(blocks_l, 5),
                list(blocks_l[:3]) + list(blocks_l[4:])]
    ok = True
    details = []
    for blks in variants:
        _clear_beta_cache()
        sync = replay_blocks_pipelined(rules, blks, rules.initial_state(),
                                       backend=cpu, window=window)
        _clear_beta_cache()
        shard = replay_blocks_pipelined(rules, blks,
                                        rules.initial_state(),
                                        backend=sb, window=window)
        same = (shard.n_valid == sync.n_valid
                and (shard.error is None) == (sync.error is None)
                and ((shard.final_state is None)
                     == (sync.final_state is None))
                and (sync.final_state is None
                     or (shard.final_state.ledger.state_hash()
                         == sync.final_state.ledger.state_hash())))
        ok = ok and same
        details.append({"n_valid": [sync.n_valid, shard.n_valid],
                        "match": bool(same)})
    leaked = _smoke_producer_leak()
    return {"ok": bool(ok and leaked == 0), "skipped": None,
            "devices": [str(d) for d in sb.mesh.devices],
            "variants": details,
            "producer_threads_leaked": int(leaked),
            "padding": sb.padding_stats()}


def _clear_beta_cache():
    from .crypto.backend import GLOBAL_BETA_CACHE
    GLOBAL_BETA_CACHE.clear()


def _smoke_stream(chain_dir, jb, cpu_hash):
    """Replay the smoke chain from disk through storage/stream.py
    (prefetch thread + pipelined verify + snapshots), then reopen with
    resume.  Gates: state-hash parity vs the CPU baseline, >=1 chunk
    streamed, >=1 snapshot written, the resumed reopen replays zero
    blocks to the same hash, and no thread leaks."""
    from .storage import DiskPolicy, StreamConfig, StreamingReplayEngine
    from .storage.stream import prefetcher_threads_alive

    fs, db, rules, decode = load_stream_ctx(chain_dir)
    cfg = StreamConfig(window=8, read_ahead=2,
                       policy=DiskPolicy(num_snapshots=2,
                                         snapshot_interval_slots=4),
                       resume=False)
    jb.cache._kes.clear()
    _clear_beta_cache()
    res = StreamingReplayEngine(fs, db, rules, decode, backend=jb,
                                config=cfg).replay()
    hash_ok = (res.all_valid
               and res.final_state.ledger.state_hash() == cpu_hash)
    _clear_beta_cache()
    res2 = StreamingReplayEngine(
        fs, db, rules, decode, backend=jb,
        config=StreamConfig(window=8, read_ahead=2, policy=cfg.policy,
                            resume=True)).replay()
    resume_ok = (res2.all_valid and res2.n_valid == 0
                 and res2.stats["resumed_from_slot"] is not None
                 and res2.final_state.ledger.state_hash() == cpu_hash)
    leaked = prefetcher_threads_alive() + _smoke_producer_leak()
    ok = (hash_ok and resume_ok and res.stats["chunks_read"] >= 1
          and res.stats["snapshots_written"] >= 1 and leaked == 0)
    return {"ok": bool(ok), "state_hash_parity": bool(hash_ok),
            "resume_parity": bool(resume_ok),
            "resumed_from_slot": res2.stats["resumed_from_slot"],
            "restore_secs": res2.stats["restore_secs"],
            "threads_leaked": int(leaked),
            "stats": res.stats}


def _smoke_serve():
    """The scaled-down serve legs (`serve.sim_legs(7, 0.5)`): parity on
    every leg, >=5x over the unbatched CPU baseline at saturation, p95
    inside the deadline, zero device dispatches under light load, zero
    leaked sim threads."""
    from .serve import sim_legs
    return sim_legs(7, 0.5)


def _stream_leg(chain_dir, jb, cpu_hash, n_proofs):
    """The ``stream`` section: one replay of the same chain from disk
    through the streaming engine (read-ahead 4, a snapshot every
    EPOCH_LEN slots) on the warm backend, then a resumed reopen that
    restores the tip snapshot."""
    from .storage import DiskPolicy, StreamConfig, StreamingReplayEngine
    fs, db, rules, decode = load_stream_ctx(chain_dir)
    cfg = StreamConfig(window=WINDOW, read_ahead=4,
                       policy=DiskPolicy(num_snapshots=2,
                                         snapshot_interval_slots=max(
                                             1, EPOCH_LEN)),
                       resume=False)
    _clear_beta_cache()
    res = StreamingReplayEngine(fs, db, rules, decode, backend=jb,
                                config=cfg).replay()
    if not res.all_valid:
        raise SystemExit(f"stream leg failed at block {res.n_valid}: "
                         f"{res.error}")
    parity = res.final_state.ledger.state_hash() == cpu_hash
    _clear_beta_cache()
    res2 = StreamingReplayEngine(
        fs, db, rules, decode, backend=jb,
        config=StreamConfig(window=WINDOW, read_ahead=4,
                            policy=cfg.policy, resume=True)).replay()
    out = dict(res.stats)
    out["state_hash_parity"] = bool(parity)
    out["proofs_per_sec"] = round(n_proofs / res.stats["replay_secs"], 1)
    out["restart"] = {
        "restore_secs": res2.stats["restore_secs"],
        "blocks_replayed": res2.n_valid,
        "state_hash_parity": bool(
            res2.all_valid and res2.final_state is not None
            and res2.final_state.ledger.state_hash() == cpu_hash),
    }
    if not parity:
        raise SystemExit("stream leg state hash parity violated")
    return out


def _mesh_leg(rules, blocks, cpu_hash, cpu_secs, dev_secs, n_proofs,
              mesh_n: int, device):
    """The sharded pipelined replay: the same chain and window through
    ShardedTorchBackend over `mesh_n` devices (the first `mesh_n` cards,
    or `[device] * mesh_n` where there are fewer), with the same
    discipline: two warm-ups, fenced reps, state-hash parity each rep.
    Returns the ``sharded`` dict."""
    import torch

    from .parallel import ShardedTorchBackend, log_compile_time, make_mesh
    if device.type == "cuda" and torch.cuda.device_count() >= mesh_n:
        devices = [torch.device("cuda", i) for i in range(mesh_n)]
    else:
        devices = [device] * mesh_n
    inner = ShardedTorchBackend(make_mesh(devices=devices))
    sb = TimingBackend(inner)
    with log_compile_time(f"mesh={mesh_n} sharded replay warmup"):
        _clear_beta_cache()
        replay(rules, blocks, sb, WINDOW)
    _clear_beta_cache()
    replay(rules, blocks, sb, WINDOW)
    pad0 = inner.padding_stats()
    fills0 = inner.cache.device_fills
    times, dev_times, disp_times = [], [], []
    for _ in range(REPS):
        _clear_beta_cache()
        _device_fence()
        sb.device_secs = sb.dispatch_secs = 0.0
        secs, mesh_hash, _ = replay(rules, blocks, sb, WINDOW)
        _same_hash(mesh_hash, cpu_hash, "sharded replay")
        times.append(secs)
        dev_times.append(sb.device_secs)
        disp_times.append(sb.dispatch_secs)
    med, spread = check_spread("sharded replay", times)
    return {
        "devices": [str(d) for d in inner.mesh.devices],
        "proofs_per_sec": round(n_proofs / med, 1),
        "vs_baseline": round(cpu_secs / med, 3),
        "vs_single_device": round(dev_secs / med, 3),
        "replay_secs": {"median": round(med, 3),
                        "min": round(min(times), 3),
                        "max": round(max(times), 3)},
        "spread": round(spread, 3),
        "device_wait_secs": round(statistics.median(dev_times), 3),
        "dispatch_secs": round(statistics.median(disp_times), 3),
        "state_hash_parity": True,
        "warm_extra_fills": inner.cache.device_fills - fills0,
        "padding": inner.padding_stats(since=pad0),   # timed reps only
    }


def main(mesh_n: int = None, device=None) -> dict:
    """The bench; prints and returns its JSON line."""
    dev = device_mod.resolve(device)
    from . import observe
    from .crypto import kernels as K
    from .crypto.torch_backend import TorchBackend

    tmp = tempfile.mkdtemp(prefix="bench-shelley-")
    try:
        t0 = time.perf_counter()
        chain = synth_chain(tmp)
        synth_secs = time.perf_counter() - t0
        rules, blocks = load(chain)

        # CPU baseline: the sequential C++ replay, median of CPU_REPS
        cpu = _cpu_backend()
        cpu_times = []
        cpu_hash = n_proofs = None
        for _ in range(CPU_REPS):
            _clear_beta_cache()
            secs, cpu_hash, n_proofs = replay(rules, blocks, cpu, WINDOW)
            cpu_times.append(secs)
        cpu_secs, cpu_spread = check_spread("cpu replay", cpu_times)
        log(f"cpu [{cpu.name}] replay: median {cpu_secs:.2f}s over "
            f"{CPU_REPS} reps (spread {100 * cpu_spread:.0f}%; "
            f"{n_proofs / cpu_secs:.0f} proofs/s, "
            f"{len(blocks) / cpu_secs:.0f} blocks/s)")

        # the card: the kernel library built (or loaded) and the device
        # touched outside every clock, then warm-up 1 from a cold key
        # cache (fills every key, hashes every KES path; spans recorded),
        # warm-up 2 warm (its windows carry no KES jobs), then REPS timed
        # replays with a cold beta cache and a warm key cache: the steady
        # state
        t0 = time.perf_counter()
        _start_device(dev, K)
        build_secs = time.perf_counter() - t0
        inner = TorchBackend(dev)
        jb = TimingBackend(inner)
        _clear_beta_cache()
        launches_cold0 = dict(K.LAUNCHES)
        observe.spans.RECORDER.enable()
        try:
            cold_secs, cold_hash, _ = replay(rules, blocks, jb, WINDOW)
            cold_roots = observe.spans.RECORDER.drain()
        finally:
            observe.spans.RECORDER.disable()
        kernel_launches_cold = _launches_since(launches_cold0)
        _same_hash(cold_hash, cpu_hash, "cold replay")
        cold = {"replay_secs": round(cold_secs, 3),
                "fill_secs": round(_span_secs(observe, cold_roots,
                                              "precompute.fill"), 4),
                "phases": _rep_phase_totals(observe, cold_roots, cold_secs),
                "precompute": inner.cache.stats()}
        log(f"kernel library and device start: {build_secs:.2f}s; cold "
            f"replay: {cold_secs:.2f}s, of which {cold['fill_secs']:.2f}s "
            f"in per-key fills; phases {cold['phases']}; precompute "
            f"after it: {cold['precompute']}")
        _clear_beta_cache()
        replay(rules, blocks, jb, WINDOW)
        warm_fills = inner.cache.device_fills
        launches0 = dict(K.LAUNCHES)
        dev_times_l, dev_wait, disp_times = [], [], []
        rep_phases: list = []
        rep_overlaps: list = []
        observe.spans.RECORDER.enable()
        try:
            for _ in range(REPS):
                jb.device_secs = jb.dispatch_secs = 0.0
                _clear_beta_cache()
                with observe.span("rep.fence", cat="sync", fence=True):
                    pass        # drain in-flight work before the rep
                # the fence ran outside the rep: drop its span
                observe.spans.RECORDER.drain()
                secs, dev_hash, _ = replay(rules, blocks, jb, WINDOW)
                _same_hash(dev_hash, cpu_hash, "card replay")
                dev_times_l.append(secs)
                dev_wait.append(jb.device_secs)
                disp_times.append(jb.dispatch_secs)
                roots = observe.spans.RECORDER.drain()
                rep_phases.append(_rep_phase_totals(observe, roots, secs))
                rep_overlaps.append(_rep_overlap(observe, roots))
        finally:
            observe.spans.RECORDER.disable()
        kernel_launches = _launches_since(launches0)
        warm_extra_fills = inner.cache.device_fills - warm_fills
        if warm_extra_fills:
            raise SystemExit(
                f"cache-warm replay ran {warm_extra_fills} per-key fills; "
                f"the precompute cache is leaking work into the steady "
                f"state")
        dev_secs, dev_spread = check_spread("card replay", dev_times_l)
        wait_secs = statistics.median(dev_wait)
        disp_secs = statistics.median(disp_times)
        overlap = _overlap_summary(rep_overlaps)
        log(f"card replay: median {dev_secs:.2f}s over {REPS} reps "
            f"(spread {100 * dev_spread:.0f}%; "
            f"{n_proofs / dev_secs:.0f} proofs/s, "
            f"{len(blocks) / dev_secs:.0f} blocks/s); "
            f"device-wait {wait_secs:.2f}s / dispatch {disp_secs:.2f}s "
            f"(producer thread); launches {kernel_launches}")
        if overlap:
            log(f"overlap: host-seq {overlap['host_seq_secs_median']:.2f}s "
                f"of which {overlap['host_hidden_secs_median']:.2f}s "
                f"({100 * overlap['hidden_frac_median']:.0f}%) hidden "
                f"under in-flight windows; producer stalled "
                f"{overlap['producer_stall_secs_median']:.2f}s on the "
                f"permit gate")
        variance = _phase_variance(rep_phases)
        if variance:
            dom = variance["dominant_phase"]
            log(f"variance: largest cross-rep spread in phase '{dom}' "
                f"({variance['dominant_spread_secs']:.2f}s min->max)")

        prim = bench_primitives(TimingBackend(TorchBackend(dev)))
        log(f"primitives: {prim}")
        prim_vs_prev = compare_previous(prim)

        stream = _stream_leg(chain, jb, cpu_hash, n_proofs)
        log(f"stream: {stream['disk_secs']}s disk+decode, "
            f"{100 * stream['disk_hidden_frac']:.0f}% hidden under "
            f"device; {stream['snapshots_written']} snapshots, restart "
            f"restored in {stream['restart']['restore_secs']}s")

        sharded = None
        if mesh_n:
            sharded = _mesh_leg(rules, blocks, cpu_hash, cpu_secs,
                                dev_secs, n_proofs, mesh_n, dev)
            log(f"sharded (mesh={mesh_n}): {sharded}")

        rate = n_proofs / dev_secs
        line = {
            "metric": "shelley_replay_proofs_per_sec",
            "value": round(rate, 1),
            "unit": "proofs/s",
            "vs_baseline": round(cpu_secs / dev_secs, 3),
            "blocks_per_sec": round(len(blocks) / dev_secs, 1),
            "cpu_baseline_proofs_per_sec": round(n_proofs / cpu_secs, 1),
            "state_hash_parity": True,
            "blocks": len(blocks),
            "proofs": n_proofs,
            "reps": REPS,
            "cpu_reps": CPU_REPS,
            "spread": round(dev_spread, 3),
            "replay_secs": {"median": round(dev_secs, 3),
                            "min": round(min(dev_times_l), 3),
                            "max": round(max(dev_times_l), 3)},
            "cpu_replay_secs": {"median": round(cpu_secs, 3),
                                "spread": round(cpu_spread, 3)},
            "build_secs": round(build_secs, 3),
            "cold_replay_secs": round(cold_secs, 3),
            "cold": cold,
            "synth_secs": round(synth_secs, 3),
            "warm_extra_fills": warm_extra_fills,
            "breakdown": {
                # device_wait: consumer-thread drains; dispatch: producer
                # packing + launches, overlapped with the waits
                "device_wait_secs": round(wait_secs, 3),
                "dispatch_secs": round(disp_secs, 3),
                "host_secs": round(dev_secs - wait_secs, 3)},
            "overlap": overlap,
            "phases": rep_phases,
            "variance": variance,
            "metrics": observe.metrics.registry().snapshot(),
            "kernel_launches": kernel_launches,
            "kernel_launches_cold": kernel_launches_cold,
            "precompute": inner.cache.stats(),
            "primitives": prim,
            "primitives_vs_previous": prim_vs_prev,
            "stream": stream,
            "device": _device_info(dev),
            **({"sharded": sharded} if sharded else {}),
        }
        print(json.dumps(line), flush=True)
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small parity-only replay (1 rep, no timing "
                         "assertions) with the smoke's probes")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="also run the sharded pipelined replay over N "
                         "devices (N shards of one card where fewer "
                         "cards are present)")
    ap.add_argument("--serve", action="store_true",
                    help="the verification service's simulated legs "
                         "(serve.sim_legs): p50/p95/p99 latency and "
                         "proofs/s vs the unbatched CPU baseline")
    ap.add_argument("--serve-seed", type=int, default=7,
                    help="arrival-trace seed for --serve (default 7)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain forms)")
    return ap


def cli(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if args.serve:
        from .serve import sim_legs
        res = sim_legs(args.serve_seed)
        print(json.dumps({
            "metric": "verify_service_serve",
            "value": res["saturated"]["proofs_per_sec"],
            "unit": "proofs/s",
            "vs_unbatched_cpu": res["saturated"]["vs_unbatched_cpu"],
            "serve": res}))
        if not res["ok"]:
            raise SystemExit("bench --serve gate failure (see 'serve' "
                             "section)")
    elif args.smoke:
        smoke(device=args.device)
    else:
        main(mesh_n=args.mesh, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
