"""serve — a caught-up node's verification path: VerifyService on the card.

    python -m ouroboros_tpu_torch.serve [--device cuda|cpu] [--blocks N]
        [--scale S] [--seed 7]

A syncing node replays big uniform windows; a caught-up node sees
batch-of-1 headers at the tip and a firehose of single-transaction
witness checks (crypto/batching.py).  This entry point drives that
traffic through `VerifyService` and prints one JSON line with two parts:

* ``sim`` — `bench.py`'s three serve legs (saturated, light load,
  back-pressure) in virtual time over `ModeledBackend` and
  `PrecheckedBackend`, copied from `bench.py` (`_serve_population` ...
  `serve_bench`, here `sim_legs`): the same seed gives the same dict, field
  for field, in both packages.
* ``card`` — the same service over the real `TorchBackend` under
  `sim.io_run` on the real clock, with the port's `CppBackend` as the
  break-even fallback (no step down to another CPU backend).  The table
  comes from `calibrate_break_even(TorchBackend, CppBackend, ...,
  bucket=128, persist=False)`, run before any timed leg.  Requests are a
  forged Shelley chain's (chainsynth: 2 pools, f = 4/5, epoch length 600,
  two transactions a block, KES depth 6), taken in chain order through
  `_seq_block_step` (two VRF proofs, the OCert signature and the KES
  signature of each header, then the transaction witnesses); every
  97th request has a byte of its signature or proof flipped.  The stream
  wraps to the chain's start when a leg needs more requests than the
  chain holds.  Legs:

  - saturated: `sim_legs`' phases (0.4 s at 5,000/s, then 0.2 s at
    10,000/s, both times `scale`), deadline 0.05 s, max_batch 256,
    max_queue 2048;
  - light load: 2 s at 2/s, as saturated: a flush of one request is below
    every primitive's break-even and takes `CppBackend`; two proofs of one
    header that land in one flush go to the card where that primitive's
    n* is 2, as the reference routes them;
  - back-pressure: 0.01 s at 20,000/s, max_batch 64, max_queue 32;
  - mempool: the first 200 blocks' transactions, one
    `Mempool.try_add_txs_async` call a block, while a second task submits
    the same blocks' header proofs through the same service; admissions,
    rejections and the snapshot must equal the synchronous `try_add_txs`
    on `CppBackend`.

  Every verdict must equal `CppBackend`'s (a sample of 64 is also held
  against `CpuRefBackend`); no verdict may be an exception and
  `service.dispatch_errors` may not move.  On the card each device batch
  must launch a kernel, and the saturated leg must launch
  `ed25519_split`, `vrf_verify` and `kes_hash`; under light load no
  flush below break-even may reach the card (`check_card`).  Latency is
  counted from a request's scheduled arrival to its verdict, so the
  event loop's stalls behind a synchronous device flush are in it.  Each
  leg also reports the seconds spent in device and fallback calls, and
  the device backend's per-key fills (`precompute.fill` spans) inside
  them.

The run is on the CUDA card unless `--device cpu` is given; without a
card it raises before forging.
"""
from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import random
import time
from dataclasses import replace

from . import chainsynth
from . import device as device_mod
from . import simharness as sim
from .chain.block import Point
from .consensus.batch import _seq_block_step
from .consensus.mempool import Mempool
from .crypto import kernels as K
from .crypto import ed25519_ref, kes, vrf_ref
from .crypto.backend import (CpuRefBackend, CryptoBackend, Ed25519Req,
                             KesReq, VrfReq)
from .crypto.batching import (_METHOD_OF, BreakEvenTable, ModeledBackend,
                              PrecheckedBackend, ServiceConfig,
                              VerifyService, calibrate_break_even)
from .crypto.cpp_backend import CppBackend
from .crypto.torch_backend import TorchBackend
from .observe import metrics as _metrics
from .observe import spans as _spans

# modeled serving costs used when no break-even calibration file exists
# for a real device (this container has none): ~libsodium-class 1 ms per
# CPU-reference proof vs a device batch costing a fixed ~2 ms dispatch +
# 20 µs per lane — the cost SHAPE every accelerator shares; the absolute
# numbers only scale the virtual clock.  With these, break-even is n*=3.
SERVE_MODEL_DEFAULTS = {"cpu_secs_per_req": 1e-3,
                        "device_setup_secs": 2e-3,
                        "device_secs_per_req": 2e-5}


def _serve_population():
    """A small pool of (request, expected-verdict) pairs covering every
    primitive, valid and corrupted — verdicts computed ONCE by the
    pure-Python oracle; the sim samples from the pool so a long trace
    costs no per-arrival EC math."""
    sk = hashlib.sha256(b"serve-ed").digest()
    vk = ed25519_ref.public_key(sk)
    vsk = hashlib.sha256(b"serve-vrf").digest()
    vvk = vrf_ref.public_key(vsk)
    ksk = kes.KesSignKey(4, hashlib.sha256(b"serve-kes").digest())
    kvk = ksk.verification_key
    good_kes = ksk.sign(b"kmsg")
    reqs = [Ed25519Req(vk, b"m%d" % i, ed25519_ref.sign(sk, b"m%d" % i))
            for i in range(4)]
    reqs.append(Ed25519Req(vk, b"bad", ed25519_ref.sign(sk, b"good")))
    reqs += [VrfReq(vvk, b"a%d" % i, vrf_ref.prove(vsk, b"a%d" % i))
             for i in range(3)]
    reqs.append(VrfReq(vvk, b"bad-alpha", vrf_ref.prove(vsk, b"a0")))
    reqs += [KesReq(4, kvk, 0, b"kmsg", good_kes.to_bytes()),
             KesReq(4, kvk, 1, b"kmsg", good_kes.to_bytes()),   # bad
             KesReq(4, kvk, 0, b"kmsg", b"\x00" * 7)]           # bad
    oracle = CpuRefBackend()
    want = {}
    want.update(zip(reqs[:5], oracle.verify_ed25519_batch(reqs[:5])))
    want.update(zip(reqs[5:9], oracle.verify_vrf_batch(reqs[5:9])))
    want.update(zip(reqs[9:], oracle.verify_kes_batch(reqs[9:])))
    return [(r, bool(want[r])) for r in reqs], want


def _serve_trace(seed, phases, population):
    """Seeded bursty arrival trace: per phase (label, duration_secs,
    rate_per_sec), Poisson arrivals (exponential gaps) each carrying a
    request sampled from the population.  Returns [(t, req, want)] —
    the SAME trace drives the service sim and the unbatched baseline."""
    rng = random.Random(seed)
    out = []
    t = 0.0
    for _label, duration, rate in phases:
        end = t + duration
        while True:
            t += rng.expovariate(rate)
            if t >= end:
                t = end
                break
            req, want = population[rng.randrange(len(population))]
            out.append((t, req, want))
    return out


def _serve_unbatched_baseline(trace, cpu_secs_per_req):
    """The per-request CPU baseline on the same trace: one sequential
    CPU verifier (an M/D/1 queue), each request costing
    `cpu_secs_per_req`.  Exact discrete-event fold — no sim needed.
    Returns (makespan_secs, latencies)."""
    free_at = 0.0
    lat = []
    for t, _req, _want in trace:
        start = max(t, free_at)
        free_at = start + cpu_secs_per_req
        lat.append(free_at - t)
    return (free_at if trace else 0.0), lat


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return round(sorted_vals[i], 6)


def _run_serve_trace(trace, model, deadline, cfg_kw, break_even):
    """One seeded trace through the VerifyService in deterministic sim
    time.  Returns (stats dict, latencies, parity_ok, leaked)."""
    arrivals = trace["arrivals"]
    lookup = PrecheckedBackend(CpuRefBackend(), dict(trace["want"]))
    device = ModeledBackend(model["device_setup_secs"],
                            model["device_secs_per_req"], inner=lookup,
                            name="modeled-device")
    cpu = ModeledBackend(0.0, model["cpu_secs_per_req"], inner=lookup,
                         name="modeled-cpu")
    results = []

    async def client(req, want):
        t0 = sim.now()
        ok = await svc.verify(req, deadline=deadline)
        results.append((sim.now() - t0, bool(ok) == want))

    svc = None

    async def main():
        nonlocal svc
        cfg = ServiceConfig(
            initial_latency=model["device_setup_secs"], **cfg_kw)
        svc = await VerifyService(device, cpu_ref=cpu, config=cfg,
                                  break_even=break_even).start()
        tasks = []
        for t, req, want in arrivals:
            gap = t - sim.now()
            if gap > 0:
                await sim.sleep(gap)
            tasks.append(sim.spawn(client(req, want),
                                   label=f"serve-client-{len(tasks)}"))
        for task in tasks:
            await task.wait()
        makespan = sim.now()
        await svc.stop()
        return makespan

    makespan, sim_trace = sim.run_trace(main())
    leaked = len(sim.leaked_threads(sim_trace))
    lat = sorted(l for l, _ in results)
    parity = all(ok for _, ok in results) and len(results) == len(arrivals)
    return {"makespan_secs": round(makespan, 6),
            "service": dict(svc.stats),
            "batch_size_hist": {str(k): svc.batch_sizes[k]
                                for k in sorted(svc.batch_sizes)}}, \
        lat, parity, leaked


def _serve_break_even(model, bucket=256):
    """BreakEvenTable derived from the latency model — NEVER from a
    persisted calibration file: the serve legs are a deterministic
    tier-1 gate, so routing (n*) and the modeled costs it was derived
    from must come from the same place.  Real-device calibration
    (`calibrate_break_even`) is for production services, where the same
    backend that was measured does the serving."""
    dev_batch = (model["device_setup_secs"]
                 + model["device_secs_per_req"] * bucket)
    cpu_one = model["cpu_secs_per_req"]
    # device cost is setup-dominated at coalescer sizes: break even where
    # n sequential CPU verifies outrun one device dispatch of n
    n_star = 1
    while (model["device_setup_secs"]
           + model["device_secs_per_req"] * n_star) >= cpu_one * n_star \
            and n_star < bucket:
        n_star += 1
    entries = {p: {"n_star": int(n_star),
                   "cpu_secs_per_req": cpu_one,
                   "device_secs_batch": round(dev_batch, 9),
                   "bucket": bucket}
               for p in ("ed25519", "vrf", "kes")}
    return BreakEvenTable(entries, "modeled-device"), True


def sim_legs(seed: int = 7, scale: float = 1.0,
             deadline: float = 0.05) -> dict:
    """`bench.serve_bench`: the coalescing service vs the unbatched
    per-request CPU baseline on seeded bursty sim traces.

    Three legs, all deterministic virtual time at a fixed seed:

    * **saturated** — Poisson warm phase + burst phases well past the
      single-CPU rate: the service must sustain >= 5x the unbatched
      baseline with p95 request latency inside the deadline;
    * **light_load** — arrival gaps far above the coalescing window:
      every flush is below break-even, so ZERO device dispatches (the
      whole trace rides the CPU fallback);
    * **backpressure** — a near-simultaneous burst against a tiny
      admission queue: submitters block (the back-pressure contract),
      nothing is lost, every verdict still lands.

    `scale` shrinks the trace; verdict parity vs the pure-Python oracle
    is asserted on EVERY leg.
    """
    population, want = _serve_population()
    model = dict(SERVE_MODEL_DEFAULTS)
    break_even, modeled = _serve_break_even(model)
    n_star = break_even.n_star("ed25519")

    def run(phases, cfg_kw):
        arrivals = _serve_trace(seed, phases, population)
        stats, lat, parity, leaked = _run_serve_trace(
            {"arrivals": arrivals, "want": want}, model, deadline,
            cfg_kw, break_even)
        return arrivals, stats, lat, parity, leaked

    out = {"seed": seed, "deadline_secs": deadline,
           "modeled_costs": modeled, "model": model,
           "break_even": break_even.snapshot()}

    # -- saturated: every phase's arrival rate sits well past the single-
    # CPU service rate (1/cpu_secs_per_req = 1000/s on the default
    # model), so the measured makespan ratio is the CAPACITY gap, not an
    # arrival-rate artifact — a cooldown below the CPU rate would let
    # the baseline catch up while the service idles
    phases = saturated_phases(scale)
    arrivals, stats, lat, parity, leaked = run(
        phases, {"max_batch": 256, "max_queue": 2048})
    cpu_makespan, cpu_lat = _serve_unbatched_baseline(
        arrivals, model["cpu_secs_per_req"])
    cpu_lat.sort()
    n = len(arrivals)
    svc_stats = stats["service"]
    misses = svc_stats["deadline_misses"]
    out["saturated"] = {
        "phases": [[p, round(d, 3), r] for p, d, r in phases],
        "requests": n,
        "makespan_secs": stats["makespan_secs"],
        "proofs_per_sec": round(n / stats["makespan_secs"], 1),
        "cpu_unbatched_makespan_secs": round(cpu_makespan, 6),
        "cpu_unbatched_proofs_per_sec": round(n / cpu_makespan, 1),
        "vs_unbatched_cpu": round(cpu_makespan / stats["makespan_secs"],
                                  2),
        "latency": {"p50": _pct(lat, 0.50), "p95": _pct(lat, 0.95),
                    "p99": _pct(lat, 0.99)},
        "cpu_unbatched_latency": {"p50": _pct(cpu_lat, 0.50),
                                  "p95": _pct(cpu_lat, 0.95),
                                  "p99": _pct(cpu_lat, 0.99)},
        "p95_within_deadline": _pct(lat, 0.95) <= deadline,
        "deadline_misses": misses,
        "deadline_miss_frac": round(misses / n, 4) if n else 0.0,
        "service": svc_stats,
        "batch_size_hist": stats["batch_size_hist"],
        "parity": parity,
        "leaked_threads": leaked,
    }

    # -- light load: gaps far above the coalescing window -------------------
    phases = [("idle", max(8.0 * scale, 2.0), 2.0)]
    arrivals, stats, lat, parity, leaked = run(
        phases, {"max_batch": 256, "max_queue": 2048})
    svc_stats = stats["service"]
    out["light_load"] = {
        "requests": len(arrivals),
        "break_even_n": n_star,
        "device_batches": svc_stats["device_batches"],
        "fallback_requests": svc_stats["fallback_requests"],
        "latency_p95": _pct(lat, 0.95),
        "parity": parity,
        "leaked_threads": leaked,
    }

    # -- back-pressure: burst >> tiny admission queue -----------------------
    phases = BACKPRESSURE_PHASES
    arrivals, stats, lat, parity, leaked = run(
        phases, BACKPRESSURE_CONFIG)
    svc_stats = stats["service"]
    out["backpressure"] = {
        "requests": len(arrivals),
        "max_queue": 32,
        "backpressure_waits": svc_stats["backpressure_waits"],
        "completed": svc_stats["submitted"],
        "parity": parity,
        "leaked_threads": leaked,
    }
    out["ok"] = bool(
        out["saturated"]["parity"] and out["light_load"]["parity"]
        and out["backpressure"]["parity"]
        and out["saturated"]["vs_unbatched_cpu"] >= 5.0
        and out["saturated"]["p95_within_deadline"]
        and out["light_load"]["device_batches"] == 0
        and out["saturated"]["leaked_threads"] == 0
        and out["light_load"]["leaked_threads"] == 0
        and out["backpressure"]["leaked_threads"] == 0)
    return out


# -- the card legs ------------------------------------------------------------

DEADLINE = 0.05
SATURATED_CONFIG = {"max_batch": 256, "max_queue": 2048}
LIGHT_PHASES = [("idle", 2.0, 2.0)]
BACKPRESSURE_PHASES = [("slam", 0.01, 20000.0)]
BACKPRESSURE_CONFIG = {"max_batch": 64, "max_queue": 32}
MEMPOOL_BLOCKS = 200
TAMPER_EVERY = 97            # request i is tampered when i % 97 == 96
CPU_REF_SAMPLE = 64
CALIBRATION_BUCKET = 128
# the kernels a device flush of the serve path can launch
SERVE_KERNELS = ("ed25519_split", "vrf_verify", "kes_hash")
# chainsynth's parameters for the replay's chain (chip_smoke.py phase 5)
KES_DEPTH = 6
EPOCH_LENGTH = 600


def saturated_phases(scale: float) -> list:
    return [("warm", 0.4 * scale, 5000.0), ("burst", 0.2 * scale, 10000.0)]


def arrival_times(seed: int, phases) -> list:
    """`_serve_trace`'s Poisson arrival instants for `phases`, without
    the population: the card legs carry the chain's requests instead."""
    return [t for t, _r, _w in _serve_trace(seed, phases, [(None, None)])]


def _flip(b: bytes, at: int) -> bytes:
    return b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]


def tamper(req):
    """`req` with one byte of its signature or proof flipped: an Ed25519
    signature's s, a VRF proof's challenge, a KES leaf signature's R."""
    if isinstance(req, Ed25519Req):
        return replace(req, sig=_flip(req.sig, 40))
    if isinstance(req, VrfReq):
        return replace(req, proof=_flip(req.proof, 40))
    return replace(req, sig_bytes=_flip(req.sig_bytes, 8))


def chain_proofs(ext, chain) -> list:
    """Per block, (header proofs, transaction witness requests) as the
    sequential pass `_seq_block_step` extracts them, in chain order."""
    st = ext.initial_state()
    out = []
    for blk in chain:
        reqs, st = _seq_block_step(ext.protocol, ext.ledger, st, blk)
        cut = len(reqs) - sum(len(tx.witnesses) for tx in blk.body)
        out.append((reqs[:cut], reqs[cut:]))
    return out


def request_stream(per_block, n: int) -> list:
    """The first n requests of the chain in order (wrapping to its start
    if it holds fewer), every TAMPER_EVERY-th one tampered."""
    flat = [r for hdr, body in per_block for r in hdr + body]
    return [tamper(flat[i % len(flat)]) if i % TAMPER_EVERY
            == TAMPER_EVERY - 1 else flat[i % len(flat)] for i in range(n)]


class WatchedBackend(CryptoBackend):
    """A backend as the service sees it: each batch call passes through to
    `inner` and is logged as (primitive, requests, seconds, kernel
    launches).  Carries `inner`'s name and padding ladder, which the
    service reads."""

    def __init__(self, inner: CryptoBackend):
        self.inner = inner
        self.name = inner.name
        self.min_bucket = getattr(inner, "min_bucket", None)
        self.log: list = []

    def _pass(self, prim: str, reqs):
        before = sum(K.LAUNCHES.values())
        t = time.perf_counter()
        out = getattr(self.inner, _METHOD_OF[prim])(reqs)
        self.log.append((prim, len(reqs), time.perf_counter() - t,
                         sum(K.LAUNCHES.values()) - before))
        return out

    def verify_ed25519_batch(self, reqs):
        return self._pass("ed25519", reqs)

    def verify_vrf_batch(self, reqs):
        return self._pass("vrf", reqs)

    def verify_kes_batch(self, reqs):
        return self._pass("kes", reqs)

    def summary(self) -> dict:
        """Per primitive: calls, requests, the fewest requests a call
        carried, seconds in the calls, calls that launched no kernel."""
        out: dict = {}
        for prim, n, secs, launched in self.log:
            d = out.setdefault(prim, {"calls": 0, "requests": 0,
                                      "min_requests": n, "secs": 0.0,
                                      "calls_without_launch": 0})
            d["calls"] += 1
            d["requests"] += n
            d["min_requests"] = min(d["min_requests"], n)
            d["secs"] += secs
            d["calls_without_launch"] += not launched
        return out


def _hist_delta(name: str, before: dict) -> dict:
    """A histogram's counts since the `before` snapshot: {edge: count},
    the non-zero buckets only."""
    now = _metrics.registry().get(name).snapshot_value()
    out = {edge: c - before["buckets"].get(edge, 0)
           for edge, c in now["buckets"].items()}
    out["+Inf"] = now["overflow"] - before["overflow"]
    return {k: v for k, v in out.items() if v}


class _Leg:
    """What one card leg measures around its run, each counted from the
    leg's start: the kernel launches, both backends' calls (device and
    fallback), the device backend's per-key fills and their
    `precompute.fill` span seconds, `service.dispatch_errors` and the
    `service.batch_bucket` histogram."""

    def __init__(self, device: WatchedBackend, cpu: WatchedBackend):
        self.device, self.cpu = device, cpu
        reg = _metrics.registry()
        K.reset_launches()
        device.log.clear()
        cpu.log.clear()
        self.fills0 = device.inner.cache.device_fills
        self.errors0 = reg.get("service.dispatch_errors").value
        self.bucket0 = reg.get("service.batch_bucket").snapshot_value()
        self.was_recording = _spans.RECORDER.enabled
        _spans.RECORDER.drain()
        _spans.RECORDER.enable()

    def report(self, svc: VerifyService, n: int, makespan: float,
               lat: list, leaked: int) -> dict:
        roots = _spans.RECORDER.drain()
        if not self.was_recording:
            _spans.RECORDER.disable()
        lat = sorted(lat)
        reg = _metrics.registry()
        device = self.device.summary()
        return {
            "requests": n, "makespan_secs": makespan,
            "proofs_per_sec": n / makespan if makespan else 0.0,
            "latency": {"p50": _pct(lat, 0.50), "p95": _pct(lat, 0.95),
                        "p99": _pct(lat, 0.99)},
            "deadline_misses": svc.stats["deadline_misses"],
            "service": dict(svc.stats),
            "batch_size_hist": {str(k): svc.batch_sizes[k]
                                for k in sorted(svc.batch_sizes)},
            "batch_bucket_hist": _hist_delta("service.batch_bucket",
                                             self.bucket0),
            "dispatch_errors": (reg.get("service.dispatch_errors").value
                                - self.errors0),
            "device": device, "fallback": self.cpu.summary(),
            "device_call_secs": sum(d["secs"] for d in device.values()),
            "device_calls_without_launch": sum(
                d["calls_without_launch"] for d in device.values()),
            "fills": self.device.inner.cache.device_fills - self.fills0,
            "fill_secs": sum(sp.duration for root in roots
                             for sp in root.walk()
                             if sp.name == "precompute.fill"),
            "launches": dict(K.LAUNCHES),
            "leaked_tasks": leaked,
        }


def _live_tasks() -> int:
    """asyncio tasks other than the caller that have not finished."""
    me = asyncio.current_task()
    return sum(1 for t in asyncio.all_tasks() if t is not me and not t.done())


def _service(device, cpu, break_even, cfg_kw) -> VerifyService:
    return VerifyService(device, cpu_ref=cpu, break_even=break_even,
                         config=ServiceConfig(default_deadline=DEADLINE,
                                              **cfg_kw))


def run_leg(device: WatchedBackend, cpu: WatchedBackend, break_even,
            times: list, reqs: list, cfg_kw: dict) -> tuple:
    """One trace through a fresh service under `sim.io_run`: request i
    arrives at times[i] seconds after the leg starts.  Returns (the leg's
    report, the verdicts in request order: bool, or the exception a
    caller got)."""
    leg = _Leg(device, cpu)
    verdicts: list = [None] * len(reqs)
    done_at: list = [None] * len(reqs)

    async def client(svc, i, req):
        try:
            verdicts[i] = await svc.verify(req)
        except Exception as e:          # the dispatch error IS the verdict
            verdicts[i] = e
        done_at[i] = sim.now()

    async def main():
        svc = await _service(device, cpu, break_even, cfg_kw).start()
        t0 = sim.now()
        tasks = []
        for i, (t, req) in enumerate(zip(times, reqs)):
            gap = t0 + t - sim.now()
            if gap > 0:
                await sim.sleep(gap)
            tasks.append(sim.spawn(client(svc, i, req),
                                   label=f"serve-client-{i}"))
        for task in tasks:
            await task.wait()
        makespan = sim.now() - t0
        await svc.stop()
        lat = [d - (t0 + t) for d, t in zip(done_at, times)]
        return svc, makespan, lat, _live_tasks()

    svc, makespan, lat, leaked = sim.io_run(main())
    return leg.report(svc, len(reqs), makespan, lat, leaked), verdicts


def _tamper_txs(body, j0: int) -> tuple:
    """A block's transactions, the witness of each one whose index in the
    stream of transactions (from j0) is a TAMPER_EVERY-th flipped."""
    out = []
    for j, tx in enumerate(body, j0):
        if j % TAMPER_EVERY == TAMPER_EVERY - 1:
            (vk, sig), *rest = tx.witnesses
            tx = replace(tx, witnesses=((vk, _flip(sig, 40)), *rest))
        out.append(tx)
    return tuple(out)


def mempool_leg(ext, chain, per_block, device: WatchedBackend,
                cpu: WatchedBackend, break_even, n_blocks: int) -> dict:
    """The first n_blocks blocks' transactions into a fresh Mempool at
    genesis, one `try_add_txs_async` call a block through the service,
    while a second task submits the same blocks' header proofs through it;
    then the same transactions through the synchronous `try_add_txs` on
    `CppBackend`.  Returns the leg's report with both paths' admissions."""
    blocks = chain[:n_blocks]
    txs, j = [], 0
    for blk in blocks:
        txs.append(_tamper_txs(blk.body, j))
        j += len(blk.body)
    genesis = ext.initial_state().ledger

    def fresh(backend):
        return Mempool(ext.ledger, lambda: (genesis, Point.genesis()),
                       backend=backend)

    want_cpu = cpu.inner
    ref = fresh(want_cpu)
    want = [ref.try_add_txs(list(b)) for b in txs]
    hdr_want = want_cpu.verify_mixed([r for hdr, _b in per_block[:n_blocks]
                                      for r in hdr])
    mp = fresh(want_cpu)
    leg = _Leg(device, cpu)
    lat: list = []

    async def main():
        svc = await _service(device, cpu, break_even,
                             SATURATED_CONFIG).start()
        mp.verify_service = svc
        t0 = sim.now()

        async def headers():
            # batch-of-1 headers at the tip: one header's proofs at a
            # time, coalesced with the mempool's witness checks
            out = []
            for hdr, _body in per_block[:n_blocks]:
                t = sim.now()
                out.extend(await svc.verify_many(hdr))
                lat.append(sim.now() - t)
            return out

        hdr_task = sim.spawn(headers(), label="serve-headers")
        got = []
        for b in txs:
            t = sim.now()
            got.append(await mp.try_add_txs_async(list(b)))
            lat.append(sim.now() - t)
        hdr_got = await hdr_task.wait()
        makespan = sim.now() - t0
        await svc.stop()
        return svc, got, hdr_got, makespan, _live_tasks()

    svc, got, hdr_got, makespan, leaked = sim.io_run(main())
    n = svc.stats["submitted"]
    out = leg.report(svc, n, makespan, lat, leaked)

    def admissions(res):
        return [([a.hex() for a in added], [t.txid.hex() for t, _e in rej])
                for added, rej in res]
    out.update(
        blocks=len(blocks), txs=sum(len(b) for b in txs),
        admitted=sum(len(a) for a, _r in got),
        rejected=sum(len(r) for _a, r in got),
        admissions_equal=admissions(got) == admissions(want),
        snapshot_equal=mp.get_snapshot().tx_ids == ref.get_snapshot().tx_ids,
        header_verdicts_equal=hdr_got == hdr_want)
    return out


def card_legs(ext, chain, backend: TorchBackend, seed: int = 7,
              scale: float = 1.0, log=None) -> dict:
    """The four card legs over `backend` (module doc), with the break-even
    table calibrated first.  Returns the `card` dict; `check_card` says
    what it must show."""
    log = log or (lambda *_a: None)
    cpu = CppBackend()
    t = time.perf_counter()
    break_even = calibrate_break_even(
        backend, cpu, backend.device_kind, bucket=CALIBRATION_BUCKET,
        persist=False)
    cal_s = time.perf_counter() - t
    log(f"serve: break-even calibrated in {cal_s:.3f} s: "
        + ", ".join(f"{p} n* {e['n_star']}" for p, e
                    in break_even.entries.items()))
    device, fallback = WatchedBackend(backend), WatchedBackend(cpu)
    legs = {"saturated": (saturated_phases(scale), SATURATED_CONFIG),
            "light_load": (LIGHT_PHASES, SATURATED_CONFIG),
            "backpressure": (BACKPRESSURE_PHASES, BACKPRESSURE_CONFIG)}
    times = {name: arrival_times(seed, phases)
             for name, (phases, _c) in legs.items()}
    need = sum(len(v) for v in times.values())
    # a block carries at least its header's four proofs: the sequential
    # pass runs over no more blocks than the legs can use
    per_block = chain_proofs(ext, chain[:max(MEMPOOL_BLOCKS, -(-need // 4))])
    stream = request_stream(per_block, need)
    t = time.perf_counter()
    want = cpu.verify_mixed(stream)
    want_s = time.perf_counter() - t
    tampered = [i % TAMPER_EVERY == TAMPER_EVERY - 1
                for i in range(len(stream))]
    rng = random.Random(seed)
    sample = sorted(set(rng.sample(range(len(stream)), CPU_REF_SAMPLE))
                    | {TAMPER_EVERY - 1, 2 * TAMPER_EVERY - 1})
    ref = CpuRefBackend().verify_mixed([stream[i] for i in sample])
    out = {"device_kind": backend.device_kind, "seed": seed,
           "scale": scale, "deadline_secs": DEADLINE,
           "calibration_s": cal_s, "break_even": break_even.snapshot(),
           "requests": len(stream), "tampered": sum(tampered),
           "cpp_verdicts_s": want_s,
           "cpp_verdicts_match_tampering": all(
               w == (not tp) for w, tp in zip(want, tampered)),
           "cpu_ref_sample": len(sample),
           "cpu_ref_sample_equal": ref == [want[i] for i in sample]}
    start = 0
    for name, (phases, cfg_kw) in legs.items():
        n = len(times[name])
        reqs = stream[start:start + n]
        rep, verdicts = run_leg(device, fallback, break_even, times[name],
                                reqs, cfg_kw)
        rep["phases"] = [[p, d, r] for p, d, r in phases]
        rep["exceptions"] = sum(isinstance(v, BaseException)
                                for v in verdicts)
        rep["verdicts_equal_cpp"] = verdicts == want[start:start + n]
        out[name] = rep
        start += n
        log(f"serve {name}: {_summary(rep)}")
    out["mempool"] = mempool_leg(ext, chain, per_block, device, fallback,
                                 break_even, min(MEMPOOL_BLOCKS, len(chain)))
    log(f"serve mempool: {_summary(out['mempool'])}; admitted "
        f"{out['mempool']['admitted']}, rejected "
        f"{out['mempool']['rejected']}")
    return out


def _summary(rep: dict) -> str:
    lat = rep["latency"]
    return (f"{rep['requests']} requests, {rep['proofs_per_sec']:.1f} "
            f"proofs/s, makespan {rep['makespan_secs']:.4f} s, p50/p95/p99 "
            f"{lat['p50']}/{lat['p95']}/{lat['p99']} s, "
            f"{rep['deadline_misses']} deadline misses, device batches "
            f"{rep['service']['device_batches']}, fallback batches "
            f"{rep['service']['fallback_batches']}, back-pressure waits "
            f"{rep['service']['backpressure_waits']}; device calls "
            f"{rep['device_call_secs']:.4f} s ({rep['fills']} fills, "
            f"{rep['fill_secs']:.4f} s), fallback calls "
            f"{sum(d['secs'] for d in rep['fallback'].values()):.4f} s; "
            f"launches {rep['launches']}")


def check_card(card: dict, on_card: bool) -> list:
    """What the card legs must show (module doc); returns the failures.
    Launch checks apply only `on_card`: on the CPU the wrappers run
    their plain versions and count nothing."""
    bad = []
    if not card["cpp_verdicts_match_tampering"]:
        bad.append("CppBackend's verdicts are not 'valid unless tampered'")
    if not card["cpu_ref_sample_equal"]:
        bad.append("the CpuRefBackend sample disagrees with CppBackend")
    for name in ("saturated", "light_load", "backpressure", "mempool"):
        rep = card[name]
        if rep.get("exceptions") or rep["dispatch_errors"]:
            bad.append(f"{name}: a dispatch failed")
        if rep.get("verdicts_equal_cpp") is False:
            bad.append(f"{name}: verdicts != CppBackend's")
        if rep["leaked_tasks"]:
            bad.append(f"{name}: {rep['leaked_tasks']} tasks leaked")
        if on_card and rep["device_calls_without_launch"]:
            bad.append(f"{name}: a device batch launched no kernel")
    if on_card:
        missing = [k for k in SERVE_KERNELS
                   if not card["saturated"]["launches"][k]]
        if missing:
            bad.append(f"saturated: kernels not launched: {missing}")
    # light load: the reference's break-even routing.  A lone request
    # never beats one CPU verify; a group of two can, where n* is 2
    n_star = {p: e["n_star"]
              for p, e in card["break_even"]["entries"].items()}
    light = card["light_load"]
    if any(d["min_requests"] < n_star[p]
           for p, d in light["device"].items()):
        bad.append("light load: a flush below break-even went to the "
                   "device")
    if not light["service"]["fallback_batches"]:
        bad.append("light load: no flush took the CPU fallback")
    bp = card["backpressure"]
    if not bp["service"]["backpressure_waits"] or \
            bp["service"]["submitted"] != bp["requests"]:
        bad.append("back-pressure: no waits, or a verdict not delivered")
    mp = card["mempool"]
    if not (mp["admissions_equal"] and mp["snapshot_equal"]
            and mp["header_verdicts_equal"]):
        bad.append("mempool: the service path != the synchronous path")
    return bad


def run(device=None, blocks: int = 720, scale: float = 1.0, seed: int = 7,
        log=None) -> dict:
    """Both parts: the sim legs, then the card legs over a chain of
    `blocks` forged blocks.  Raises without a card unless device='cpu'."""
    backend = TorchBackend(device_mod.resolve(device))
    t = time.perf_counter()
    ext, chain, _state = chainsynth.forge_shelley(
        blocks, epoch_length=EPOCH_LENGTH, kes_depth=KES_DEPTH)
    forge_s = time.perf_counter() - t
    card = card_legs(ext, chain, backend, seed, scale, log)
    card.update(blocks=blocks, forge_s=forge_s)
    return {"sim": sim_legs(seed, scale), "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--blocks", type=int, default=720)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    out = run(a.device, a.blocks, a.scale, a.seed, log=print)
    bad = check_card(out["card"], out["card"]["device_kind"] != "cpu")
    bad += [] if out["sim"]["ok"] else ["sim legs: a gate failed"]
    for b in bad:
        print("FAILED:", b)
    print(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
