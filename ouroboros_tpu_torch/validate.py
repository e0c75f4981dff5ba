"""Validate Shelley-shaped windows through the port's crypto seam.

    python -m ouroboros_tpu_torch.validate [--windows 3] [--window 1024]
        [--pools 1024] [--seed 0] [--workers N] [--tamper W:B]
        [--device cuda|cpu] [--profile]

It makes `--windows` windows of `--window` blocks from `--seed`
(windowgen.py: two VRF proofs, an OCert signature, a Sum6 KES signature
and two transaction witnesses per block) and drives them through
`TorchBackend` the way `consensus/pipeline.py:replay_threaded` drives the
JAX backend: a producer thread packs and submits window w+1 with
`fold=True`, carrying the next window's VRF proofs for their betas, while
the caller drains window w; at most two windows are in flight.  It
prints each window's first bad block and host seconds, blocks/s and
proofs/s; `--profile` traces the card and adds its busy seconds and the
kernels that took its time.  Data generation runs first, outside every
timed region, and its seconds are printed on their own line.

`--tamper W:B` flips a byte of block B's first witness signature in
window W, so that window must report block B.  The run is on the CUDA
card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

from . import device as device_mod
from . import windowgen
from .crypto.backend import VrfReq
from .crypto.torch_backend import TorchBackend

DEPTH = 2          # windows in flight


def _flatten(blocks):
    reqs: list = []
    owner: list[int] = []
    for b, rs in enumerate(blocks):
        reqs.extend(rs)
        owner.extend([b] * len(rs))
    return reqs, owner


def drive(windows, backend) -> dict:
    """Replay `windows` (lists of blocks of requests) through `backend`
    with a producer thread, two windows in flight.  Returns per-window
    verdicts, the betas each drain delivered, and the timed seconds.
    Each window also reports `submit_s`, the producer's host seconds in
    submit_window (prep, per-key fills, launches), and `wait_s`, the
    seconds the drain spent in finish_window."""
    permits = threading.Semaphore(DEPTH)
    handoff: queue.Queue = queue.Queue()
    stop = threading.Event()

    def produce():
        try:
            for w, blocks in enumerate(windows):
                permits.acquire()
                if stop.is_set():
                    break
                reqs, owner = _flatten(blocks)
                nxt = ([r.proof for b in windows[w + 1] for r in b
                        if isinstance(r, VrfReq)]
                       if w + 1 < len(windows) else [])
                t = time.perf_counter()
                sub = backend.submit_window(reqs, nxt, fold=True)
                handoff.put((w, sub, owner, len(reqs),
                             time.perf_counter() - t))
        except BaseException as e:      # hand the failure to the drain side
            handoff.put(e)
            return
        handoff.put(None)

    results = []
    betas: dict = {}
    t0 = time.perf_counter()
    producer = threading.Thread(target=produce, name="window-producer")
    producer.start()
    try:
        while True:
            item = handoff.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            w, sub, owner, n_reqs, submit_s = item
            t = time.perf_counter()
            verdict, bs = backend.finish_window(sub)
            wait_s = time.perf_counter() - t
            permits.release()
            betas.update(bs)
            bad = verdict.first_bad
            results.append({"window": w, "blocks": len(windows[w]),
                            "requests": n_reqs, "all_ok": verdict.all_ok,
                            "first_bad_request": bad,
                            "first_bad_block": None if bad is None
                            else owner[bad],
                            "submit_s": submit_s, "wait_s": wait_s})
    finally:
        stop.set()
        permits.release()
        producer.join()
    seconds = time.perf_counter() - t0
    n_blocks = sum(len(w) for w in windows)
    n_reqs = sum(r["requests"] for r in results)
    return {"windows": results, "betas": betas, "seconds": seconds,
            "blocks_per_s": n_blocks / seconds,
            "proofs_per_s": n_reqs / seconds}


def profile_drive(windows, backend, top: int = 12) -> dict:
    """drive() under torch.profiler (device.profiled).  Adds
    `device_busy_s`, the union of the traced device intervals, and
    `device_top`, the `top` names by total device milliseconds as
    [name, ms, count]."""
    out, busy_s, rows = device_mod.profiled(
        lambda: drive(windows, backend), backend.device.type == "cuda", top)
    out.update(device_busy_s=busy_s, device_top=rows)
    return out


def run(n_windows: int = 3, window: int = 1024, pools: int = 1024,
        seed: int = 0, workers: int = 1, tamper=None, device=None,
        profile: bool = False) -> dict:
    """Make the windows, then drive them (under the profiler with
    `profile`).  `tamper` is (window, block) or None.  Returns drive()'s
    dict plus the generation seconds."""
    backend = TorchBackend(device)
    t0 = time.perf_counter()
    windows = windowgen.make_windows(seed, n_windows, window, pools,
                                     workers)
    if tamper is not None:
        w, b = tamper
        windows[w][b] = windowgen.tamper_witness(windows[w][b])
    gen_seconds = time.perf_counter() - t0
    out = (profile_drive if profile else drive)(windows, backend)
    out.update(gen_seconds=gen_seconds, device=backend.device_kind)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--pools", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--tamper", default=None, help="W:B")
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="trace the card: device busy seconds and the "
                    "kernels by device time")
    a = ap.parse_args(argv)
    tamper = (tuple(int(x) for x in a.tamper.split(":"))
              if a.tamper else None)
    out = run(a.windows, a.window, a.pools, a.seed, a.workers, tamper,
              a.device, profile=a.profile)
    print(f"data generation: {out['gen_seconds']:.3f} s "
          f"({a.workers} workers)")
    for r in out["windows"]:
        print(f"window {r['window']}: blocks={r['blocks']} "
              f"requests={r['requests']} "
              f"first_bad_block={r['first_bad_block']} "
              f"submit_s={r['submit_s']:.4f} wait_s={r['wait_s']:.4f}")
    if a.profile:
        for name, ms, count in out["device_top"]:
            print(f"device {ms:10.3f} ms {count:7d} x {name}")
        print(f"device busy {out['device_busy_s']:.4f} s of "
              f"{out['seconds']:.4f} s (profiled)")
    print(json.dumps({"device": out["device"],
                      "seconds": out["seconds"],
                      "blocks_per_s": out["blocks_per_s"],
                      "proofs_per_s": out["proofs_per_s"],
                      "first_bad_blocks": [r["first_bad_block"]
                                           for r in out["windows"]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
