"""Perf probe: repeated measurements of the standalone batch-verify paths.

    python -m ouroboros_tpu_torch.perf_probe [--reps 5] [--n-ed 4096]
        [--n-vrf 2048] [--skip-vrf] [--old] [--device cpu]

The port of `tools/perf_probe.py`.  Each row runs once untimed (the
kernel build and the per-key fill land there), then `--reps` times, each
call fenced with `torch.cuda.synchronize()`; it prints the median and
min/max rates, one line a row, and last one JSON line of the medians.

Rows: `ed split e2e` (prepare_words_batch, the shared per-key cache and
the `ed25519_split` kernel) and `ed split device` (the kernel on staged
tensors); with `--old`, `ed full e2e` (`kernels.batch_verify_ed25519`)
and `ed full device` (the `ed25519_verify` kernel on staged tensors);
then `vrf e2e` (`vrf.batch_verify_vrf`) and `betas e2e`
(`vrf.batch_betas`) unless `--skip-vrf`.  Every row asserts that all its
lanes verify.

Data: one Ed25519 key signs `--n-ed` messages and one VRF key proves
`--n-vrf` inputs, from fixed seeds, in pure Python spread over one
worker process a CPU (windowgen.signatures / proofs).  The run is on the
CUDA card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import time

import numpy as np
import torch

from . import device as device_mod
from . import windowgen
from .crypto import ed25519 as E
from .crypto import ed25519_ref, vrf_ref
from .crypto import kernels as K
from .crypto import vrf as V
from .crypto.precompute import shared_cache


def all_valid(row: str, oks) -> None:
    """Every lane of a row verifies (the probes' data is all valid);
    raises naming the first lanes that did not."""
    bad = np.flatnonzero(~np.asarray(oks, dtype=bool))
    if bad.size:
        raise AssertionError(f"{row}: {bad.size} lanes rejected, first "
                             f"{bad[:4].tolist()}")


def timed(fn, reps, fence):
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        fence()
        vals.append(time.perf_counter() - t0)
    return vals


def report(name, n, vals):
    med = statistics.median(vals)
    spread = (max(vals) - min(vals)) / med if med else 0
    print(f"{name:28s} n={n:5d}  median {n / med:9.1f}/s   "
          f"min {n / max(vals):9.1f}/s  max {n / min(vals):9.1f}/s  "
          f"spread {100 * spread:.0f}%", flush=True)
    return n / med


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n-ed", type=int, default=4096)
    ap.add_argument("--n-vrf", type=int, default=2048)
    ap.add_argument("--skip-vrf", action="store_true")
    ap.add_argument("--old", action="store_true",
                    help="also run the full 256-bit Ed25519 verify")
    ap.add_argument("--device", default=None,
                    help='"cpu" runs the plain versions; default the card')
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    workers = os.cpu_count() or 1

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows: dict = {}

    def row(name, n, fn):
        fn()
        fence()
        vals = timed(fn, args.reps, fence)
        rows[name] = {"n": n, "median_s": statistics.median(vals),
                      "per_s": report(name, n, vals)}

    t = time.perf_counter()
    n = args.n_ed
    sk = hashlib.sha256(b"probe").digest()
    vks = [ed25519_ref.public_key(sk)] * n
    msgs = [b"m%06d" % i for i in range(n)]
    sigs = windowgen.signatures(sk, msgs, workers)
    nv = 0 if args.skip_vrf else args.n_vrf
    vsk = hashlib.sha256(b"probe-vrf").digest()
    vvks = [vrf_ref.public_key(vsk)] * nv
    alphas = [b"a%d" % i for i in range(nv)]
    proofs = windowgen.proofs(vsk, alphas, workers)
    print(f"data seconds: {time.perf_counter() - t:.3f} ({n} signatures, "
          f"{nv} proofs, {workers} workers)", flush=True)

    # --- Ed25519 split-128 (the validation window's kernel)
    cache = shared_cache(dev)

    def run_split_e2e():
        (Aw, _sA, Rw, signR, sw, kw), parse_ok = E.prepare_words_batch(
            vks, msgs, sigs)
        xa, xw, yw, known = cache.assemble(vks)
        ok = K.ed25519_split(*device_mod.stage(
            (Aw, xa, xw, yw, Rw, signR, sw, kw), dev))
        all_valid("ed split e2e", ok.cpu().numpy() & parse_ok & known)
    row("ed split e2e", n, run_split_e2e)

    (Aw, _sA, Rw, signR, sw, kw), _ = E.prepare_words_batch(vks, msgs, sigs)
    xa, xw, yw, _known = cache.assemble(vks)
    split_args = device_mod.stage((Aw, xa, xw, yw, Rw, signR, sw, kw), dev)

    def run_split_dev():
        all_valid("ed split device",
                  K.ed25519_split(*split_args).cpu().numpy())
    row("ed split device", n, run_split_dev)

    # --- Ed25519 full 256-bit (the standalone batch verify's kernel)
    if args.old:
        def run_full_e2e():
            all_valid("ed full e2e",
                      K.batch_verify_ed25519(vks, msgs, sigs, device=dev))
        row("ed full e2e", n, run_full_e2e)

        arrays, _ = E.prepare_words_batch(vks, msgs, sigs)
        full_args = device_mod.stage(arrays, dev)

        def run_full_dev():
            all_valid("ed full device",
                      K.ed25519_verify(*full_args).cpu().numpy())
        row("ed full device", n, run_full_dev)

    # --- VRF verify and betas
    if nv:
        def run_vrf():
            oks, _betas = V.batch_verify_vrf(vvks, alphas, proofs,
                                             device=dev)
            all_valid("vrf e2e", oks)
        row("vrf e2e", nv, run_vrf)

        def run_betas():
            betas = V.batch_betas(proofs, device=dev)
            all_valid("betas e2e", [b is not None for b in betas])
        row("betas e2e", nv, run_betas)

    print(json.dumps({"perf_probe": {
        "device": device_mod.device_kind(dev), "reps": args.reps,
        "rows": rows}}), flush=True)
    return rows


if __name__ == "__main__":
    main()
