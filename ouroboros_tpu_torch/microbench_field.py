"""Per-operation costs of the field and point arithmetic on the card, and
host prep against device time on the verify paths.

    python -m ouroboros_tpu_torch.microbench_field [--ops] [--e2e]
        [--lanes 4096] [--reps 7] [--n-ed 4096] [--n-vrf 2048]
        [--n-kes 4096] [--device cpu]

The port of `experiments/microbench_field.py`; with neither flag it runs
`--e2e`, as that script does.

`--ops` runs chains of k field operations a lane through the
`field_chain` kernel (mul, sqr, add, carry at k = 64 and 192) and of k
point operations through `point_chain` (one thread a lane) and
`point_chain_x4` (four threads a lane) (dbl, addc at k = 32 and 96), on
`--lanes` lanes of the JAX script's inputs: two (20, N) radix-2^13 limb
arrays from default_rng(0), carried across by value
(`field.limbs_from_radix13`).  The cost of one batched operation is the
difference of the two chains' times over the difference of their
lengths, printed in microseconds and in cycles at the card's maximum SM
clock (`nvidia-smi --query-gpu=clocks.max.sm`).  Times are device times:
the chain kernel's duration from torch.profiler, median of `--reps`
calls after two warm-ups (`device.kernel_ms`); a line says where the
trace held more or fewer launches than calls, or where CUDA events had
to stand in.  4096 lanes, the default, are the JAX shape and
one warp an SM for the one-thread kernels; 65536 lanes are sixteen.  A
time per operation that stays flat from the one to the other is the
latency of the chain; one that grows with the warps is issue.

`--e2e` ports `bench_e2e`: host prep against device time for the full
Ed25519 verify, the VRF verify and the betas, the host-to-device copy,
the VRF and beta finish, and the KES host hash path, each row through
the port's own function (the row names it, and the JAX function it
stands for where the names differ).  Every row's data must verify.  The
data is made in pure Python from fixed seeds over one spawned process a
CPU (`windowgen`).

The run is on the CUDA card unless `--device cpu` is given (the plain
versions, host times only); without a card it raises.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from . import device as D
from . import windowgen
from .crypto import ed25519 as E
from .crypto import ed25519_ref, kes, vrf_ref
from .crypto import field as F
from .crypto import kernels as K
from .crypto import vrf as V
from .crypto.backend import CryptoBackend, KesReq
from .crypto.precompute import shared_cache
from .perf_probe import all_valid

FIELD_K = (64, 192)
POINT_K = (32, 96)
# kernel, its operations, the two chain lengths
CHAINS = (("field_chain", F.FIELD_OPS, FIELD_K),
          ("point_chain", E.POINT_OPS, POINT_K),
          ("point_chain_x4", E.POINT_OPS, POINT_K))
# 32-bit operations a lane does per chain step, the chains' bound: 100
# multiply-adds a product and 55 a square; carry is carry_round64's 51
# 64-bit adds, shifts, subtractions and multiply, two 32-bit operations
# each; add is that plus fe_add's 10 adds (csrc/field_chain.cu)
OPS_PER_STEP = {"mul": 100, "sqr": 55, "add": 10 + 102, "carry": 102,
                "dbl": 4 * 55 + 4 * 100, "addc": 9 * 100}


def inputs(lanes: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's two inputs, (20, lanes) radix-2^13 limbs from
    default_rng(0), as (10, lanes) int32 carried limbs on `device`."""
    rng = np.random.default_rng(0)
    raw = [rng.integers(0, 8191, size=(20, lanes), dtype=np.int32)
           for _ in range(2)]
    return tuple(F.limbs_from_radix13(r).to(torch.int32).to(device)
                 for r in raw)


def timed(fn, reps: int = 7, warm: int = 2) -> tuple[float, float, float]:
    """Host seconds of fn(): (median, min, max) over `reps` calls after
    `warm` untimed ones (the JAX script's `timed`)."""
    for _ in range(warm):
        fn()
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        vals.append(time.perf_counter() - t0)
    vals.sort()
    return vals[len(vals) // 2], vals[0], vals[-1]


def _call_ms(fn, name: str, dev: torch.device,
             reps: int) -> tuple[float, str]:
    """Milliseconds of one call of the wrapper of kernel `name`: the
    kernel's device time on the card, host time of the plain version on
    the CPU."""
    if dev.type == "cuda":
        return D.kernel_ms(fn, f"{name}_kernel", reps)
    return timed(fn, reps)[0] * 1e3, "host"


def max_sm_mhz() -> float | None:
    """The card's maximum SM clock (nvidia-smi), None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bench_ops(lanes: int, dev: torch.device, reps: int) -> list[dict]:
    """Every chain at both lengths; one row an operation and kernel."""
    a, b = inputs(lanes, dev)
    mhz = max_sm_mhz() if dev.type == "cuda" else None
    rows = []
    for name, ops, (k1, k2) in CHAINS:
        wrapper = getattr(K, name)
        for op in ops:
            t1, src1 = _call_ms(lambda: wrapper(a, b, op, k1), name, dev,
                                reps)
            t2, src2 = _call_ms(lambda: wrapper(a, b, op, k2), name, dev,
                                reps)
            us = (t2 - t1) / (k2 - k1) * 1e3
            row = {"kernel": name, "op": op, "lanes": lanes,
                   "threads_per_lane": K.KERNELS[name].threads_per_lane,
                   "k": [k1, k2], "ms": [t1, t2], "us_per_op": us,
                   "cycles_per_op": us * mhz if mhz else None,
                   "time_from": src1 if src1 == src2 else f"{src1}/{src2}"}
            rows.append(row)
            cyc = (f"{row['cycles_per_op']:9.1f} cycles at {mhz:.0f} MHz"
                   if mhz else "cycles not measured")
            src = (f"device time from {row['time_from']}"
                   if dev.type == "cuda" else "host time, plain version")
            print(f"{name:14s} {op + ':':6s} {us:9.4f} us per batched op, "
                  f"{cyc} (chain {k1}: {t1:.4f} ms, {k2}: {t2:.4f} ms; "
                  f"{lanes} lanes, {row['threads_per_lane']} thread(s) a "
                  f"lane; {src})", flush=True)
    return rows


def bench_e2e(dev: torch.device, n: int, nv: int, nk: int,
              reps: int) -> list[dict]:
    """Host prep, device time, copy and finish of the verify paths; one
    row each."""
    rows = []
    workers = os.cpu_count() or 1

    def report(name, ms, lo=None, hi=None, src="host", per=None):
        rows.append({"name": name, "ms": ms, "min_ms": lo, "max_ms": hi,
                     "time_from": src, "per_s": per})
        spread = f"  min {lo:9.3f}  max {hi:9.3f}" if lo is not None else ""
        rate = f"  ({per:.0f}/s)" if per else ""
        print(f"{name:58s} med {ms:9.3f} ms{spread}  [{src}]{rate}",
              flush=True)

    def host(name, fn):
        med, lo, hi = timed(fn, reps)
        report(name, med * 1e3, lo * 1e3, hi * 1e3)

    def device(name, kernel, lanes, fn):
        ms, src = _call_ms(fn, kernel, dev, reps)
        report(name, ms, src=src, per=lanes / ms * 1e3)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    sk = hashlib.sha256(b"bench-ed").digest()
    vks = [ed25519_ref.public_key(sk)] * n
    msgs = [b"m%06d" % i for i in range(n)]
    sigs = windowgen.signatures(sk, msgs, workers)
    vsk = hashlib.sha256(b"bench-vrf").digest()
    vvks = [vrf_ref.public_key(vsk)] * nv
    alphas = [b"a%d" % i for i in range(nv)]
    proofs = windowgen.proofs(vsk, alphas, workers)
    kseed = hashlib.sha256(b"bench-kes").digest()
    kmsgs = [b"m%d" % i for i in range(nk)]
    kvk = kes.vk_of(windowgen.KES_DEPTH, kseed)
    kreqs = [KesReq(windowgen.KES_DEPTH, kvk, 0, m, s) for m, s in
             zip(kmsgs, windowgen.kes_signatures(kseed, kmsgs, workers))]
    print(f"data seconds: {time.perf_counter() - t:.3f} ({n} signatures, "
          f"{nv} proofs, {nk} KES signatures, {workers} workers)",
          flush=True)

    # Ed25519, the full 256-bit verify
    host(f"ed prepare_words_batch n={n} (for prepare_bytes_batch)",
         lambda: E.prepare_words_batch(vks, msgs, sigs))
    arrays, parse_ok = E.prepare_words_batch(vks, msgs, sigs)
    ed_args = D.stage(arrays, dev)
    all_valid("ed25519_verify",
               K.ed25519_verify(*ed_args).cpu().numpy() & parse_ok)
    device(f"ed ed25519_verify n={n} (for _ed25519_verify_jit)",
           "ed25519_verify", n,
           lambda: K.ed25519_verify(*ed_args))

    def h2d():
        D.stage(arrays, dev)
        fence()
    host(f"ed h2d transfer n={n}", h2d)

    # VRF
    host(f"vrf _prepare_words n={nv} (for vrf_jax._prepare)",
         lambda: V._prepare_words(vvks, alphas, proofs))
    args, v_ok, gamma_ok, s_ok, pf_arr = V._prepare_words(vvks, alphas,
                                                          proofs)
    Yw, _sY, Gw, signG, rw, cw, sw = args
    xa, _x128, _y128, known = shared_cache(dev).assemble(vvks)
    vrf_args = D.stage((Yw, xa, Gw, signG, rw, cw, sw), dev)
    vrows = K.vrf_verify(*vrf_args).cpu().numpy()
    all_valid("vrf_verify", V._finish(vrows, v_ok & known, gamma_ok, s_ok,
                                       pf_arr, nv)[0])
    device(f"vrf vrf_verify n={nv} (for vrf_verify_pallas)", "vrf_verify",
           nv,
           lambda: K.vrf_verify(*vrf_args))
    host(f"vrf _finish n={nv}",
         lambda: V._finish(vrows, v_ok & known, gamma_ok, s_ok, pf_arr, nv))

    # betas
    host(f"beta _prepare_betas_words n={nv} (for vrf_jax._prepare_betas)",
         lambda: V._prepare_betas_words(proofs))
    (Gb, signGb), decode_ok = V._prepare_betas_words(proofs)
    beta_args = D.stage((Gb, signGb), dev)
    brows = K.gamma8(*beta_args).cpu().numpy()
    all_valid("gamma8", [b is not None for b in
                          V._finish_betas(brows, decode_ok, nv)])
    device(f"beta gamma8 n={nv} (for gamma8_pallas)", "gamma8", nv,
           lambda: K.gamma8(*beta_args))
    host(f"beta _finish_betas n={nv}",
         lambda: V._finish_betas(brows, decode_ok, nv))

    # KES: the hash path on the host, leaves to the Ed25519 batch
    cb = CryptoBackend()
    if len(cb.split_mixed(kreqs)[0]) != nk:
        raise AssertionError("kes split_mixed: a hash path failed")
    host(f"kes split_mixed (host hash path) n={nk}",
         lambda: cb.split_mixed(kreqs))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--n-ed", type=int, default=4096)
    ap.add_argument("--n-vrf", type=int, default=2048)
    ap.add_argument("--n-kes", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help='"cpu" runs the plain versions; default the card')
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    if not (args.ops or args.e2e):
        args.e2e = True
    out = {"device": D.device_kind(dev), "clock_max_sm_mhz":
           max_sm_mhz() if dev.type == "cuda" else None}
    if args.e2e:
        out["e2e"] = bench_e2e(dev, args.n_ed, args.n_vrf, args.n_kes,
                               args.reps)
    if args.ops:
        out["ops"] = bench_ops(args.lanes, dev, args.reps)
    print(json.dumps({"microbench_field": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
