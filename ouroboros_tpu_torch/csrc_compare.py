"""Build copies of the kernel sources side by side and compare them on the
card: the instrument for a design choice inside csrc/ (a carry plan, which
call sites inline a product).

    python -m ouroboros_tpu_torch.csrc_compare DIR [DIR ...]
        [--lanes 4096,65536] [--reps 7] [--sass OUTDIR] [--floor]

Each DIR holds a full copy of ouroboros_tpu_torch/csrc/, edited.  For
each, in one process on one card: the build (`kernels.build`, one nvcc a
source) with each kernel's registers and spills (`-Xptxas -v`); every
kernel the copy exports against its plain version on 96 and 97 lanes of
random words or limbs, and the chain kernels on uncarried limbs at the
products' bound, compared exactly (a copy that disagrees is reported and
not timed); the device time of each window kernel at the main path's
lane counts on random words (kes_hash at 65536 lanes too); µs per
batched operation of every chain at each lane count, as
`microbench_field --ops` takes them; and the host µs of each step of
one kes_hash and one vrf_verify wrapper call (`launch_parts`).  The
first DIR runs again last, so that drift over the run shows.  A kernel
that a copy does not export is skipped.  Once a run: kes_hash's bound
at each of its lane counts; with --floor, also the device time of an
empty kernel and of one that only loads kes_hash's 24 words a lane and
stores one, at each launch shape in KES_SHAPES (`floor_ms`).  With
--sass, `cuobjdump -sass` of each copy's library is written to
OUTDIR/<name>.sass, and the instructions of the chain kernels and of
kes_hash are counted (`sass_counts`).  Needs the card and nvcc; the
last line is a JSON object of every number.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess

import numpy as np
import torch

from . import device as D
from . import microbench_field as MB
from .crypto import blake2b as B2
from .crypto import field as F
from .crypto import fold as FD
from .crypto import kernels as K

# the main path's lane counts (chip_smoke.py phase 2); kes_hash also at
# eight times its own, where the card is full
WINDOW_LANES = {"ed25519_split": (4096,), "vrf_verify": (2048,),
                "gamma8": (2048,), "ed25519_verify": (4096,),
                "kes_hash": (8192, 65536), "window_fold": (2048,)}
# kes_hash's launch shapes (threads a lane, block) whose floor is timed
KES_SHAPES = ((1, 32), (1, 128), (2, 64))
# the wrappers whose launch is timed step by step: the smallest and the
# largest host part of the event time (PERF.md)
LAUNCH_PARTS = ("kes_hash", "vrf_verify")
CHAIN_OPS = {name: ops for name, ops, _k in MB.CHAINS}
# |limb| the products accept: sums of four carried elements
LIMB_BOUND = (1 << 27) + (1 << 10)
# the SASS instruction classes counted apart (IMAD.X: nvcc's add of a
# carry into a 64-bit sum's high half, beside IADD3.X)
SASS_CLASSES = ("IMAD.WIDE", "IMAD.X", "SHFL", "SEL", "IADD3", "LOP3",
                "SHF", "PRMT", "LDG")


def sass_counts(text: str) -> dict:
    """Instructions of each chain kernel and of kes_hash_kernel in a
    `cuobjdump -sass` listing, split at its CALL.REL targets: a
    __noinline__ callee is a subroutine inside each kernel that calls
    it, from its target to the next one.  {kernel: [[start offset,
    instructions, {class: count}], ...]}, NOPs left out; a class counts
    the instructions of that mnemonic (SHF is not SHFL)."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = re.search(r"Function : \S*?(\w+_chain\w*_kernel|"
                          r"kes_hash_kernel)", ln)
            cur = funcs.setdefault(m.group(1), []) if m else None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([^;]+)",
                     ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        calls = [re.search(r"CALL\.REL\.NOINC (0x[0-9a-f]+)", t)
                 for _a, t in ins]
        starts = sorted({0} | {int(c.group(1), 16) for c in calls if c})
        parts = []
        for a, b in zip(starts, starts[1:] + [1 << 40]):
            ops = [t.split()[0] for addr, t in ins
                   if a <= addr < b and not t.startswith("NOP")]
            parts.append([a, len(ops), {
                c: sum(o == c or o.startswith(c + ".") for o in ops)
                for c in SASS_CLASSES}])
        out[fn] = parts
    return out


def random_limbs(rng, dev, n: int) -> list[torch.Tensor]:
    """Two (10, n) int32 carried limb arrays of random radix-2^13
    digits."""
    return [F.limbs_from_radix13(rng.integers(0, 8192, (20, n),
                                              dtype=np.int32))
            .to(torch.int32).to(dev) for _ in range(2)]


# the fold's cases (`fold_case`): every lane valid, one failure of each
# kind, two failures of two kinds, failures the host already knows
FOLD_CASES = ("valid", "ed_lane", "c_flip", "okY", "okG", "ed_and_vrf",
              "host_known", "random")


def fold_case(rng, ne: int, nv: int, nb: int, nk: int, case: str):
    """Inputs of the verdict fold (`fold.fold_window`) as numpy arrays,
    (packed, ed_own, vrf_own, gamma, c), and the first failing request
    index it must find (FOLD_SENT for none).  The last quarter of each
    kind's lanes is padding (owner FOLD_SENT, verdict byte and row
    zero), as a padded window has; the others are requests numbered in a
    random order across both kinds, each VRF row random bytes with c its
    challenge (SHA-512 of suite || 0x02 || H || Gamma || U || V) and both
    decompression flags set.  `case` (one of FOLD_CASES) says which lanes
    fail: none; one Ed25519 lane (its byte 0); one VRF lane by c, by
    okY or by okG; an Ed25519 and a VRF lane, the VRF one's request the
    lower; lanes of both kinds whose owners are FOLD_SENT (failures the
    host knows already); or a random third of each kind."""
    sent = FD.FOLD_SENT
    ue, uv = ne - ne // 4, nv - nv // 4
    order = rng.permutation(ue + uv).astype(np.int32)
    ed_own = np.full(ne, sent, np.int32)
    vrf_own = np.full(nv, sent, np.int32)
    ed_own[:ue], vrf_own[:uv] = order[:ue], order[ue:]
    ed_ok = np.zeros(ne, np.uint8)
    ed_ok[:ue] = rng.integers(1, 256, ue)
    rows = np.zeros((nv, 130), np.uint8)
    rows[:uv, :128] = rng.integers(0, 256, (uv, 128))
    rows[:uv, 128:] = rng.integers(1, 256, (uv, 2))
    gamma = rng.integers(0, 256, (nv, 32), dtype=np.uint8)
    c = rng.integers(0, 256, (nv, 16), dtype=np.uint8)
    for j in range(uv):
        pre = (b"\x04\x02" + rows[j, :32].tobytes() + gamma[j].tobytes()
               + rows[j, 32:96].tobytes())
        c[j] = np.frombuffer(hashlib.sha512(pre).digest()[:16], np.uint8)
    bad_ed: list[int] = []
    bad_vrf: list[int] = []
    if case in ("ed_lane", "ed_and_vrf", "host_known") and ue:
        bad_ed = [int(rng.integers(0, ue))]
    if case in ("c_flip", "okY", "okG", "ed_and_vrf", "host_known") and uv:
        bad_vrf = [int(rng.integers(0, uv))]
    if case == "random":
        bad_ed = list(np.flatnonzero(rng.random(ue) < 1 / 3))
        bad_vrf = list(np.flatnonzero(rng.random(uv) < 1 / 3))
    if case == "ed_and_vrf" and bad_ed and bad_vrf:
        k, j = bad_ed[0], bad_vrf[0]
        lo, hi = sorted((ed_own[k], vrf_own[j]))
        vrf_own[j], ed_own[k] = lo, hi
    for k in bad_ed:
        ed_ok[k] = 0
    for i, j in enumerate(bad_vrf):
        kind = case if case in ("okY", "okG") else \
            ("c_flip", "okY", "okG")[i % 3]
        if kind == "c_flip":
            c[j, int(rng.integers(0, 16))] ^= 1 << int(rng.integers(0, 8))
        else:
            rows[j, 128 if kind == "okY" else 129] = 0
    if case == "host_known":
        ed_own[bad_ed] = sent
        vrf_own[bad_vrf] = sent
    beta = rng.integers(0, 256, nb * 33, dtype=np.uint8)
    kes = rng.integers(0, 2, nk, dtype=np.uint8)
    packed = np.concatenate([ed_ok, rows.reshape(-1), beta, kes])
    want = min([sent] + [int(ed_own[k]) for k in bad_ed]
               + [int(vrf_own[j]) for j in bad_vrf])
    return (packed, ed_own, vrf_own, gamma, c), want


def random_args(name: str, rng, dev, n: int) -> list:
    """Random inputs of kernel `name` on n lanes: words (most off the
    curve), signs, limbs, Blake2b jobs a third of which do not match, or
    a fold's buffer (`fold_case`'s random third)."""
    def w(rows, clear_top=True):
        a = rng.integers(0, 2**32, (rows, n), dtype=np.uint64)
        a = a.astype(np.uint32)
        if clear_top:
            a[-1] &= 0x7FFFFFFF
        return torch.from_numpy(a).to(dev)

    def sign():
        return torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)
                                ).to(dev)
    if name == "ed25519_split":
        return [w(8) for _ in range(5)] + [sign()] \
            + [w(8, False) for _ in range(2)]
    if name == "vrf_verify":
        return [w(8) for _ in range(3)] + [sign(), w(8), w(4, False),
                                           w(8, False)]
    if name == "ed25519_verify":
        return [w(8), sign(), w(8), sign(), w(8, False), w(8, False)]
    if name == "gamma8":
        return [w(8), sign()]
    if name in CHAIN_OPS:
        return random_limbs(rng, dev, n) + [CHAIN_OPS[name][-1], 5]
    if name == "window_fold":       # n VRF lanes, twice as many Ed25519
        shape = (2 * n, n, n, 2 * n)
        (packed, *own), _want = fold_case(rng, *shape, "random")
        packed, eo, vo, gamma, c = (torch.from_numpy(a).to(dev)
                                    for a in (packed, *own))
        return [packed, *shape, eo, vo, gamma, c]
    msgs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    digs = np.stack([np.frombuffer(hashlib.blake2b(
        m.tobytes(), digest_size=32).digest(), np.uint8) for m in msgs])
    digs[::3, 0] ^= 1
    return [torch.from_numpy(B2.msg_words(msgs)).to(dev),
            torch.from_numpy(B2.digest_words(digs)).to(dev)]


def _mismatches(names: list[str], dev) -> list[str]:
    bad = []
    for name in names:
        for n in (96, 97):
            args = random_args(name, np.random.default_rng(n), dev, n)
            got = getattr(K, name)(*args)
            if not torch.equal(got.cpu(),
                               K.KERNELS[name].plain(*args).cpu()):
                bad.append(f"{name} on {n} lanes")
    rng = np.random.default_rng(27)
    a, b = (torch.from_numpy(rng.integers(-LIMB_BOUND, LIMB_BOUND + 1,
                                          (10, 4099)).astype(np.int32))
            .to(dev) for _ in range(2))
    for name in ("field_chain", "field_chain_lp"):
        for op in CHAIN_OPS[name] if name in names else ():
            got = getattr(K, name)(a, b, op, 9)
            if not torch.equal(got.cpu(),
                               F.field_chain_core(a, b, op, 9).cpu()):
                bad.append(f"{name} {op} on uncarried limbs")
    return bad


def launch_parts(name: str, args: list, reps: int = 200) -> dict:
    """Median host µs (device.host_us) of each step of one call of the
    window kernel `name`'s wrapper on the card, as `kernels._launch`
    takes them: the argument checks, the output's allocation, the raw
    stream handle, the ctypes call (the launch itself), and the whole
    wrapper call; and that call's CUDA-event µs, host and device time
    together."""
    dev = args[0].device
    n = args[0].shape[-1]
    wrapper = getattr(K, name)
    out = wrapper(*args)
    fn = K._fns[name]
    stream = K._raw_stream(dev.index)
    steps = {
        "checks": lambda: [K._check("t", t, t.dtype, tuple(t.shape), dev)
                           for t in args],
        "torch.empty": lambda: torch.empty(out.shape, dtype=out.dtype,
                                           device=dev),
        "raw stream": lambda: K._raw_stream(dev.index),
        "ctypes call": lambda: fn(*[t.data_ptr() for t in args],
                                  out.data_ptr(), n, stream),
        "wrapper": lambda: wrapper(*args),
    }
    res = {step: D.host_us(f, reps) for step, f in steps.items()}
    # the wrapper call between two CUDA events, as chip_smoke.py's `ms`
    # takes it, but over as many calls
    res["wrapper, events"] = D.event_ms(lambda: wrapper(*args), reps) * 1e3
    return res


# an empty kernel, and one that loads a lane's 24 kes_hash words and
# stores one: the floor under kes_hash at a launch shape
FLOOR_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void empty_kernel() {}
__global__ void touch_kernel(const uint32_t *__restrict__ w,
                             int32_t *__restrict__ out, int n, int tpl) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = g / tpl;
    if (j >= n) return;
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 24; i++) x ^= w[(size_t)i * n + j];
    if (g % tpl == 0) out[j] = (int32_t)x;
}
extern "C" int ouro_floor(const void *w, void *out, int n, int tpl,
                          int block, int touch, void *stream) {
    const int blocks = (n * tpl + block - 1) / block;
    if (touch)
        touch_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)w, (int32_t *)out, n, tpl);
    else
        empty_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


def floor_ms(dev, lanes, reps: int) -> dict:
    """Device ms of the empty and the loading kernel (FLOOR_CU) at
    kes_hash's grid for each of its lane counts and KES_SHAPES."""
    src = os.path.join(K.BUILD_DIR, "compare", "floor_src")
    os.makedirs(src, exist_ok=True)
    with open(os.path.join(src, "floor.cu"), "w") as fh:
        fh.write(FLOOR_CU)
    fn = ctypes.CDLL(K.build(src, os.path.join(K.BUILD_DIR, "compare",
                                               "floor"))).ouro_floor
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for n in lanes:
        w = torch.randint(0, 2**31, (24, n), dtype=torch.int32, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        for tpl, block in KES_SHAPES:
            for touch, kernel in ((0, "empty_kernel"), (1, "touch_kernel")):
                def call():
                    if fn(w.data_ptr(), out.data_ptr(), n, tpl, block,
                          touch, stream):
                        raise RuntimeError(f"{kernel}: launch failed")
                res[f"{kernel} {n} lanes, {tpl} x {block}"] = D.kernel_ms(
                    call, kernel, reps)[0]
    return res


def measure(so: str, dev, lanes: list[int], reps: int) -> dict:
    """Check and time the kernels of one built library."""
    lib = ctypes.CDLL(so)
    fns = K.bind(lib)
    names = list(fns)
    K._lib, K._fns = lib, fns
    res = {"kernels": names, "mismatches": _mismatches(names, dev),
           "device_ms": {}, "us_per_op": {}, "host_us": {}}
    if res["mismatches"]:
        return res
    for name, counts in WINDOW_LANES.items():
        for n in counts if name in names else ():
            args = random_args(name, np.random.default_rng(1), dev, n)
            res["device_ms"][f"{name} {n}"] = D.kernel_ms(
                lambda: getattr(K, name)(*args), f"{name}_kernel", reps)[0]
    for name in LAUNCH_PARTS:
        if name in names:
            args = random_args(name, np.random.default_rng(2), dev,
                               WINDOW_LANES[name][0])
            res["host_us"][name] = launch_parts(name, args)
    for n in lanes:
        a, b = MB.inputs(n, dev)
        for name, ops, (k1, k2) in MB.CHAINS:
            for op in ops if name in names else ():
                t1, t2 = (D.kernel_ms(lambda: getattr(K, name)(a, b, op, k),
                                      f"{name}_kernel", reps)[0]
                          for k in (k1, k2))
                res["us_per_op"][f"{name} {op} {n}"] = \
                    (t2 - t1) / (k2 - k1) * 1e3
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--lanes", default="4096,65536")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--sass", default=None)
    ap.add_argument("--floor", action="store_true",
                    help="also time the floor under kes_hash (floor_ms)")
    args = ap.parse_args(argv)
    dev = D.resolve(None)
    lanes = [int(x) for x in args.lanes.split(",")]
    builds, sass = {}, {}
    for d in args.dirs:
        name = os.path.basename(os.path.normpath(d))
        start = len(K.BUILD_LOG)
        so = K.build(os.path.abspath(d),
                     os.path.join(K.BUILD_DIR, "compare", name))
        regs = [ln.strip() for entry in K.BUILD_LOG[start:]
                for ln in entry.splitlines()
                if ln.startswith("==") or "registers" in ln
                or re.search(r"[1-9]\d* bytes spill stores", ln)]
        builds[name] = so
        print(f"[{name}] built: " + " | ".join(regs), flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            text = subprocess.run(
                [os.path.join(os.path.dirname(K._nvcc()), "cuobjdump"),
                 "-sass", so], capture_output=True, text=True,
                check=True).stdout
            with open(os.path.join(args.sass, f"{name}.sass"), "w") as fh:
                fh.write(text)
            sass[name] = sass_counts(text)
            for fn, parts in sorted(sass[name].items()):
                print(f"[{name}] {fn}: " + "; ".join(
                    f"@{a:#x} {n} (" + ", ".join(
                        f"{c} {v}" for c, v in cl.items()) + ")"
                    for a, n, cl in parts), flush=True)
    order = list(builds) + list(builds)[:1]
    mhz = MB.max_sm_mhz()
    # kes_hash's adds, xors and rotations are simple operations: the
    # SM's issue rate bounds them, as it bounds a chain's add
    rate = MB.int_rate(dev, mhz, "add")
    out = {"device": D.device_kind(dev), "clock_max_sm_mhz": mhz,
           "sass": sass, "runs": [],
           "kes_hash_bound_ms": {
               n: n * B2.INT_OPS / rate * 1e3 if rate else None
               for n in WINDOW_LANES["kes_hash"]}}
    print(f"kes_hash bound ms: {out['kes_hash_bound_ms']}", flush=True)
    if args.floor:
        out["floor_ms"] = floor_ms(dev, WINDOW_LANES["kes_hash"], args.reps)
        print(f"floor device ms: {out['floor_ms']}", flush=True)
    try:
        for name in order:
            res = measure(builds[name], dev, lanes, args.reps)
            out["runs"].append({"name": name, **res})
            print(f"[{name}] " + (f"MISMATCH {res['mismatches']}"
                                  if res["mismatches"] else "all exact"),
                  flush=True)
    finally:
        K._lib = K._fns = None
    for r in out["runs"]:
        for name, parts in r.get("host_us", {}).items():
            print(f"[{r['name']}] {name} host us: " + ", ".join(
                f"{step} {us:.2f}" for step, us in parts.items()))
    keys = sorted({k for r in out["runs"]
                   for part in ("device_ms", "us_per_op") for k in r[part]})
    print("device ms / us per op".ljust(32)
          + "".join(r["name"].rjust(10) for r in out["runs"]))
    for k in keys:
        vals = [r["device_ms"].get(k, r["us_per_op"].get(k))
                for r in out["runs"]]
        print(k.ljust(32) + "".join(f"{v:10.4f}" if v is not None
                                    else " " * 10 for v in vals))
    print(json.dumps({"csrc_compare": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
