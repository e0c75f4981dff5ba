"""The port's CUDA kernels: build, load, wrappers and launch counters.

The seven TPU kernels of the JAX package are written by hand for Hopper
in CUDA C++ under `../csrc/`: the five of
`ouroboros_tpu/crypto/pallas_kernels.py` (four on the validation window's
path, and the full 256-bit Ed25519 verify of the standalone batch API),
and the field-op and point-op chains of `experiments/microbench_field.py`
(`field_chain` / `field_chain_lp` for the port's two field products,
`point_chain` / `point_chain_x4` for its two point-op forms).  Beside
them, `window_fold` stands for a program the JAX package leaves to XLA,
which fuses it: the validation window's verdict fold
(`jax_backend._fold_program`), whose torch-op form issued ~28,000 eager
ops a window.  They are compiled with nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, into `ouroboros_tpu_torch/build/` (one nvcc per source, all
started together, then one link), keyed by a hash of the sources and
flags.

Each verify wrapper takes packed (8, N) uint32 words: the JAX call's
layout for the four window kernels, and for `ed25519_verify` the words of
`ed25519.prepare_words_batch` in place of the JAX call's radix-2^13 limbs
and bit rows.  It returns the JAX output layout.  The chain wrappers take
(10, N) int32 carried limbs (`field.limbs_from_radix13` of the JAX
script's inputs), an operation name and a count.  `ed25519_split`,
`ed25519_verify` and `point_chain_x4` run four threads a lane and
`vrf_verify` eight (`csrc/ge25519_x4.cuh`: one thread a point
coordinate); `gamma8` and `field_chain_lp` run eight, each field product
spread over them (`csrc/fe25519_lp.cuh`); `kes_hash` two, two columns of
the Blake2b state each; the others run one thread a lane.  `window_fold`
takes the packed buffer of a window and the fold's host inputs and
returns the fold's bytes (`fold.fold_window`'s layout).

On a CPU tensor a wrapper runs the kernel's plain PyTorch version (named
in `KERNELS`); on a CUDA tensor it launches the kernel on the current
stream, adds one to `LAUNCHES[name]`, and raises on anything the kernel
does not take or on a launch error.  There is no fallback between the
two.  A launch costs the host tens of microseconds, more than most of
these kernels run (PERF.md), so the launch path does only what it must:
the entry points are bound once, when the library loads; the stream is
read as a raw handle; the device guard is entered only for a tensor
that is not on the current device; and each argument check is one test
that explains itself only when it fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Callable

import torch

from .. import device as device_mod
from . import blake2b as B2
from . import ed25519 as E
from . import field as F
from . import fold as FD
from . import vrf as V

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Kernel:
    name: str
    symbol: str          # C entry point in the shared library
    source: str          # path in the repository
    replaces: str        # file:line of the TPU kernel
    plain: Callable      # the plain PyTorch version (CPU tensors, tests)
    threads_per_lane: int  # the launch shape the source's launcher uses
    block: int             # (the CPU tests hold these against csrc/)


KERNELS = {k.name: k for k in (
    Kernel("ed25519_split", "ouro_ed25519_split",
           "ouroboros_tpu_torch/csrc/ed25519_split.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:182",
           E.verify_full_split_words_core, 4, 64),
    Kernel("vrf_verify", "ouro_vrf_verify",
           "ouroboros_tpu_torch/csrc/vrf_verify.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:318",
           V.vrf_verify_words_core, 8, 64),
    Kernel("gamma8", "ouro_gamma8",
           "ouroboros_tpu_torch/csrc/gamma8.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:407",
           V.gamma8_words_core, 8, 64),
    Kernel("kes_hash", "ouro_kes_hash",
           "ouroboros_tpu_torch/csrc/kes_hash.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:454",
           B2.check_block64, 2, 64),
    Kernel("ed25519_verify", "ouro_ed25519_verify",
           "ouroboros_tpu_torch/csrc/ed25519_verify.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:105",
           E.verify_full_words_core, 4, 64),
    Kernel("field_chain", "ouro_field_chain",
           "ouroboros_tpu_torch/csrc/field_chain.cu",
           "experiments/microbench_field.py:160",
           F.field_chain_core, 1, 32),
    Kernel("field_chain_lp", "ouro_field_chain_lp",
           "ouroboros_tpu_torch/csrc/field_chain.cu",
           "experiments/microbench_field.py:160",
           F.field_chain_core, 8, 64),
    Kernel("point_chain", "ouro_point_chain",
           "ouroboros_tpu_torch/csrc/point_chain.cu",
           "experiments/microbench_field.py:186",
           E.point_chain_core, 1, 32),
    Kernel("point_chain_x4", "ouro_point_chain_x4",
           "ouroboros_tpu_torch/csrc/point_chain.cu",
           "experiments/microbench_field.py:186",
           E.point_chain_core, 4, 64),
    Kernel("window_fold", "ouro_window_fold",
           "ouroboros_tpu_torch/csrc/window_fold.cu",
           "ouroboros_tpu/crypto/jax_backend.py:687",
           FD.fold_window, 1, 64),
)}

# launches per kernel since the last reset_launches(); counted only where a
# wrapper launches its CUDA kernel
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build ------------------------------------------------------------------

_lib = None
_fns: dict | None = None   # kernel name -> its bound entry point in _lib
_lib_lock = threading.Lock()
BUILD_LOG: list[str] = []      # nvcc's output (-Xptxas -v: registers, spills)


def _sources(csrc: str) -> tuple[list[str], str]:
    files = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.encode())
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(fh.read())
    return [f for f in files if f.endswith(".cu")], h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def build(csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    """Compile csrc/*.cu (../csrc unless another copy is given) into the
    shared library under build_dir (once per source hash) and return its
    path."""
    cu_files, key = _sources(csrc)
    lib_path = os.path.join(build_dir, f"libouro_kernels_{key}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    # objects go to a directory of this process's own, so two processes
    # building the same sources never link each other's half-written files;
    # the library itself appears atomically (os.replace)
    obj_dir = os.path.join(build_dir, f"{key}.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for f in cu_files:
        obj = os.path.join(obj_dir, f[:-3] + ".o")
        procs.append((f, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(csrc, f), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for f, _obj, p in procs:
        out, _ = p.communicate()
        BUILD_LOG.append(f"== {f}\n{out}")
        if p.returncode != 0:
            failed.append(f)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(BUILD_LOG))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp]
        + [obj for _f, obj, _p in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


# every entry point takes its tensors' pointers (inputs, then the output),
# its int arguments, then (int n, stream)
ENTRY_ARGS = {"ouro_ed25519_split": (9, 0), "ouro_vrf_verify": (8, 0),
              "ouro_gamma8": (3, 0), "ouro_kes_hash": (3, 0),
              "ouro_ed25519_verify": (7, 0),
              "ouro_field_chain": (3, 2),     # op, k
              "ouro_field_chain_lp": (3, 2),  # op, k
              "ouro_point_chain": (3, 2),     # kind, k
              "ouro_point_chain_x4": (3, 2),  # kind, k
              # packed, ed_own, vrf_own, gamma, c, the slot; ne, nv, nb, nk;
              # n = ne + nv
              "ouro_window_fold": (7, 4)}


def bind(lib: ctypes.CDLL) -> dict:
    """Set the argument types of the entry points `lib` exports; returns
    {kernel name: entry point} for the kernels it serves."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for sym, (n_ptr, n_int) in ENTRY_ARGS.items():
        try:
            fn = getattr(lib, sym)
        except AttributeError:
            continue
        fn.argtypes = [p] * n_ptr + [i] * n_int + [i, p]
        fn.restype = ctypes.c_int
        fns.update((k.name, fn) for k in KERNELS.values() if k.symbol == sym)
    return fns


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib, _fns
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fns = bind(lib)
            missing = set(KERNELS) - set(fns)
            if missing:
                raise RuntimeError(f"kernel library lacks {sorted(missing)}")
            _lib, _fns = lib, fns
    return _lib


# -- wrappers -----------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape: tuple,
           device) -> None:
    """Raise unless `t` lies on `device` with `dtype`, `shape` (a tuple)
    and a contiguous layout."""
    if t.device == device and t.dtype == dtype and t.shape == shape \
            and t.is_contiguous():
        return
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    raise ValueError(f"{name}: not contiguous")


def _raw_stream(index: int) -> int:
    """The cudaStream_t of device `index`'s current stream: torch's own
    getter, without the Stream object `torch.cuda.current_stream`
    builds.  A torch built for CUDA has it (tests check its stub)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(kernel: str, args, out: torch.Tensor, n: int,
            *ints: int) -> torch.Tensor:
    if _fns is None:
        library()
    fn = _fns[kernel]
    dev = out.device.index
    ptrs = [a.data_ptr() for a in args]
    stream = _raw_stream(dev)
    if dev == torch.cuda.current_device():
        err = fn(*ptrs, out.data_ptr(), *ints, n, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*ptrs, out.data_ptr(), *ints, n, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[kernel] += 1
    return out


def ed25519_split(Aw, xAw, A128xw, A128yw, Rw, signR, sw, kw):
    """Split-128 Ed25519 verify: (8, N) uint32 words ×7 + (N,) int32 sign
    of R -> (N,) int32 0/1.  Lanes whose key the per-key cache did not
    know must be masked by the caller."""
    if Aw.device.type == "cpu":
        return E.verify_full_split_words_core(Aw, xAw, A128xw, A128yw, Rw,
                                              signR, sw, kw)
    n, dev = Aw.shape[1], Aw.device
    for name, t in (("Aw", Aw), ("xAw", xAw), ("A128xw", A128xw),
                    ("A128yw", A128yw), ("Rw", Rw), ("sw", sw), ("kw", kw)):
        _check(name, t, torch.uint32, (8, n), dev)
    _check("signR", signR, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    return _launch("ed25519_split",
                   (Aw, xAw, A128xw, A128yw, Rw, signR, sw, kw), out, n)


def vrf_verify(Yw, xYw, Gw, signG, rw, cw, sw):
    """ECVRF device half: (8, N) uint32 words (cw: (4, N)) + (N,) int32 sign
    of Gamma -> (N, 130) uint8 rows (H, U, V, [8]Gamma, okY, okG)."""
    if Yw.device.type == "cpu":
        return V.vrf_verify_words_core(Yw, xYw, Gw, signG, rw, cw, sw)
    n, dev = Yw.shape[1], Yw.device
    for name, t in (("Yw", Yw), ("xYw", xYw), ("Gw", Gw), ("rw", rw),
                    ("sw", sw)):
        _check(name, t, torch.uint32, (8, n), dev)
    _check("cw", cw, torch.uint32, (4, n), dev)
    _check("signG", signG, torch.int32, (n,), dev)
    out = torch.empty((n, 130), dtype=torch.uint8, device=dev)
    return _launch("vrf_verify", (Yw, xYw, Gw, signG, rw, cw, sw), out, n)


def gamma8(Gw, signG):
    """[8]Gamma: (8, N) uint32 words + (N,) int32 sign -> (N, 33) uint8."""
    if Gw.device.type == "cpu":
        return V.gamma8_words_core(Gw, signG)
    n, dev = Gw.shape[1], Gw.device
    _check("Gw", Gw, torch.uint32, (8, n), dev)
    _check("signG", signG, torch.int32, (n,), dev)
    out = torch.empty((n, 33), dtype=torch.uint8, device=dev)
    return _launch("gamma8", (Gw, signG), out, n)


def kes_hash(mw, ew):
    """Blake2b-256 job check: (16, N) message words + (8, N) expected
    digest words (uint32) -> (N,) int32 0/1."""
    if mw.device.type == "cpu":
        return B2.check_block64(mw, ew)
    n, dev = mw.shape[1], mw.device
    _check("mw", mw, torch.uint32, (16, n), dev)
    _check("ew", ew, torch.uint32, (8, n), dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    return _launch("kes_hash", (mw, ew), out, n)


def ed25519_verify(Aw, signA, Rw, signR, sw, kw):
    """Full 256-bit Ed25519 verify (ed25519_verify_pallas): (8, N) uint32
    words of y_A, y_R, s and k + (N,) int32 signs of A and R -> (N,) int32
    0/1.  Lanes the host parse rejected must be masked by the caller."""
    if Aw.device.type == "cpu":
        return E.verify_full_words_core(Aw, signA, Rw, signR, sw, kw)
    n, dev = Aw.shape[1], Aw.device
    for name, t in (("Aw", Aw), ("Rw", Rw), ("sw", sw), ("kw", kw)):
        _check(name, t, torch.uint32, (8, n), dev)
    for name, t in (("signA", signA), ("signR", signR)):
        _check(name, t, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    return _launch("ed25519_verify", (Aw, signA, Rw, signR, sw, kw), out, n)


# (device index, raw stream) -> the window_fold kernel's int32 slot:
# [running minimum, ticket], (FOLD_SENT, 0) between launches.  Each
# launch leaves it so, and launches on one stream run in order, so one
# slot a stream serves every fold on it.
_FOLD_SLOTS: dict = {}


def _fold_slot(dev: torch.device) -> torch.Tensor:
    key = (dev.index, _raw_stream(dev.index))
    slot = _FOLD_SLOTS.get(key)
    if slot is None:
        slot = _FOLD_SLOTS.setdefault(key, torch.tensor(
            [FD.FOLD_SENT, 0], dtype=torch.int32, device=dev))
    return slot


def window_fold(packed, ne: int, nv: int, nb: int, nk: int, ed_own,
                vrf_own, gamma_b, c_b):
    """The verdict fold over a window's packed buffer (fold.fold_window):
    (ne + 130 nv + 33 nb + nk,) uint8, (ne,) and (nv,) int32 request
    indices, (nv, 32) and (nv, 16) uint8 gamma and c bytes -> (4 + nk +
    33 nb,) uint8, the first failing index (FOLD_SENT for none) in four
    little-endian bytes, the KES job flags and the beta rows."""
    if packed.device.type == "cpu":
        return FD.fold_window(packed, ne, nv, nb, nk, ed_own, vrf_own,
                              gamma_b, c_b)
    dev = packed.device
    _check("packed", packed, torch.uint8, (ne + 130 * nv + 33 * nb + nk,),
           dev)
    _check("ed_own", ed_own, torch.int32, (ne,), dev)
    _check("vrf_own", vrf_own, torch.int32, (nv,), dev)
    _check("gamma_b", gamma_b, torch.uint8, (nv, 32), dev)
    _check("c_b", c_b, torch.uint8, (nv, 16), dev)
    out = torch.empty(4 + nk + 33 * nb, dtype=torch.uint8, device=dev)
    return _launch("window_fold", (packed, ed_own, vrf_own, gamma_b, c_b,
                                   _fold_slot(dev)),
                   out, ne + nv, ne, nv, nb, nk)


def _chain(kernel: str, ops: tuple, a, b, op: str, k: int) -> torch.Tensor:
    """A chain kernel's wrapper: `op` one of `ops` (its index is the
    kernel's op argument), k steps, (10, N) int32 limbs x2."""
    if op not in ops:
        raise ValueError(f"operation {op!r} is not one of {ops}")
    if not 0 <= k < 2**31:
        raise ValueError(f"chain length {k} out of range")
    if a.device.type == "cpu":
        return KERNELS[kernel].plain(a, b, op, k)
    n, dev = a.shape[1], a.device
    for name, t in (("a", a), ("b", b)):
        _check(name, t, torch.int32, (F.NLIMBS, n), dev)
    out = torch.empty((F.NLIMBS, n), dtype=torch.int32, device=dev)
    return _launch(kernel, (a, b), out, n, ops.index(op), k)


def field_chain(a, b, op: str, k: int):
    """k field operations a lane (the per-operation probe): a <- op(a, b)
    k times, op one of field.FIELD_OPS.  (10, N) int32 carried limbs x2
    -> (10, N) int32."""
    return _chain("field_chain", F.FIELD_OPS, a, b, op, k)


def field_chain_lp(a, b, op: str, k: int):
    """`field_chain` on eight threads a lane, each product spread over
    them (csrc/fe25519_lp.cuh, gamma8's product); op one of
    field.FIELD_LP_OPS (mul, sqr).  The same function and plain
    version."""
    return _chain("field_chain_lp", F.FIELD_LP_OPS, a, b, op, k)


def point_chain(a, b, kind: str, k: int):
    """k point operations a lane, one thread a lane: from P = (a, b, a,
    b), Q <- pt_double(Q) or pt_add(Q, P) k times, kind one of
    ed25519.POINT_OPS; X + Y + Z + T.  (10, N) int32 carried limbs x2 ->
    (10, N) int32."""
    return _chain("point_chain", E.POINT_OPS, a, b, kind, k)


def point_chain_x4(a, b, kind: str, k: int):
    """`point_chain` on four threads a lane, one a coordinate
    (csrc/ge25519_x4.cuh); the same function and plain version."""
    return _chain("point_chain_x4", E.POINT_OPS, a, b, kind, k)


# -- standalone batch API -----------------------------------------------------

def batch_verify_ed25519(vks, msgs, sigs, device=None,
                         pad_to: int | None = None) -> list[bool]:
    """End-to-end batched Ed25519 verify through `ed25519_verify`
    (pallas_kernels.batch_verify_ed25519, ed25519_jax.batch_verify): host
    prep, one launch, verdicts folded with the host parse.  The kernel
    takes any lane count, so the batch is padded only up to `pad_to`.
    `device`: None for the card (raises without one) or "cpu" for the
    plain version."""
    dev = device_mod.resolve(device)
    n = len(vks)
    if n == 0:
        return []
    m = pad_to if pad_to and pad_to >= n else n
    vks = list(vks) + [b"\x00" * 32] * (m - n)
    msgs = list(msgs) + [b""] * (m - n)
    sigs = list(sigs) + [b"\x00" * 64] * (m - n)
    arrays, parse_ok = E.prepare_words_batch(vks, msgs, sigs)
    ok = ed25519_verify(*device_mod.stage(arrays, dev)).cpu().numpy()
    return [bool(o) and bool(p) for o, p in zip(ok[:n], parse_ok[:n])]
