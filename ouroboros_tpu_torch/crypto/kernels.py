"""The port's CUDA kernels: build, load, wrappers and launch counters.

The seven TPU kernels of the JAX package are written by hand for Hopper
in CUDA C++ under `../csrc/`: the five of
`ouroboros_tpu/crypto/pallas_kernels.py` (four on the validation window's
path, and the full 256-bit Ed25519 verify of the standalone batch API),
and the field-op and point-op chains of `experiments/microbench_field.py`
(`field_chain`, and `point_chain` / `point_chain_x4` for the port's two
point-op forms).  They are compiled with nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, into `ouroboros_tpu_torch/build/` (one nvcc per source, all
started together, then one link), keyed by a hash of the sources and
flags.

Each verify wrapper takes packed (8, N) uint32 words: the JAX call's
layout for the four window kernels, and for `ed25519_verify` the words of
`ed25519.prepare_words_batch` in place of the JAX call's radix-2^13 limbs
and bit rows.  It returns the JAX output layout.  The chain wrappers take
(10, N) int32 carried limbs (`field.limbs_from_radix13` of the JAX
script's inputs), an operation name and a count.  `ed25519_split` and
`point_chain_x4` run four threads a lane and `vrf_verify` eight
(`csrc/ge25519_x4.cuh`: one thread a point coordinate); the others run
one thread a lane.

On a CPU tensor a wrapper runs the kernel's plain PyTorch version (named
in `KERNELS`); on a CUDA tensor it launches the kernel on the current
stream, adds one to `LAUNCHES[name]`, and raises on anything the kernel
does not take or on a launch error.  There is no fallback between the
two.
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
           V.gamma8_words_core, 1, 32),
    Kernel("kes_hash", "ouro_kes_hash",
           "ouroboros_tpu_torch/csrc/kes_hash.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:454",
           B2.check_block64, 1, 32),
    Kernel("ed25519_verify", "ouro_ed25519_verify",
           "ouroboros_tpu_torch/csrc/ed25519_verify.cu",
           "ouroboros_tpu/crypto/pallas_kernels.py:105",
           E.verify_full_words_core, 1, 32),
    Kernel("field_chain", "ouro_field_chain",
           "ouroboros_tpu_torch/csrc/field_chain.cu",
           "experiments/microbench_field.py:160",
           F.field_chain_core, 1, 32),
    Kernel("point_chain", "ouro_point_chain",
           "ouroboros_tpu_torch/csrc/point_chain.cu",
           "experiments/microbench_field.py:186",
           E.point_chain_core, 1, 32),
    Kernel("point_chain_x4", "ouro_point_chain_x4",
           "ouroboros_tpu_torch/csrc/point_chain.cu",
           "experiments/microbench_field.py:186",
           E.point_chain_core, 4, 64),
)}

# launches per kernel since the last reset_launches(); counted only where a
# wrapper launches its CUDA kernel
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build ------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG: list[str] = []      # nvcc's output (-Xptxas -v: registers, spills)


def _sources() -> tuple[list[str], str]:
    files = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return [f for f in files if f.endswith(".cu")], h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def build() -> str:
    """Compile ../csrc/*.cu into the shared library (once per source
    hash) and return its path."""
    cu_files, key = _sources()
    lib_path = os.path.join(BUILD_DIR, f"libouro_kernels_{key}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    # objects go to a directory of this process's own, so two processes
    # building the same sources never link each other's half-written files;
    # the library itself appears atomically (os.replace)
    obj_dir = os.path.join(BUILD_DIR, f"{key}.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for f in cu_files:
        obj = os.path.join(obj_dir, f[:-3] + ".o")
        procs.append((f, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, f), "-o", obj],
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            # every entry point takes its tensors' pointers (inputs, then
            # the output), its int arguments, then (int n, stream)
            argc = {"ouro_ed25519_split": (9, 0), "ouro_vrf_verify": (8, 0),
                    "ouro_gamma8": (3, 0), "ouro_kes_hash": (3, 0),
                    "ouro_ed25519_verify": (7, 0),
                    "ouro_field_chain": (3, 2),     # op, k
                    "ouro_point_chain": (3, 2),     # kind, k
                    "ouro_point_chain_x4": (3, 2)}  # kind, k
            for sym, (n_ptr, n_int) in argc.items():
                fn = getattr(lib, sym)
                fn.argtypes = [p] * n_ptr + [i] * n_int + [i, p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- wrappers -----------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(kernel: str, args, out: torch.Tensor, n: int,
            *ints: int) -> torch.Tensor:
    fn = getattr(library(), KERNELS[kernel].symbol)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), *ints, n,
                 stream)
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
