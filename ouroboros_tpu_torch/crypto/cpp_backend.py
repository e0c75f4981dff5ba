"""CppBackend — the native CPU CryptoBackend over native/ouro_crypto.cpp.

The libsodium role (SURVEY.md: the reference's hot crypto lives in external
C reached through typeclass indirection — Shelley/Protocol/Crypto.hs:15-23):
a fast scalar path for batch-of-1 operation when the node is caught up
(the VerifyService's break-even fallback, crypto/batching.py), and the
honest CPU baseline for replay benchmarks.  The shared library is
compiled on demand with g++ and rebuilt when the source's digest changes;
bit-exactness versus ed25519_ref/vrf_ref is enforced by
tests/test_torch_cpp_backend.py.

Ported from `ouroboros_tpu/crypto/cpp_backend.py` (the port imports
nothing of the JAX package), with `native/ouro_crypto.cpp` copied whole.
Changed from the reference: the library and its digest stamp are built
into `ouroboros_tpu_torch/build/` (gitignored, beside the CUDA kernels'
library), never beside the source, each written to a file of this
process's own and renamed into place, so two processes building at once
never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Sequence

from .backend import CryptoBackend, Ed25519Req, VrfReq

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "crypto", "native", "ouro_crypto.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_LIB = os.path.join(BUILD_DIR, "libouro_crypto.so")
_STAMP = os.path.join(BUILD_DIR, "ouro_crypto.build-stamp")


def _src_digest() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _replace(path: str, write) -> None:
    """Write `path` through a file of this process's own, then rename it
    into place (atomic: a reader sees the old file or the whole new one)."""
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def build_library(force: bool = False) -> str:
    """Compile the shared library if missing or stale; returns its path."""
    digest = _src_digest()
    if not force and os.path.exists(_LIB) and os.path.exists(_STAMP):
        with open(_STAMP) as f:
            if f.read().strip() == digest:
                return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    _replace(_LIB, lambda tmp: subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
        check=True, capture_output=True, text=True))

    def stamp(tmp):
        with open(tmp, "w") as f:
            f.write(digest)
    _replace(_STAMP, stamp)
    return _LIB


def load_library():
    lib = ctypes.CDLL(build_library())
    p, size, u8p = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p
    lib.ouro_ed25519_verify.restype = ctypes.c_int
    lib.ouro_ed25519_verify.argtypes = [p, p, size, p]
    lib.ouro_ed25519_verify_batch.restype = None
    lib.ouro_ed25519_verify_batch.argtypes = [size, p, p, u8p, p, u8p]
    lib.ouro_vrf_verify.restype = ctypes.c_int
    lib.ouro_vrf_verify.argtypes = [p, p, size, p]
    lib.ouro_vrf_verify_batch.restype = None
    lib.ouro_vrf_verify_batch.argtypes = [size, p, p, u8p, p, u8p]
    lib.ouro_vrf_proof_to_hash.restype = ctypes.c_int
    lib.ouro_vrf_proof_to_hash.argtypes = [p, p]
    lib.ouro_scalarmult.restype = ctypes.c_int
    lib.ouro_scalarmult.argtypes = [p, p, p]
    lib.ouro_scalarmult_base.restype = None
    lib.ouro_scalarmult_base.argtypes = [p, p]
    return lib


_CACHED_LIB = None


def shared_library():
    """Build-once, load-once module-level handle (None if the toolchain is
    unavailable) — the host-side fast path for scalar multiplications."""
    global _CACHED_LIB
    if _CACHED_LIB is None:
        try:
            _CACHED_LIB = load_library()
        except (OSError, subprocess.CalledProcessError):
            _CACHED_LIB = False
    return _CACHED_LIB or None


def scalarmult(pt32: bytes, scalar: int):
    """[scalar]P for compressed P — compressed result, or None when P does
    not decode.  C speed; full 256-bit double-and-add ladder, so clamped
    Ed25519 scalars and mod-L scalars are both fine."""
    lib = shared_library()
    if lib is None:
        return NotImplemented
    out = ctypes.create_string_buffer(32)
    ok = lib.ouro_scalarmult(pt32, int.to_bytes(scalar, 32, "little"), out)
    return out.raw if ok else None


def scalarmult_base(scalar: int):
    lib = shared_library()
    if lib is None:
        return NotImplemented
    out = ctypes.create_string_buffer(32)
    lib.ouro_scalarmult_base(int.to_bytes(scalar, 32, "little"), out)
    return out.raw


class CppBackend(CryptoBackend):
    """Native scalar verification (ed25519 + ECVRF in C++; KES leaves via
    the shared KES decomposition onto the ed25519 batch)."""

    name = "cpu-native"

    def __init__(self):
        self.lib = load_library()

    def verify_ed25519_batch(self, reqs: Sequence[Ed25519Req]) -> list[bool]:
        if not reqs:
            return []
        n = len(reqs)
        vks = b"".join(r.vk if len(r.vk) == 32 else b"\x00" * 32
                       for r in reqs)
        msgs = b"".join(r.msg for r in reqs)
        lens = (ctypes.c_size_t * n)(*[len(r.msg) for r in reqs])
        sigs = b"".join(r.sig if len(r.sig) == 64 else b"\x00" * 64
                        for r in reqs)
        out = (ctypes.c_uint8 * n)()
        self.lib.ouro_ed25519_verify_batch(n, vks, msgs, lens, sigs, out)
        return [bool(out[i]) and len(reqs[i].vk) == 32
                and len(reqs[i].sig) == 64 for i in range(n)]

    def verify_vrf_batch(self, reqs: Sequence[VrfReq]) -> list[bool]:
        if not reqs:
            return []
        n = len(reqs)
        vks = b"".join(r.vk if len(r.vk) == 32 else b"\x00" * 32
                       for r in reqs)
        alphas = b"".join(r.alpha for r in reqs)
        alens = (ctypes.c_size_t * n)(*[len(r.alpha) for r in reqs])
        pis = b"".join(r.proof if len(r.proof) == 80 else b"\x00" * 80
                       for r in reqs)
        out = (ctypes.c_uint8 * n)()
        self.lib.ouro_vrf_verify_batch(n, vks, alphas, alens, pis, out)
        return [bool(out[i]) and len(reqs[i].vk) == 32
                and len(reqs[i].proof) == 80 for i in range(n)]

    def vrf_proof_to_hash(self, proof: bytes) -> bytes:
        beta = ctypes.create_string_buffer(64)
        if len(proof) != 80 or \
                not self.lib.ouro_vrf_proof_to_hash(proof, beta):
            raise ValueError("invalid VRF proof")
        return beta.raw
