"""The port's native CPU backend (`ouroboros_tpu_torch.crypto.cpp_backend`,
the VerifyService's break-even fallback) against the JAX package's.

The cases of tests/test_cpp_backend.py, each on the same seeded inputs
through four verifiers: the port's `CppBackend`, the JAX package's
`CppBackend`, and both packages' pure-Python references
(`ed25519_ref`, `vrf_ref`); valid and corrupted inputs, garbage
encodings, VRF betas, KES through the shared decomposition, and the
scalar multiplications.  The port's library is built with g++ into
`ouroboros_tpu_torch/build/`, never beside the source: the JAX package's
`crypto/native/` directory gains no file.

Tolerance: none.  Verdicts and bytes compare exactly.
"""
import hashlib
import os
import random

import pytest

from ouroboros_tpu.crypto import ed25519_ref as j_ed, vrf_ref as j_vrf
from ouroboros_tpu.crypto import kes as j_kes
from ouroboros_tpu.crypto import cpp_backend as j_cpp
from ouroboros_tpu.crypto.backend import (
    Ed25519Req as JEd25519Req, KesReq as JKesReq, VrfReq as JVrfReq,
)
from ouroboros_tpu_torch.crypto import cpp_backend, ed25519_ref, edwards
from ouroboros_tpu_torch.crypto import kes as kes_mod, vrf_ref
from ouroboros_tpu_torch.crypto.backend import Ed25519Req, KesReq, VrfReq

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(
    cpp_backend.__file__)))
_JAX_NATIVE = os.path.dirname(j_cpp._SRC)


@pytest.fixture(scope="module")
def backends():
    """(the port's CppBackend, the JAX package's)."""
    return cpp_backend.CppBackend(), j_cpp.CppBackend()


def _both(backends, method, reqs, jreqs):
    port, jax_ = backends
    got = getattr(port, method)(reqs)
    assert got == getattr(jax_, method)(jreqs)
    return got


def test_ed25519_parity(backends):
    rng = random.Random(7)
    reqs, expect = [], []
    for i in range(20):
        sk = hashlib.sha256(b"cpp-%d" % i).digest()
        vk = ed25519_ref.public_key(sk)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 150)))
        sig = ed25519_ref.sign(sk, msg)
        assert sig == j_ed.sign(sk, msg)
        reqs.append(Ed25519Req(vk, msg, sig))
        expect.append(True)
        bad = bytearray(sig)
        bad[rng.randrange(64)] ^= 1 << rng.randrange(8)
        reqs.append(Ed25519Req(vk, msg, bytes(bad)))
        expect.append(ed25519_ref.verify(vk, msg, bytes(bad)))
    jreqs = [JEd25519Req(r.vk, r.msg, r.sig) for r in reqs]
    assert expect == [j_ed.verify(r.vk, r.msg, r.sig) for r in reqs]
    assert _both(backends, "verify_ed25519_batch", reqs, jreqs) == expect


def test_ed25519_garbage_inputs(backends):
    raw = [(b"\xff" * 32, b"m", b"\x00" * 64),
           (b"short", b"m", b"\x00" * 64),
           (b"\x00" * 32, b"m", b"sig-too-short")]
    got = _both(backends, "verify_ed25519_batch",
                [Ed25519Req(*r) for r in raw], [JEd25519Req(*r) for r in raw])
    assert got == [False, False, False]


def test_vrf_parity(backends):
    rng = random.Random(8)
    reqs, expect = [], []
    for i in range(8):
        sk = hashlib.sha256(b"cppv-%d" % i).digest()
        vk = ed25519_ref.public_key(sk)
        alpha = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
        pi = vrf_ref.prove(sk, alpha)
        assert pi == j_vrf.prove(sk, alpha)
        reqs.append(VrfReq(vk, alpha, pi))
        expect.append(True)
        bad = bytearray(pi)
        bad[rng.randrange(80)] ^= 1 << rng.randrange(8)
        reqs.append(VrfReq(vk, alpha, bytes(bad)))
        expect.append(vrf_ref.verify(vk, alpha, bytes(bad)))
    jreqs = [JVrfReq(r.vk, r.alpha, r.proof) for r in reqs]
    assert expect == [j_vrf.verify(r.vk, r.alpha, r.proof) for r in reqs]
    assert _both(backends, "verify_vrf_batch", reqs, jreqs) == expect


def test_vrf_proof_to_hash_parity(backends):
    port, jax_ = backends
    sk = hashlib.sha256(b"beta").digest()
    pi = vrf_ref.prove(sk, b"alpha")
    for proof in (pi, b"\x00" * 80):   # y = 0 decompresses: a valid encoding
        beta = port.vrf_proof_to_hash(proof)
        assert beta == jax_.vrf_proof_to_hash(proof) \
            == vrf_ref.proof_to_hash(proof) == j_vrf.proof_to_hash(proof)
    bad = pi[:48] + b"\xff" * 32          # s >= L: invalid in all four
    for fn in (port.vrf_proof_to_hash, jax_.vrf_proof_to_hash,
               vrf_ref.proof_to_hash, j_vrf.proof_to_hash):
        with pytest.raises(ValueError):
            fn(bad)


def test_kes_via_native_leaves(backends):
    """KES decomposition (the shared CryptoBackend path) over native
    ed25519, on keys both packages derive alike."""
    seed = hashlib.sha256(b"cpp-kes").digest()
    key, jkey = kes_mod.KesSignKey(4, seed), j_kes.KesSignKey(4, seed)
    assert key.verification_key == jkey.verification_key
    vk = key.verification_key
    sigs = []
    for period in range(3):
        sig = key.sign(b"msg-%d" % period).to_bytes()
        assert sig == jkey.sign(b"msg-%d" % period).to_bytes()
        sigs.append((period, sig))
        key.evolve()
        jkey.evolve()
    raw = [(4, vk, p, b"msg-%d" % p, s) for p, s in sigs]
    raw.append((4, vk, 0, b"wrong", sigs[0][1]))
    got = _both(backends, "verify_kes_batch", [KesReq(*r) for r in raw],
                [JKesReq(*r) for r in raw])
    assert got == [True, True, True, False]


def test_scalarmult_parity():
    rng = random.Random(9)
    pt = edwards.compress(edwards.scalar_mult_base(12345))
    for _ in range(8):
        k = rng.randrange(1 << 256)
        want = edwards.compress(edwards.scalar_mult_base(k % edwards.L))
        assert cpp_backend.scalarmult_base(k) == j_cpp.scalarmult_base(k) \
            == want
        assert cpp_backend.scalarmult(pt, k) == j_cpp.scalarmult(pt, k)
    bad_y = next(y for y in range(2, 100) if edwards.decompress(
        y.to_bytes(32, "little")) is None).to_bytes(32, "little")
    assert cpp_backend.scalarmult(bad_y, 5) is None
    assert j_cpp.scalarmult(bad_y, 5) is None


def test_build_is_cached():
    import time
    p1 = cpp_backend.build_library()
    t0 = time.time()
    p2 = cpp_backend.build_library()
    assert p1 == p2 and time.time() - t0 < 0.05   # cache hit, no recompile


def test_builds_only_into_the_ports_build_directory(backends):
    """A forced rebuild writes the library and its stamp under
    ouroboros_tpu_torch/build/ and nothing into the JAX package's
    crypto/native/ (whose own library the JAX backend above has built)."""
    before = sorted(os.listdir(_JAX_NATIVE))
    path = cpp_backend.build_library(force=True)
    assert os.path.dirname(path) == os.path.join(_PORT, "build")
    with open(cpp_backend._STAMP) as f:
        assert f.read() == cpp_backend._src_digest()
    assert os.path.dirname(cpp_backend._STAMP) == os.path.dirname(path)
    assert cpp_backend.CppBackend().verify_ed25519_batch([]) == []
    assert sorted(os.listdir(_JAX_NATIVE)) == before
    assert not any(f.startswith("libouro_crypto.so.tmp")
                   for f in os.listdir(os.path.dirname(path)))
