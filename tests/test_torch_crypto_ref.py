"""The port's copies of the CPU reference crypto (ed25519 / ECVRF / KES).

The cases of tests/test_crypto_ref.py on `ouroboros_tpu_torch.crypto`:
known-answer vectors (RFC 8032), cross-implementation agreement (OpenSSL
via `cryptography`, and the port's CppBackend where the reference used
OpensslBackend), sign/verify round-trips, and tamper rejection.  Then
parity with the JAX package's copies: `edwards.is_on_curve`,
`vrf_ref.prove_pure`, `vrf_ref.output` and `kes.verify` on seeded inputs,
byte-equal outputs and equal booleans on tampered inputs.

Tolerance: none.  Bytes and booleans compare exactly.
"""
import hashlib
import os

import pytest

import numpy as np

from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import kes as jkes
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu_torch.crypto import (
    CpuRefBackend, Ed25519Req, KesReq, VrfReq,
)
from ouroboros_tpu_torch.crypto import ed25519_ref, kes, vrf_ref
from ouroboros_tpu_torch.crypto import edwards as ed
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend

# RFC 8032 §7.1 TEST 1
RFC_SK = bytes.fromhex(
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
RFC_VK = bytes.fromhex(
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
RFC_SIG = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
    "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


def test_rfc8032_vector1():
    # the PURE implementation is the spec: check it against the RFC
    # vectors directly, not just the openssl-delegating fast path
    assert ed25519_ref.public_key_pure(RFC_SK) == RFC_VK
    assert ed25519_ref.sign_pure(RFC_SK, b"") == RFC_SIG
    assert ed25519_ref.public_key(RFC_SK) == RFC_VK
    assert ed25519_ref.sign(RFC_SK, b"") == RFC_SIG
    assert ed25519_ref.verify(RFC_VK, b"", RFC_SIG)


def test_sign_verify_roundtrip_and_tamper():
    sk = hashlib.sha256(b"seed-1").digest()
    vk = ed25519_ref.public_key(sk)
    msg = b"block header bytes"
    sig = ed25519_ref.sign(sk, msg)
    assert ed25519_ref.verify(vk, msg, sig)
    assert not ed25519_ref.verify(vk, msg + b"x", sig)
    bad = bytearray(sig)
    bad[10] ^= 1
    assert not ed25519_ref.verify(vk, msg, bytes(bad))
    bad_vk = bytearray(vk)
    bad_vk[0] ^= 1
    assert not ed25519_ref.verify(bytes(bad_vk), msg, sig)


def test_cross_check_openssl():
    pytest.importorskip(
        "cryptography", reason="OpenSSL oracle unavailable")
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat,
    )
    for i in range(5):
        key = Ed25519PrivateKey.generate()
        sk = key.private_bytes(Encoding.Raw, PrivateFormat.Raw, NoEncryption())
        vk = key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        msg = f"msg-{i}".encode()
        # our PURE sign == openssl sign; our verify accepts openssl sig
        assert ed25519_ref.public_key_pure(sk) == vk
        assert ed25519_ref.sign_pure(sk, msg) == key.sign(msg)
        assert ed25519_ref.verify(vk, msg, key.sign(msg))


def test_vrf_prove_fast_path_matches_pure():
    """The table-based prove must emit byte-identical proofs to the
    pure-Python spec (determinism of the draft-03 construction)."""
    sk = hashlib.sha256(b"vrf-fast").digest()
    for i in range(3):
        alpha = b"a%d" % i
        assert vrf_ref.prove(sk, alpha) == vrf_ref.prove_pure(sk, alpha)
    assert vrf_ref.public_key(sk) == ed.compress(
        ed.scalar_mult(vrf_ref._secret_expand(sk)[0], ed.BASE))


def test_curve_sanity():
    assert ed.is_on_curve(ed.BASE)
    assert ed.pt_equal(ed.scalar_mult(ed.L, ed.BASE), ed.IDENTITY)
    # compress/decompress roundtrip on multiples of base
    for k in (1, 2, 7, 12345):
        p = ed.scalar_mult(k, ed.BASE)
        assert ed.pt_equal(ed.decompress(ed.compress(p)), p)


def test_vrf_prove_verify():
    sk = hashlib.sha256(b"vrf-seed").digest()
    x, _ = vrf_ref._secret_expand(sk)
    vk = ed.compress(ed.scalar_mult(x, ed.BASE))
    alpha = b"slot-12345|eta"
    pi = vrf_ref.prove(sk, alpha)
    assert len(pi) == vrf_ref.PROOF_LEN
    assert vrf_ref.verify(vk, alpha, pi)
    # beta deterministic + 64 bytes
    beta = vrf_ref.proof_to_hash(pi)
    assert len(beta) == 64
    assert beta == vrf_ref.output(sk, alpha)
    # tamper: wrong alpha, wrong proof byte, wrong key
    assert not vrf_ref.verify(vk, alpha + b"!", pi)
    bad = bytearray(pi)
    bad[3] ^= 1
    assert not vrf_ref.verify(vk, alpha, bytes(bad))
    sk2 = hashlib.sha256(b"other").digest()
    x2, _ = vrf_ref._secret_expand(sk2)
    vk2 = ed.compress(ed.scalar_mult(x2, ed.BASE))
    assert not vrf_ref.verify(vk2, alpha, pi)


def test_vrf_distinct_alphas_distinct_outputs():
    sk = hashlib.sha256(b"vrf-seed-2").digest()
    outs = {vrf_ref.output(sk, f"slot-{i}".encode()) for i in range(8)}
    assert len(outs) == 8


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_kes_sign_verify_all_periods(depth):
    seed = hashlib.sha256(f"kes-{depth}".encode()).digest()
    sk = kes.KesSignKey(depth, seed)
    vk = sk.verification_key
    periods = kes.total_periods(depth)
    for t in range(periods):
        assert sk.period == t
        assert sk.verification_key == vk   # root vk stable across evolution
        msg = f"header-at-{t}".encode()
        sig = sk.sign(msg)
        assert kes.verify(depth, vk, t, msg, sig)
        # wrong period / wrong message rejected
        assert not kes.verify(depth, vk, (t + 1) % periods, msg, sig) \
            or periods == 1
        assert not kes.verify(depth, vk, t, msg + b"x", sig)
        if t + 1 < periods:
            sk.evolve()
    with pytest.raises(ValueError):
        sk.evolve()


def test_kes_sig_serialisation_roundtrip():
    seed = os.urandom(32)
    sk = kes.KesSignKey(3, seed)
    sig = sk.sign(b"m")
    raw = sig.to_bytes()
    assert kes.KesSig.from_bytes(3, raw).to_bytes() == raw
    assert kes.verify(3, sk.verification_key, 0, b"m",
                      kes.KesSig.from_bytes(3, raw))


def test_backend_batches_agree():
    ref = CpuRefBackend()
    ssl = CppBackend()
    eds, vrfs, kess = [], [], []
    for i in range(4):
        sk = hashlib.sha256(f"b{i}".encode()).digest()
        msg = f"m{i}".encode()
        eds.append(Ed25519Req(ed25519_ref.public_key(sk), msg,
                              ed25519_ref.sign(sk, msg)))
        x, _ = vrf_ref._secret_expand(sk)
        vrfs.append(VrfReq(ed.compress(ed.scalar_mult(x, ed.BASE)), msg,
                           vrf_ref.prove(sk, msg)))
        ksk = kes.KesSignKey(2, sk)
        ksk.evolve()
        kess.append(KesReq(2, ksk.verification_key, 1, msg,
                           ksk.sign(msg).to_bytes()))
    # corrupt one of each
    eds.append(Ed25519Req(eds[0].vk, b"wrong", eds[0].sig))
    vrfs.append(VrfReq(vrfs[0].vk, b"wrong", vrfs[0].proof))
    kess.append(KesReq(2, kess[0].vk, 0, kess[0].msg, kess[0].sig_bytes))
    expect_ed = [True] * 4 + [False]
    assert ref.verify_ed25519_batch(eds) == expect_ed
    assert ref.verify_vrf_batch(vrfs) == [True] * 4 + [False]
    assert ref.verify_kes_batch(kess) == [True] * 4 + [False]
    assert ssl.verify_ed25519_batch(eds) == expect_ed
    assert ssl.verify_vrf_batch(vrfs) == [True] * 4 + [False]
    assert ssl.verify_kes_batch(kess) == [True] * 4 + [False]


# -- parity with the JAX package's copies --------------------------------

def _points(rng, n):
    """n seeded points in extended coordinates: multiples of the base
    (on the curve), each with a twin whose x is moved by one (off it),
    and a random projective Z on every one."""
    out = []
    for _ in range(n):
        k = int.from_bytes(rng.bytes(32), "little") % ed.L
        x, y = ed.to_affine(ed.scalar_mult(k, ed.BASE))
        for xx in (x, (x + 1) % ed.P):
            z = int.from_bytes(rng.bytes(32), "little") % (ed.P - 1) + 1
            out.append((xx * z % ed.P, y * z % ed.P, z,
                        xx * y % ed.P * z % ed.P))
    return out


def test_is_on_curve_equals_the_jax_packages():
    pts = _points(np.random.default_rng(16), 12) + [ed.BASE, ed.IDENTITY]
    got = [ed.is_on_curve(p) for p in pts]
    assert got == [jed.is_on_curve(p) for p in pts]
    assert got[:24] == [True, False] * 12


def test_prove_pure_and_output_equal_the_jax_packages():
    rng = np.random.default_rng(17)
    for i in range(3):
        sk, alpha = rng.bytes(32), rng.bytes(i * 17)
        pi = vrf_ref.prove_pure(sk, alpha)
        assert pi == jvrf.prove_pure(sk, alpha) == vrf_ref.prove(sk, alpha)
        assert vrf_ref.output(sk, alpha) == jvrf.output(sk, alpha) \
            == jvrf.proof_to_hash(pi)
        vk = vrf_ref.public_key(sk)
        bad = bytearray(pi)
        bad[i * 20] ^= 1
        for a, p in ((alpha, pi), (alpha + b"!", pi), (alpha, bytes(bad))):
            assert vrf_ref.verify(vk, a, p) == jvrf.verify(vk, a, p)


def _kes_cases(rng, depth):
    """(depth, vk, period, msg, sig) for a seeded key at three periods,
    each valid and with one field tampered."""
    sk = kes.KesSignKey(depth, rng.bytes(32))
    vk = sk.verification_key
    cases = []
    for t in range(min(3, kes.total_periods(depth))):
        while sk.period < t:
            sk.evolve()
        msg = rng.bytes(40)
        sig = sk.sign(msg)
        cases.append((depth, vk, t, msg, sig))
        cases.append((depth, vk, t, msg + b"x", sig))
        cases.append((depth, vk, (t + 1) % kes.total_periods(depth), msg,
                      sig))
        cases.append((depth, bytes(32), t, msg, sig))
        lsig = bytearray(sig.leaf_sig)
        lsig[5] ^= 1
        cases.append((depth, vk, t, msg, kes.KesSig(bytes(lsig),
                                                    sig.merkle)))
        if depth:
            (l0, r0), *rest = sig.merkle
            cases.append((depth, vk, t, msg,
                          kes.KesSig(sig.leaf_sig, ((r0, l0), *rest))))
            cases.append((depth + 1, vk, t, msg, sig))
    return cases


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_kes_verify_equals_the_jax_packages(depth):
    got, want = [], []
    for d, vk, t, msg, sig in _kes_cases(np.random.default_rng(depth),
                                         depth):
        got.append(kes.verify(d, vk, t, msg, sig))
        want.append(jkes.verify(d, vk, t, msg,
                                jkes.KesSig(sig.leaf_sig, sig.merkle)))
    assert got == want
    assert got[0] and not all(got)
