"""The port's numpy host prep is byte-identical to the JAX package's.

Same inputs (made from a seed with numpy) go through the JAX package's
prep functions and the port's; every array and mask must be equal, on
valid inputs and on malformed ones: short keys and signatures,
non-canonical y, s >= L, undecodable Gamma.  Comparisons are exact.
"""
import hashlib

import numpy as np
import pytest

from ouroboros_tpu.crypto import blake2b_jax as JB2
from ouroboros_tpu.crypto import ed25519_jax as JE
from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import field_jax as JF
from ouroboros_tpu.crypto import vrf_jax as JV
from ouroboros_tpu_torch.crypto import blake2b as B2
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import ed25519_ref, vrf_ref
from ouroboros_tpu_torch.crypto import vrf as V

RNG = np.random.default_rng(20261016)
P = jed.P
L = jed.L
NONCANON_Y = (P + 3).to_bytes(32, "little")            # y >= p
UNDECODABLE = next(y.to_bytes(32, "little") for y in range(2, 100)
                   if jed.decompress(y.to_bytes(32, "little")) is None)


def _seeds(n):
    return [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


def _ed_inputs():
    seeds = _seeds(8)
    vks = [ed25519_ref.public_key(s) for s in seeds]
    msgs = [bytes(RNG.integers(0, 256, j + 3, dtype=np.uint8))
            for j in range(8)]
    sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
    vks[1] = vks[1][:31]                                  # short key
    vks[2] = NONCANON_Y                                   # y >= p
    sigs[3] = sigs[3][:32] + L.to_bytes(32, "little")     # s == L
    sigs[4] = NONCANON_Y[:31] + b"\xff" + sigs[4][32:]    # R y >= p, sign 1
    sigs[5] = sigs[5][:63]                                # short signature
    sigs[6] = sigs[6][:32] + (L + 5).to_bytes(32, "little")
    return vks, msgs, sigs


def _vrf_inputs():
    seeds = _seeds(4)
    vks = [vrf_ref.public_key(s) for s in seeds] * 2
    alphas = [bytes(RNG.integers(0, 256, 9, dtype=np.uint8))
              for _ in range(8)]
    proofs = [vrf_ref.prove(s, a) for s, a in zip(seeds * 2, alphas[:4])]
    proofs += [proofs[0], proofs[1][:79],                 # short proof
               UNDECODABLE + proofs[2][32:],              # bad Gamma
               proofs[3][:48] + L.to_bytes(32, "little")]  # s == L
    vks[5] = NONCANON_Y
    return vks, alphas, proofs


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b)


def test_ed25519_prepare_words_batch_identical():
    vks, msgs, sigs = _ed_inputs()
    got_arrays, got_ok = E.prepare_words_batch(vks, msgs, sigs)
    want_arrays, want_ok = JE.prepare_words_batch(vks, msgs, sigs)
    for g, w in zip(got_arrays, want_arrays):
        _eq(g, w)
    _eq(got_ok, want_ok)
    assert list(got_ok) == [True, False, False, False, False, False, False,
                            True]


def test_ed25519_helpers_identical():
    vks, _msgs, sigs = _ed_inputs()
    arr, ok = E._bytes_rows(vks, 32)
    warr, wok = JE._bytes_rows(vks, 32)
    _eq(arr, warr)
    _eq(ok, wok)
    rows = np.frombuffer(b"".join([NONCANON_Y, UNDECODABLE]
                                  + [v for v in vks if len(v) == 32]),
                         np.uint8).reshape(-1, 32)
    _eq(E._y_canonical(rows), JE._y_canonical(rows))
    s_rows = np.frombuffer(b"".join(
        [s[32:] for s in sigs if len(s) == 64]
        + [(L - 1).to_bytes(32, "little"), L.to_bytes(32, "little"),
           (2**253).to_bytes(32, "little")]), np.uint8).reshape(-1, 32)
    _eq(E._scalar_lt_L(s_rows), JE._scalar_lt_L(s_rows))
    # _decode_compressed: the port returns y as words, the JAX package as
    # radix-2^13 limbs of the same value
    yw, sign, yok = E._decode_compressed(rows)
    ylimbs, wsign, wyok = JE._decode_compressed(rows)
    _eq(sign, wsign)
    _eq(yok, wyok)
    got = [int.from_bytes(yw[:, j].tobytes(), "little")
           for j in range(rows.shape[0])]
    assert got == [sum(int(x) << (JF.RADIX * i)
                       for i, x in enumerate(ylimbs[:, j]))
                   for j in range(rows.shape[0])]
    _eq(E._words_of_int(P - 1), JE._words_of_int(P - 1))
    for name in ("_GX_W", "_B128X_W", "_B128Y_W"):
        _eq(getattr(E, name), getattr(JE, name))
    _eq(E.words_from_bytes_rows(rows), JF.words_from_bytes_rows(rows))


def test_vrf_prepare_words_identical():
    vks, alphas, proofs = _vrf_inputs()
    got = V._prepare_words(vks, alphas, proofs)
    want = JV._prepare_words(vks, alphas, proofs)
    for g, w in zip(got[0], want[0]):
        _eq(g, w)
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)
    assert list(got[1]) == [True] * 5 + [False, True, False]
    _eq(V._r_rows(vks, alphas), JV._r_rows(vks, alphas))


def test_vrf_prepare_betas_words_identical():
    _vks, _alphas, proofs = _vrf_inputs()
    (gw, gs), gok = V._prepare_betas_words(proofs)
    (ww, ws), wok = JV._prepare_betas_words(proofs)
    _eq(gw, ww)
    _eq(gs, ws)
    _eq(gok, wok)
    # Gamma's decompression is the kernel's job; the host checks length,
    # canonical y and s < L
    assert list(gok) == [True] * 5 + [False, True, False]


def test_vrf_finish_identical_on_the_same_rows():
    vks, alphas, proofs = _vrf_inputs()
    _args, parse_ok, gamma_ok, s_ok, pf_arr = V._prepare_words(
        vks, alphas, proofs)
    rows = RNG.integers(0, 256, (8, 130), dtype=np.uint8)
    rows[:, 128:] = RNG.integers(0, 2, (8, 2), dtype=np.uint8)
    # make lane 0's challenge match so both finishes accept it
    rows[0, 128:] = 1
    c = hashlib.sha512(vrf_ref.SUITE + b"\x02" + rows[0, :32].tobytes()
                       + bytes(pf_arr[0, :32]) + rows[0, 32:96].tobytes()
                       ).digest()[:16]
    pf_arr = pf_arr.copy()
    pf_arr[0, 32:48] = np.frombuffer(c, np.uint8)
    got = V._finish(rows, parse_ok, gamma_ok, s_ok, pf_arr, 8)
    want = JV._finish(rows, parse_ok, gamma_ok, s_ok, pf_arr, 8)
    assert got == want and got[0][0] is True
    brows = np.concatenate([rows[:, :32], rows[:, 129:]], axis=1)
    assert V._finish_betas(brows, gamma_ok, 8) == \
        JV._finish_betas(brows, gamma_ok, 8)


@pytest.mark.parametrize("n", [1, 16])
def test_blake2b_words_identical(n):
    msgs = RNG.integers(0, 256, (n, 64), dtype=np.uint8)
    digs = RNG.integers(0, 256, (n, 32), dtype=np.uint8)
    _eq(B2.msg_words(msgs), JB2.msg_words(msgs))
    _eq(B2.digest_words(digs), JB2.digest_words(digs))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_copied_references_sign_and_walk_as_the_jax_package(depth):
    """The port's copies of kes.py, ed25519_ref.py and vrf_ref.py give
    the JAX package's keys, signatures, proofs and KES walks."""
    from ouroboros_tpu.crypto import ed25519_ref as jref
    from ouroboros_tpu.crypto import kes as jkes
    from ouroboros_tpu.crypto import vrf_ref as jvrf
    from ouroboros_tpu_torch.crypto import kes
    seed = _seeds(1)[0]
    ours, theirs = kes.KesSignKey(depth, seed), jkes.KesSignKey(depth, seed)
    vk = ours.verification_key
    assert vk == theirs.verification_key
    sig = ours.sign(b"header body")
    assert sig.to_bytes() == theirs.sign(b"header body").to_bytes()
    assert jkes.verify(depth, vk, 0, b"header body", sig)
    raw = sig.to_bytes()
    assert kes.hash_path_key(depth, vk, 0, raw) == \
        jkes.hash_path_key(depth, vk, 0, raw)
    parsed = kes.KesSig.from_bytes(depth, raw)
    assert kes.verify_walk(depth, vk, 0, parsed) == \
        jkes.verify_walk(depth, vk, 0, jkes.KesSig.from_bytes(depth, raw))
    assert kes.verify_prepare(depth, vk, 0, parsed) == \
        jkes.verify_prepare(depth, vk, 0, parsed)
    assert ed25519_ref.sign(seed, b"m") == jref.sign(seed, b"m")
    assert ed25519_ref.public_key(seed) == jref.public_key(seed)
    proof = vrf_ref.prove(seed, b"alpha")
    assert proof == jvrf.prove(seed, b"alpha")
    assert vrf_ref.proof_to_hash(proof) == jvrf.proof_to_hash(proof)
