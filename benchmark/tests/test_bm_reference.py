"""The reference against published vectors (RFC 8032 §7.1, the ECVRF
draft-irtf-cfrg-vrf-03 examples of ECVRF-ED25519-SHA512-Elligator2), its
KES and ledger rules on a forged chain, and the forger's fast signing
against the reference's."""
import hashlib

import pytest

from reference import cbor, chain, ed25519, kes, ledger, vrf

KEYS = ["9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7"]
PUBLIC = ["d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
          "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
          "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025"]
MESSAGES = ["", "72", "af82"]
RFC8032_SIGS = [
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
    "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
    "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
    "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"]
VRF_PROOFS = [
    "b6b4699f87d56126c9117a7da55bd0085246f4c56dbc95d20172612e9d38e8d7"
    "ca65e573a126ed88d4e30a46f80a666854d675cf3ba81de0de043c3774f06156"
    "0f55edc256a787afe701677c0f602900",
    "ae5b66bdf04b4c010bfe32b2fc126ead2107b697634f6f7337b9bff8785ee111"
    "200095ece87dde4dbe87343f6df3b107d91798c8a7eb1245d3bb9c5aafb09335"
    "8c13e6ae1111a55717e895fd15f99f07",
    "dfa2cba34b611cc8c833a6ea83b8eb1bb5e2ef2dd1b0c481bc42ff36ae7847f6"
    "ab52b976cfd5def172fa412defde270c8b8bdfbaae1c7ece17d9833b1bcf3106"
    "4fff78ef493f820055b561ece45e1009"]
VRF_OUTPUTS = [
    "5b49b554d05c0cd5a5325376b3387de59d924fd1e13ded44648ab33c21349a60"
    "3f25b84ec5ed887995b33da5e3bfcb87cd2f64521c4c62cf825cffabbe5d31cc",
    "94f4487e1b2fec954309ef1289ecb2e15043a2461ecc7b2ae7d4470607ef82eb"
    "1cfa97d84991fe4a7bfdfd715606bc27e2967a6c557cfb5875879b671740b7d8",
    "2031837f582cd17a9af9e0c7ef5a6540e3453ed894b62c293686ca3c1e319dde"
    "9d0aa489a4b59a9594fc2328bc3deff3c8a0929a369a72b1180a596e016b5ded"]
CASES = list(zip(KEYS, PUBLIC, MESSAGES, RFC8032_SIGS, VRF_PROOFS,
                 VRF_OUTPUTS))


@pytest.mark.parametrize("sk,pk,msg,sig,_pi,_beta", CASES)
def test_rfc8032(sk, pk, msg, sig, _pi, _beta):
    sk, pk, msg, sig = map(bytes.fromhex, (sk, pk, msg, sig))
    assert ed25519.public_key(sk) == pk
    assert ed25519.sign(sk, msg) == sig
    assert ed25519.verify(pk, msg, sig)
    bad = bytearray(sig)
    bad[40] ^= 1
    assert not ed25519.verify(pk, msg, bytes(bad))
    assert not ed25519.verify(pk, msg + b"x", sig)


@pytest.mark.parametrize("sk,pk,alpha,_sig,pi,beta", CASES)
def test_ecvrf_draft03(sk, pk, alpha, _sig, pi, beta):
    sk, pk, alpha, pi, beta = map(bytes.fromhex, (sk, pk, alpha, pi, beta))
    assert vrf.public_key(sk) == pk
    assert vrf.prove(sk, alpha) == pi
    assert vrf.proof_to_hash(pi) == beta
    assert vrf.verify(pk, alpha, pi)
    bad = bytearray(pi)
    bad[50] ^= 1
    assert not vrf.verify(pk, alpha, bytes(bad))
    assert not vrf.verify(pk, alpha + b"x", pi)


def test_sum_kes_signs_and_verifies_every_period_of_a_small_tree():
    seed = hashlib.sha256(b"kes").digest()
    vk = kes.vk_of(3, seed)
    for period in range(8):
        sig = kes.sign(3, seed, period, b"header")
        assert len(sig) == 64 + 3 * 64
        assert kes.verify(3, vk, period, b"header", sig)
        assert not kes.verify(3, vk, (period + 1) % 8, b"header", sig)
        bad = sig[:100] + bytes([sig[100] ^ 1]) + sig[101:]
        assert not kes.verify(3, vk, period, b"header", bad)


def test_cbor_round_trip_and_spans():
    obj = [1, 23, 24, 255, 256, 2 ** 32, 2 ** 40, -5, b"ab", "tp", [[]]]
    raw = cbor.encode(obj)
    assert cbor.decode(raw) == (obj, len(raw))
    elems, end = cbor.items(raw, 0)
    assert end == len(raw)
    assert [raw[a:b] for _v, a, b in elems] == [cbor.encode(x) for x in obj]


def test_the_leader_threshold():
    from fractions import Fraction
    f, half = Fraction(4, 5), Fraction(1, 2)
    edge = 1 - 0.2 ** 0.5
    below = int((edge - 1e-9) * 2 ** 512).to_bytes(64, "big")
    above = int((edge + 1e-9) * 2 ** 512).to_bytes(64, "big")
    assert ledger.is_leader(below, half, f)
    assert not ledger.is_leader(above, half, f)


@pytest.mark.parametrize("mode", ["fresh", "owners", 3])
def test_forged_chains_pass_and_each_tampered_block_fails(mode):
    import forge
    config = {"name": "t", "stakePools": 2, "activeSlotsCoeff": 0.8,
              "securityParam": 2160, "epochLength": 27000,
              "slotsPerKESPeriod": 8100, "kesDepth": 6,
              "maxKESEvolutions": 62, "chainBlocks": 6, "txsPerBlock": 3,
              "window": 3}
    out = forge.forge(config, {"witness_keys": mode}, 2 ** 31 + 99,
                      workers=1)
    g = out["genesis"]
    stake = g.stake()
    st = ledger.State.genesis(g)
    before = []
    for raw in out["blocks"]:
        before.append(st)
        st = ledger.apply_block(g, stake, st, chain.decode_block(raw), True)
    reasons = {}
    blocks = out["blocks"]
    for kind, i, raw, headers in out["variants"]:
        assert raw != blocks[i]
        with pytest.raises(ledger.Invalid) as err:
            ledger.apply_block(g, stake, before[i], chain.decode_block(raw),
                               True)
        reasons[kind] = str(err.value)
        # with that check left out, the rest of its window holds, re-chained
        # onto it, and the next window's first block does not
        end = i + 1 + len(headers)
        assert end == min(6, (i // 3 + 1) * 3)
        st = ledger.apply_block(g, stake, before[i], chain.decode_block(raw),
                                False)
        for j, h in enumerate(headers, i + 1):
            st = ledger.apply_block(g, stake, st, chain.decode_block(
                forge.with_header(blocks[j], h)), True)
        if end < 6:
            with pytest.raises(ledger.Invalid, match="envelope"):
                ledger.apply_block(g, stake, st,
                                   chain.decode_block(blocks[end]), True)
    assert [v[0] for v in out["variants"]] == list(forge.TAMPER)
    assert reasons == {"witness": "witness signature",
                       "kes": "KES signature",
                       "ocert": "operational certificate signature",
                       "vrf_eta": "nonce VRF proof",
                       "vrf_leader": "leader VRF proof"}


@pytest.mark.parametrize("n_blocks,window", [(4096, 1024), (2048, 1024),
                                             (8, 4), (8, 3)])
def test_tampered_positions_reach_every_window_and_both_halves(n_blocks,
                                                               window):
    """Whatever the seed, the first two forms a window take both of its
    halves, so no window, and no half of one, goes unchecked."""
    import forge
    n_windows = -(-n_blocks // window)
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 1):
        at = forge.positions(seed, n_blocks, window, 2 * n_windows)
        assert all(0 <= i < n_blocks for i in at)
        cells = set()
        for i in at:
            lo = i // window * window
            size = min(window, n_blocks - lo)
            cells.add((i // window, i - lo >= size // 2))
        assert cells == {(w, h) for w in range(n_windows)
                         for h in (False, True)}
        # the first forms take every window once
        assert {i // window for i in at[:n_windows]} == set(range(n_windows))
    assert forge.positions(3, n_blocks, window, 6) \
        != forge.positions(4, n_blocks, window, 6)
    assert forge.positions(3, 7, 3, 6).count(6) == 2    # a 1-block window


def test_fast_signing_gives_the_reference_bytes():
    import forge
    for i in range(5):
        sk = hashlib.sha256(bytes([i])).digest()
        msg = bytes([i]) * (17 * i)
        assert forge.PUBLIC_KEY(sk) == ed25519.public_key(sk)
        assert forge.SIGN(sk, msg) == ed25519.sign(sk, msg)


def test_the_reference_agrees_with_the_programs_own_references():
    """A cross-check in this test only: the reference imports nothing of
    the program, and the program's pure-Python references agree with it."""
    from ouroboros_tpu_torch.crypto import ed25519_ref, vrf_ref
    from ouroboros_tpu_torch.crypto import kes as pkes
    for i in range(3):
        sk = hashlib.sha256(b"x%d" % i).digest()
        msg = b"m" * i
        assert ed25519.sign(sk, msg) == ed25519_ref.sign(sk, msg)
        assert vrf.prove(sk, msg) == vrf_ref.prove(sk, msg)
        assert kes.vk_of(2, sk) == pkes.vk_of(2, sk)
