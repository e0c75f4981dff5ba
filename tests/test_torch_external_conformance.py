"""External crypto conformance on the port — vectors NOT produced by this
codebase.  The cases of tests/test_external_conformance.py on
`ouroboros_tpu_torch.crypto`; the JAX package's `vrf_jax.batch_betas`
case becomes the port's `vrf.batch_betas` (the `gamma8` kernel's
wrapper) on the plain version here and on the card in a `cuda` case;
then the vendored proofs' decoding, betas and hash-to-curve points held
equal to the JAX package's copies.  Tolerance: none, bytes compare
exactly.

Ed25519 is pinned by the RFC 8032 vectors and OpenSSL cross-checks in
test_crypto_ref.py.  For the ECVRF (draft-irtf-cfrg-vrf-03 ciphersuite
0x04, the libsodium crypto_vrf_ietfdraft03 used by Cardano's PraosVRF —
Shelley/Protocol/Crypto.hs:15-23), the published test vectors are not
vendorable in this zero-egress environment, but the reference repository
ships golden headers whose VRF certificates were generated by the REAL
Cardano crypto stack (libsodium under cardano-crypto-class):

  /root/reference/ouroboros-consensus-shelley-test/test/golden/
      ShelleyNodeToNodeVersion1/Header   (Test.Consensus.Shelley.Examples)

Each certificate carries (output, proof) with output == proof_to_hash
(proof), so the pairs below are bit-level external checks of our proof
decoding, Γ decompression, the [8]Γ scalar multiplication, point
compression, and the suite/SHA-512 output construction — independent of
any code in this repository.  The pairs are vendored here (test data,
with provenance) so the check also runs without the reference mounted.

The prove/verify halves are additionally anchored by: the C++ backend
written independently from the draft, curve-membership and subgroup
properties of the Elligator2 map (below), and the RFC-8032-anchored
Ed25519 shared arithmetic.
"""
import hashlib
import os

import pytest

from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu_torch.crypto import vrf_ref
from ouroboros_tpu_torch.crypto import edwards as ed

# ShelleyNodeToNodeVersion1/Header, bhbody field 5 (nonce VRF cert)
NONCE_OUT = bytes.fromhex(
    "4fefc7c718693b57c87170ceba220382afbdd148c0a53b4a009ca63ad1f10148"
    "3a6170c83a77f23d362a68dcb502802df7f98fa4f7a78b4082b211530e123430")
NONCE_PROOF = bytes.fromhex(
    "f770f6769ae9871d42b970fc6254bb927c2181fff45897f241bd72221d86d33c"
    "8df64c0a3c8cbb9aa52fef191d7202465c52df8d33727a38c7dc5d40864d7533"
    "48a340f8afcbb3bb05d4a03f16b1080d")
# bhbody field 6 (leader VRF cert)
LEADER_OUT = bytes.fromhex(
    "fe682775f0fa232e909ddc9ec3210ea7a0ee6514cd8b0815190a08f7cef39854"
    "63152e10dfad9ed6c09b641b6c1824498e77814a7c12e03096a63cd620564463")
LEADER_PROOF = bytes.fromhex(
    "0951ed3ef2065e4196d008b50a63bb3e2bdc9a64df67eff4e230b35429291def"
    "476684114e074357a5c834bf79eacf583b6fe9fcd1d17f3719a31de97aa4da5e"
    "4630b05421359e0b6e4a9bd76c6b920b")

GOLDEN = ("/root/reference/ouroboros-consensus-shelley-test/test/golden/"
          "ShelleyNodeToNodeVersion1/Header")


class TestLibsodiumGoldenCerts:
    @pytest.mark.parametrize("out,proof", [(NONCE_OUT, NONCE_PROOF),
                                           (LEADER_OUT, LEADER_PROOF)])
    def test_proof_to_hash_matches_libsodium(self, out, proof):
        assert vrf_ref.proof_to_hash(proof) == out

    @pytest.mark.parametrize("out,proof", [(NONCE_OUT, NONCE_PROOF),
                                           (LEADER_OUT, LEADER_PROOF)])
    def test_gamma_decodes_onto_the_curve(self, out, proof):
        gamma, c, s = vrf_ref.decode_proof(proof)
        assert ed.is_on_curve(gamma)
        assert s < ed.L and c < (1 << 128)

    @pytest.mark.parametrize("out,proof", [(NONCE_OUT, NONCE_PROOF),
                                           (LEADER_OUT, LEADER_PROOF)])
    def test_cpp_backend_agrees(self, out, proof):
        from ouroboros_tpu_torch.crypto import cpp_backend
        lib = cpp_backend.shared_library()
        if lib is None:
            pytest.skip("native toolchain unavailable")
        import ctypes
        beta = ctypes.create_string_buffer(64)
        assert lib.ouro_vrf_proof_to_hash(proof, beta) == 1
        assert beta.raw == out

    def test_jax_batch_betas_agree(self):
        """The reference's batched-betas case: the port's `gamma8`
        wrapper, on its plain version for host tensors."""
        from ouroboros_tpu_torch.crypto import vrf
        got = vrf.batch_betas([NONCE_PROOF, LEADER_PROOF], pad_to=2,
                              device="cpu")
        assert got == [NONCE_OUT, LEADER_OUT]

    @pytest.mark.cuda
    def test_batch_betas_on_the_card(self):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        from ouroboros_tpu_torch.crypto import kernels as K, vrf
        before = K.LAUNCHES["gamma8"]
        got = vrf.batch_betas([NONCE_PROOF, LEADER_PROOF], pad_to=2)
        assert got == [NONCE_OUT, LEADER_OUT]
        assert K.LAUNCHES["gamma8"] == before + 1

    def test_vendored_pairs_match_reference_checkout(self):
        """When the reference is mounted, re-extract the certs and confirm
        the vendored vectors are faithful copies."""
        if not os.path.exists(GOLDEN):
            pytest.skip("reference checkout not mounted")
        from ouroboros_tpu_torch.utils import cbor
        tag = cbor.loads(open(GOLDEN, "rb").read())
        payload = tag.value if hasattr(tag, "value") else tag.payload
        body, _kes = cbor.loads(bytes(payload))
        assert (bytes(body[5][0]), bytes(body[5][1])) == (NONCE_OUT,
                                                          NONCE_PROOF)
        assert (bytes(body[6][0]), bytes(body[6][1])) == (LEADER_OUT,
                                                          LEADER_PROOF)


class TestElligatorProperties:
    """Structural anchors for the prove/verify halves that golden data
    cannot reach without the (external) mkSeed alpha construction."""

    def test_hash_to_curve_lands_in_prime_subgroup(self):
        for i in range(8):
            vk = hashlib.sha256(b"htc-%d" % i).digest()
            H = vrf_ref._hash_to_curve(vk, b"alpha-%d" % i)
            assert ed.is_on_curve(H)
            # cofactor cleared: [L]H == identity
            assert ed.pt_equal(ed.scalar_mult(ed.L, H), ed.IDENTITY)

    def test_prove_verify_roundtrip_and_cross_tamper(self):
        sk = hashlib.sha256(b"ext-conf").digest()
        vk = vrf_ref.public_key(sk)
        pi = vrf_ref.prove(sk, b"msg")
        assert vrf_ref.verify(vk, b"msg", pi)
        assert not vrf_ref.verify(vk, b"msg2", pi)
        bad = bytearray(pi)
        bad[40] ^= 1
        assert not vrf_ref.verify(vk, b"msg", bytes(bad))


class TestParityWithTheJaxPackage:
    """The port's copies against the JAX package's on the same bytes."""

    @pytest.mark.parametrize("proof", [NONCE_PROOF, LEADER_PROOF])
    def test_decoding_and_beta_equal_the_jax_packages(self, proof):
        ours, theirs = vrf_ref.decode_proof(proof), jvrf.decode_proof(proof)
        assert ed.compress(ours[0]) == jed.compress(theirs[0])
        assert ours[1:] == theirs[1:]
        assert vrf_ref.proof_to_hash(proof) == jvrf.proof_to_hash(proof)
        bad = bytes([proof[0] ^ 1]) + proof[1:]
        assert (vrf_ref.decode_proof(bad) is None) \
            == (jvrf.decode_proof(bad) is None)

    def test_hash_to_curve_equals_the_jax_packages(self):
        for i in range(4):
            vk = hashlib.sha256(b"htc-%d" % i).digest()
            a = vrf_ref._hash_to_curve(vk, b"alpha-%d" % i)
            b = jvrf._hash_to_curve(vk, b"alpha-%d" % i)
            assert ed.compress(a) == jed.compress(b)
