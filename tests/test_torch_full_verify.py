"""The port's full 256-bit Ed25519 verify and the standalone batch APIs
against the JAX package, on the same seeded lanes.

- `ed25519.verify_full_words_core` (the plain version of the
  `ed25519_verify` kernel) against `ed25519_ref.verify`, lane by lane;
- its window digits and host parse against the bit rows of
  `ed25519_jax.prepare_bytes_batch` (numpy only);
- `kernels.batch_verify_ed25519`, `ed25519.batch_verify`,
  `vrf.batch_verify_vrf` and `vrf.batch_betas` with `device="cpu"`
  against `ed25519_ref` and `vrf_ref`, with and without padding;
- `perf_probe.main` at a tiny size on the CPU.

Nothing in tier-1 here starts a JAX compile.  The comparisons with the JAX
package's kernels (`pallas_kernels.batch_verify_ed25519` in interpret
mode, `ed25519_jax.batch_verify`, `vrf_jax.batch_verify_vrf` and
`batch_betas`) compile for minutes on the CPU and are `slow`.  Every
comparison is exact.
"""
import json

import numpy as np
import pytest
import torch

from ouroboros_tpu.crypto import ed25519_jax as JE
from ouroboros_tpu.crypto import ed25519_ref as jref
from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu_torch import perf_probe
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import kernels as K
from ouroboros_tpu_torch.crypto import vrf as V

N = 16
# the plain versions run many small ops: one thread per test worker
# avoids oversubscribing the cores the other workers share
torch.set_num_threads(1)
RNG = np.random.default_rng(25519)
UNDECODABLE = next(y.to_bytes(32, "little") for y in range(2, 100)
                   if jed.decompress(y.to_bytes(32, "little")) is None)
L_BYTES = jed.L.to_bytes(32, "little")


def _enc(y: int, sign: int) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def _t(a):
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _bytes(n):
    return bytes(RNG.integers(0, 256, n, dtype=np.uint8))


@pytest.fixture(scope="module")
def ed_lanes():
    """16 lanes over 4 keys.  Lanes 1-11 are the tampers: a flipped
    signature byte, a wrong message, s >= L, R off the curve, A off the
    curve; a signature (R = [r]B, s = r) that the identity key accepts,
    under y = 1 with the sign bit set (x = 0, must not decode: only the
    okA check rejects it) and under the identity itself (accepted: the
    reference has no small-order check); y_A = p (non-canonical); a
    31-byte key; a 63-byte signature; the order-2 key (0, -1) with the
    same forged signature."""
    seeds = [_bytes(32) for _ in range(4)]
    keys = [seeds[j % 4] for j in range(N)]
    vks = [jref.public_key(k) for k in keys]
    msgs = [_bytes(24) for _ in range(N)]
    sigs = [jref.sign(k, m) for k, m in zip(keys, msgs)]
    r = int.from_bytes(_bytes(32), "little") % jed.L
    forged = jed.compress(jed.scalar_mult(r, jed.BASE)) + \
        r.to_bytes(32, "little")
    sigs[1] = sigs[1][:50] + bytes([sigs[1][50] ^ 2]) + sigs[1][51:]
    msgs[2] = b"another message"
    sigs[3] = sigs[3][:32] + L_BYTES
    sigs[4] = UNDECODABLE + sigs[4][32:]
    vks[5] = UNDECODABLE
    vks[6], sigs[6] = _enc(1, 1), forged
    vks[7], sigs[7] = _enc(1, 0), forged
    vks[8] = _enc(jed.P, 0)
    vks[9] = vks[9][:31]
    sigs[10] = sigs[10][:63]
    vks[11], sigs[11] = _enc(jed.P - 1, 0), forged
    want = [jref.verify(v, m, s) for v, m, s in zip(vks, msgs, sigs)]
    assert want[0] and want[7] and all(want[12:])
    assert not any(want[1:7]) and not any(want[8:11])
    return vks, msgs, sigs, want


@pytest.fixture(scope="module")
def vrf_lanes():
    """6 VRF lanes over 2 pool keys: valid, a wrong alpha, an undecodable
    Gamma, s >= L, a flipped challenge byte, valid."""
    sks = [_bytes(32) for _ in range(2)]
    sks = [sks[j % 2] for j in range(6)]
    vks = [jvrf.public_key(s) for s in sks]
    alphas = [_bytes(12) for _ in range(6)]
    proofs = [jvrf.prove(s, a) for s, a in zip(sks, alphas)]
    alphas[1] = b"wrong alpha"
    proofs[2] = UNDECODABLE + proofs[2][32:]
    proofs[3] = proofs[3][:48] + L_BYTES
    proofs[4] = proofs[4][:33] + bytes([proofs[4][33] ^ 1]) + proofs[4][34:]
    oks = [jvrf.verify(v, a, p) for v, a, p in zip(vks, alphas, proofs)]
    betas = [jvrf.proof_to_hash(p) if jvrf.decode_proof(p) else None
             for p in proofs]
    assert oks == [True, False, False, False, False, True]
    assert betas[2] is None and betas[3] is None and betas[1] is not None
    return vks, alphas, proofs, oks, betas


# -- the plain version --------------------------------------------------------

def test_verify_full_words_core_matches_ed25519_ref(ed_lanes):
    vks, msgs, sigs, want = ed_lanes
    arrays, parse_ok = E.prepare_words_batch(vks, msgs, sigs)
    ok = E.verify_full_words_core(*[_t(a) for a in arrays])
    assert ok.dtype == torch.int32 and tuple(ok.shape) == (N,)
    assert [bool(o) and bool(p) for o, p in zip(ok, parse_ok)] == want
    # the host parse passes lane 6 (y = 1 is canonical): its rejection
    # is the kernel's okA
    assert parse_ok[6] and not ok[6] and ok[7]


def test_full_idx_rows_and_parse_match_prepare_bytes_batch(ed_lanes):
    """The digits the ladder reads, MSB first, and the host parse, against
    the JAX package's bit-row prep (radix-2^13 limbs, 1 KiB of bits a
    scalar)."""
    vks, msgs, sigs, _want = ed_lanes
    (yA, signA, yR, signR, s_bits, k_bits), j_ok = JE.prepare_bytes_batch(
        vks, msgs, sigs)
    (Aw, p_signA, Rw, p_signR, sw, kw), p_ok = E.prepare_words_batch(
        vks, msgs, sigs)
    want = (2 * s_bits[0::2] + s_bits[1::2]) + \
        4 * (2 * k_bits[0::2] + k_bits[1::2])
    got = E.full_idx_rows(_t(sw), _t(kw))
    assert got.shape == (128, N)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(p_ok, j_ok)
    assert np.array_equal(p_signA, signA) and np.array_equal(p_signR, signR)
    for limbs, words in ((yA, Aw), (yR, Rw)):
        for j in range(N):
            y_j = sum(int(v) << (13 * i) for i, v in enumerate(limbs[:, j]))
            y_p = int.from_bytes(words[:, j].astype("<u4").tobytes(),
                                 "little")
            assert y_j == y_p


# -- the standalone batch APIs ------------------------------------------------

@pytest.mark.parametrize("api,pad_to", [("kernels", None), ("ed25519", None),
                                        ("ed25519", 20)])
def test_batch_verify_ed25519_matches_ed25519_ref(ed_lanes, api, pad_to):
    vks, msgs, sigs, want = ed_lanes
    K.reset_launches()
    if api == "kernels":
        got = K.batch_verify_ed25519(vks, msgs, sigs, device="cpu")
    else:
        got = E.batch_verify(vks, msgs, sigs, pad_to=pad_to, device="cpu")
    assert got == want
    assert K.LAUNCHES["ed25519_verify"] == 0       # the plain version ran


def test_batch_apis_on_empty_batches():
    assert K.batch_verify_ed25519([], [], [], device="cpu") == []
    assert E.batch_verify([], [], [], pad_to=8, device="cpu") == []
    assert V.batch_verify_vrf([], [], [], device="cpu") == ([], [])
    assert V.batch_betas([], pad_to=8, device="cpu") == []


@pytest.mark.parametrize("pad_to", [None, 8])
def test_batch_verify_vrf_matches_vrf_ref(vrf_lanes, pad_to):
    vks, alphas, proofs, want_oks, want_betas = vrf_lanes
    oks, betas = V.batch_verify_vrf(vks, alphas, proofs, pad_to=pad_to,
                                    device="cpu")
    assert isinstance(oks, list) and isinstance(betas, list)
    assert oks == want_oks
    assert betas == want_betas


@pytest.mark.parametrize("pad_to", [None, 8])
def test_batch_betas_matches_vrf_ref(vrf_lanes, pad_to):
    _vks, _alphas, proofs, _oks, want_betas = vrf_lanes
    assert V.batch_betas(proofs, pad_to=pad_to, device="cpu") == want_betas


# -- the probe ----------------------------------------------------------------

def test_perf_probe_runs_on_the_cpu(capsys):
    rows = perf_probe.main(["--device", "cpu", "--n-ed", "4", "--n-vrf",
                            "2", "--reps", "1", "--old"])
    names = ["ed split e2e", "ed split device", "ed full e2e",
             "ed full device", "vrf e2e", "betas e2e"]
    assert list(rows) == names
    lines = capsys.readouterr().out.splitlines()
    for name in names:
        assert any(line.startswith(name) and "median" in line
                   for line in lines), name
    last = json.loads(lines[-1])["perf_probe"]
    assert last["device"] == "cpu" and list(last["rows"]) == names
    assert all(r["per_s"] > 0 for r in last["rows"].values())


# -- against the JAX package's kernels (slow: minutes of XLA:CPU compile) -----

@pytest.mark.slow
def test_full_verify_matches_pallas_interpret(ed_lanes, monkeypatch):
    """The Pallas kernel in interpret mode at TILE = 8 (two grid steps),
    as tests/test_pallas_kernels.py runs it: raw kernel rows on every lane
    and the API's verdicts."""
    from ouroboros_tpu.crypto import pallas_kernels as PK
    monkeypatch.setattr(PK, "TILE", 8)
    monkeypatch.setattr(PK, "_interpret", lambda: True)
    vks, msgs, sigs, want = ed_lanes
    assert PK.batch_verify_ed25519(vks, msgs, sigs) == want
    assert K.batch_verify_ed25519(vks, msgs, sigs, device="cpu") == want
    (yA, signA, yR, signR, s_bits, k_bits), _ok = JE.prepare_bytes_batch(
        vks, msgs, sigs)
    raw = np.asarray(PK.ed25519_verify_pallas(yA, signA, yR, signR, s_bits,
                                              k_bits, N))[0]
    arrays, _p = E.prepare_words_batch(vks, msgs, sigs)
    assert E.verify_full_words_core(*[_t(a) for a in arrays]).tolist() == \
        raw.tolist()


@pytest.mark.slow
def test_full_verify_matches_xla_batch_verify(ed_lanes):
    vks, msgs, sigs, want = ed_lanes
    assert JE.batch_verify(vks, msgs, sigs) == want
    assert E.batch_verify(vks, msgs, sigs, device="cpu") == want


@pytest.mark.slow
def test_vrf_batch_apis_match_vrf_jax(vrf_lanes):
    from ouroboros_tpu.crypto import vrf_jax as JV
    vks, alphas, proofs, _oks, _betas = vrf_lanes
    assert V.batch_verify_vrf(vks, alphas, proofs, pad_to=8, device="cpu") \
        == JV.batch_verify_vrf(vks, alphas, proofs, pad_to=8)
    assert V.batch_betas(proofs, device="cpu") == JV.batch_betas(proofs)
