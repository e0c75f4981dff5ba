"""The r3 Ed25519 verify form behind the compile-probe entry
(`ouroboros_tpu_torch.graft_entry`, `crypto/ed25519.py`: `prepare_batch`,
`decompress_kernel`, `verify_core`, `finalize`, `prepare_bytes_batch`,
`limbs_from_jax`) on the CPU:

- verdicts at 8-16 lanes, valid and tampered (a flipped signature or
  message byte, s >= L, a non-canonical R, an off-curve R, a small-order
  A, wrong lengths), against `ed25519_ref`;
- (d1, d2) mod p against a Python-integer model of the JAX package's
  `verify_core` (edwards.py's formulas, its table and ladder step for
  step), tampered lanes included, where they are not 0;
- `limbs_from_jax` round trips through the integers;
- `prepare_bytes_batch` byte for byte the JAX package's (numpy only
  there); `prepare_batch`'s bit rows those of the same signatures;
- the entry: 128 x True on the CPU (tests/test_torch_imports.py holds
  that it raises without a card);
- one `slow` case: the JAX package's own `prepare_batch` output (its
  jitted `decompress_kernel`) through `limbs_from_jax` into the port's
  `verify_core`, d1 and d2 equal to its jitted `verify_kernel`'s mod p,
  the bit rows and the valid mask byte for byte the port's.

Reference: ed25519_jax.py:190-232, 451-466, 531-630, 680-710;
__graft_entry__.py:15-30.

Tolerance: none.  Verdicts, bytes and integers mod p compare exactly.
"""
import hashlib

import numpy as np
import pytest
import torch

from ouroboros_tpu_torch import graft_entry
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import ed25519_ref, edwards as ed
from ouroboros_tpu_torch.crypto import field as F


def _batch(n: int, seed: int):
    """n signatures over seeded messages by seeded keys, and a copy with
    one tamper of each kind on the lanes after the first."""
    rng = np.random.default_rng(seed)
    sks = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
           for _ in range(3)]
    vks = [ed25519_ref.public_key(sk) for sk in sks]
    keys = [int(k) for k in rng.integers(0, 3, n)]
    msgs = [rng.integers(0, 256, int(rng.integers(0, 64)),
                         dtype=np.uint8).tobytes() for _ in range(n)]
    sigs = [ed25519_ref.sign(sks[k], m) for k, m in zip(keys, msgs)]
    vks = [vks[k] for k in keys]
    bad_R = next(y for y in range(2, 100)
                 if ed.decompress(y.to_bytes(32, "little")) is None)
    tv, tm, ts = list(vks), list(msgs), list(sigs)
    ts[1] = ts[1][:40] + bytes([ts[1][40] ^ 1]) + ts[1][41:]
    tm[2] = tm[2] + b"!"
    ts[3] = ts[3][:32] + ed.L.to_bytes(32, "little")           # s >= L
    ts[4] = ed.P.to_bytes(32, "little") + ts[4][32:]           # R: y = p
    ts[5] = bad_R.to_bytes(32, "little") + ts[5][32:]          # R off curve
    tv[6] = (ed.P - 1).to_bytes(32, "little")                  # order 2
    ts[7] = ts[7][:63]                                         # short sig
    if n > 8:
        tv[8] = tv[8][:31]                                     # short key
    return (vks, msgs, sigs), (tv, tm, ts)


def _model_d(negA_x, negA_y, Rx, Ry, s: int, k: int, nbits: int = 256):
    """ed25519_jax.verify_core on one lane in Python integers: its joint
    table (Bs affine, As by pt_double and pt_add, the mixed entries
    pt_add(Bs[i], As[j])) and its ladder, with edwards.py's formulas,
    which are the JAX module's mod p."""
    P = ed.P
    ident = (0, 1, 1, 0)
    Bs = [ident] + [ed.from_affine(*ed.to_affine(ed.scalar_mult(i, ed.BASE)))
                    for i in (1, 2, 3)]
    A = (negA_x, negA_y, 1, negA_x * negA_y % P)
    A2 = ed.pt_double(A)
    As = [ident, A, A2, ed.pt_add(A2, A)]
    table = [As[j] if i == 0 else Bs[i] if j == 0 else ed.pt_add(Bs[i], As[j])
             for j in range(4) for i in range(4)]
    Q = ident
    for i in range(nbits // 2):
        Q = ed.pt_double(ed.pt_double(Q))
        sd = (s >> (nbits - 2 - 2 * i)) & 3
        kd = (k >> (nbits - 2 - 2 * i)) & 3
        Q = ed.pt_add(Q, table[sd + 4 * kd])
    X, Y, Z, _ = Q
    return (Rx * Z - X) % P, (Ry * Z - Y) % P


def _bits_int(col) -> int:
    return int("".join(str(int(b)) for b in col), 2)


@pytest.mark.parametrize("n,seed", [(8, 0), (13, 1), (16, 2)])
def test_r3_verdicts_equal_ed25519_ref(n, seed):
    for vks, msgs, sigs in _batch(n, seed):
        arrays, valid = E.prepare_batch(vks, msgs, sigs, device="cpu")
        d1, d2 = E.verify_core(*arrays)
        assert d1.shape == (F.NLIMBS, n) and d2.device.type == "cpu"
        got = E.finalize(d1, d2, valid)
        assert got == [ed25519_ref.verify(a, m, s)
                       for a, m, s in zip(vks, msgs, sigs)]


@pytest.mark.parametrize("seed", [0, 1])
def test_r3_differences_equal_the_jax_forms_mod_p(seed):
    """(d1, d2) mod p are the JAX form's on every lane that prepares,
    tampered ones too (where they are not zero)."""
    _valid, (vks, msgs, sigs) = _batch(12, seed)
    arrays, valid = E.prepare_batch(vks, msgs, sigs, device="cpu")
    d1, d2 = E.verify_core(*arrays)
    cols = [F.unpack(a) for a in arrays[:5]]
    s_bits, k_bits = (a.numpy() for a in arrays[5:])
    got1, got2 = F.unpack(d1), F.unpack(d2)
    nonzero = 0
    for j in np.flatnonzero(valid):
        nax, nay, _nat, rx, ry = (c[j] for c in cols)
        want = _model_d(nax, nay, rx, ry, _bits_int(s_bits[:, j]),
                        _bits_int(k_bits[:, j]))
        assert (got1[j], got2[j]) == want
        nonzero += want != (0, 0)
    assert nonzero >= 2          # the flipped-byte and message lanes


def test_nbits_shortens_the_ladder():
    """verify_core's nbits (static in JAX): the ladder over the top nbits
    bit rows alone, as the JAX form indexes them."""
    (vks, msgs, sigs), _ = _batch(8, 3)
    arrays, valid = E.prepare_batch(vks, msgs, sigs, device="cpu")
    assert E.verify_kernel is E.verify_core
    d1, d2 = E.verify_core(*arrays, nbits=64)
    cols = [F.unpack(a) for a in arrays[:5]]
    s_bits, k_bits = (a.numpy() for a in arrays[5:])
    for j in np.flatnonzero(valid):
        nax, nay, _nat, rx, ry = (c[j] for c in cols)
        want = _model_d(nax, nay, rx, ry, _bits_int(s_bits[:64, j]),
                        _bits_int(k_bits[:64, j]), nbits=64)
        assert (F.unpack(d1)[j], F.unpack(d2)[j]) == want != (0, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_limbs_from_jax_round_trips_through_the_integers(seed):
    from ouroboros_tpu.crypto import field_jax as FJ
    rng = np.random.default_rng(seed)
    ints = [0, 1, 19, ed.P - 1, ed.P - 19, (1 << 255) - 20, ed.D, ed.SQRT_M1]
    ints += [int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8)
                            .tobytes(), "little") % ed.P for _ in range(24)]
    jax_limbs = FJ.pack(ints)
    assert jax_limbs.shape == (20, len(ints))
    port = E.limbs_from_jax(jax_limbs, device="cpu")
    assert port.shape == (F.NLIMBS, len(ints)) and port.dtype == torch.int64
    assert F.unpack(port) == ints
    # and back: the port's integers give the JAX package's limbs
    assert FJ.pack(F.unpack(port)).tobytes() == jax_limbs.tobytes()


@pytest.mark.parametrize("n,seed", [(8, 0), (16, 1)])
def test_prepare_bytes_batch_is_the_jax_packages(n, seed):
    from ouroboros_tpu.crypto import ed25519_jax as EJ
    for vks, msgs, sigs in _batch(n, seed):
        got, got_ok = E.prepare_bytes_batch(vks, msgs, sigs)
        want, want_ok = EJ.prepare_bytes_batch(vks, msgs, sigs)
        assert got_ok.dtype == want_ok.dtype and \
            got_ok.tobytes() == want_ok.tobytes()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        # its y limbs carry the same integers as the port's words
        yA = E.limbs_from_jax(got[0], device="cpu")
        assert F.unpack(yA) == [int.from_bytes(v, "little") & ((1 << 255) - 1)
                                if len(v) == 32 else 0 for v in vks]


def test_prepare_batch_bits_and_mask():
    """prepare_batch's bit rows are prepare_bytes_batch's on the lanes it
    keeps (MSB-first int32, (256, N)); its mask is parse and both
    decompressions."""
    _v, (vks, msgs, sigs) = _batch(12, 4)
    arrays, valid = E.prepare_batch(vks, msgs, sigs, device="cpu")
    (_yA, _sA, _yR, _sR, s_bits, k_bits), parse_ok = \
        E.prepare_bytes_batch(vks, msgs, sigs)
    for got, want in zip(arrays[5:], (s_bits, k_bits)):
        got = got.numpy()
        assert got.dtype == np.int32 and got.shape == (256, 12)
        assert np.array_equal(got[:, valid], want[:, valid])
        assert not got[:, ~valid].any()
    want_valid = [bool(parse_ok[j]) and ed.decompress(vks[j]) is not None
                  and ed.decompress(sigs[j][:32]) is not None
                  for j in range(12)]
    assert valid.tolist() == want_valid
    assert valid.dtype == bool


def test_decompress_kernel_gives_the_square_root_candidate():
    ys = [ed.to_affine(ed.scalar_mult(k, ed.BASE))[1] for k in (1, 2, 7)]
    ys += [2, 3, ed.P - 1]
    xc = F.unpack(E.decompress_kernel(F.pack(ys)))
    for y, x in zip(ys, xc):
        u, v = (y * y - 1) % ed.P, (ed.D * y * y + 1) % ed.P
        assert x == u * pow(v, 3, ed.P) * pow(u * pow(v, 7, ed.P),
                                              (ed.P - 5) // 8, ed.P) % ed.P
        pt = ed.decompress(y.to_bytes(32, "little"))
        fin = E._finish_decompress(y, 0, x)
        assert (fin is None) == (pt is None)
        if pt is not None:
            assert fin == ed.to_affine(pt)[0]


def test_entry_on_the_cpu_verifies_128_lanes():
    fn, args = graft_entry.entry(device="cpu")
    assert fn is E.verify_kernel and len(args) == 7
    assert all(torch.is_tensor(a) and a.device.type == "cpu" for a in args)
    assert args[0].shape == (F.NLIMBS, graft_entry.N)
    assert args[5].shape == (256, graft_entry.N)
    assert E.finalize(*fn(*args), [True] * graft_entry.N) \
        == [True] * graft_entry.N
    # the same batch as the JAX package's entry: sha256(b"graft-entry")
    vks, msgs, sigs = graft_entry.entry_batch()
    sk = hashlib.sha256(b"graft-entry").digest()
    assert vks[0] == ed25519_ref.public_key(sk) and msgs[5] == b"hdr-5"


@pytest.mark.slow
def test_jax_prepare_batch_through_the_ports_verify_core():
    """The JAX package's jitted forms (minutes of XLA:CPU compile)."""
    from ouroboros_tpu.crypto import ed25519_jax as EJ
    from ouroboros_tpu.crypto import field_jax as FJ
    _v, (vks, msgs, sigs) = _batch(12, 5)
    ref_arrays, ref_valid = EJ.prepare_batch(vks, msgs, sigs)
    port_arrays, port_valid = E.prepare_batch(vks, msgs, sigs, device="cpu")
    assert ref_valid.tobytes() == port_valid.tobytes()
    for r, p in zip(ref_arrays[5:], port_arrays[5:]):
        assert r.dtype == p.numpy().dtype and r.tobytes() == p.numpy().tobytes()
    for r, p in zip(ref_arrays[:5], port_arrays[:5]):
        assert FJ.unpack(r) == F.unpack(p)
    limbs = [E.limbs_from_jax(a, device="cpu") for a in ref_arrays[:5]]
    d1, d2 = E.verify_core(*limbs, *(torch.from_numpy(a)
                                     for a in ref_arrays[5:]))
    r1, r2 = EJ.verify_kernel(*ref_arrays)
    assert F.unpack(d1) == FJ.unpack(np.asarray(r1))
    assert F.unpack(d2) == FJ.unpack(np.asarray(r2))
    assert E.finalize(d1, d2, ref_valid) == EJ.finalize(r1, r2, ref_valid)
