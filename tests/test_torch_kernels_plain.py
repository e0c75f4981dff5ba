"""Plain PyTorch versions of the four window kernels against the JAX
package, on the same 16 lanes made from a seed with numpy (the fifth,
ed25519_verify, is held to the JAX package in test_torch_full_verify.py).

- kes_hash:      blake2b.check_block64   vs blake2b_jax.check_block64_jit
- gamma8:        vrf.gamma8_words_core   vs vrf_jax.gamma8_words_kernel
- ed25519_split: ed25519.verify_full_split_words_core
                 vs ed25519_jax.verify_full_split_words_kernel (slow)
- vrf_verify:    vrf.vrf_verify_words_core
                 vs vrf_jax.vrf_verify_words_kernel (slow)
- the fold's challenge_ok_device against vrf_jax's, and the whole fold
  (window_fold's plain version, fold.fold_window) against
  jax_backend's _fold_program.

The two ladder kernels' XLA forms take minutes to compile on the CPU, so
those comparisons are `slow`; the same lanes stay in tier-1 against the
JAX package's CPU oracles (ed25519_ref, vrf_ref, edwards).  Every
comparison is exact.  The CPU side of the kernel wrappers (plain version
on CPU tensors, no launch counted, argument checks) is tested here too;
the CUDA side runs in test_torch_cuda.py and chip_smoke.py.
"""
import ctypes
import hashlib
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ouroboros_tpu.crypto import blake2b_jax as JB2
from ouroboros_tpu.crypto import ed25519_jax as JE
from ouroboros_tpu.crypto import ed25519_ref as jref
from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import vrf_jax as JV
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu.crypto.jax_backend import JaxBackend
from ouroboros_tpu_torch import csrc_compare as CC
from ouroboros_tpu_torch.crypto import blake2b as B2
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import fold as FD
from ouroboros_tpu_torch.crypto import kernels as K
from ouroboros_tpu_torch.crypto import vrf as V
from ouroboros_tpu_torch.crypto.precompute import PrecomputeCache

N = 16
# the plain versions run many small ops: one thread per test worker
# avoids oversubscribing the cores the other workers share
torch.set_num_threads(1)
RNG = np.random.default_rng(16)
UNDECODABLE = next(y.to_bytes(32, "little") for y in range(2, 100)
                   if jed.decompress(y.to_bytes(32, "little")) is None)
L_BYTES = jed.L.to_bytes(32, "little")


def _seed():
    return bytes(RNG.integers(0, 256, 32, dtype=np.uint8))


def _t(a):
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.fixture(scope="module")
def ed_lanes():
    """16 Ed25519 lanes over 5 keys: valid, a flipped signature byte,
    s >= L, an undecodable R, a swapped message, an undecodable key."""
    seeds = [_seed() for _ in range(5)]
    keys = [seeds[j % 5] for j in range(N)]
    vks = [jref.public_key(k) for k in keys]
    msgs = [bytes(RNG.integers(0, 256, 20, dtype=np.uint8)) for _ in range(N)]
    sigs = [jref.sign(k, m) for k, m in zip(keys, msgs)]
    sigs[1] = sigs[1][:40] + bytes([sigs[1][40] ^ 8]) + sigs[1][41:]
    sigs[2] = sigs[2][:32] + L_BYTES
    sigs[3] = UNDECODABLE + sigs[3][32:]
    msgs[4] = b"another message"
    vks[5] = UNDECODABLE
    (Aw, _sA, Rw, signR, sw, kw), parse_ok = E.prepare_words_batch(
        vks, msgs, sigs)
    xa, xw, yw, known = PrecomputeCache("cpu").assemble(vks)
    args = tuple(_t(a) for a in (Aw, xa, xw, yw, Rw, signR, sw, kw))
    want = [jref.verify(v, m, s) for v, m, s in zip(vks, msgs, sigs)]
    return args, parse_ok & known, want


@pytest.fixture(scope="module")
def vrf_lanes():
    """16 VRF lanes over 4 pool keys: valid, a wrong alpha, an undecodable
    Gamma, s >= L, a flipped challenge byte."""
    seeds = [_seed() for _ in range(4)]
    sks = [seeds[j % 4] for j in range(N)]
    vks = [jvrf.public_key(s) for s in sks]
    alphas = [bytes(RNG.integers(0, 256, 12, dtype=np.uint8))
              for _ in range(N)]
    proofs = [jvrf.prove(s, a) for s, a in zip(sks, alphas)]
    alphas[1] = b"wrong alpha"
    proofs[2] = UNDECODABLE + proofs[2][32:]
    proofs[3] = proofs[3][:48] + L_BYTES
    proofs[4] = proofs[4][:33] + bytes([proofs[4][33] ^ 1]) + proofs[4][34:]
    args, parse_ok, gamma_ok, s_ok, pf_arr = V._prepare_words(
        vks, alphas, proofs)
    Yw, _sY, Gw, signG, rw, cw, sw = args
    xa, _x, _y, known = PrecomputeCache("cpu").assemble(vks)
    targs = tuple(_t(a) for a in (Yw, xa, Gw, signG, rw, cw, sw))
    return (targs, (parse_ok & known, gamma_ok, s_ok, pf_arr),
            (vks, alphas, proofs))


@pytest.fixture(scope="module")
def vrf_rows(vrf_lanes):
    targs, _masks, _raw = vrf_lanes
    return V.vrf_verify_words_core(*targs)


# -- kes_hash ------------------------------------------------------------------

def test_kes_hash_plain_matches_jax():
    msgs = RNG.integers(0, 256, (N, 64), dtype=np.uint8)
    digs = np.stack([np.frombuffer(hashlib.blake2b(
        m.tobytes(), digest_size=32).digest(), np.uint8) for m in msgs])
    digs[1::3, 5] ^= 0x40                       # every third job fails
    mw, ew = B2.msg_words(msgs), B2.digest_words(digs)
    got = B2.check_block64(_t(mw), _t(ew))
    want = np.asarray(JB2.check_block64_jit(_j(mw), _j(ew)))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    assert got.tolist() == [0 if j % 3 == 1 else 1 for j in range(N)]


@pytest.mark.parametrize("n", [1, 31, 33, 97])
def test_kes_hash_plain_edge_rows_match_jax_and_hashlib(n):
    """Edge rows at lane counts around a warp: all-zero and all-ones
    messages, digests that differ from the true one only in word 0 or
    only in word 7, and a message whose first word differs from the one
    hashed; the plain version, the JAX package's check and hashlib
    agree on every lane."""
    rng = np.random.default_rng(n)
    msgs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    msgs[0::5] = 0
    msgs[1::5] = 0xFF
    digs = np.stack([np.frombuffer(hashlib.blake2b(
        m.tobytes(), digest_size=32).digest(), np.uint8) for m in msgs])
    digs[2::5, 0] ^= 0x01                       # word 0 only
    digs[3::5, 31] ^= 0x80                      # word 7 only
    msgs[4::5, 0] ^= 0x01                       # message word 0 only
    want = [int(hashlib.blake2b(m.tobytes(), digest_size=32).digest()
                == d.tobytes()) for m, d in zip(msgs, digs)]
    mw, ew = B2.msg_words(msgs), B2.digest_words(digs)
    got = B2.check_block64(_t(mw), _t(ew))
    assert got.tolist() == want
    assert want == [int(j % 5 < 2) for j in range(n)]
    assert np.asarray(JB2.check_block64_jit(_j(mw), _j(ew))).tolist() == want


# -- gamma8 --------------------------------------------------------------------

def test_gamma8_plain_matches_jax_and_vrf_ref(vrf_lanes):
    _targs, _masks, (_vks, _alphas, proofs) = vrf_lanes
    (Gw, signG), decode_ok = V._prepare_betas_words(proofs)
    got = V.gamma8_words_core(_t(Gw), _t(signG)).numpy()
    want = np.asarray(JV.gamma8_words_kernel(_j(Gw), _j(signG)))
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    betas = V._finish_betas(got, decode_ok, N)
    for p, b in zip(proofs, betas):
        try:
            ref = jvrf.proof_to_hash(p)
        except ValueError:
            ref = None
        assert b == ref


# -- the fold's challenge check ------------------------------------------------

def test_challenge_ok_device_matches_jax(vrf_lanes, vrf_rows):
    _targs, (_pok, _gok, _sok, pf_arr), _raw = vrf_lanes
    rows = vrf_rows.clone()
    rows[7, 50] ^= 1                            # U byte: challenge breaks
    rows[8, 129] = 0                            # okG cleared
    gb = np.ascontiguousarray(pf_arr[:, :32])
    cb = np.ascontiguousarray(pf_arr[:, 32:48])
    got = V.challenge_ok_device(rows, _t(gb), _t(cb))
    want = np.asarray(jax.jit(JV.challenge_ok_device)(
        _j(rows), _j(gb), _j(cb)))
    assert got.tolist() == want.tolist()
    assert not got[7] and not got[8] and got[0]


@pytest.mark.parametrize("length", [0, 111, 112, 130])
def test_sha512_digest_words_match_hashlib(length):
    """The fold's SHA-512 at its 130-byte preimage and at the one- and
    two-block padding edges."""
    from ouroboros_tpu_torch.crypto import sha512 as S
    msgs = RNG.integers(0, 256, (3, length), dtype=np.uint8)
    lo, hi = S.digest_words(_t(msgs), length)
    for j, m in enumerate(msgs):
        got = b"".join(int(h[j]).to_bytes(4, "big") + int(l[j]).to_bytes(
            4, "big") for l, h in zip(lo, hi))
        assert got == hashlib.sha512(m.tobytes()).digest()


# -- ed25519_split ---------------------------------------------------------------

def test_ed25519_split_plain_matches_ed25519_ref(ed_lanes):
    args, mask, want = ed_lanes
    ok = E.verify_full_split_words_core(*args)
    assert ok.dtype == torch.int32
    assert [bool(o) and bool(m) for o, m in zip(ok, mask)] == want
    assert want[0] and not any(want[1:6])


@pytest.mark.slow
def test_ed25519_split_plain_matches_jax(ed_lanes):
    """slow: ~120 s to compile the XLA form on the CPU."""
    args, _mask, _want = ed_lanes
    got = E.verify_full_split_words_core(*args).numpy()
    want = np.asarray(JE.verify_full_split_words_kernel(
        *[_j(a) for a in args]))
    assert got.tolist() == want.tolist()


# -- vrf_verify ------------------------------------------------------------------

def test_vrf_verify_plain_matches_vrf_ref(vrf_lanes, vrf_rows):
    """Row bytes against the JAX package's Python-int curve math: H, U =
    [s]B - [c]Y, V = [s]H - [c]Gamma and [8]Gamma for every lane whose
    proof decodes; verdicts and betas for every lane."""
    _targs, masks, (vks, alphas, proofs) = vrf_lanes
    rows = vrf_rows.numpy()
    assert rows.shape == (N, 130) and rows.dtype == np.uint8
    for j in range(N):
        H = jvrf._hash_to_curve(vks[j], alphas[j])
        assert rows[j, 0:32].tobytes() == jed.compress(H)
        assert rows[j, 128] == 1
        dec = jvrf.decode_proof(proofs[j])
        if proofs[j][:32] == UNDECODABLE:
            assert rows[j, 129] == 0
            continue
        assert rows[j, 129] == 1
        G = jed.decompress(proofs[j][:32])
        assert rows[j, 96:128].tobytes() == jed.compress(
            jed.scalar_mult(8, G))
        if dec is None:                     # s >= L: the ladders ran on it
            continue
        _G, c, s = dec
        Y = jed.decompress(vks[j])
        U = jed.pt_add(jed.scalar_mult(s, jed.BASE),
                       jed.pt_neg(jed.scalar_mult(c, Y)))
        Vp = jed.pt_add(jed.scalar_mult(s, H),
                        jed.pt_neg(jed.scalar_mult(c, G)))
        assert rows[j, 32:64].tobytes() == jed.compress(U)
        assert rows[j, 64:96].tobytes() == jed.compress(Vp)
    oks, betas = V._finish(rows, *masks, N)
    assert oks == [jvrf.verify(v, a, p)
                   for v, a, p in zip(vks, alphas, proofs)]
    assert oks[0] and not any(oks[1:5])
    for p, b in zip(proofs, betas):
        assert b == (jvrf.proof_to_hash(p) if jvrf.decode_proof(p)
                     else None)


@pytest.mark.slow
def test_vrf_verify_plain_matches_jax(vrf_lanes, vrf_rows):
    """slow: ~140 s to compile the XLA form on the CPU."""
    targs, _masks, _raw = vrf_lanes
    want = np.asarray(JV.vrf_verify_words_kernel(*[_j(a) for a in targs]))
    assert np.array_equal(vrf_rows.numpy(), want)


# -- the verdict fold ---------------------------------------------------------

# (ne, nv, nb, nk): a window with every part, and with each part empty
FOLD_SHAPES = {"full": (64, 16, 8, 16), "ne0": (0, 16, 8, 16),
               "nv0": (64, 0, 8, 16), "nb0": (64, 16, 0, 16),
               "nk0": (64, 16, 8, 0)}


@pytest.fixture(scope="module")
def jax_fold():
    """The JAX package's jitted fold, one program a shape."""
    return JaxBackend(use_pallas=False, autotune=False)._fold_program


@pytest.mark.parametrize("case, shape",
                         [(c, "full") for c in CC.FOLD_CASES]
                         + [("ed_and_vrf", s) for s in FOLD_SHAPES
                            if s != "full"])
def test_window_fold_plain_matches_jax_fold_program(jax_fold, case, shape):
    """window_fold on CPU tensors (its plain version) against the JAX
    package's `_fold_program` on the same packed buffer and owners, byte
    for byte, and its index against the failures the case planted: none,
    one of each kind, the lower of an Ed25519 and a VRF failure, failures
    whose owners are FOLD_SENT, a random third; each part of the buffer
    empty in turn."""
    ne, nv, nb, nk = FOLD_SHAPES[shape]
    rng = np.random.default_rng(CC.FOLD_CASES.index(case) + 7 * ne + nv)
    arrays, want = CC.fold_case(rng, ne, nv, nb, nk, case)
    K.reset_launches()
    got = K.window_fold(_t(arrays[0]), ne, nv, nb, nk,
                        *(_t(a) for a in arrays[1:]))
    assert K.LAUNCHES["window_fold"] == 0
    ref = np.asarray(jax_fold(ne, nv, nb, nk)(*(_j(a) for a in arrays)))
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == ref.tobytes()
    assert int.from_bytes(got[:4].numpy().tobytes(), "little") == want
    packed = arrays[0]
    beta = packed[ne + 130 * nv:ne + 130 * nv + 33 * nb]
    assert got[4:].numpy().tobytes() == (packed[len(packed) - nk:].tobytes()
                                         if nk else b"") + beta.tobytes()
    if case in ("valid", "host_known"):
        assert want == FD.FOLD_SENT
    elif shape == "full":
        assert want < FD.FOLD_SENT


@pytest.mark.parametrize("shape", [(64, 16, 8, 16), (64, 0, 0, 0),
                                   (0, 16, 0, 0), (0, 0, 3, 4)])
def test_backend_fold_stages_the_owners_as_one_buffer(shape):
    """TorchBackend._fold lays `_fold_owners`' four host arrays into one
    staged buffer and hands the kernel views of it: on the CPU the
    result is the plain fold's on the arrays as they are, a window of
    betas and KES jobs alone (no lanes) included."""
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    arrays, want = CC.fold_case(np.random.default_rng(sum(shape)), *shape,
                                "random")
    packed = _t(arrays[0])
    got = TorchBackend(device="cpu")._fold(packed, *shape, *arrays[1:])
    assert torch.equal(got, FD.fold_window(packed, *shape,
                                           *(_t(a) for a in arrays[1:])))
    assert int.from_bytes(got[:4].numpy().tobytes(), "little") == want


# -- the wrappers' CPU side ------------------------------------------------------

def test_wrappers_run_the_plain_version_on_cpu_tensors(ed_lanes, vrf_lanes,
                                                       vrf_rows):
    K.reset_launches()
    args, _mask, _want = ed_lanes
    assert torch.equal(K.ed25519_split(*args),
                       E.verify_full_split_words_core(*args))
    vargs, _masks, _raw = vrf_lanes
    assert torch.equal(K.vrf_verify(*vargs), vrf_rows)
    assert torch.equal(K.gamma8(vargs[2], vargs[3]),
                       V.gamma8_words_core(vargs[2], vargs[3]))
    mw = _t(RNG.integers(0, 2**32, (16, 4), dtype=np.uint64)
            .astype(np.uint32))
    ew = _t(RNG.integers(0, 2**32, (8, 4), dtype=np.uint64)
            .astype(np.uint32))
    assert torch.equal(K.kes_hash(mw, ew), B2.check_block64(mw, ew))
    Aw, _xa, _xw, _yw, Rw, signR, sw, kw = args
    signA = _t(RNG.integers(0, 2, N).astype(np.int32))
    assert torch.equal(K.ed25519_verify(Aw, signA, Rw, signR, sw, kw),
                       E.verify_full_words_core(Aw, signA, Rw, signR, sw,
                                                kw))
    assert K.LAUNCHES == {name: 0 for name in K.KERNELS}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_argument_checks_raise(bad):
    t = torch.zeros((8, 4), dtype=torch.uint32)
    dev = torch.device("cpu")
    if bad == "dtype":
        with pytest.raises(TypeError):
            K._check("w", t.to(torch.int32), torch.uint32, (8, 4), dev)
    elif bad == "shape":
        with pytest.raises(ValueError):
            K._check("w", t, torch.uint32, (8, 5), dev)
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            K._check("w", torch.zeros((4, 8), dtype=torch.uint32).T,
                     torch.uint32, (8, 4), dev)
    else:
        with pytest.raises(ValueError):
            K._check("w", t, torch.uint32, (8, 4), torch.device("meta"))
    K._check("w", t, torch.uint32, (8, 4), dev)


# the C signature of ouro_kes_hash: mw, ew, out, n, stream
_KES_ENTRY = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


@pytest.fixture
def stand_in(monkeypatch):
    """The card side of the kes_hash wrapper without a card: meta tensors
    take it (their device is not the CPU), a stand-in C function of the
    entry point's signature takes the launch and returns `rc[0]`, and the
    stream and current-device queries answer for one device that, like a
    meta tensor's, has no index."""
    calls, rc = [], [0]

    def entry(mw, ew, out, n, stream):
        calls.append((n, stream))
        return rc[0]
    fn = _KES_ENTRY(entry)
    monkeypatch.setattr(K, "_fns", {"kes_hash": fn})
    monkeypatch.setattr(K, "_raw_stream", lambda index: 0xBEEF)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setitem(K.LAUNCHES, "kes_hash", 0)
    return calls, rc


def _meta(shape, dtype=torch.uint32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device",
                                 "return code"])
def test_launch_path_raises_on_bad_arguments_and_launch_errors(stand_in,
                                                               bad):
    """Each argument the kernel does not take raises before the launch;
    a nonzero cudaError_t from the entry point raises after it; neither
    counts a launch."""
    calls, rc = stand_in
    mw, ew = _meta((16, 5)), _meta((8, 5))
    if bad == "dtype":
        args, exc = (mw, _meta((8, 5), torch.int32)), TypeError
    elif bad == "shape":
        args, exc = (mw, _meta((8, 6))), ValueError
    elif bad == "contiguity":
        args, exc = (mw, _meta((5, 8)).T), ValueError
    elif bad == "device":
        args, exc = (mw, torch.zeros((8, 5), dtype=torch.uint32)), ValueError
    else:
        args, exc = (mw, ew), RuntimeError
        rc[0] = 700
    with pytest.raises(exc):
        K.kes_hash(*args)
    assert calls == ([(5, 0xBEEF)] if bad == "return code" else [])
    assert K.LAUNCHES["kes_hash"] == 0


def test_launch_path_launches_once_and_counts(stand_in):
    """A good call goes to the bound entry point once, with the lane
    count and the current stream's raw handle, counts one launch and
    returns the output it allocated; the plain version never runs."""
    calls, _rc = stand_in
    out = K.kes_hash(_meta((16, 7)), _meta((8, 7)))
    assert calls == [(7, 0xBEEF)]
    assert K.LAUNCHES["kes_hash"] == 1
    assert out.device.type == "meta" and out.dtype == torch.int32
    assert tuple(out.shape) == (7,)


# the C signature of ouro_window_fold: packed, ed_own, vrf_own, gamma, c,
# the slot, out, ne, nv, nb, nk, n, stream
_FOLD_ENTRY = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 7,
                               *[ctypes.c_int] * 5, ctypes.c_void_p)


def test_window_fold_launch_path_on_a_stand_in(monkeypatch):
    """The card side of window_fold without a card (meta tensors and a
    stand-in entry point, as `stand_in`): one call with the counts (ne,
    nv, nb, nk, then n = ne + nv) and the stream, one launch counted, the
    output of the fold's layout; one slot a stream, made at the first
    fold on it and reused after; a buffer of the wrong length refused
    before the launch."""
    calls = []

    def entry(*a):
        calls.append(a[7:])
        return 0
    fn = _FOLD_ENTRY(entry)
    stream = [0xBEEF]
    monkeypatch.setattr(K, "_fns", {"window_fold": fn})
    monkeypatch.setattr(K, "_raw_stream", lambda index: stream[0])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setitem(K.LAUNCHES, "window_fold", 0)
    monkeypatch.setattr(K, "_FOLD_SLOTS", {})
    ne, nv, nb, nk = 256, 128, 64, 32

    def args(extra=0):
        return (_meta((ne + 130 * nv + 33 * nb + nk + extra,), torch.uint8),
                ne, nv, nb, nk, _meta((ne,), torch.int32),
                _meta((nv,), torch.int32), _meta((nv, 32), torch.uint8),
                _meta((nv, 16), torch.uint8))
    out = K.window_fold(*args())
    assert out.device.type == "meta" and out.dtype == torch.uint8
    assert tuple(out.shape) == (4 + nk + 33 * nb,)
    assert calls == [(ne, nv, nb, nk, ne + nv, 0xBEEF)]
    assert K.LAUNCHES["window_fold"] == 1
    (slot,) = K._FOLD_SLOTS.values()
    assert slot.dtype == torch.int32 and tuple(slot.shape) == (2,)
    K.window_fold(*args())
    stream[0] = 0xCAFE
    K.window_fold(*args())
    assert len(calls) == 3 and calls[2][-1] == 0xCAFE
    assert list(K._FOLD_SLOTS) == [(None, 0xBEEF), (None, 0xCAFE)]
    with pytest.raises(ValueError):
        K.window_fold(*args(extra=1))
    assert len(calls) == 3 and K.LAUNCHES["window_fold"] == 3


def test_raw_stream_getter_is_part_of_this_torch():
    """The launch path reads the stream with torch's private
    `_cuda_getCurrentRawStream`, which a CPU-only build does not load:
    its stub must declare it, with the signature `_raw_stream` calls,
    and a build for CUDA must have it, so a torch without it fails here
    rather than at a wrapper's first launch."""
    stub = pathlib.Path(torch.__file__).parent / "_C" / "__init__.pyi"
    assert re.search(r"^def _cuda_getCurrentRawStream\(device: _int\) "
                     r"-> _int: \.\.\.$", stub.read_text(), re.M)
    if torch.version.cuda is not None:
        assert callable(torch._C._cuda_getCurrentRawStream)


def test_bind_maps_each_entry_point_to_its_kernels():
    """bind() types each entry point a library exports once and names
    the kernels it serves; a kernel whose symbol is missing is left out
    (library() then refuses the library)."""
    lib = types.SimpleNamespace(
        ouro_kes_hash=_KES_ENTRY(lambda *a: 0),
        ouro_field_chain=ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0))
    fns = K.bind(lib)
    assert set(fns) == {"kes_hash", "field_chain"}
    assert fns["kes_hash"] is lib.ouro_kes_hash
    assert fns["kes_hash"].restype is ctypes.c_int
    assert len(fns["field_chain"].argtypes) == 3 + 2 + 2


def test_kernel_table_names_each_tpu_kernel():
    """Seven TPU kernels and one fused XLA program, ten entries: the five
    of pallas_kernels.py, the two chain kernels of
    experiments/microbench_field.py (each a nested `kernel` of the
    function making it), the field chain and the point chain in two
    launch shapes each, and the verdict fold that jax_backend jits
    (`_fold_program`)."""
    lines = {"ed25519_split": "_ed25519_split_kernel",
             "vrf_verify": "_vrf_verify_kernel",
             "gamma8": "_gamma8_kernel", "kes_hash": "_kes_hash_kernel",
             "ed25519_verify": "_ed25519_verify_kernel",
             "field_chain": "kernel", "field_chain_lp": "kernel",
             "point_chain": "kernel", "point_chain_x4": "kernel",
             "window_fold": "_fold_program"}
    assert set(K.KERNELS) == set(lines)
    assert len({k.replaces for k in K.KERNELS.values()}) == 8
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, k in K.KERNELS.items():
        path, line = k.replaces.split(":")
        text = open(os.path.join(root, path)).read().splitlines()
        assert text[int(line) - 1].lstrip().startswith(
            f"def {lines[name]}("), name
        assert os.path.exists(os.path.join(root, k.source)), name


def test_kernel_table_launch_shapes_match_the_sources():
    """threads_per_lane and block, which chip_smoke.py reports, are those
    of each kernel's launcher (its `extern "C"` function in the source,
    which may hold several), window_fold's among them: `<<<blocks, BLOCK`
    with BLOCK a #define of csrc/, and a `*_THREADS_PER_LANE` #define used
    in the launcher where a lane has several threads (one otherwise)."""
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(root, "ouroboros_tpu_torch", "csrc")
    defines = {}
    for f in os.listdir(csrc):
        text = open(os.path.join(csrc, f)).read()
        defines.update(re.findall(r"^#define (\w+) (\d+)$", text, re.M))
    for name, k in K.KERNELS.items():
        text = open(os.path.join(root, k.source)).read()
        launchers = re.split(r'^extern "C" ', text, flags=re.M)[1:]
        body = [t for t in launchers if t.startswith(f"int {k.symbol}(")]
        assert len(body) == 1, name
        block = re.findall(r"<<<blocks, (\w+),", body[0])
        tpl = sorted(set(re.findall(r"\b(\w+_THREADS_PER_LANE)\b",
                                    body[0])))
        assert len(block) == 1 and int(defines[block[0]]) == k.block, name
        assert len(tpl) <= 1, name
        assert (int(defines[tpl[0]]) if tpl else 1) == \
            k.threads_per_lane, name
