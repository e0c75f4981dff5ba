"""Plain PyTorch versions of the four window kernels against the JAX
package, on the same 16 lanes made from a seed with numpy (the fifth,
ed25519_verify, is held to the JAX package in test_torch_full_verify.py).

- kes_hash:      blake2b.check_block64   vs blake2b_jax.check_block64_jit
- gamma8:        vrf.gamma8_words_core   vs vrf_jax.gamma8_words_kernel
- ed25519_split: ed25519.verify_full_split_words_core
                 vs ed25519_jax.verify_full_split_words_kernel (slow)
- vrf_verify:    vrf.vrf_verify_words_core
                 vs vrf_jax.vrf_verify_words_kernel (slow)
- the fold's challenge_ok_device against vrf_jax's.

The two ladder kernels' XLA forms take minutes to compile on the CPU, so
those comparisons are `slow`; the same lanes stay in tier-1 against the
JAX package's CPU oracles (ed25519_ref, vrf_ref, edwards).  Every
comparison is exact.  The CPU side of the kernel wrappers (plain version
on CPU tensors, no launch counted, argument checks) is tested here too;
the CUDA side runs in test_torch_cuda.py and chip_smoke.py.
"""
import hashlib

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
from ouroboros_tpu_torch.crypto import blake2b as B2
from ouroboros_tpu_torch.crypto import ed25519 as E
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


def test_kernel_table_names_each_tpu_kernel():
    """Seven TPU kernels, eight entries: the five of pallas_kernels.py and
    the two chain kernels of experiments/microbench_field.py (each a
    nested `kernel` of the function making it), the point chain in two
    launch shapes."""
    lines = {"ed25519_split": "_ed25519_split_kernel",
             "vrf_verify": "_vrf_verify_kernel",
             "gamma8": "_gamma8_kernel", "kes_hash": "_kes_hash_kernel",
             "ed25519_verify": "_ed25519_verify_kernel",
             "field_chain": "kernel", "point_chain": "kernel",
             "point_chain_x4": "kernel"}
    assert set(K.KERNELS) == set(lines)
    assert len({k.replaces for k in K.KERNELS.values()}) == 7
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
    which may hold several): `<<<blocks, BLOCK` with BLOCK a #define of
    csrc/, and a `*_THREADS_PER_LANE` #define used in the launcher where
    a lane has several threads (one otherwise)."""
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
