"""TorchBackend's validation window on the CPU against the JAX package.

One mixed window (the cases of test_crypto_split.py's mixed-window test,
plus an undecodable key and an undecodable beta proof) goes through
`TorchBackend(device="cpu")` with fold=True and fold=False and through the
JAX package's `CpuRefBackend`; per-request verdicts, the WindowVerdict and
the betas must be equal.  The comparison against `JaxBackend`'s XLA path
takes minutes of compiling and is `slow`.  Also: small two-in-flight
`validate` runs (one with each kind of tampered block), and per-key entries made by the JAX package's
`PrecomputeCache.assemble` loaded with `import_entries` (they equal the
port's own fill, and a window verified from them does no fill and no
Blake2b job).
"""
import hashlib

import numpy as np
import pytest
import torch

from ouroboros_tpu.crypto import backend as jb
from ouroboros_tpu.crypto import ed25519_ref as jref
from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import kes as jkes
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu_torch import validate, windowgen
from ouroboros_tpu_torch.crypto import backend as pb
from ouroboros_tpu_torch.crypto import kes as kes_port
from ouroboros_tpu_torch.crypto.precompute import PrecomputeCache
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

# the plain versions run many small ops: one thread per test worker
# avoids oversubscribing the cores the other workers share
torch.set_num_threads(1)
RNG = np.random.default_rng(2026)
UNDECODABLE = next(y.to_bytes(32, "little") for y in range(2, 100)
                   if jed.decompress(y.to_bytes(32, "little")) is None)


def _seed(tag: bytes) -> bytes:
    return hashlib.sha256(tag + bytes(RNG.integers(0, 256, 8,
                                                   dtype=np.uint8))).digest()


def _to_jax(r):
    """The same request as the JAX package's type."""
    cls = {pb.Ed25519Req: jb.Ed25519Req, pb.VrfReq: jb.VrfReq,
           pb.KesReq: jb.KesReq}[type(r)]
    return cls(**r.__dict__)


@pytest.fixture(scope="module")
def window():
    sk, vsk = _seed(b"mix-ed"), _seed(b"mix-vrf")
    vk, vvk = jref.public_key(sk), jvrf.public_key(vsk)
    ksk = jkes.KesSignKey(2, _seed(b"mix-kes"))
    kvk = ksk.verification_key
    reqs = []
    for i in range(3):
        m = b"e%d" % i
        reqs.append(pb.Ed25519Req(vk, m, jref.sign(sk, m)))
    reqs.append(pb.Ed25519Req(vk, b"bad", jref.sign(sk, b"good")))
    for i in range(2):
        a = b"v%d" % i
        reqs.append(pb.VrfReq(vvk, a, jvrf.prove(vsk, a)))
    reqs.append(pb.VrfReq(vvk, b"bad-alpha", jvrf.prove(vsk, b"va")))
    good = ksk.sign(b"kmsg")
    reqs.append(pb.KesReq(2, kvk, 0, b"kmsg", good.to_bytes()))
    tam = jkes.KesSig(good.leaf_sig,
                      ((good.merkle[0][0], bytes(32)),) + good.merkle[1:])
    reqs.append(pb.KesReq(2, kvk, 0, b"kmsg", tam.to_bytes()))    # bad node
    reqs.append(pb.KesReq(2, kvk, 1, b"kmsg", good.to_bytes()))   # period
    reqs.append(pb.KesReq(2, kvk, 0, b"kmsg", b"\x00" * 7))       # broken
    reqs.append(pb.Ed25519Req(UNDECODABLE, b"m", jref.sign(sk, b"m")))
    proofs = [jvrf.prove(vsk, b"b%d" % i) for i in range(3)]
    proofs.append(UNDECODABLE + proofs[0][32:])                  # bad beta
    want = jb.CpuRefBackend().verify_mixed([_to_jax(r) for r in reqs])
    want_betas = {}
    for p in proofs:
        try:
            want_betas[p] = jvrf.proof_to_hash(p)
        except ValueError:
            want_betas[p] = None
    return reqs, proofs, want, want_betas


def test_mixed_window_matches_cpu_ref_fold_false(window):
    reqs, proofs, want, want_betas = window
    be = TorchBackend(device="cpu")
    ok, betas = be.finish_window(be.submit_window(reqs, proofs))
    assert ok == want
    assert betas == want_betas
    assert want[:3] == [True] * 3 and want[3] is False
    assert want[7:] == [True, False, False, False, False]
    assert be.verify_mixed(reqs) == want          # cache-warm second pass


def test_mixed_window_matches_cpu_ref_fold_true(window):
    reqs, proofs, want, want_betas = window
    be = TorchBackend(device="cpu")
    verdict, betas = be.finish_window(be.submit_window(reqs, proofs,
                                                       fold=True))
    assert isinstance(verdict, pb.WindowVerdict)
    assert verdict.n == len(reqs)
    assert verdict.first_bad == want.index(False)
    assert betas == want_betas
    # the first bad request moves when the earlier ones are dropped
    rest = reqs[4:]
    v2, _ = be.finish_window(be.submit_window(rest, fold=True))
    assert v2.first_bad == want[4:].index(False)
    v3, _ = be.finish_window(be.submit_window(reqs[:3], fold=True))
    assert v3.all_ok


def test_batch_entry_points_and_window_stats(window):
    """The per-kind batch calls, chunked betas, prewarm_window and
    padding_stats(since=) of TorchBackend on the same window."""
    reqs, proofs, want, want_betas = window
    be = TorchBackend(device="cpu")
    assert be.n_shards == 1 and be.supports_window_fold
    ed = [(i, r) for i, r in enumerate(reqs) if isinstance(r, pb.Ed25519Req)]
    vrf = [(i, r) for i, r in enumerate(reqs) if isinstance(r, pb.VrfReq)]
    kes = [(i, r) for i, r in enumerate(reqs) if isinstance(r, pb.KesReq)]
    assert be.verify_ed25519_batch([r for _, r in ed]) == [want[i]
                                                          for i, _ in ed]
    assert be.verify_vrf_batch([r for _, r in vrf]) == [want[i]
                                                       for i, _ in vrf]
    assert be.verify_kes_batch([r for _, r in kes]) == [want[i]
                                                       for i, _ in kes]
    be.BETA_CHUNK = 3
    assert be.vrf_betas_batch(proofs) == [want_betas[p] for p in proofs]
    before = be.padding_stats()
    seconds, verdict = be.prewarm_window(reqs, proofs, fold=True)
    assert seconds > 0 and verdict.first_bad == want.index(False)
    delta = be.padding_stats(since=before)
    assert delta["windows"] == 1 and delta["shards"] == 1
    # verify_kes_batch left every KES path warm: no Blake2b jobs, and only
    # the two paths that hash correctly (the valid one and the wrong
    # period, whose leaf key then fails) add a leaf lane to the five
    # direct Ed25519 lanes; 3 VRF lanes and 4 beta lanes
    assert delta["lanes_used"] == (5 + 2) + 3 + 4
    assert delta["lanes_padded"] == 3 * 128


def test_validate_main_profiles_on_the_cpu(capsys):
    assert validate.main(["--windows", "1", "--window", "2", "--pools",
                          "2", "--workers", "1", "--device", "cpu",
                          "--profile"]) == 0
    out = capsys.readouterr().out
    assert "device busy 0.0000 s" in out
    assert '"first_bad_blocks": [null]' in out


@pytest.mark.slow
def test_mixed_window_matches_jax_backend(window):
    """slow: tracing JaxBackend's XLA window programs takes minutes."""
    from ouroboros_tpu.crypto.jax_backend import JaxBackend
    reqs, proofs, want, want_betas = window
    jreqs = [_to_jax(r) for r in reqs]
    jbk = JaxBackend(use_pallas=False, autotune=False, min_bucket=16)
    jok, jbetas = jbk.finish_window(jbk.submit_window(jreqs, proofs))
    be = TorchBackend(device="cpu")
    ok, betas = be.finish_window(be.submit_window(reqs, proofs))
    assert ok == jok == want
    assert betas == jbetas == want_betas
    jv, _ = jbk.finish_window(jbk.submit_window(jreqs, proofs, fold=True))
    v, _ = be.finish_window(be.submit_window(reqs, proofs, fold=True))
    assert v.first_bad == jv.first_bad == want.index(False)


def test_validate_two_in_flight_small_run():
    windows = windowgen.make_windows(seed=5, n_windows=3, window=8, pools=8)
    windows[2][5] = windowgen.tamper_witness(windows[2][5])
    res = validate.drive(windows, TorchBackend(device="cpu"))
    assert [r["all_ok"] for r in res["windows"]] == [True, True, False]
    assert res["windows"][2]["first_bad_block"] == 5
    assert res["windows"][2]["first_bad_request"] == \
        5 * windowgen.REQS_PER_BLOCK + windowgen.FIRST_WITNESS
    assert res["blocks_per_s"] > 0 and res["proofs_per_s"] > 0
    cpu = jb.CpuRefBackend()
    for w, blocks in enumerate(windows):
        for b, block in enumerate(blocks):
            assert len(block) == windowgen.REQS_PER_BLOCK
            ok = cpu.verify_mixed([_to_jax(r) for r in block])
            assert all(ok) == (not (w == 2 and b == 5)), (w, b)
    later = [r.proof for w in (1, 2) for blk in windows[w] for r in blk
             if isinstance(r, pb.VrfReq)]
    assert len(later) == 2 * 8 * 2
    for p in later:
        assert res["betas"][p] == jvrf.proof_to_hash(p)


def test_validate_reports_each_tamper_kind():
    """A wrong VRF input (seen only by the fold's challenge check), a bad
    KES Merkle node in a KES-warm window (a cold path among warm ones) and
    a flipped witness each give their block as the window's first bad."""
    windows = windowgen.make_windows(seed=6, n_windows=4, window=8, pools=8)
    G = windowgen
    tampers = {1: (3, G.tamper_vrf_alpha, G.LEADER_VRF),
               2: (6, G.tamper_kes_node, G.KES_SIG),
               3: (2, G.tamper_witness, G.FIRST_WITNESS)}
    for w, (b, edit, _pos) in tampers.items():
        windows[w][b] = edit(windows[w][b])
    res = validate.drive(windows, TorchBackend(device="cpu"))
    assert [r["first_bad_block"] for r in res["windows"]] == [None, 3, 6, 2]
    cpu = jb.CpuRefBackend()
    for w, (b, _edit, pos) in tampers.items():
        assert res["windows"][w]["first_bad_request"] == \
            b * G.REQS_PER_BLOCK + pos
        ok = cpu.verify_mixed([_to_jax(r) for r in windows[w][b]])
        assert [i for i, o in enumerate(ok) if not o] == [pos]


def _kes_root_key_cases():
    """Depth 2, period 0: a valid request, one whose root key is cut to 31
    bytes and one (another key's) grown to 33."""
    keys = [jkes.KesSignKey(2, hashlib.sha256(s).digest())
            for s in (b"k", b"k2")]
    sigs = [k.sign(b"km").to_bytes() for k in keys]
    vk, vk2 = (k.verification_key for k in keys)
    valid = pb.KesReq(2, vk, 0, b"km", sigs[0])
    short = pb.KesReq(2, vk[:31], 0, b"km", sigs[0])
    long = pb.KesReq(2, vk2 + b"\x01", 0, b"km", sigs[1])
    return valid, short, long


@pytest.mark.parametrize("steps", [
    [("short", [False])],
    [("short valid long", [False, True, False]), ("valid", [True])],
], ids=["short-key-alone", "mixed-window-then-warm-valid"])
def test_kes_root_key_not_32_bytes_is_invalid_and_cached_nowhere(steps):
    """A KesReq whose root key is not 32 bytes is structurally invalid:
    False, as both CpuRefBackends say, with no Blake2b job scheduled and
    no cache entry read or written, so a valid request of the same
    signature in the same window passes and stays warm-valid after."""
    valid, short, long = _kes_root_key_cases()
    named = {"valid": valid, "short": short, "long": long}
    be = TorchBackend(device="cpu")         # one backend for every step
    for names, want in steps:
        reqs = [named[n] for n in names.split()]
        assert pb.CpuRefBackend().verify_mixed(reqs) == want
        assert jb.CpuRefBackend().verify_mixed(
            [_to_jax(r) for r in reqs]) == want
        assert be.verify_mixed(reqs) == want, names
    assert kes_port.hash_path_key(2, short.vk, 0, short.sig_bytes) is None
    assert kes_port.hash_path_key(2, long.vk, 0, long.sig_bytes) is None


def test_import_entries_from_the_jax_cache_match_the_port_fill():
    """Entries from the JAX package's a128 fill (PrecomputeCache.assemble)
    and KES outcomes, loaded with import_entries, equal the port's own
    a128_core fill; a window verified from them fills nothing."""
    from ouroboros_tpu.crypto.precompute import _BAD
    from ouroboros_tpu.crypto.precompute import PrecomputeCache as JCache
    seeds = [_seed(b"imp%d" % i) for i in range(6)]
    ksk = jkes.KesSignKey(2, _seed(b"imp-kes"))
    ksig = ksk.sign(b"hdr")
    kreq = pb.KesReq(2, ksk.verification_key, 0, b"hdr", ksig.to_bytes())
    leaf_vk = jkes.verify_walk(2, kreq.vk, 0, ksig)[0]
    # the all-zero key pads every batch to its bucket, so it is an entry
    # of every warm cache too
    vks = [jref.public_key(s) for s in seeds] + [UNDECODABLE, b"\x01" * 31,
                                                 leaf_vk, b"\x00" * 32]
    jc = JCache()
    jxa, jxs, jys, jknown = jc.assemble(vks)
    jb.CryptoBackend().split_mixed_cached([_to_jax(kreq)], cache=jc)
    points = {vk: None if ent is _BAD else ent for vk, ent in jc._c.items()}
    kes = dict(jc._kes)
    assert len(points) == 10 and len(kes) == 1

    own = PrecomputeCache("cpu")
    oxa, oxs, oys, oknown = own.assemble(vks)
    imported = PrecomputeCache("cpu")
    imported.import_entries(points, kes)
    ixa, ixs, iys, iknown = imported.assemble(vks)
    for a, b, c in ((oxa, ixa, jxa), (oxs, ixs, jxs), (oys, iys, jys)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert list(oknown) == list(iknown) == list(jknown)
    assert list(iknown) == [True] * 6 + [False, False, True, True]
    assert imported.device_fills == 0 and own.device_fills == 1

    be = TorchBackend(device="cpu")
    be.cache.import_entries(points, kes)
    leaf_reqs = [pb.Ed25519Req(vks[i], b"m%d" % i, jref.sign(seeds[i],
                                                             b"m%d" % i))
                 for i in range(6)]
    assert kes[next(iter(kes))] == (leaf_vk, True)
    state = be.submit_window(leaf_reqs + [kreq], fold=True)
    verdict, _ = be.finish_window(state)
    assert verdict.all_ok
    assert state["nk"] == 0 and be.cache.device_fills == 0
