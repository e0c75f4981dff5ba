"""The port's multi-device path (`ouroboros_tpu_torch/parallel/`) on the CPU.

tests/test_parallel.py's cases and tests/test_replay_pipeline.py's
sharded cases, on `make_mesh(devices=["cpu"] * d)` for d in 1, 2, 3, 8:
the shards run the kernels' plain PyTorch versions one after another,
with the split, the gather and the fold of the card's path.  Verdicts,
WindowVerdicts, betas and replay results are held against both
packages' `CpuRefBackend` and the port's single-device `TorchBackend`;
`_pad` and `padding_stats` against `ShardedJaxBackend`, which is only
constructed here (no JAX program is compiled).  Also the repairs of a
negative KES depth and of per-shard padding stats, and a stand-in
launch that shows each shard staged, launched and recorded under its own
device and stream.  The comparison with `ShardedJaxBackend`'s own
verdicts compiles sharded programs for minutes and is `slow`.

Tolerance: none.  Verdicts, bytes, counts and hashes compare exactly.
"""
import contextlib
import hashlib
import threading
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ouroboros_tpu.consensus.batch as j_batch
import ouroboros_tpu.consensus.headers as j_headers
import ouroboros_tpu.consensus.ledger as j_ledger
import ouroboros_tpu.eras.shelley as j_shelley
from ouroboros_tpu.crypto import backend as jb
from ouroboros_tpu.crypto import ed25519_ref as jref
from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import kes as jkes
from ouroboros_tpu.crypto import vrf_ref as jvrf
from ouroboros_tpu.crypto.jax_backend import JaxBackend
from ouroboros_tpu.parallel import ShardedJaxBackend
from ouroboros_tpu.parallel import make_mesh as jax_make_mesh
from ouroboros_tpu_torch.consensus import batch as p_batch
from ouroboros_tpu_torch.consensus import headers as p_headers
from ouroboros_tpu_torch.consensus import ledger as p_ledger
from ouroboros_tpu_torch.crypto import backend as pb
from ouroboros_tpu_torch.crypto import kernels as K
from ouroboros_tpu_torch.crypto import vrf as V
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.eras import shelley as p_shelley
from ouroboros_tpu_torch.observe import metrics as _metrics
from ouroboros_tpu_torch.parallel import (ShardedTorchBackend,
                                          build_sharded_verifier, make_mesh,
                                          sharded_batch_verify)
from ouroboros_tpu_torch.parallel import mesh as mesh_mod
from ouroboros_tpu_torch.parallel import sharded_verify as SV

# the plain versions run many small ops: one thread per test worker
torch.set_num_threads(1)
SHARDS = (1, 2, 3, 8)
# ROADMAP queue 3 item 4's request: structurally invalid, False everywhere
NEG_DEPTH = dict(depth=-1, vk=bytes(32), period=0, msg=b"m",
                 sig_bytes=bytes(64))


UNDECODABLE = next(y.to_bytes(32, "little") for y in range(2, 100)
                   if jed.decompress(y.to_bytes(32, "little")) is None)


def _mesh(d):
    return make_mesh(devices=["cpu"] * d)


def _to_jax(r):
    cls = {pb.Ed25519Req: jb.Ed25519Req, pb.VrfReq: jb.VrfReq,
           pb.KesReq: jb.KesReq}[type(r)]
    return cls(**r.__dict__)


def _refs(reqs):
    """Both packages' CpuRefBackend verdicts, which must agree."""
    want = jb.CpuRefBackend().verify_mixed([_to_jax(r) for r in reqs])
    assert pb.CpuRefBackend().verify_mixed(reqs) == want
    return want


# -- the mesh -----------------------------------------------------------------

def test_mesh_has_8_cpu_shards_and_refuses_what_it_cannot_be():
    mesh = _mesh(8)
    assert mesh.size == 8 and mesh.axis_names == (mesh_mod.WINDOW_AXIS,)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(3, devices=["cpu"] * 8).size == 3
    assert hash(mesh) == hash(_mesh(8))      # builders cache per mesh
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="mix"):
        make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(devices=["cuda:0", "cuda:0"])


def test_log_compile_time_records_span_gauge_and_secs(capsys):
    with mesh_mod.log_compile_time("probe") as ct:
        assert ct["secs"] is None
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "[parallel] probe: compiling..."
    assert err[1].startswith("[parallel] probe: done in ")
    assert ct["secs"] is not None and ct["secs"] >= 0
    assert _metrics.registry().get(
        "parallel.last_compile_secs").value == ct["secs"]


# -- sharded batch verify ----------------------------------------------------

def _signed(n, tag):
    vks, msgs, sigs = [], [], []
    for i in range(n):
        sk = hashlib.sha256(f"{tag}{i}".encode()).digest()
        msg = f"hdr{i}".encode()
        vks.append(jref.public_key(sk))
        msgs.append(msg)
        sigs.append(jref.sign(sk, msg))
    return vks, msgs, sigs


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_batch_verify_matches_reference(d):
    vks, msgs, sigs = _signed(16, "sh")
    bad = bytearray(sigs[4])
    bad[0] ^= 1
    sigs[4] = bytes(bad)
    launcher = SV.launcher(_mesh(d))
    assert launcher is SV.launcher(_mesh(d))    # one launcher a mesh
    before = launcher.counts["ed25519_verify"]
    got = sharded_batch_verify(vks, msgs, sigs, _mesh(d))
    assert got == [i != 4 for i in range(16)]
    assert got == [jref.verify(*t) for t in zip(vks, msgs, sigs)]
    assert launcher.counts["ed25519_verify"] == before + d


def test_sharded_pads_to_mesh_divisible():
    mesh = _mesh(4)
    sk = hashlib.sha256(b"p").digest()
    vk = jref.public_key(sk)
    sig = jref.sign(sk, b"z")
    assert sharded_batch_verify([vk] * 3, [b"z"] * 3, [sig] * 3, mesh) \
        == [True] * 3
    # the padded lane is the fourth: a zero key and signature, rejected;
    # the psum's counterpart counts the three
    from ouroboros_tpu_torch.crypto import ed25519 as E
    arrays, _parse = E.prepare_words_batch(
        [vk] * 3 + [bytes(32)], [b"z"] * 3 + [b""],
        [sig] * 3 + [bytes(64)])
    ok, total = build_sharded_verifier(mesh)(*arrays)
    assert ok.tolist() == [1, 1, 1, 0] and int(total) == 3
    with pytest.raises(ValueError, match="do not split"):
        build_sharded_verifier(mesh)(*(a[..., :3] for a in arrays))


def test_sharded_ed25519_thousands_of_proofs():
    """1024 signatures over 8 shards (128 lanes each), one tampered entry
    localized."""
    sk = hashlib.sha256(b"shard-scale").digest()
    vk = jref.public_key(sk)
    n = 1024
    msgs = [b"blk-%05d" % i for i in range(n)]
    sigs = [jref.sign(sk, m) for m in msgs]
    sigs[513] = sigs[513][:20] + b"\x00" + sigs[513][21:]
    got = sharded_batch_verify([vk] * n, msgs, sigs, _mesh(8))
    assert got == [i != 513 for i in range(n)]


# -- mixed windows ------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    """tests/test_parallel.py's mixed window: 11 uneven Ed25519 + VRF +
    KES triples, one tamper of each kind, and the negative-depth KES
    request; the verdicts of both CpuRefBackends and of the port's
    single-device TorchBackend."""
    sk = hashlib.sha256(b"shard-mixed").digest()
    vk = jref.public_key(sk)
    vsk = hashlib.sha256(b"shard-vrf").digest()
    vvk = jvrf.public_key(vsk)
    ksk = jkes.KesSignKey(2, hashlib.sha256(b"shard-kes").digest())
    reqs = []
    for i in range(11):                     # deliberately uneven
        m = b"m%d" % i
        reqs.append(pb.Ed25519Req(vk, m, jref.sign(sk, m)))
        reqs.append(pb.VrfReq(vvk, m, jvrf.prove(vsk, m)))
        reqs.append(pb.KesReq(2, ksk.verification_key, 0, m,
                              ksk.sign(m).to_bytes()))
    reqs[0] = pb.Ed25519Req(vk, b"m0", b"\x00" * 64)
    bad_vrf = bytearray(reqs[4].proof)
    bad_vrf[70] ^= 1
    reqs[4] = pb.VrfReq(vvk, b"m1", bytes(bad_vrf))
    reqs[8] = pb.KesReq(2, ksk.verification_key, 0, b"other",
                        reqs[8].sig_bytes)
    reqs.append(pb.KesReq(**NEG_DEPTH))
    want = _refs(reqs)
    assert sum(want) == len(reqs) - 4
    assert not (want[0] or want[4] or want[8] or want[-1])
    single = TorchBackend(device="cpu")
    verdict, _ = single.finish_window(single.submit_window(reqs, fold=True))
    assert single.verify_mixed(reqs) == want
    return reqs, want, verdict


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_backend_mixed_window_parity(mixed, d):
    reqs, want, single_verdict = mixed
    sb = ShardedTorchBackend(_mesh(d), min_bucket=16)
    assert sb.name == f"torch-mesh-{d}" and sb.n_shards == d
    assert sb.verify_mixed(reqs) == want
    verdict, _ = sb.finish_window(sb.submit_window(reqs, fold=True))
    assert verdict == single_verdict and verdict.first_bad == 0
    # the per-kind batch calls, over the shards
    for kind in (pb.Ed25519Req, pb.VrfReq):
        own = [(i, r) for i, r in enumerate(reqs) if isinstance(r, kind)]
        call = (sb.verify_ed25519_batch if kind is pb.Ed25519Req
                else sb.verify_vrf_batch)
        assert call([r for _i, r in own]) == [want[i] for i, _r in own]
    kes = [(i, r) for i, r in enumerate(reqs) if isinstance(r, pb.KesReq)]
    assert sb.verify_kes_batch([r for _i, r in kes]) == \
        [want[i] for i, _r in kes]


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_submit_window_pipelines(d):
    """One submit carries Ed25519 + VRF + KES and the next window's betas;
    finish_window unpacks with host parity; the folded verdict too.  The
    KES hash path goes to `kes_hash`, split over the shards like the
    rest.  The unfolded packed buffer is byte for byte the one that one
    launch a kernel (TorchBackend._launch_lanes) gives at the same
    padding, on a second backend whose cache is as cold."""
    sk = hashlib.sha256(b"win-ed").digest()
    vk = jref.public_key(sk)
    vsk = hashlib.sha256(b"win-vrf").digest()
    vvk = jvrf.public_key(vsk)
    ksk = jkes.KesSignKey(2, hashlib.sha256(b"win-kes").digest())
    reqs, next_proofs = [], []
    for i in range(5):
        m = b"w%d" % i
        reqs.append(pb.Ed25519Req(vk, m, jref.sign(sk, m)))
        reqs.append(pb.VrfReq(vvk, m, jvrf.prove(vsk, m)))
        reqs.append(pb.KesReq(2, ksk.verification_key, 0, m,
                              ksk.sign(m).to_bytes()))
        next_proofs.append(jvrf.prove(vsk, b"next%d" % i))
    reqs[6] = pb.Ed25519Req(vk, b"other", reqs[0].sig)     # one bad

    def backend():
        return ShardedTorchBackend(_mesh(d), min_bucket=16)

    sb = backend()
    counts = sb._shards.counts
    calls0 = dict(counts)
    st = sb.submit_window(reqs, next_beta_proofs=next_proofs)
    assert {k: v - calls0[k] for k, v in counts.items()
            if v != calls0[k]} == {"ed25519_split": d, "vrf_verify": d,
                                   "gamma8": d, "kes_hash": d}
    # one cold depth-2 path: two Blake2b jobs
    assert st["nk"] == sb._pad(2) and st["ne"] == sb._pad(10)
    sharded = st["host"].numpy().tobytes()
    ok, betas = sb.finish_window(st)
    assert ok == _refs(reqs)
    assert betas == {p: jvrf.proof_to_hash(p) for p in next_proofs}
    one = backend()
    one._launch_lanes = TorchBackend._launch_lanes.__get__(one)
    st1 = one.submit_window(reqs, next_beta_proofs=next_proofs)
    assert st1["host"].numpy().tobytes() == sharded
    assert one.finish_window(st1) == (ok, betas)
    fb = backend()
    verdict, fbetas = fb.finish_window(fb.submit_window(
        reqs, next_beta_proofs=next_proofs, fold=True))
    assert verdict == pb.WindowVerdict(len(reqs), 6) and fbetas == betas


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_betas_batch(d):
    """vrf_betas_batch over the shards, an undecodable proof among them,
    chunked past BETA_CHUNK at a width no shard count divides."""
    vsk = hashlib.sha256(b"betas").digest()
    proofs = [jvrf.prove(vsk, b"b%d" % i) for i in range(7)]
    proofs[3] = UNDECODABLE + proofs[3][32:]
    want = []
    for p in proofs:
        try:
            want.append(jvrf.proof_to_hash(p))
        except ValueError:
            want.append(None)
    sb = ShardedTorchBackend(_mesh(d), min_bucket=2)
    sb.BETA_CHUNK = 5
    assert sb.vrf_betas_batch(proofs) == want and want[3] is None


def test_sharded_vrf_and_gamma8_builders_equal_one_launch():
    """build_sharded_vrf / build_sharded_gamma8 over three shards: the
    gathered rows equal one launch over all the lanes, garbage lanes
    included."""
    vsk = hashlib.sha256(b"builders").digest()
    vvk = jvrf.public_key(vsk)
    alphas = [b"a%d" % i for i in range(6)]
    proofs = [jvrf.prove(vsk, a) for a in alphas]
    proofs[4] = UNDECODABLE + proofs[4][32:]
    args, _p, _g, _s, _pf = V._prepare_words([vvk] * 6, alphas, proofs)
    Yw, _signY, Gw, signG, rw, cw, sw = args
    from ouroboros_tpu_torch.crypto.precompute import PrecomputeCache
    xa, _x, _y, known = PrecomputeCache("cpu").assemble([vvk] * 6)
    assert known.all()
    vrf_args = (Yw, xa, Gw, signG, rw, cw, sw)
    mesh = _mesh(3)
    rows = SV.build_sharded_vrf(mesh)(*vrf_args)
    assert torch.equal(rows, K.vrf_verify(*map(torch.from_numpy,
                                               vrf_args)))
    (bGw, bsG), _ok = V._prepare_betas_words(proofs)
    rows = SV.build_sharded_gamma8(mesh)(bGw, bsG)
    assert rows.shape == (6, 33)
    assert torch.equal(rows, K.gamma8(torch.from_numpy(bGw),
                                      torch.from_numpy(bsG)))


# -- padding ------------------------------------------------------------------

@pytest.mark.parametrize("d", SHARDS)
def test_pad_and_padding_stats_equal_sharded_jax_backend(d):
    sb = ShardedTorchBackend(_mesh(d), min_bucket=16)
    jsb = ShardedJaxBackend(jax_make_mesh(d), min_bucket=16)
    assert sb.n_shards == jsb.n_shards == d
    for n in range(1, 601):
        m = sb._pad(n)
        assert m == jsb._pad(n) and m % d == 0 and m >= max(n, 16)
        sb._note_padding(n, m)
        jsb._note_padding(n, m)
        if n % 97 == 0:
            assert sb.padding_stats() == jsb.padding_stats()
    st = sb.padding_stats()
    assert st == jsb.padding_stats()
    assert st["lanes_per_shard_per_window"] == st["lanes_padded"] // (d * 600)


def test_padding_stats_per_shard_over_two_shards():
    """tests/test_replay_pipeline.py's sharded padding seam on the port:
    17 lanes of a two-shard mesh pad to 18, 9 a shard; one device keeps
    the accounting of the single-device test."""
    sb = ShardedTorchBackend(_mesh(2), min_bucket=16)
    assert sb.n_shards == 2
    assert sb._pad(5) == 16 and sb._pad(17) == 18
    sb._note_padding(17, 18)
    st = sb.padding_stats()
    assert st["shards"] == 2 and st["lanes_per_shard_per_window"] == 9
    tb = TorchBackend(device="cpu")
    tb._note_padding(24, 32)
    tb._note_padding(8, 16)
    assert tb.padding_stats() == {
        "windows": 2, "lanes_used": 32, "lanes_padded": 48,
        "waste_frac": round(1 - 32 / 48, 4), "shards": 1,
        "lanes_per_shard_per_window": 24}


# -- ROADMAP queue 3 item 4: a negative KES depth -----------------------------

def test_negative_kes_depth_is_false_on_every_port_path():
    req = pb.KesReq(**NEG_DEPTH)
    assert _refs([req]) == [False]
    tb = TorchBackend(device="cpu")
    assert tb.verify_mixed([req]) == [False]
    assert tb.verify_kes_batch([req]) == [False]
    verdict, _ = tb.finish_window(tb.submit_window([req], fold=True))
    assert verdict == pb.WindowVerdict(1, 0)
    assert tb.split_mixed_cached([req], tb.cache) == ([], [], [], [], 1)
    assert pb.CpuRefBackend().split_mixed_cached([req]) == \
        ([], [], [], [], 1)
    sb = ShardedTorchBackend(_mesh(2), min_bucket=16)
    assert sb.verify_mixed([req]) == [False]
    # the reference keeps the defect, unedited: its hash_path_key shifts by
    # the negative depth before any check, and JaxBackend's window split
    # calls it
    with pytest.raises(ValueError, match="negative shift count"):
        jkes.hash_path_key(-1, bytes(32), 0, bytes(64))
    with pytest.raises(ValueError, match="negative shift count"):
        JaxBackend(use_pallas=False, autotune=False)._split_mixed_device(
            [_to_jax(req)])


# -- the stand-in launch: each shard under its own device and stream ---------

class _Recorded(torch.Tensor):
    """A plain version's output that logs the gather's `.to` and
    `record_stream` (a CPU tensor has neither a card to go to nor a
    stream)."""
    log: list = []
    cur: dict = {}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            cls.log.append(("to", args[1], cls.cur["device"],
                            cls.cur["stream"]))
            return args[0]
        if func is torch.Tensor.record_stream:
            cls.log.append(("record_stream", args[1]))
            return None
        return super().__torch_function__(func, types, args, kwargs or {})


def test_each_shard_launches_under_its_own_device_and_stream(monkeypatch):
    """The card's branch of ShardLauncher.launch with stand-ins for the
    CUDA streams, events and contexts, the pinned staging and the gamma8
    wrapper: over a mesh of cuda:0, cuda:1, cuda:0, each shard stages its
    blocks, launches, copies to the first device and records its event
    under its own device and stream, in lane order; the caller's stream
    waits on every event and is recorded on every output before the
    concatenation, which equals one launch over all the lanes."""
    cur = {"device": torch.device("cuda:0"), "stream": "caller"}
    log: list = []

    class Stream(torch.Stream):
        """A stand-in CUDA stream: a torch.Stream (record_stream takes
        no other type) that remembers the device it was made for."""

        def __new__(cls, device):
            self = super().__new__(cls, device="cpu")
            self.dev = torch.device(device)
            return self

        def __init__(self, device):
            pass

        def wait_event(self, event):
            log.append(("wait", self, event))

    class Event:
        def record(self, stream):
            log.append(("event", cur["device"], cur["stream"], stream))

    def setter(key):
        @contextlib.contextmanager
        def cm(value):
            prev, cur[key] = cur[key], value
            try:
                yield
            finally:
                cur[key] = prev
        return cm

    caller = Stream("cuda:0")

    def stage(a, dev):
        log.append(("stage", dev, cur["device"], cur["stream"]))
        return torch.from_numpy(np.ascontiguousarray(a))

    def gamma8(Gw, signG):
        log.append(("launch", cur["device"], cur["stream"], Gw.shape[1]))
        return K.KERNELS["gamma8"].plain(Gw, signG).as_subclass(_Recorded)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "device", setter("device"))
    monkeypatch.setattr(torch.cuda, "stream", setter("stream"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: caller)
    monkeypatch.setattr(SV, "stage", stage)
    monkeypatch.setattr(K, "gamma8", gamma8)
    monkeypatch.setattr(_Recorded, "log", log)
    monkeypatch.setattr(_Recorded, "cur", cur)
    devs = tuple(torch.device(d) for d in ("cuda:0", "cuda:1", "cuda:0"))
    launcher = SV.ShardLauncher(mesh_mod.Mesh(devs))
    streams = launcher.streams
    assert [s.dev for s in streams] == list(devs)
    assert len({id(s) for s in streams}) == 3

    vsk = hashlib.sha256(b"stand-in").digest()
    proofs = [jvrf.prove(vsk, b"s%d" % i) for i in range(6)]
    (Gw, signG), _ok = V._prepare_betas_words(proofs)
    out = launcher.launch("gamma8", (Gw, signG))

    want = []
    for dev, stream in zip(devs, streams):
        want += [("stage", dev, dev, stream)] * 2
        want += [("launch", dev, stream, 2),
                 ("to", devs[0], dev, stream),
                 ("event", dev, stream, stream)]
    n = len(want)
    assert log[:n] == want
    rest = log[n:]
    assert [e[0] for e in rest] == ["wait", "record_stream"] * 3
    assert all(e[1] is caller for e in rest)
    assert cur == {"device": torch.device("cuda:0"), "stream": "caller"}
    plain = K.KERNELS["gamma8"].plain(torch.from_numpy(Gw),
                                      torch.from_numpy(signG))
    assert torch.equal(out.as_subclass(torch.Tensor), plain)
    # the card's branch counts nothing of its own: each wrapper adds to
    # kernels.LAUNCHES where it launches
    assert launcher.counts is K.LAUNCHES


# -- the sharded replay -----------------------------------------------------

def _rp_forge(pkg):
    """tests/test_replay_pipeline.py's fixture chain (seed b"rp", 24
    blocks, KES depth 4), forged with `pkg`."""
    cfg = pkg.shelley.TPraosConfig(
        k=3, f=Fraction(1, 2), epoch_length=20, slots_per_kes_period=5,
        kes_depth=4, max_kes_evolutions=14)
    protocol, ledger, pools = pkg.shelley.shelley_genesis_setup(
        2, cfg, seed=b"rp")
    ext = pkg.ledger.ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    backend = pkg.backend.OpensslBackend()
    blocks, prev, slot = [], None, 0
    while len(blocks) < 24:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            h = pkg.headers.make_header(prev, slot, (), issuer=0)
            h = pkg.shelley.forge_tpraos_fields(
                protocol, p["hot_key"], p["can_be_leader"], lead, h)
            blk = pkg.headers.ProtocolBlock(h, ())
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
        slot += 1
    return ext, blocks


def _variants(pkg, blocks):
    """The valid chain, a KES signature flipped at block 9, block 7
    dropped (test_replay_pipeline.py's three)."""
    blk = blocks[9]
    sig = bytearray(blk.header.get(pkg.shelley.KES_FIELD))
    sig[3] ^= 1
    tampered = list(blocks)
    tampered[9] = pkg.headers.ProtocolBlock(
        blk.header.with_fields(**{pkg.shelley.KES_FIELD: bytes(sig)}),
        blk.body)
    return {"valid": list(blocks), "kes_tamper": tampered,
            "truncated": list(blocks[:7]) + list(blocks[8:])}


def _summary(res):
    return (res.all_valid, res.n_valid, type(res.error).__name__,
            None if res.final_state is None
            else res.final_state.ledger.state_hash())


@pytest.fixture(scope="module")
def rp():
    """Both packages' chains, and for each variant the JAX package's
    CpuRefBackend result and the port's single-device TorchBackend's."""
    jax_pkg = SimpleNamespace(shelley=j_shelley, headers=j_headers,
                              ledger=j_ledger, backend=jb)
    port_pkg = SimpleNamespace(shelley=p_shelley, headers=p_headers,
                               ledger=p_ledger, backend=pb)
    j_ext, j_blocks = _rp_forge(jax_pkg)
    p_ext, p_blocks = _rp_forge(port_pkg)
    j_var = _variants(jax_pkg, j_blocks)
    p_var = _variants(port_pkg, p_blocks)
    want = {}
    for name in p_var:
        jb.GLOBAL_BETA_CACHE.clear()
        ref = _summary(j_batch.replay_blocks_pipelined(
            j_ext, j_var[name], j_ext.initial_state(),
            backend=jb.CpuRefBackend(), window=8))
        pb.GLOBAL_BETA_CACHE.clear()
        single = _summary(p_batch.replay_blocks_pipelined(
            p_ext, p_var[name], p_ext.initial_state(),
            backend=TorchBackend(device="cpu"), window=8))
        assert single == ref
        want[name] = ref
    assert want["valid"][:3] == (True, 24, "NoneType")
    assert want["kes_tamper"][:2] == (False, 9)
    assert want["truncated"][:2] == (False, 7)
    return p_ext, p_var, want


def _producers():
    return (_metrics.counter("pipeline.producers_started",
                             always=True).value,
            _metrics.counter("pipeline.producers_finished",
                             always=True).value,
            [t for t in threading.enumerate()
             if t.name == "ouro-replay-producer" and t.is_alive()])


@pytest.mark.parametrize("name,d", [("valid", d) for d in SHARDS]
                         + [(v, d) for v in ("kes_tamper", "truncated")
                            for d in (2, 3)])
def test_sharded_threaded_replay_equals_single_device_and_cpu_ref(rp, name,
                                                                  d):
    """The sharded backend through the threaded driver (fold=True): the
    ReplayResult and state_hash of the JAX package's CpuRefBackend and
    of the port's single-device TorchBackend; one producer started and
    joined, none left; padding accounted per shard."""
    ext, variants, want = rp
    sb = ShardedTorchBackend(_mesh(d), min_bucket=16)
    s0, f0, _alive = _producers()
    pb.GLOBAL_BETA_CACHE.clear()
    got = _summary(p_batch.replay_blocks_pipelined(
        ext, variants[name], ext.initial_state(), backend=sb, window=8))
    assert got == want[name]
    s1, f1, alive = _producers()
    assert (s1 - s0, f1 - f0) == (1, 1) and not alive
    st = sb.padding_stats()
    assert st["shards"] == d and st["windows"] >= 1
    assert 0.0 <= st["waste_frac"] < 1.0


# -- against ShardedJaxBackend itself (minutes of XLA compiles) ---------------

@pytest.mark.slow
def test_verdicts_and_replay_equal_sharded_jax_backend(mixed, rp):
    """At tests/test_parallel.py's shapes (an 8-shard mesh, min_bucket 16)
    and test_replay_pipeline.py's (2 shards, window 8): ShardedJaxBackend's
    own verdicts, betas and replay results equal the port's."""
    reqs, want, _v = mixed
    # the last request, of negative KES depth, raises in the reference
    # (pinned by test_negative_kes_depth_is_false_on_every_port_path)
    reqs, want = reqs[:-1], want[:-1]
    jsb = ShardedJaxBackend(jax_make_mesh(8), min_bucket=16)
    sb = ShardedTorchBackend(_mesh(8), min_bucket=16)
    jreqs = [_to_jax(r) for r in reqs]
    assert jsb.verify_mixed(jreqs) == sb.verify_mixed(reqs) == want
    vsk = hashlib.sha256(b"win-vrf").digest()
    proofs = [jvrf.prove(vsk, b"next%d" % i) for i in range(5)]
    assert jsb.vrf_betas_batch(proofs) == sb.vrf_betas_batch(proofs)
    vks, msgs, sigs = _signed(16, "sh")
    from ouroboros_tpu.parallel import sharded_batch_verify as j_sbv
    assert j_sbv(vks, msgs, sigs, jax_make_mesh(8)) == \
        sharded_batch_verify(vks, msgs, sigs, _mesh(8))
    ext, variants, want_rp = rp
    jax_pkg = SimpleNamespace(shelley=j_shelley, headers=j_headers,
                              ledger=j_ledger, backend=jb)
    j_ext, j_blocks = _rp_forge(jax_pkg)
    j_var = _variants(jax_pkg, j_blocks)
    jsb2 = ShardedJaxBackend(jax_make_mesh(2), min_bucket=16)
    sb2 = ShardedTorchBackend(_mesh(2), min_bucket=16)
    for name in variants:
        jb.GLOBAL_BETA_CACHE.clear()
        j = _summary(j_batch.replay_blocks_pipelined(
            j_ext, j_var[name], j_ext.initial_state(), backend=jsb2,
            window=8))
        pb.GLOBAL_BETA_CACHE.clear()
        p = _summary(p_batch.replay_blocks_pipelined(
            ext, variants[name], ext.initial_state(), backend=sb2,
            window=8))
        assert j == p == want_rp[name]
