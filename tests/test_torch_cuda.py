"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA card (decided inside the
fixture).  Run them on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's lane counts.
"""
import hashlib

import numpy as np
import pytest
import torch

from ouroboros_tpu_torch import csrc_compare as CC
from ouroboros_tpu_torch.crypto import ed25519_ref, kes, vrf_ref
from ouroboros_tpu_torch.crypto import fold as FD
from ouroboros_tpu_torch.crypto import kernels as K
from ouroboros_tpu_torch.crypto.backend import (CpuRefBackend, Ed25519Req,
                                                KesReq, VrfReq)
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

pytestmark = pytest.mark.cuda
N = 96


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K.library()
    return torch.device("cuda")


# the chain kernels' operations (microbench_field's path)
CHAIN_OPS = CC.CHAIN_OPS


def _limbs(rng, dev, n):
    """Two (10, n) int32 carried limb arrays of random radix-2^13 digits."""
    return CC.random_limbs(rng, dev, n)


def _random_args(name, rng, dev, n=N):
    """Random words for each of the kernel's inputs, n lanes."""
    return CC.random_args(name, rng, dev, n)


def _launch_and_compare(dev, name, args):
    before = K.LAUNCHES[name]
    got = getattr(K, name)(*args)
    want = K.KERNELS[name].plain(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_equals_plain_version_on_random_lanes(dev, name):
    """Random words exercise every formula on off-curve garbage too: the
    kernel must reproduce the plain version byte for byte."""
    rng = np.random.default_rng(sorted(K.KERNELS).index(name))
    _launch_and_compare(dev, name, _random_args(name, rng, dev))


@pytest.mark.parametrize("n", [1, 7, 97, 4099])
@pytest.mark.parametrize("name", ["ed25519_split", "ed25519_verify",
                                  "gamma8", "kes_hash", "vrf_verify"])
def test_multi_thread_kernel_on_ragged_lane_counts(dev, name, n):
    """Several threads a lane: lane counts that no block size divides
    leave part of the last block past the end, where threads run on
    clamped inputs and store nothing."""
    rng = np.random.default_rng(n)
    _launch_and_compare(dev, name, _random_args(name, rng, dev, n))


@pytest.mark.parametrize("n", [1, 7, 97, 4099])
@pytest.mark.parametrize("name", sorted(CHAIN_OPS))
def test_chain_kernels_on_every_operation(dev, name, n):
    """Every operation of each chain kernel on random limbs, at lane
    counts that no block divides; kernel and plain version limb for
    limb."""
    rng = np.random.default_rng(n)
    a, b = _limbs(rng, dev, n)
    for op in CHAIN_OPS[name]:
        _launch_and_compare(dev, name, [a, b, op, 9])


@pytest.mark.parametrize("name", ["field_chain", "field_chain_lp"])
def test_field_chains_on_garbage_limbs(dev, name):
    """Uncarried limbs anywhere in the range the products accept (sums of
    four carried elements, |limb| <= 2^27 + 2^10), the extremes included,
    at 4099 lanes: kernel and plain version limb for limb, every
    operation."""
    rng = np.random.default_rng(27)
    bound = (1 << 27) + (1 << 10)
    a, b = (rng.integers(-bound, bound + 1, (10, 4099)) for _ in range(2))
    a[:, :64] = rng.choice((-bound, bound), (10, 64))
    b[:, 32:96] = rng.choice((-bound, bound), (10, 64))
    a, b = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (a, b))
    for op in CHAIN_OPS[name]:
        for k in (1, 9):
            _launch_and_compare(dev, name, [a, b, op, k])


# (ne, nv, nb, nk): the main path's windows (light and loaded), ragged
# counts, and each part of the buffer empty
FOLD_SHAPES = [(4096, 2048, 2048, 4096), (131072, 2048, 2048, 8192),
               (1, 1, 1, 1), (97, 7, 3, 5), (4099, 2049, 13, 0),
               (0, 2048, 2048, 0), (131072, 0, 0, 8192), (0, 0, 0, 0)]


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("case", CC.FOLD_CASES)
def test_window_fold_equals_plain_fold(dev, case, shape):
    """The fold kernel against its plain version (torch ops on the same
    card), byte for byte, on each of `fold_case`'s cases, twice in a row
    on one stream (the slot is reset between launches), one launch a
    call; its index is the failure the case planted."""
    rng = np.random.default_rng(CC.FOLD_CASES.index(case) + sum(shape))
    arrays, want = CC.fold_case(rng, *shape, case)
    packed, *rest = (torch.from_numpy(a).to(dev) for a in arrays)
    before = K.LAUNCHES["window_fold"]
    got = [K.window_fold(packed, *shape, *rest) for _ in range(2)]
    plain = FD.fold_window(packed, *shape, *rest)
    torch.cuda.synchronize()
    assert K.LAUNCHES["window_fold"] == before + 2
    for g in got:
        assert g.device.type == "cuda"
        assert g.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes()
    assert int.from_bytes(got[0][:4].cpu().numpy().tobytes(),
                          "little") == want


def test_fold_is_one_launch_and_one_copy(dev):
    """TorchBackend's fold of a light window on the card: under the
    profiler, one staging copy to the card and one kernel, the fold's,
    and no other device work; on the host no torch op but allocation,
    pinning, the copy and views."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    shape = (4096, 2048, 2048, 4096)
    arrays, want = CC.fold_case(np.random.default_rng(5), *shape, "c_flip")
    be = TorchBackend(device=dev)
    packed = torch.from_numpy(arrays[0]).to(dev)
    torch.cuda.synchronize()
    with be._on_stream():
        be._fold(packed, *shape, *arrays[1:])          # the stream's slot
        torch.cuda.synchronize()
        for _trace in range(5):     # CUPTI may hand records over late
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = be._fold(packed, *shape, *arrays[1:])
                torch.cuda.synchronize()
            on_card = [e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            if any("window_fold_kernel" in n for n in on_card):
                break
    copies = [n for n in on_card if "Memcpy" in n or "Memset" in n]
    assert len(on_card) == 2 and len(copies) == 1 and "HtoD" in copies[0]
    assert any("window_fold_kernel" in n for n in on_card)
    host_ops = {e.name for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name.startswith("aten::")}
    assert host_ops <= {"aten::empty", "aten::empty_strided", "aten::to",
                        "aten::_to_copy", "aten::copy_", "aten::pin_memory",
                        "aten::_pin_memory", "aten::is_pinned",
                        "aten::set_", "aten::split",
                        "aten::split_with_sizes", "aten::narrow",
                        "aten::slice", "aten::view",
                        "aten::as_strided", "aten::alias", "aten::detach",
                        "aten::lift_fresh"}, host_ops
    assert int.from_bytes(out[:4].cpu().numpy().tobytes(), "little") == want


def test_window_on_the_card_matches_cpu_ref(dev):
    sk = hashlib.sha256(b"card-ed").digest()
    vsk = hashlib.sha256(b"card-vrf").digest()
    ksk = kes.KesSignKey(3, hashlib.sha256(b"card-kes").digest())
    vk, vvk = ed25519_ref.public_key(sk), vrf_ref.public_key(vsk)
    reqs = [Ed25519Req(vk, b"m%d" % i, ed25519_ref.sign(sk, b"m%d" % i))
            for i in range(5)]
    reqs.append(Ed25519Req(vk, b"x", ed25519_ref.sign(sk, b"y")))
    reqs += [VrfReq(vvk, b"a%d" % i, vrf_ref.prove(vsk, b"a%d" % i))
             for i in range(3)]
    reqs.append(VrfReq(vvk, b"zz", vrf_ref.prove(vsk, b"a0")))
    sig = ksk.sign(b"hdr")
    reqs += [KesReq(3, ksk.verification_key, 0, b"hdr", sig.to_bytes()),
             KesReq(3, ksk.verification_key, 1, b"hdr", sig.to_bytes())]
    want = CpuRefBackend().verify_mixed(reqs)
    be = TorchBackend(device=dev)
    assert be.verify_mixed(reqs) == want
    proofs = [r.proof for r in reqs if isinstance(r, VrfReq)]
    verdict, betas = be.finish_window(be.submit_window(reqs, proofs,
                                                       fold=True))
    assert verdict.first_bad == want.index(False)
    assert all(betas[p] == vrf_ref.proof_to_hash(p) for p in proofs)


def test_replay_of_the_fixture_chain_on_the_card(dev):
    """tests/test_replay_pipeline.py's 24-block chain (seed b"rp", KES
    depth 4), forged with the port, replayed at window 8 through
    TorchBackend on the card: every block valid with the forger's state
    hash, the four window kernels launched and the fold once a folded
    window, a KES signature flipped at block 13 stopping there, as on the
    port's CpuRefBackend."""
    from fractions import Fraction

    from ouroboros_tpu_torch.consensus.batch import replay_blocks_pipelined
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       make_header)
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.eras.shelley import (
        KES_FIELD, TPraosConfig, forge_tpraos_fields, shelley_genesis_setup)
    cfg = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=20,
                       slots_per_kes_period=5, kes_depth=4,
                       max_kes_evolutions=14)
    protocol, ledger, pools = shelley_genesis_setup(2, cfg, seed=b"rp")
    ext = ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
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
            h = forge_tpraos_fields(protocol, p["hot_key"],
                                    p["can_be_leader"], lead,
                                    make_header(prev, slot, (), issuer=0))
            blocks.append(ProtocolBlock(h, ()))
            state = ext.tick_then_reapply(state, blocks[-1])
            prev = h
            break
        slot += 1
    def counted(backend):
        """`backend` with its folds counted: each is a window that had a
        packed buffer, and launches window_fold once."""
        fold = backend._fold

        def count(*a):
            folds[0] += 1
            return fold(*a)
        backend._fold = count
        return backend
    GLOBAL_BETA_CACHE.clear()
    K.reset_launches()
    folds = [0]
    res = replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                  backend=counted(TorchBackend(device=dev)),
                                  window=8)
    assert res.all_valid and res.n_valid == 24
    assert (res.final_state.ledger.state_hash()
            == state.ledger.state_hash())
    assert all(K.LAUNCHES[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                            "gamma8", "kes_hash"))
    assert K.LAUNCHES["window_fold"] == folds[0] >= 3
    bad = list(blocks)
    sig = bytearray(bad[13].header.get(KES_FIELD))
    sig[8] ^= 1
    bad[13] = ProtocolBlock(
        bad[13].header.with_fields(**{KES_FIELD: bytes(sig)}), ())
    for backend in (counted(TorchBackend(device=dev)), CpuRefBackend()):
        GLOBAL_BETA_CACHE.clear()
        K.reset_launches()
        folds = [0]
        res = replay_blocks_pipelined(ext, bad, ext.initial_state(),
                                      backend=backend, window=8)
        assert (res.all_valid, res.n_valid) == (False, 13)
        assert K.LAUNCHES["window_fold"] == folds[0]


def test_disk_replay_of_a_cardano_db_on_the_card(dev, tmp_path, capsys):
    """A 60-block Byron->Shelley DB written by the port's db_synth and
    replayed from disk by its db_analyser on the card ends at the state
    `--validate reapply` reaches, through the four window kernels."""
    import json

    from ouroboros_tpu_torch import db_analyser, db_synth
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE

    d = str(tmp_path / "db")
    assert db_synth.main(["--out", d, "--protocol", "cardano", "--eras",
                          "byron-shelley", "--blocks", "60",
                          "--epoch-length", "10", "--chunk-size", "10",
                          "--txs-per-block", "1"]) == 0
    capsys.readouterr()
    assert db_analyser.main([d, "--validate", "reapply"]) == 0
    want = json.loads(capsys.readouterr().out)
    GLOBAL_BETA_CACHE.clear()
    K.reset_launches()
    assert db_analyser.main([d, "--backend", "torch", "--window", "16"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["backend"] == "torch" and got["blocks"] == 60
    assert got["state_hash"] == want["state_hash"]
    assert got["stream"]["era_crossings"] == 1
    assert all(K.LAUNCHES[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                            "gamma8", "kes_hash"))


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_window_on_one_card_matches_single_device(dev, d):
    """ShardedTorchBackend over d shards of cuda:0 (a stream each): a
    mixed window with next-window betas gives the CPU reference's
    verdicts and betas, each kernel (kes_hash too) launches once a shard,
    and the unfolded packed buffer is byte for byte the one a single
    launch a kernel gives at the same padding, on a second backend as
    cold; the folded verdict and the sharded
    full verify agree with the CPU reference."""
    import functools

    from ouroboros_tpu_torch.parallel import (ShardedTorchBackend, make_mesh,
                                              sharded_batch_verify)
    sk = hashlib.sha256(b"shard-card-ed").digest()
    vsk = hashlib.sha256(b"shard-card-vrf").digest()
    ksk = kes.KesSignKey(3, hashlib.sha256(b"shard-card-kes").digest())
    vk, vvk = ed25519_ref.public_key(sk), vrf_ref.public_key(vsk)
    reqs = []
    for i in range(37):                 # no shard count divides the lanes
        m = b"m%d" % i
        reqs += [Ed25519Req(vk, m, ed25519_ref.sign(sk, m)),
                 VrfReq(vvk, m, vrf_ref.prove(vsk, m)),
                 KesReq(3, ksk.verification_key, 0, m,
                        ksk.sign(m).to_bytes())]
    reqs[30] = Ed25519Req(vk, b"x", reqs[30].sig)
    proofs = [vrf_ref.prove(vsk, b"n%d" % i) for i in range(5)]
    want = CpuRefBackend().verify_mixed(reqs)
    mesh = make_mesh(devices=["cuda:0"] * d)
    sb = ShardedTorchBackend(mesh, min_bucket=16)
    before = dict(K.LAUNCHES)
    st = sb.submit_window(reqs, proofs)
    ok, betas = sb.finish_window(st)
    assert {k: v - before[k] for k, v in K.LAUNCHES.items()
            if v != before[k]} == {"ed25519_split": d, "vrf_verify": d,
                                   "gamma8": d, "kes_hash": d}
    assert st["nk"] > 0
    assert ok == want
    assert betas == {p: vrf_ref.proof_to_hash(p) for p in proofs}
    sharded = st["host"].numpy().tobytes()
    # one launch a kernel, on a backend whose KES cache is as cold
    one = ShardedTorchBackend(mesh, min_bucket=16)
    one._launch_lanes = functools.partial(TorchBackend._launch_lanes, one)
    st1 = one.submit_window(reqs, proofs)
    one.finish_window(st1)
    assert st1["host"].numpy().tobytes() == sharded
    sb = ShardedTorchBackend(mesh, min_bucket=16)
    verdict, _ = sb.finish_window(sb.submit_window(reqs, proofs, fold=True))
    assert verdict.first_bad == want.index(False) == 30
    vks, msgs, sigs = ([getattr(r, f) for r in reqs
                        if isinstance(r, Ed25519Req)]
                       for f in ("vk", "msg", "sig"))
    assert sharded_batch_verify(vks, msgs, sigs, sb.mesh) == \
        K.batch_verify_ed25519(vks, msgs, sigs)


def test_chaindb_restart_on_the_card(dev):
    """chip_smoke.py's chain-database restart at a small size: a 30-block
    Shelley chain (KES depth 3), 4 blocks in the ImmutableDB and 26 in the
    VolatileDB, opened by the port's ChainDB on TorchBackend: the initial
    chain selection validates the 26-block candidate in one call to the
    forger's state hash through the four window kernels, and a witness
    flipped at block 17 stops the tip at block 16, with every later block
    invalid, as on the port's CppBackend."""
    import dataclasses

    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.storage import MockFS
    ext, blocks, state = chainsynth.forge_shelley(30, epoch_length=10,
                                                  kes_depth=3)
    fs = MockFS()
    chainsynth.write_chaindb(fs, blocks, 4)
    GLOBAL_BETA_CACHE.clear()
    K.reset_launches()
    db = chainsynth.open_chaindb(fs, ext, TorchBackend(device=dev))
    assert db.tip_point().hash == blocks[-1].hash and not db.invalid
    assert (db.current_ledger.ledger.state_hash()
            == state.ledger.state_hash())
    assert all(K.LAUNCHES[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                            "gamma8", "kes_hash"))
    tx = blocks[17].body[0]
    (vk, sig), = tx.witnesses
    bad = list(blocks)
    bad[17] = ProtocolBlock(blocks[17].header, (dataclasses.replace(
        tx, witnesses=((vk, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]),)),)
        + blocks[17].body[1:])
    got = []
    for backend in (TorchBackend(device=dev), CppBackend()):
        fs = MockFS()
        chainsynth.write_chaindb(fs, bad, 4)
        GLOBAL_BETA_CACHE.clear()
        db = chainsynth.open_chaindb(fs, ext, backend)
        got.append((db.tip_point(), sorted(db.invalid)))
    assert got[0] == got[1]
    assert got[0][0].hash == blocks[16].hash
    assert got[0][1] == sorted(b.hash for b in bad[17:])


def test_two_node_sync_on_the_card(dev):
    """chip_smoke.py's node phase at a small size: a 40-block Shelley
    chain (KES depth 3) served by a NodeKernel over a ChainDB (4 blocks
    immutable, 36 volatile) to a fresh follower on TorchBackend, wired by
    connect_nodes in the port's simulator: the follower reaches the
    server's tip and the forger's state hash, its header flushes and
    ChainDB adds through the four window kernels."""
    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.node import (BlockchainTime, NodeKernel,
                                          connect_nodes)
    from ouroboros_tpu_torch.storage import MockFS
    ext, blocks, state = chainsynth.forge_shelley(40, epoch_length=10,
                                                  kes_depth=3)
    fs = MockFS()
    chainsynth.write_chaindb(fs, blocks, 4)
    server_db = chainsynth.open_chaindb(fs, ext, CppBackend())
    GLOBAL_BETA_CACHE.clear()
    backend = TorchBackend(device=dev)
    follower_db = chainsynth.open_chaindb(MockFS(), ext, backend)

    def kernel(db, label, be):
        return NodeKernel(
            db, ext.ledger, None, BlockchainTime(1.0), label=label,
            backend=be, header_decode=ProtocolHeader.decode,
            block_decode_obj=lambda o: ProtocolBlock.decode(
                o, tx_decode=ShelleyTx.decode),
            tx_decode=ShelleyTx.decode)

    async def main():
        await sim.sleep(blocks[-1].slot + 1)
        server = kernel(server_db, "server", None)
        follower = kernel(follower_db, "follower", backend)
        server.start()
        follower.start()
        connect_nodes(follower, server, delay=0.05)
        while follower_db.tip_point() != server_db.tip_point():
            assert sim.now() < 600, follower_db.tip_point()
            await sim.sleep(0.05)
        server.stop()
        follower.stop()

    K.reset_launches()
    sim.run(main(), seed=0)
    assert follower_db.tip_point().hash == blocks[-1].hash
    assert not follower_db.invalid
    assert (follower_db.current_ledger.ledger.state_hash()
            == state.ledger.state_hash())
    assert all(K.LAUNCHES[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                            "gamma8", "kes_hash"))


def test_two_peer_sync_over_tcp_on_the_card(dev):
    """chip_smoke.py's diffusion phase at a small size: a 40-block Shelley
    chain (KES depth 3) held by two servers, each behind
    `run_data_diffusion` on a loopback TCP port, and a fresh follower on
    TorchBackend that subscribes to both (initiator-only) under the
    real-clock IO runtime, its slots 0.05 s so that its clock passes the
    chain's last slot before it starts: the follower reaches the tip and
    the forger's state hash, its header flushes and ChainDB adds through
    the four window kernels."""
    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.network.snocket import TcpSnocket
    from ouroboros_tpu_torch.node import BlockchainTime, NodeKernel
    from ouroboros_tpu_torch.node.diffusion import (
        INITIATOR_ONLY, DiffusionArguments, run_data_diffusion)
    from ouroboros_tpu_torch.storage import MockFS
    slot_s = 0.05
    ext, blocks, state = chainsynth.forge_shelley(40, epoch_length=10,
                                                  kes_depth=3)
    server_dbs = []
    for _ in range(2):
        fs = MockFS()
        chainsynth.write_chaindb(fs, blocks, len(blocks))
        server_dbs.append(chainsynth.open_chaindb(fs, ext, CppBackend()))
    GLOBAL_BETA_CACHE.clear()
    backend = TorchBackend(device=dev)
    follower_db = chainsynth.open_chaindb(MockFS(), ext, backend)

    def kernel(db, label, be):
        return NodeKernel(
            db, ext.ledger, None, BlockchainTime(slot_s), label=label,
            backend=be, header_decode=ProtocolHeader.decode,
            block_decode_obj=lambda o: ProtocolBlock.decode(
                o, tx_decode=ShelleyTx.decode),
            tx_decode=ShelleyTx.decode)

    async def main():
        snk = TcpSnocket()
        servers, addrs, ds = [], [], []
        for i, db in enumerate(server_dbs):
            k = kernel(db, f"server{i}", None)
            k.start()
            d = await run_data_diffusion(
                k, DiffusionArguments(addresses=[("127.0.0.1", 0)]), snk)
            servers.append(k)
            ds.append(d)
            addrs.append(d.listeners[0].addr)
        await sim.sleep((blocks[-1].slot + 2) * slot_s - sim.now())
        follower = kernel(follower_db, "follower", backend)
        follower.start()
        ds.append(await run_data_diffusion(
            follower, DiffusionArguments(ip_producers=addrs, ip_valency=2,
                                         mode=INITIATOR_ONLY), snk))
        t0 = sim.now()
        while follower_db.tip_point() != server_dbs[0].tip_point():
            assert sim.now() - t0 < 120, follower_db.tip_point()
            await sim.sleep(0.01)
        for k in servers + [follower]:
            k.stop()
        for d in ds:
            d.stop()

    K.reset_launches()
    sim.io_run(main())
    assert follower_db.tip_point().hash == blocks[-1].hash
    assert not follower_db.invalid
    assert (follower_db.current_ledger.ledger.state_hash()
            == state.ledger.state_hash())
    assert all(K.LAUNCHES[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                            "gamma8", "kes_hash"))


def test_graft_entry_r3_form_on_the_card(dev):
    """The compile-probe entry on the card: its example arguments on the
    card, 128 x True; a tampered copy's r3 verdicts ed25519_ref's and the
    ed25519_verify kernel's, which launches; the differences mod p those
    of the same batch on the CPU."""
    from ouroboros_tpu_torch import graft_entry
    from ouroboros_tpu_torch.crypto import ed25519 as E
    from ouroboros_tpu_torch.crypto import edwards as ed
    from ouroboros_tpu_torch.crypto import field as F
    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    assert E.finalize(*fn(*args), [True] * graft_entry.N) \
        == [True] * graft_entry.N
    vks, msgs, sigs = (x[:16] for x in graft_entry.entry_batch())
    msgs[1] = msgs[1] + b"!"
    sigs[2] = sigs[2][:32] + ed.L.to_bytes(32, "little")
    vks[3] = (ed.P - 1).to_bytes(32, "little")
    sigs[4] = sigs[4][:63]
    arrays, valid = E.prepare_batch(vks, msgs, sigs, device=dev)
    d = E.verify_core(*arrays)
    want = [ed25519_ref.verify(a, m, s) for a, m, s in zip(vks, msgs, sigs)]
    before = K.LAUNCHES["ed25519_verify"]
    assert E.finalize(*d, valid) == want
    assert E.batch_verify(vks, msgs, sigs, device=dev) == want
    assert K.LAUNCHES["ed25519_verify"] == before + 1
    cpu_arrays, _v = E.prepare_batch(vks, msgs, sigs, device="cpu")
    for got, ref in zip(d, E.verify_core(*cpu_arrays)):
        assert got.device.type == "cuda"
        assert F.unpack(got) == F.unpack(ref)


def test_txsubmission2_relay_between_card_mempools(dev):
    """chip_smoke.py's mempool leg at a small size: a Mempool over
    TorchBackend admits 32 wallet transactions and rejects 4 with a
    flipped witness (ed25519_split launched), CppBackend's verdicts;
    TxSubmission2 (Hello first) over a Mux bearer pair relays it into a
    second card Mempool, the txids in the same order."""
    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.chain import point_of
    from ouroboros_tpu_torch.consensus.mempool import Mempool
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    from ouroboros_tpu_torch.eras.shelley import ShelleyTx
    from ouroboros_tpu_torch.network import node_to_node as n2n
    from ouroboros_tpu_torch.network.mux import (INITIATOR, RESPONDER,
                                                 CodecChannel, Mux,
                                                 bearer_pair)
    from ouroboros_tpu_torch.network.protocols import txsubmission2 as tx2
    from ouroboros_tpu_torch.network.typed import CLIENT, SERVER, Session
    from ouroboros_tpu_torch.utils import cbor
    ext, blocks, state = chainsynth.forge_shelley(40, epoch_length=10,
                                                  kes_depth=3)
    _e, pools = chainsynth.shelley_setup(40, epoch_length=10, kes_depth=3)
    txs = chainsynth.wallet_txs(pools, state.ledger, 32, 4)
    tip = point_of(blocks[-1])

    def mempool(backend):
        return Mempool(ext.ledger, lambda: (state.ledger, tip),
                       backend=backend)

    def verdicts(mp, batch):
        _added, rejected = mp.try_add_txs(batch)
        why = {id(tx): str(e) for tx, e in rejected}
        return [why.get(id(tx)) for tx in batch]

    K.reset_launches()
    mp1, mp2 = mempool(TorchBackend(device=dev)), mempool(
        TorchBackend(device=dev))
    assert verdicts(mp1, txs) == verdicts(mempool(CppBackend()), txs)
    assert K.LAUNCHES["ed25519_split"] > 0

    class BytesReader:
        def __init__(self, reader):
            self.reader = reader

        def next_ids(self, n):
            return self.reader.next_ids(n)

        def lookup(self, txid):
            tx = self.reader.lookup(txid)
            return None if tx is None else cbor.dumps(tx.encode())

    got = []

    def sink(raw):
        got.append(verdicts(mp2, [ShelleyTx.decode(cbor.loads(raw))])[0])

    async def main():
        ba, bb = bearer_pair()
        ma, mb = Mux(ba, "a"), Mux(bb, "b")
        ma.start()
        mb.start()
        out = sim.spawn(tx2.outbound_from_mempool(
            Session(tx2.SPEC, CLIENT, CodecChannel(
                ma.channel(n2n.TXSUBMISSION_NUM, INITIATOR), tx2.CODEC)),
            BytesReader(mp1.reader())), label="out")
        await tx2.inbound_collect(Session(tx2.SPEC, SERVER, CodecChannel(
            mb.channel(n2n.TXSUBMISSION_NUM, RESPONDER), tx2.CODEC)),
            sink, window=5)
        await out.wait()
        ma.stop()
        mb.stop()

    sim.run(main())
    assert got == [None] * 32
    assert [e.txid for e in mp2.get_snapshot().entries] == \
        [e.txid for e in mp1.get_snapshot().entries]


def test_golden_header_through_torch_backend_on_the_card(dev):
    """chip_smoke.py's conformance phase, leg 1, first part: the golden
    Shelley header made by the real Cardano crypto stack (libsodium
    ECVRF, Sum6 KES, Ed25519) validates through TorchBackend on the
    card, each of the four window kernels launched."""
    import chip_smoke
    from ouroboros_tpu_torch.eras import shelley_cbor as SC
    alphas = [hashlib.blake2b(bytes([i]), digest_size=32).digest()
              for i in (0, 1)]
    hdr = SC.parse_header(bytes.fromhex(chip_smoke.GOLDEN_HEADER_HEX))
    K.reset_launches()
    assert SC.validate_header(hdr, *alphas, TorchBackend(device=dev))
    assert all(K.LAUNCHES[k] > 0 for k in chip_smoke.MAIN_PATH)
    bad = SC.RealShelleyHeader(hdr.body, hdr.kes_sig[:-1] + bytes(
        [hdr.kes_sig[-1] ^ 1]), hdr.body_bytes)
    assert not SC.validate_header(bad, *alphas, TorchBackend(device=dev))


def test_golden_lanes_tiled_and_tampered_on_the_card(dev, monkeypatch):
    """chip_smoke.py's conformance phase, leg 1, at 97 lanes a kernel: the
    golden header's OCert, VRF certificates, KES path jobs and the two
    libsodium proofs tiled, every 7th lane tampered, each kernel exactly
    its plain version, every lane the CPU references' verdict, every
    untampered beta the libsodium output (golden_leg raises otherwise)."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "GOLDEN_LANES",
                        {k: 97 for k in chip_smoke.GOLDEN_LANES})
    out = chip_smoke.golden_leg(dev)
    assert set(out["lanes"]) == set(chip_smoke.GOLDEN_LANES)
    assert all(err == 0 for err in out["max_abs_err"].values())
    assert out["launches"]["ed25519_verify"] == 1
    assert out["launches"]["gamma8"] >= 2


def test_cardano_network_crosses_the_fork_on_the_card(dev):
    """chip_smoke.py's conformance phase, leg 2, the fork crossing only:
    the reference's 3-node Byron PBFT -> Shelley TPraos network on a
    fresh TorchBackend, every node's block hashes, era tags and encoded
    final state those of the same network on CppBackend, the reference's
    checks met, the four window kernels launched."""
    import chip_smoke
    from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
    digests = {}
    for which, backend in (("card", TorchBackend(device=dev)),
                           ("cpp", CppBackend())):
        m = chip_smoke.cardano_port(backend)
        K.reset_launches()
        res = chip_smoke.cardano_network(m)
        assert chip_smoke.cardano_checks(res, False) == []
        digests[which] = chip_smoke.cardano_digest(m, res)
        if which == "card":
            assert all(K.LAUNCHES[k] > 0 for k in chip_smoke.MAIN_PATH)
    assert digests["card"] == digests["cpp"]


def test_bench_smoke_on_the_card(dev):
    """`bench.smoke(device="cuda")`: every gate of the smoke on the card
    (the sharded probe on two shards of the card), the four window
    kernels launched in it and `ed25519_verify` not."""
    from ouroboros_tpu_torch import bench
    res = bench.smoke(device="cuda")
    assert res["value"] == 1.0 and res["device"] == "cuda"
    assert res["state_hash_parity"] and res["verdict_parity"]
    assert res["fold_verdict_parity"] and res["perfgate_ok"]
    assert res["warm_device_fills"] == 0 and res["warm_kes_jobs"] == 0
    assert res["replay_fill_dispatches"] <= 3
    assert res["sharded_replay_smoke"]["ok"] is True
    assert res["sharded_replay_smoke"]["skipped"] is None
    assert res["stream_probe"]["ok"] and res["serve_probe"]["ok"]
    launched = res["kernel_launches"]
    assert all(launched[k] > 0 for k in ("ed25519_split", "vrf_verify",
                                         "gamma8", "kes_hash")), launched
    assert launched["ed25519_verify"] == 0
