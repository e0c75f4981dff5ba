"""The port's chain database (`ouroboros_tpu_torch.storage.chaindb`, with
its VolatileDB, chain fragments and BFT protocol) against the JAX
package's, on the CPU.

- (a) Seeded random sequences of operations run through both packages'
  `ChainDB`s, each over its package's `CpuRefBackend`: adds from three
  BFT forks (each block with a witnessed transaction) in shuffled order,
  duplicates, a block older than the immutable tip, a header signed by
  the wrong key, `copy_to_immutable`, a reopen, and followers.  Every
  `AddBlockResult`, tip, invalid set, follower instruction and ledger
  encoding is equal after every operation, and so are the files.
- (b) The slice as a whole: a short Shelley chain forged by
  `chainsynth.forge_shelley` restarted from disk through the port's
  `ChainDB.open` on `TorchBackend(device="cpu")` (the plain versions of
  ed25519_split, vrf_verify, gamma8 and kes_hash), valid and with one
  tampered block, against the JAX package's `ChainDB` over its
  `CpuRefBackend`: equal tip, invalid set and `state_hash`.
- (c) Carrying state across: a DB written by the JAX package opens in the
  port to the same chain, and the port writes the same bytes.
- A candidate longer than the interpreter's recursion limit: the JAX
  package's ChainDB raises RecursionError, the port's opens it to the
  same tip as the reference reaches with the limit raised.

No JAX program is compiled: both packages verify on the host.

Tolerance: none.  Results, points, hashes, reasons and bytes compare
exactly.
"""
import dataclasses
import random
import sys
from types import SimpleNamespace

import pytest

import ouroboros_tpu.chain.block as j_block
import ouroboros_tpu.consensus.header_validation as j_hv
import ouroboros_tpu.consensus.headers as j_headers
import ouroboros_tpu.consensus.ledger as j_ledger
import ouroboros_tpu.consensus.protocols as j_protocols
import ouroboros_tpu.crypto.backend as j_backend
import ouroboros_tpu.eras.shelley as j_shelley
import ouroboros_tpu.ledgers as j_ledgers
import ouroboros_tpu.ledgers.mock as j_mock
import ouroboros_tpu.storage as j_storage
import ouroboros_tpu.storage.chaindb as j_chaindb
import ouroboros_tpu.storage.stream as j_stream
import ouroboros_tpu.utils.cbor as j_cbor
from ouroboros_tpu_torch import chainsynth
from ouroboros_tpu_torch.chain import block as p_block
from ouroboros_tpu_torch.consensus import header_validation as p_hv
from ouroboros_tpu_torch.consensus import headers as p_headers
from ouroboros_tpu_torch.consensus import ledger as p_ledger
from ouroboros_tpu_torch.consensus import protocols as p_protocols
from ouroboros_tpu_torch.crypto import backend as p_backend
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.eras.shelley import KES_FIELD
from ouroboros_tpu_torch import ledgers as p_ledgers
from ouroboros_tpu_torch.ledgers import mock as p_mock
from ouroboros_tpu_torch import storage as p_storage
from ouroboros_tpu_torch.storage import chaindb as p_chaindb
from ouroboros_tpu_torch.utils import cbor as p_cbor

JAX = SimpleNamespace(block=j_block, hv=j_hv, headers=j_headers,
                      ledger=j_ledger, protocols=j_protocols,
                      backend=j_backend, ledgers=j_ledgers, mock=j_mock,
                      storage=j_storage, chaindb=j_chaindb, cbor=j_cbor)
PORT = SimpleNamespace(block=p_block, hv=p_hv, headers=p_headers,
                       ledger=p_ledger, protocols=p_protocols,
                       backend=p_backend, ledgers=p_ledgers, mock=p_mock,
                       storage=p_storage, chaindb=p_chaindb, cbor=p_cbor)

N_NODES, K = 3, 5
SKS = [bytes([7, i]) * 16 for i in range(N_NODES)]
VKS = [ed25519_ref.public_key(sk) for sk in SKS]
OWNER_SK = bytes([9]) * 32
OWNER = ed25519_ref.public_key(OWNER_SK)
COIN = 1000


# -- both packages' BFT ChainDB (tests/test_chaindb.py's Env) -----------------

def _enc_ext(ext):
    return [list(ext.ledger.utxo), ext.ledger.slot, ext.ledger.tip.encode(),
            [ext.header.tip.slot, ext.header.tip.block_no,
             ext.header.tip.hash] if ext.header.tip else None]


def _dec_ext(pkg):
    def dec(obj):
        utxo = tuple(tuple([bytes(e[0]), int(e[1]), bytes(e[2]), int(e[3])])
                     for e in obj[0])
        led = pkg.mock.MockLedgerState(utxo, int(obj[1]),
                                       pkg.block.Point.decode(obj[2]))
        tip = None if obj[3] is None else pkg.hv.AnnTip(
            int(obj[3][0]), int(obj[3][1]), bytes(obj[3][2]))
        return pkg.ledger.ExtLedgerState(led, pkg.hv.HeaderState(tip, ()))
    return dec


class Side:
    """One package's ChainDB over its own MockFS and (by default) its
    CpuRefBackend."""

    def __init__(self, pkg, k=K, backend="CpuRefBackend"):
        self.pkg = pkg
        self.ext = pkg.ledger.ExtLedgerRules(
            pkg.protocols.Bft(VKS, k=k), pkg.ledgers.MockLedger({OWNER: COIN}))
        self.fs = pkg.storage.MockFS()
        self.backend = getattr(pkg.backend, backend)()
        self.db = self.open()

    def decode(self, raw):
        return self.pkg.headers.ProtocolBlock.decode(
            self.pkg.cbor.loads(raw), tx_decode=self.pkg.ledgers.Tx.decode)

    def open(self):
        return self.pkg.chaindb.ChainDB.open(
            self.fs, self.ext, _enc_ext, _dec_ext(self.pkg), self.decode,
            chunk_size=10, max_blocks_per_file=5, backend=self.backend,
            disk_policy=self.pkg.storage.DiskPolicy(
                num_snapshots=2, snapshot_interval_slots=1))


def _pt(p):
    return (p.slot, p.hash)


def _instr(ins):
    if ins is None:
        return None
    kind, x = ins
    return (kind, _pt(x) if kind == "rollback" else x.hash)


def _observe(side, followers):
    db = side.db
    log = []
    for f in followers:
        for _ in range(64):
            ins = f.instruction()
            log.append(_instr(ins))
            if ins is None:
                break
    return (_pt(db.tip_point()), _pt(db.immutable_tip_point()),
            dict(db.invalid), [_pt(p) for p in db.current_chain.points()],
            side.pkg.cbor.dumps(_enc_ext(db.current_ledger)), log)


# -- the blocks, made with the JAX package and decoded by each side -----------

def _bft_block(prev, slot, prev_txid, signer=None):
    """A BFT block at `slot` on `prev` (None: genesis) carrying one
    witnessed transaction that moves the coin on from `prev_txid`."""
    m = j_ledgers
    tx = m.make_tx([m.TxIn(prev_txid, 0)], [m.TxOut(OWNER, COIN)],
                   [OWNER_SK])
    leader = slot % N_NODES
    h = j_headers.make_header(prev.header if prev else None, slot, (tx,),
                              issuer=leader)
    h = j_protocols.bft_sign_header(SKS[leader if signer is None
                                        else signer], h)
    return j_headers.ProtocolBlock(h, (tx,)), tx.txid


def _branch(root, root_txid, n, first_slot, bad_at=None):
    out, prev, txid = [], root, root_txid
    for i in range(n):
        signer = (first_slot + i + 1) % N_NODES if i == bad_at else None
        prev, txid = _bft_block(prev, first_slot + i, txid, signer)
        out.append((prev, txid))
    return out


def _scenario(seed):
    """The seeded sequence: ("add", block) | ("copy",) | ("reopen",)."""
    rng = random.Random(seed)
    genesis_txid = j_ledgers.MockLedger.GENESIS_TXID
    trunk = _branch(None, genesis_txid, 16, 0)
    a_at, b_at = rng.randrange(2, 8), rng.randrange(8, 13)
    fork_a = _branch(*trunk[a_at], 14, trunk[a_at][0].slot + 2)
    fork_b = _branch(*trunk[b_at], 8, trunk[b_at][0].slot + 3,
                     bad_at=rng.randrange(1, 6))
    blocks = [b for b, _ in trunk + fork_a + fork_b]
    # parents mostly before children: shuffle within a sliding window
    order = sorted(range(len(blocks)),
                   key=lambda i: blocks[i].slot + rng.uniform(0, 6))
    ops = [("add", blocks[i]) for i in order]
    for _ in range(6):                        # duplicates
        j = rng.randrange(4, len(ops))
        ops.insert(j, ("add", ops[rng.randrange(j)][1]))
    n = len(ops)
    ops.insert(n // 3, ("copy",))
    ops.insert(n // 3 + 1, ("add", _bft_block(None, 0, b"\x01" * 32)[0]))
    ops.insert(n // 2, ("reopen",))
    ops.insert(2 * n // 3, ("copy",))
    ops.append(("copy",))
    return ops


def _run(ops, side):
    followers = [side.db.new_follower()]
    trace = []
    for op in ops:
        if op[0] == "add":
            blk = side.decode(op[1].bytes)
            assert blk.hash == op[1].hash
            r = side.db.add_block(blk)
            trace.append(("add", r.kind, _pt(r.new_tip)))
        elif op[0] == "copy":
            trace.append(("copy", side.db.copy_to_immutable()))
        else:
            side.db = side.open()
            followers = [side.db.new_follower()]
            trace.append(("reopen",))
        trace.append(_observe(side, followers))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sequence_equals_the_jax_packages(seed):
    ops = _scenario(seed)
    jax_side, port_side = Side(JAX), Side(PORT)
    want = _run(ops, jax_side)
    got = _run(ops, port_side)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, ops[i // 2][0])
    assert len(got) == len(want)
    assert port_side.fs.files == jax_side.fs.files
    # which of two equally long forks is kept depends on the order the
    # successor sets iterate in (the hash seed), the same in both packages
    kinds = {t[1] for t in want if t[0] == "add"}
    assert {"extended", "stored", "duplicate", "too_old"} <= kinds


def test_a_fork_switch_and_an_invalid_block_equal_the_jax_packages():
    """A sequence with no ties: a trunk of 6, a fork from its 4th block
    that wins at its 3rd block (switched), then a branch from that fork
    whose 2nd header is signed by the wrong key (invalid once its
    candidate is longer), then a copy, a reopen and a duplicate."""
    gen = j_ledgers.MockLedger.GENESIS_TXID
    trunk = _branch(None, gen, 6, 0)
    fork = _branch(*trunk[3], 5, 10)
    bad = _branch(*fork[2], 4, 20, bad_at=1)
    ops = [("add", b) for b, _ in trunk + fork + bad]
    ops += [("copy",), ("reopen",), ("add", fork[4][0])]
    want = _run(ops, Side(JAX))
    got = _run(ops, Side(PORT))
    assert got == want
    adds = [t for t in want if t[0] == "add"]
    assert [t[1] for t in adds[6:11]] == ["stored", "stored", "switched",
                                          "extended", "extended"]
    assert {t[1] for t in adds[11:15]} == {"stored"}
    assert adds[-1][1] == "duplicate"
    assert want[-1][0] == (fork[4][0].slot, fork[4][0].hash)
    assert set(want[-1][2]) == {b.hash for b, _ in bad[1:]}


def test_db_written_by_the_jax_chaindb_opens_in_the_port():
    """(c) A JAX-package ChainDB's files (ImmutableDB chunks, VolatileDB
    files, CBOR ledger snapshots) open in the port's ChainDB to the same
    chain, ledger and invalid set as the JAX package's reopen."""
    ops = _scenario(7)
    jax_side = Side(JAX)
    _run(ops, jax_side)
    port_side = Side(PORT)
    port_side.fs.files = {p: bytearray(d)
                          for p, d in jax_side.fs.files.items()}
    port_side.fs.dirs = set(jax_side.fs.dirs)
    jax_side.db = jax_side.open()
    port_side.db = port_side.open()
    assert len(port_side.db.current_chain) > 0
    assert _observe(port_side, []) == _observe(jax_side, [])


# -- a candidate deeper than the recursion limit ------------------------------

def test_a_candidate_deeper_than_the_recursion_limit():
    """A VolatileDB holding a chain longer than the interpreter's
    recursion limit: the JAX package's ChainDB raises RecursionError in its
    recursive successor walk; the port's walk keeps its own stack and
    opens to the tip the reference reaches with the limit raised."""
    n = sys.getrecursionlimit() + 100
    blocks, prev, txid = [], None, j_ledgers.MockLedger.GENESIS_TXID
    for slot in range(n):
        prev, txid = _bft_block(prev, slot, txid)
        blocks.append(prev)
    sides = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        side = Side(pkg, k=n, backend="OpensslBackend")
        vol = pkg.storage.VolatileDB.open(side.fs, 5)
        for b in blocks:
            vol.put_block(b.hash, b.prev_hash, b.slot, b.block_no, b.bytes)
        sides[name] = side
    with pytest.raises(RecursionError):
        sides["jax"].open()
    port_db = sides["port"].open()
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(4 * n)
    try:
        jax_db = sides["jax"].open()
    finally:
        sys.setrecursionlimit(limit)
    assert _pt(port_db.tip_point()) == _pt(jax_db.tip_point()) \
        == (blocks[-1].slot, blocks[-1].hash)
    assert (port_db.current_ledger.ledger.state_hash()
            == jax_db.current_ledger.ledger.state_hash())


# -- (b) the Shelley restart through TorchBackend(device="cpu") ---------------

SH_BLOCKS, SH_EPOCH, SH_DEPTH, SH_IMMUTABLE = 30, 10, 3, 4
TAMPER_AT = 17


@pytest.fixture(scope="module")
def shelley():
    ext, blocks, state = chainsynth.forge_shelley(
        SH_BLOCKS, epoch_length=SH_EPOCH, kes_depth=SH_DEPTH)
    cfg = ext.protocol.config
    j_cfg = j_shelley.TPraosConfig(
        k=cfg.k, f=cfg.f, epoch_length=cfg.epoch_length,
        slots_per_kes_period=cfg.slots_per_kes_period,
        kes_depth=cfg.kes_depth, max_kes_evolutions=cfg.max_kes_evolutions)
    protocol, ledger, _pools = j_shelley.shelley_genesis_setup(
        2, j_cfg, stake_per_pool=100_000, seed=b"db-synth")
    return SimpleNamespace(ext=ext, blocks=blocks, state=state,
                           j_ext=j_ledger.ExtLedgerRules(protocol, ledger))


def _tampered(blocks, how):
    """`blocks` with block TAMPER_AT's KES signature flipped, or its
    witness flipped after forging (the header, and so the block's hash,
    stay; the witness proof fails)."""
    out = list(blocks)
    b = blocks[TAMPER_AT]
    if how == "kes_sig":
        sig = bytearray(b.header.get(KES_FIELD))
        sig[8] ^= 1
        out[TAMPER_AT] = p_headers.ProtocolBlock(
            b.header.with_fields(**{KES_FIELD: bytes(sig)}), b.body)
    else:
        tx = b.body[0]
        (vk, sig), = tx.witnesses
        bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        out[TAMPER_AT] = p_headers.ProtocolBlock(
            b.header, (dataclasses.replace(tx, witnesses=((vk, bad),)),)
            + b.body[1:])
    return out


def _jax_write(blocks):
    """The on-disk state written by the JAX package's ImmutableDB and
    VolatileDB (write_chaindb's layout)."""
    fs = j_storage.MockFS()
    imm = j_storage.ImmutableDB.open(fs, 100)
    for b in blocks[:SH_IMMUTABLE]:
        imm.append_block(b.slot, b.block_no, b.hash, b.prev_hash, b.bytes)
    vol = j_storage.VolatileDB.open(fs, 50)
    for b in blocks[SH_IMMUTABLE:]:
        vol.put_block(b.hash, b.prev_hash, b.slot, b.block_no, b.bytes)
    return fs


def _shelley_summary(db):
    return (_pt(db.tip_point()), sorted(db.invalid),
            db.current_ledger.ledger.state_hash())


@pytest.mark.parametrize("how", ["valid", "witness", "kes_sig"])
def test_shelley_restart_on_torch_cpu_equals_the_jax_package(shelley, how):
    blocks = shelley.blocks if how == "valid" else _tampered(shelley.blocks,
                                                             how)
    j_fs = _jax_write(blocks)
    p_fs = p_storage.MockFS()
    chainsynth.write_chaindb(p_fs, blocks, SH_IMMUTABLE)
    assert p_fs.files == j_fs.files           # the port writes its bytes

    j_backend.GLOBAL_BETA_CACHE.clear()
    j_db = j_chaindb.ChainDB.open(
        j_fs, shelley.j_ext, j_stream.pickle_encode, j_stream.pickle_decode,
        lambda raw: j_headers.ProtocolBlock.from_bytes(
            raw, tx_decode=j_shelley.ShelleyTx.decode, tx_body_elems=6),
        backend=j_backend.CpuRefBackend())
    # the JAX package's files, opened by the port
    fs = p_storage.MockFS()
    fs.files = {p: bytearray(d) for p, d in j_fs.files.items()}
    fs.dirs = set(j_fs.dirs)
    GLOBAL_BETA_CACHE.clear()
    backend = TorchBackend(device="cpu")
    p_db = chainsynth.open_chaindb(fs, shelley.ext, backend)
    assert _shelley_summary(p_db) == _shelley_summary(j_db)
    assert backend.padding_stats()["windows"] >= 1    # the card's path
    if how == "valid":
        assert _pt(p_db.tip_point()) == (blocks[-1].slot, blocks[-1].hash)
        assert p_db.current_ledger.ledger.state_hash() \
            == shelley.state.ledger.state_hash()
        assert not p_db.invalid
    else:
        assert _pt(p_db.tip_point()) == (blocks[TAMPER_AT - 1].slot,
                                         blocks[TAMPER_AT - 1].hash)
        # the witness flip keeps the block's hash, so every later block
        # is on the failed candidate; the KES flip changes it, so the
        # later blocks are orphans that no candidate reaches
        bad = blocks[TAMPER_AT:] if how == "witness" else [blocks[TAMPER_AT]]
        assert set(p_db.invalid) == {b.hash for b in bad}
