"""The port's ChainDB (`ouroboros_tpu_torch.storage.chaindb`) over the
port's BFT protocol and mock UTxO ledger: tests/test_chaindb.py's
scenarios (chain selection triage, fork switching, invalid-block pruning,
followers, copy-to-immutable and GC, open-time replay) and
tests/test_chaindb_model.py's random add_block sequences (forks, orphans,
out-of-order arrival, invalid blocks, reopen from disk) checked against a
pure chain-selection model, run against the port's copies over the port's
OpensslBackend.

Reference: Test/Ouroboros/Storage/ChainDB/StateMachine.hs and its pure
model ChainDB/Model.hs.  The model's key invariant, checked after every
operation, is local optimality: among all chains constructible from
stored valid blocks that fork at most k blocks from the DB's current tip,
none is strictly preferred over the adopted chain; with it the structural
invariants (linkage, monotone slots, no invalid block on the chain) and
reopen equivalence (crash recovery reaches a tip no lower).
"""
import hashlib
import random

import pytest

from ouroboros_tpu_torch.chain.block import GENESIS_HASH, Point, point_of
from ouroboros_tpu_torch.consensus import ExtLedgerRules
from ouroboros_tpu_torch.consensus.headers import (
    ProtocolBlock, ProtocolHeader, make_header,
)
from ouroboros_tpu_torch.consensus.protocols import Bft, bft_sign_header
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import OpensslBackend
from ouroboros_tpu_torch.ledgers import MockLedger, Tx
from ouroboros_tpu_torch.storage import MockFS
from ouroboros_tpu_torch.storage.chaindb import ChainDB
from ouroboros_tpu_torch.storage.ledgerdb import DiskPolicy

BACKEND = OpensslBackend()


def _keys(n):
    sks = [hashlib.sha256(b"cdb-%d" % i).digest() for i in range(n)]
    return sks, [ed25519_ref.public_key(sk) for sk in sks]


def _decode_block(raw: bytes):
    from ouroboros_tpu_torch.utils import cbor
    return ProtocolBlock.decode(cbor.loads(raw), tx_decode=Tx.decode)


def _enc_ext(ext):
    return [list(ext.ledger.utxo), ext.ledger.slot, ext.ledger.tip.encode(),
            [ext.header.tip.slot, ext.header.tip.block_no,
             ext.header.tip.hash] if ext.header.tip else None]


def _mk_dec_ext(ledger_rules, protocol):
    from ouroboros_tpu_torch.consensus.header_validation import AnnTip, HeaderState
    from ouroboros_tpu_torch.ledgers.mock import MockLedgerState
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerState

    def dec(obj):
        utxo = tuple(tuple([bytes(e[0]), int(e[1]), bytes(e[2]), int(e[3])])
                     for e in obj[0])
        led = MockLedgerState(utxo, int(obj[1]), Point.decode(obj[2]))
        tip = None if obj[3] is None else AnnTip(int(obj[3][0]),
                                                 int(obj[3][1]),
                                                 bytes(obj[3][2]))
        # chain_dep_state for Bft is (); reconstructable
        return ExtLedgerState(led, HeaderState(tip, ()))
    return dec


class Env:
    def __init__(self, k=4, n_nodes=3):
        self.sks, self.vks = _keys(n_nodes)
        self.protocol = Bft(self.vks, k=k)
        self.ledger = MockLedger({})
        self.ext_rules = ExtLedgerRules(self.protocol, self.ledger)
        self.fs = MockFS()
        self.db = self.open_db()

    def open_db(self):
        return ChainDB.open(
            self.fs, self.ext_rules, _enc_ext,
            _mk_dec_ext(self.ledger, self.protocol), _decode_block,
            chunk_size=10, max_blocks_per_file=5, backend=BACKEND,
            disk_policy=DiskPolicy(num_snapshots=2,
                                   snapshot_interval_slots=1))

    def block(self, prev, slot, body=()):
        leader = self.protocol.slot_leader(slot)
        h = make_header(prev.header if prev else None, slot, body,
                        issuer=leader)
        h = bft_sign_header(self.sks[leader], h)
        return ProtocolBlock(h, tuple(body))

    def chain(self, length, start_slot=0, prev=None):
        out = []
        for j in range(length):
            prev = self.block(prev, start_slot + j)
            out.append(prev)
        return out


class TestChainSelection:
    def test_extend_tip(self):
        env = Env()
        blocks = env.chain(5)
        for b in blocks:
            r = env.db.add_block(b)
            assert r.kind == "extended"
        assert env.db.tip_point() == point_of(blocks[-1])
        assert len(env.db.current_chain) == 5

    def test_out_of_order_arrival(self):
        """Blocks arriving child-before-parent: stored, then adopted when
        the gap fills."""
        env = Env()
        b = env.chain(3)
        assert env.db.add_block(b[0]).kind == "extended"
        assert env.db.add_block(b[2]).kind == "stored"
        r = env.db.add_block(b[1])
        assert r.kind == "extended"
        assert env.db.tip_point() == point_of(b[2])

    def test_fork_switch_longer_wins(self):
        env = Env()
        trunk = env.chain(3)                      # slots 0,1,2
        for b in trunk:
            env.db.add_block(b)
        # fork from trunk[0] with 3 blocks (longer than trunk's 2 above it)
        fork = env.chain(3, start_slot=3, prev=trunk[0])
        for b in fork[:-1]:
            env.db.add_block(b)
        assert env.db.tip_point() == point_of(trunk[-1])  # tie: keep current
        r = env.db.add_block(fork[-1])
        assert r.kind == "switched"
        assert env.db.tip_point() == point_of(fork[-1])
        assert env.db.current_chain.contains_point(point_of(trunk[0]))

    def test_shorter_fork_only_stored(self):
        env = Env()
        trunk = env.chain(4)
        for b in trunk:
            env.db.add_block(b)
        fork = env.chain(2, start_slot=10, prev=trunk[0])
        for b in fork:
            r = env.db.add_block(b)
            assert r.kind == "stored"
        assert env.db.tip_point() == point_of(trunk[-1])

    def test_invalid_block_marked_and_fork_rejected(self):
        env = Env()
        trunk = env.chain(3)
        for b in trunk:
            env.db.add_block(b)
        # forged fork with a bad signature in the middle
        f1 = env.block(trunk[0], 5)
        leader = env.protocol.slot_leader(6)
        bad_hdr = make_header(f1.header, 6, (), issuer=leader)
        bad_hdr = bft_sign_header(env.sks[(leader + 1) % 3], bad_hdr)  # wrong key
        f2 = ProtocolBlock(bad_hdr, ())
        f3 = env.block(f2, 7)
        env.db.add_block(f1)
        env.db.add_block(f2)
        r = env.db.add_block(f3)
        assert env.db.tip_point() == point_of(trunk[-1])
        assert env.db.get_is_invalid(f2.hash)
        # valid sibling chain still adoptable later
        f2b = env.block(f1, 6)
        f3b = env.block(f2b, 7)
        f4b = env.block(f3b, 8)
        env.db.add_block(f2b)
        r = env.db.add_block(f3b)
        assert r.kind == "switched"          # fork now longer than trunk
        r = env.db.add_block(f4b)
        assert r.kind == "extended"
        assert env.db.tip_point() == point_of(f4b)

    def test_duplicate_and_too_old(self):
        env = Env(k=2)
        blocks = env.chain(6)
        for b in blocks:
            env.db.add_block(b)
        assert env.db.add_block(blocks[-1]).kind == "duplicate"
        env.db.copy_to_immutable()
        old = env.block(None, 0)
        assert env.db.add_block(blocks[0]).kind in ("duplicate", "too_old")


class TestFollowers:
    def test_follow_and_rollback(self):
        env = Env()
        f = env.db.new_follower()
        trunk = env.chain(3)
        for b in trunk:
            env.db.add_block(b)
        got = []
        while True:
            ins = f.instruction()
            if ins is None:
                break
            got.append(ins)
        assert [k for k, _ in got] == ["forward"] * 3
        # switch to a longer fork from trunk[0]
        fork = env.chain(4, start_slot=5, prev=trunk[0])
        for b in fork:
            env.db.add_block(b)
        ins = f.instruction()
        assert ins[0] == "rollback" and ins[1] == point_of(trunk[0])
        forwards = []
        while (i := f.instruction()) is not None:
            forwards.append(i)
        assert [k for k, _ in forwards] == ["forward"] * 4
        assert point_of(forwards[-1][1]) == point_of(fork[-1])


class TestBackground:
    def test_copy_to_immutable_and_gc(self):
        env = Env(k=3)
        blocks = env.chain(10)
        for b in blocks:
            env.db.add_block(b)
        copied = env.db.copy_to_immutable()
        assert copied == 7
        assert env.db.immutable.tip.slot == blocks[6].slot
        assert len(env.db.current_chain) == 3
        # immutable blocks still readable through the ChainDB facade
        assert env.db.get_block(blocks[0].hash) is not None
        # volatile GC dropped old files but chain stays intact
        assert env.db.tip_point() == point_of(blocks[-1])

    def test_reopen_replays_to_same_state(self):
        env = Env(k=3)
        blocks = env.chain(10)
        for b in blocks:
            env.db.add_block(b)
        env.db.copy_to_immutable()
        tip_before = env.db.tip_point()
        state_before = env.db.current_ledger.ledger.state_hash()
        db2 = env.open_db()
        assert db2.tip_point() == tip_before
        assert db2.current_ledger.ledger.state_hash() == state_before

    def test_reopen_without_snapshot(self):
        env = Env(k=3)
        blocks = env.chain(8)
        for b in blocks:
            env.db.add_block(b)
        env.db.copy_to_immutable()
        db2 = env.open_db()
        assert db2.tip_point() == point_of(blocks[-1])

    def test_stream_blocks_for_blockfetch(self):
        env = Env(k=3)
        blocks = env.chain(8)
        for b in blocks:
            env.db.add_block(b)
        env.db.copy_to_immutable()
        got = env.db.stream_blocks(point_of(blocks[1]), point_of(blocks[6]))
        assert [b.hash for b in got] == [b.hash for b in blocks[2:7]]
        got = env.db.stream_blocks(Point.genesis(), point_of(blocks[3]))
        assert [b.hash for b in got] == [b.hash for b in blocks[:4]]


class TestFollowersAcrossTheImmutableAnchor:
    def test_follower_behind_immutable_anchor(self):
        """A follower that consumed only part of the chain before
        copy_to_immutable must still receive every block, streamed from
        the ImmutableDB (no silent skip, no bogus rollback)."""
        env = Env(k=2)
        f = env.db.new_follower()
        blocks = env.chain(6)
        for b in blocks:
            env.db.add_block(b)
        # consume only the first 2 blocks
        first = [f.instruction() for _ in range(2)]
        assert [k for k, _ in first] == ["forward"] * 2
        env.db.copy_to_immutable()            # anchor moves to slot 3
        got = []
        while (ins := f.instruction()) is not None:
            got.append(ins)
        assert [k for k, _ in got] == ["forward"] * 4
        assert [b.slot for _, b in got] == [2, 3, 4, 5]

    def test_fresh_follower_streams_from_genesis_through_immutable(self):
        env = Env(k=2)
        blocks = env.chain(6)
        for b in blocks:
            env.db.add_block(b)
        env.db.copy_to_immutable()
        f = env.db.new_follower()
        f.point = Point.genesis()             # intersect at genesis
        got = []
        while (ins := f.instruction()) is not None:
            got.append(ins)
        assert [b.slot for _, b in got] == [0, 1, 2, 3, 4, 5]


# -- the model (tests/test_chaindb_model.py) ------------------------------


class Model:
    """Pure bookkeeping: every VALID block ever accepted, by hash."""

    def __init__(self):
        self.blocks = {}                # hash -> block
        self.invalid = set()

    def add(self, block, valid: bool):
        if valid:
            self.blocks[block.hash] = block
        else:
            self.invalid.add(block.hash)

    def chains_from(self, anchor_hash: bytes):
        """All maximal chains of stored blocks extending anchor_hash."""
        children = {}
        for b in self.blocks.values():
            children.setdefault(b.prev_hash, []).append(b)
        out = []

        def walk(h, acc):
            nxt = children.get(h, [])
            if not nxt:
                if acc:
                    out.append(list(acc))
                return
            for b in nxt:
                acc.append(b)
                walk(b.hash, acc)
                acc.pop()
            if acc:
                out.append(list(acc))
        walk(anchor_hash, [])
        return out


def check_local_optimality(env, model, k):
    """No constructible chain forking <= k from the current tip is
    strictly longer than the adopted chain (the ChainSel guarantee)."""
    chain = env.db.current_chain
    cur_bn = chain.head_block_no
    # fork points: anchor + every block on the fragment within k of head
    points = [chain.anchor] + [point_of(b) for b in chain.blocks]
    for p in points:
        p_bn = (chain.anchor_block_no if p == chain.anchor
                else chain.lookup(p.hash).block_no)
        if cur_bn - p_bn > k:
            continue                    # rollback too deep: unreachable
        base = GENESIS_HASH if p.is_genesis else p.hash
        for cand in model.chains_from(base):
            cand_bn = p_bn + len(cand)
            assert cand_bn <= cur_bn, (
                f"missed a better candidate: fork at block_no {p_bn} "
                f"reaches {cand_bn} > adopted {cur_bn}")


def check_chain_structure(env, model):
    chain = env.db.current_chain
    prev_hash = (GENESIS_HASH if chain.anchor.is_genesis
                 else chain.anchor.hash)
    prev_slot = chain.anchor.slot if not chain.anchor.is_genesis else -1
    for b in chain.blocks:
        assert b.prev_hash == prev_hash, "chain linkage broken"
        assert b.slot > prev_slot, "slots not increasing"
        assert b.hash not in model.invalid, "invalid block adopted"
        prev_hash, prev_slot = b.hash, b.slot


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_random_ops_vs_model(seed):
    rng = random.Random(seed)
    k = 4
    env = Env(k=k)
    model = Model()
    # blocks the generator created but has not yet delivered (orphan play:
    # children may be delivered before parents)
    pending = []
    tips = [None]                       # forge parents: None = genesis
    next_slot = [1]

    def forge(valid=True):
        prev = rng.choice(tips[-8:])    # bias toward recent tips
        slot = next_slot[0]
        next_slot[0] += 1
        b = env.block(prev, slot)
        if not valid:
            # corrupt the signature
            hdr = b.header.with_fields(bft_sig=b"\x00" * 64)
            from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
            b = ProtocolBlock(hdr, b.body)
        else:
            tips.append(b)
        return b, valid

    for step in range(120):
        op = rng.random()
        if op < 0.55 or not pending:
            b, valid = forge(valid=rng.random() > 0.1)
            if rng.random() < 0.3:
                pending.append((b, valid))   # deliver later (orphan)
                continue
        else:
            b, valid = pending.pop(rng.randrange(len(pending)))
        res = env.db.add_block(b)
        assert res.kind in ("extended", "switched", "stored", "invalid",
                            "duplicate", "too_old")
        if res.kind != "too_old":
            # blocks at or below the immutable anchor are legitimately
            # discarded (they can never be adopted) — mirror that
            model.add(b, valid)
        check_chain_structure(env, model)
        check_local_optimality(env, model, k)
        if rng.random() < 0.08:
            env.db.copy_to_immutable()
        if rng.random() < 0.05:
            # crash + reopen: recovery must reach an equally GOOD tip —
            # with equal-length forks the specific head may differ (tie
            # breaking is adoption-order dependent), but height may not
            # regress (the Model.hs equivalence up to chain preference)
            height_before = env.db.current_chain.head_block_no
            env.db = env.open_db()
            check_chain_structure(env, model)
            check_local_optimality(env, model, k)
            assert env.db.current_chain.head_block_no >= height_before, \
                "reopen regressed the adopted chain"

    # drain the orphan pool and re-check convergence
    for b, valid in pending:
        res = env.db.add_block(b)
        if res.kind != "too_old":
            model.add(b, valid)
    check_chain_structure(env, model)
    check_local_optimality(env, model, k)
