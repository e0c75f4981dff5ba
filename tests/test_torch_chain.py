"""The port's chain types (`ouroboros_tpu_torch.chain`: AnchoredFragment,
Chain, ChainProducerState): tests/test_chain.py's cases, run against the
port's copies.

Reference: ouroboros-network/test/Test/ChainFragment.hs-style properties,
simplified.
"""
import pytest

from ouroboros_tpu_torch.chain import (
    AnchoredFragment, Chain, ChainProducerState, Point, make_block, point_of,
)
from ouroboros_tpu_torch.utils import cbor


def mk_chain(n, seed=b"", start_slot=0):
    blocks, prev = [], None
    for i in range(n):
        prev = make_block(prev, start_slot + i * 2, body=[seed + b"%d" % i])
        blocks.append(prev)
    return blocks


def test_cbor_roundtrip():
    vals = [0, 23, 24, 255, 65536, -1, -500, b"bytes", "text",
            [1, [2, 3]], {1: b"a", "k": [True, False, None]}, 1.5,
            cbor.Tag(24, b"wrapped")]
    for v in vals:
        assert cbor.loads(cbor.dumps(v)) == v


def test_fragment_add_and_lookup():
    blocks = mk_chain(10)
    f = AnchoredFragment.from_genesis()
    for b in blocks:
        f.add_block(b)
    assert len(f) == 10
    assert f.head is blocks[-1]
    assert f.contains_point(point_of(blocks[3]))
    assert f.lookup(blocks[5].hash) is blocks[5]
    with pytest.raises(ValueError):
        f.add_block(blocks[2])   # doesn't link


def test_fragment_rollback_and_after():
    blocks = mk_chain(8)
    f = AnchoredFragment.from_genesis()
    for b in blocks:
        f.add_block(b)
    p = point_of(blocks[4])
    r = f.rollback(p)
    assert r is not None and len(r) == 5 and r.head_point == p
    assert f.rollback(Point(999, b"\x01" * 32)) is None
    after = f.after_point(p)
    assert after == blocks[5:]
    assert f.after_point(f.anchor) == blocks


def test_fragment_reanchor_k_suffix():
    blocks = mk_chain(10)
    f = AnchoredFragment.from_genesis()
    for b in blocks:
        f.add_block(b)
    g = f.anchor_newer_than(3)
    assert len(g) == 3
    assert g.anchor == point_of(blocks[6])
    assert g.anchor_block_no == blocks[6].block_no


def test_fragment_intersect():
    common = mk_chain(5)
    fork_a = mk_chain(3, seed=b"a")
    f1 = AnchoredFragment.from_genesis()
    f2 = AnchoredFragment.from_genesis()
    for b in common:
        f1.add_block(b)
        f2.add_block(b)
    prev = common[-1]
    for i in range(3):
        prev = make_block(prev, 100 + i, body=[b"a%d" % i])
        f1.add_block(prev)
    prev = common[-1]
    for i in range(3):
        prev = make_block(prev, 200 + i, body=[b"b%d" % i])
        f2.add_block(prev)
    assert f1.intersect(f2) == point_of(common[-1])


def test_producer_state_follow():
    blocks = mk_chain(6)
    ps = ChainProducerState()
    fid = ps.new_follower()
    for b in blocks[:3]:
        ps.add_block(b)
    got = []
    while (ins := ps.follower_instruction(fid)) is not None:
        got.append(ins)
    # initial rollback to genesis, then 3 forwards
    assert got[0] == ("rollback", Point.genesis())
    assert [b for k, b in got[1:]] == blocks[:3]
    # produce more, follower catches up
    for b in blocks[3:]:
        ps.add_block(b)
    got2 = []
    while (ins := ps.follower_instruction(fid)) is not None:
        got2.append(ins)
    assert [b for k, b in got2] == blocks[3:]


def test_producer_state_fork_switch():
    blocks = mk_chain(6)
    ps = ChainProducerState()
    fid = ps.new_follower()
    for b in blocks:
        ps.add_block(b)
    while ps.follower_instruction(fid) is not None:
        pass
    # switch to a fork from block 2
    fork_point = point_of(blocks[2])
    prev, fork = blocks[2], []
    for i in range(4):
        prev = make_block(prev, 50 + i, body=[b"f%d" % i])
        fork.append(prev)
    assert ps.switch_fork(fork_point, fork)
    ins = ps.follower_instruction(fid)
    assert ins == ("rollback", fork_point)
    got = []
    while (ins := ps.follower_instruction(fid)) is not None:
        got.append(ins[1])
    assert got == fork


def test_block_serialisation_roundtrip():
    b = mk_chain(3)[-1]
    from ouroboros_tpu_torch.chain.block import Block
    assert Block.decode(cbor.loads(b.bytes)) == b
