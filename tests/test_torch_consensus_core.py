"""The port's BFT protocol and its protocol combinators
(`ouroboros_tpu_torch.consensus.protocols`: Bft, LeaderSchedule,
WithLeaderSchedule, ModChainSel) through the port's consensus core:
envelope checks, header and ledger validation and the batch driver on
BFT chains (tests/test_consensus_core.py's cases, every one of which runs
on `Bft`), and the combinators (tests/test_leader_schedule.py's cases),
run against the port's copies over the port's OpensslBackend.

Reference: HeaderValidation + Ledger.Extended test surface;
Protocol/LeaderSchedule.hs, Protocol/ModChainSel.hs.
"""
import hashlib

import pytest

from ouroboros_tpu_torch.chain.block import GENESIS_HASH, Point
from ouroboros_tpu_torch.consensus import (
    ExtLedgerRules, HeaderError, HeaderState, HeaderStateHistory,
    NullProtocol, validate_header, revalidate_header,
    validate_headers_batched,
)
from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
from ouroboros_tpu_torch.consensus.headers import (
    ProtocolBlock, ProtocolHeader, body_hash_of, make_header,
)
from ouroboros_tpu_torch.consensus.protocol import ProtocolError
from ouroboros_tpu_torch.consensus.protocols import (
    Bft, LeaderSchedule, ModChainSel, WithLeaderSchedule, bft_sign_header,
)
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import OpensslBackend
from ouroboros_tpu_torch.ledgers import MockLedger, TxIn, TxOut, make_tx

BACKEND = OpensslBackend()


def _keys(n):
    sks = [hashlib.sha256(b"node-%d" % i).digest() for i in range(n)]
    return sks, [ed25519_ref.public_key(sk) for sk in sks]


def _bft_chain(protocol, sks, length, start_slot=0):
    headers = []
    prev = None
    for j in range(length):
        slot = start_slot + j
        leader = protocol.slot_leader(slot)
        h = make_header(prev, slot, (), issuer=leader)
        h = bft_sign_header(sks[leader], h)
        headers.append(h)
        prev = h
    return headers


class TestEnvelope:
    def test_happy_path_and_rejections(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        headers = _bft_chain(p, sks, 5)
        st = HeaderState.genesis(p)
        for h in headers:
            st = validate_header(p, None, h, st, backend=BACKEND)
        assert st.tip.block_no == 4
        # wrong prev hash
        bad = make_header(None, 10, (), issuer=p.slot_leader(10))
        bad = bft_sign_header(sks[p.slot_leader(10)], bad)
        with pytest.raises(HeaderError):
            validate_header(p, None, bad, st, backend=BACKEND)

    def test_slot_must_increase(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        h0, h1 = _bft_chain(p, sks, 2)
        st = validate_header(p, None, h0, HeaderState.genesis(p),
                             backend=BACKEND)
        same_slot = ProtocolHeader(h0.slot, 1, h0.hash, h1.body_hash,
                                   issuer=p.slot_leader(h0.slot))
        same_slot = bft_sign_header(sks[p.slot_leader(h0.slot)], same_slot)
        with pytest.raises(HeaderError):
            validate_header(p, None, same_slot, st, backend=BACKEND)

    def test_bad_signature_rejected(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        h = make_header(None, 0, (), issuer=0)
        h = bft_sign_header(sks[1], h)   # signed by the wrong node
        with pytest.raises(HeaderError):
            validate_header(p, None, h, HeaderState.genesis(p),
                            backend=BACKEND)

    def test_revalidate_matches_validate(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        headers = _bft_chain(p, sks, 4)
        st_v = st_r = HeaderState.genesis(p)
        for h in headers:
            st_v = validate_header(p, None, h, st_v, backend=BACKEND)
            st_r = revalidate_header(p, None, h, st_r)
        assert st_v == st_r


class TestBatchDriver:
    def test_all_valid_window(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        headers = _bft_chain(p, sks, 20)
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert res.all_valid and res.n_valid == 20
        # batched result == sequential fold
        st = HeaderState.genesis(p)
        for h in headers:
            st = validate_header(p, None, h, st, backend=BACKEND)
        assert res.final_state == st

    def test_bad_proof_cuts_window(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        headers = _bft_chain(p, sks, 10)
        # corrupt header 6's signature
        h6 = headers[6]
        sig = bytearray(h6.get("bft_sig"))
        sig[0] ^= 0xFF
        headers[6] = h6.with_fields(bft_sig=bytes(sig))
        # re-link the suffix so only the signature is wrong
        prev = headers[6]
        for j in range(7, 10):
            leader = p.slot_leader(j)
            headers[j] = bft_sign_header(sks[leader],
                                         make_header(prev, j, (), leader))
            prev = headers[j]
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert not res.all_valid
        assert res.n_valid == 6
        assert res.states[-1].tip.block_no == 5

    def test_envelope_break_cuts_window(self):
        sks, vks = _keys(3)
        p = Bft(vks)
        headers = _bft_chain(p, sks, 5)
        headers[3] = headers[1]     # breaks prev-hash link at index 3
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert not res.all_valid and res.n_valid == 3


class TestHeaderStateHistory:
    def test_rewind_within_k(self):
        sks, vks = _keys(3)
        p = Bft(vks, k=5)
        headers = _bft_chain(p, sks, 8)
        hist = HeaderStateHistory(p.security_param, HeaderState.genesis(p))
        for h in headers:
            hist.append(validate_header(p, None, h, hist.current,
                                        backend=BACKEND))
        target = Point(headers[5].slot, headers[5].hash)
        assert hist.rewind(target)
        assert hist.current.tip_point == target
        # deeper than k from the new tip is gone
        assert not hist.rewind(Point(headers[0].slot, headers[0].hash))


class TestExtLedger:
    def _setup(self):
        sks, vks = _keys(3)
        addr_sks = [hashlib.sha256(b"addr-%d" % i).digest() for i in range(2)]
        addrs = [ed25519_ref.public_key(sk) for sk in addr_sks]
        ledger = MockLedger({addrs[0]: 100})
        p = Bft(vks)
        return sks, vks, addr_sks, addrs, ledger, ExtLedgerRules(p, ledger), p

    def _block(self, p, sks, prev, slot, body):
        leader = p.slot_leader(slot)
        h = make_header(prev, slot, body, issuer=leader)
        h = bft_sign_header(sks[leader], h)
        return ProtocolBlock(h, tuple(body))

    def test_apply_block_with_witnessed_tx(self):
        sks, vks, addr_sks, addrs, ledger, ext_rules, p = self._setup()
        st = ext_rules.initial_state()
        tx = make_tx([TxIn(MockLedger.GENESIS_TXID, 0)],
                     [TxOut(addrs[1], 60), TxOut(addrs[0], 40)],
                     [addr_sks[0]])
        b = self._block(p, sks, None, 0, (tx,))
        st2 = ext_rules.tick_then_apply(st, b, backend=BACKEND)
        utxo = st2.ledger.utxo_dict()
        assert (tx.txid, 0) in utxo and utxo[(tx.txid, 0)] == (addrs[1], 60)
        assert st2.header.tip.hash == b.hash
        # reapply agrees
        st2r = ext_rules.tick_then_reapply(st, b)
        assert st2r.ledger == st2.ledger and st2r.header == st2.header

    def test_unwitnessed_spend_rejected(self):
        sks, vks, addr_sks, addrs, ledger, ext_rules, p = self._setup()
        st = ext_rules.initial_state()
        tx = make_tx([TxIn(MockLedger.GENESIS_TXID, 0)],
                     [TxOut(addrs[1], 100)], [addr_sks[1]])  # wrong key
        b = self._block(p, sks, None, 0, (tx,))
        with pytest.raises(Exception):
            ext_rules.tick_then_apply(st, b, backend=BACKEND)

    def test_blocks_batched_matches_sequential(self):
        sks, vks, addr_sks, addrs, ledger, ext_rules, p = self._setup()
        st0 = ext_rules.initial_state()
        # block 0 splits genesis; block 1 spends the change
        tx0 = make_tx([TxIn(MockLedger.GENESIS_TXID, 0)],
                      [TxOut(addrs[1], 60), TxOut(addrs[0], 40)],
                      [addr_sks[0]])
        b0 = self._block(p, sks, None, 0, (tx0,))
        tx1 = make_tx([TxIn(tx0.txid, 1)], [TxOut(addrs[1], 40)],
                      [addr_sks[0]])
        b1 = self._block(p, sks, b0.header, 1, (tx1,))
        res = validate_blocks_batched(ext_rules, [b0, b1], st0,
                                      backend=BACKEND)
        assert res.all_valid and res.n_valid == 2
        st_seq = ext_rules.tick_then_apply(st0, b0, backend=BACKEND)
        st_seq = ext_rules.tick_then_apply(st_seq, b1, backend=BACKEND)
        assert res.final_state.ledger == st_seq.ledger
        assert res.final_state.header == st_seq.header
        assert res.final_state.ledger.state_hash() == \
            st_seq.ledger.state_hash()

    def test_batched_catches_bad_witness(self):
        sks, vks, addr_sks, addrs, ledger, ext_rules, p = self._setup()
        st0 = ext_rules.initial_state()
        tx0 = make_tx([TxIn(MockLedger.GENESIS_TXID, 0)],
                      [TxOut(addrs[1], 100)], [addr_sks[0]])
        # tamper the witness signature
        vk, sig = tx0.witnesses[0]
        bad_sig = sig[:-1] + bytes([sig[-1] ^ 1])
        tx_bad = type(tx0)(tx0.inputs, tx0.outputs, ((vk, bad_sig),))
        b0 = self._block(p, sks, None, 0, (tx_bad,))
        res = validate_blocks_batched(ext_rules, [b0], st0, backend=BACKEND)
        assert not res.all_valid and res.n_valid == 0


# -- the combinators (tests/test_leader_schedule.py) ----------------------


def _ls_keys(n):
    sks = [hashlib.sha256(b"ls-%d" % i).digest() for i in range(n)]
    return sks, [ed25519_ref.public_key(sk) for sk in sks]


def test_leader_schedule_lookup_and_merge():
    a = LeaderSchedule({0: [0], 1: [1, 2]})
    b = LeaderSchedule({1: [2, 0], 2: [1]})
    m = a.merge(b)
    assert list(m.leaders_of(1)) == [1, 2, 0]   # left-biased dedup
    assert m.slots_for(0) == {0, 1}
    with pytest.raises(ProtocolError, match="missing slot"):
        m.leaders_of(99)


def test_with_leader_schedule_overrides_election():
    _, vks = _ls_keys(3)
    sched = LeaderSchedule({s: [s % 2] for s in range(10)})
    # under plain BFT node 2 would lead slots 2,5,8; under the schedule
    # only nodes 0 and 1 ever lead
    for nid in range(3):
        p = WithLeaderSchedule(Bft(vks), sched, node_id=nid)
        leads = {s for s in range(10)
                 if p.check_is_leader(nid, s, (), None) is not None}
        assert leads == sched.slots_for(nid)
    # chain-dep state is trivial and headers need no crypto
    p = WithLeaderSchedule(Bft(vks), sched, node_id=0)
    h = make_header(None, 3, (), issuer=1)
    assert p.update_chain_dep_state((), h, None) == ()


def test_mod_chain_sel_swaps_ordering():
    sks, vks = _ls_keys(2)
    inner = Bft(vks)
    # reversed ordering: prefer *lower* slot (an arbitrary custom ordering)
    p = ModChainSel(inner, view=lambda h: h.slot,
                    prefer=lambda ours, cand: cand < ours)
    h1 = make_header(None, 1, (), issuer=0)
    h9 = make_header(None, 9, (), issuer=0)
    assert p.select_view(h9) == 9
    assert p.prefer_candidate(p.select_view(h9), p.select_view(h1))
    assert not p.prefer_candidate(p.select_view(h1), p.select_view(h9))
    # validation still delegates to the inner protocol (bad sig rejected)
    st = inner.initial_chain_dep_state()
    good = bft_sign_header(sks[1 % 2], make_header(None, 1, (), issuer=1))
    # the port's default backend is the card: the host one is named
    p.update_chain_dep_state(st, good, None, backend=BACKEND)
    bad = make_header(None, 1, (), issuer=1).with_fields(
        **{"bft_sig": b"\x00" * 64})
    with pytest.raises(ProtocolError):
        p.update_chain_dep_state(st, bad, None, backend=BACKEND)
