"""The Byron-analog era on the port: the cases of tests/test_byron_era.py
on `ouroboros_tpu_torch` (CppBackend where the reference used
OpensslBackend), then the forged chain, its block bytes and the final
ledger's state_hash held equal to the JAX package's.  Tolerance: none.

Byron-analog era: PBFT + delegation ledger + EBBs.

Reference test surface: ouroboros-consensus-byron-test (ThreadNet Byron,
delegation/EBB handling) — here: EBB envelope quirk (shared block number),
ledger-driven delegate set, heavyweight re-delegation, windowed threshold,
witness batching parity (SURVEY.md §2 L6, §4).
"""
import importlib
import pytest

from ouroboros_tpu_torch.consensus import (
    HeaderState, HeaderError, validate_header,
)
from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
from ouroboros_tpu_torch.consensus.headers import ProtocolBlock, make_header
from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules, LedgerError
from ouroboros_tpu_torch.consensus.protocol import ProtocolError
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.eras.byron import (
    CERT_DLG, EBB_FIELD, SIG_FIELD, ByronLedger, ByronPBft,
    byron_genesis_setup, byron_sign_header, make_byron_tx, make_ebb,
)

BACKEND = CppBackend()

EPOCH = 10


def forge_byron_chain(protocol, ledger, nodes, n_slots, pending_txs=None,
                      with_ebbs=True, delegate_sks=None):
    """Round-robin forging with optional EBBs at epoch starts.

    delegate_sks: mutable {genesis_ix: sk} — updated by the caller when a
    re-delegation tx lands (the forger must sign with the ledger's current
    delegate)."""
    pending = list(pending_txs or [])
    delegate_sks = delegate_sks or {n["index"]: n["delegate_sk"]
                                    for n in nodes}
    ext = ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    blocks, prev = [], None
    for slot in range(n_slots):
        if with_ebbs and slot % protocol.epoch_length == 0:
            h = make_ebb(prev, slot // protocol.epoch_length,
                         protocol.epoch_length)
            blk = ProtocolBlock(h, ())
            state = ext.tick_then_apply(state, blk, backend=BACKEND)
            blocks.append(blk)
            prev = h
            continue
        issuer = protocol.slot_leader(slot)
        body = tuple(pending)
        pending.clear()
        h = make_header(prev, slot, body, issuer=issuer)
        h = byron_sign_header(delegate_sks[issuer], h)
        blk = ProtocolBlock(h, body)
        state = ext.tick_then_apply(state, blk, backend=BACKEND)
        blocks.append(blk)
        prev = h
    return blocks, state


@pytest.fixture(scope="module")
def net():
    protocol, ledger, nodes = byron_genesis_setup(3, epoch_length=EPOCH)
    blocks, state = forge_byron_chain(protocol, ledger, nodes, 25)
    return dict(protocol=protocol, ledger=ledger, nodes=nodes,
                blocks=blocks, state=state)


class TestByronChain:
    def test_chain_with_ebbs_validates(self, net):
        blocks = net["blocks"]
        assert len(blocks) == 25
        ebbs = [b for b in blocks if b.header.get(EBB_FIELD)]
        assert len(ebbs) == 3                      # slots 0, 10, 20

    def test_ebb_shares_block_number(self, net):
        blocks = net["blocks"]
        by_slot = {b.slot: b for b in blocks}
        ebb = by_slot[EPOCH]                       # EBB at slot 10
        prev = by_slot[EPOCH - 1]
        assert ebb.header.block_no == prev.header.block_no
        nxt = by_slot[EPOCH + 1]
        assert nxt.header.block_no == ebb.header.block_no + 1

    def test_ebb_with_signature_rejected(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        blocks = net["blocks"]
        # rebuild the chain state up to just before the slot-10 EBB
        st = HeaderState.genesis(protocol)
        view = ledger.ledger_view(ledger.initial_state())
        for b in blocks:
            if b.slot == EPOCH:
                bad = b.header.with_fields(**{SIG_FIELD: b"\x00" * 64})
                with pytest.raises(HeaderError, match="malformed EBB"):
                    validate_header(protocol, view, bad, st, backend=BACKEND)
                return
            st = validate_header(protocol, view, b.header, st,
                                 backend=BACKEND)
        pytest.fail("no EBB found")

    def test_batched_blocks_backend_parity(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        ext = ExtLedgerRules(protocol, ledger)
        res_ssl = validate_blocks_batched(ext, net["blocks"],
                                          ext.initial_state(),
                                          backend=BACKEND)
        res_ref = validate_blocks_batched(ext, net["blocks"],
                                          ext.initial_state(),
                                          backend=CpuRefBackend())
        assert res_ssl.all_valid, res_ssl.error
        assert res_ref.all_valid
        assert (res_ssl.final_state.ledger.state_hash()
                == res_ref.final_state.ledger.state_hash())
        assert (res_ssl.final_state.ledger.state_hash()
                == net["state"].ledger.state_hash())

    def test_wrong_delegate_signature_rejected(self, net):
        protocol, ledger, nodes = net["protocol"], net["ledger"], net["nodes"]
        view = ledger.ledger_view(ledger.initial_state())
        st = HeaderState.genesis(protocol)
        # EBB at slot 0 first (chain starts with one)
        h = make_header(None, 1, (), issuer=protocol.slot_leader(1))
        h = byron_sign_header(nodes[0]["delegate_sk"], h)   # wrong delegate
        if protocol.slot_leader(1) != 0:
            with pytest.raises(HeaderError, match="does not match"):
                validate_header(protocol, view, h, st, backend=BACKEND)

    def test_threshold_enforced(self):
        protocol, ledger, nodes = byron_genesis_setup(
            3, epoch_length=100, threshold=0.34, window=6)
        view = ledger.ledger_view(ledger.initial_state())
        st = HeaderState.genesis(protocol)
        prev = None
        # issuer 0 signs every slot 0,3,6,... via round-robin is fine (2 of
        # 6); force consecutive signing by issuer 0 instead
        for j, slot in enumerate(range(0, 9, 3)):   # issuer 0's slots
            h = make_header(prev, slot, (), issuer=0)
            h = byron_sign_header(nodes[0]["delegate_sk"], h)
            if j < 2:
                st = validate_header(protocol, view, h, st, backend=BACKEND)
                prev = h
            else:
                with pytest.raises(HeaderError, match="threshold"):
                    validate_header(protocol, view, h, st, backend=BACKEND)


class TestByronDelegation:
    def test_redelegation_changes_required_signer(self):
        protocol, ledger, nodes = byron_genesis_setup(3, epoch_length=EPOCH)
        st = ledger.initial_state()
        new_sk = b"\x31" * 32
        new_vk = ed25519_ref.public_key(new_sk)
        spender = nodes[1]
        entry = [u for u in st.utxo if u[2] == spender["addr"]][0]
        tx = make_byron_tx(
            [(entry[0], entry[1])], [(spender["addr"], entry[3])],
            [(CERT_DLG, (0).to_bytes(8, "big"), new_vk)],
            [spender["addr_sk"], nodes[0]["genesis_sk"]])
        ticked = ledger.tick(st, 0)
        h = make_header(None, 1, (tx,), issuer=1)
        h = byron_sign_header(nodes[1]["delegate_sk"], h)
        blk = ProtocolBlock(h, (tx,))
        st2 = ledger.apply_block(ticked, blk, backend=BACKEND)
        assert ledger.ledger_view(st2).delegate_of(0) == new_vk
        # genesis key 0's blocks must now be signed by new_sk
        hs = HeaderState.genesis(protocol)
        hs = validate_header(protocol, ledger.ledger_view(st), h, hs,
                             backend=BACKEND)
        view2 = ledger.ledger_view(st2)
        h_old = make_header(h, 3, (), issuer=0)
        h_old = byron_sign_header(nodes[0]["delegate_sk"], h_old)
        with pytest.raises(HeaderError, match="does not match"):
            validate_header(protocol, view2, h_old, hs, backend=BACKEND)
        h_new = make_header(h, 3, (), issuer=0)
        h_new = byron_sign_header(new_sk, h_new)
        validate_header(protocol, view2, h_new, hs, backend=BACKEND)

    def test_delegation_without_genesis_witness_rejected(self):
        protocol, ledger, nodes = byron_genesis_setup(3, epoch_length=EPOCH)
        st = ledger.initial_state()
        spender = nodes[1]
        entry = [u for u in st.utxo if u[2] == spender["addr"]][0]
        tx = make_byron_tx(
            [(entry[0], entry[1])], [(spender["addr"], entry[3])],
            [(CERT_DLG, (0).to_bytes(8, "big"), b"\x05" * 32)],
            [spender["addr_sk"]])                  # genesis witness missing
        with pytest.raises(LedgerError, match="genesis-key witness"):
            ledger.apply_tx(st, tx, backend=BACKEND)

    def test_tx_witness_batching(self):
        """A block with several txs verifies all witnesses as one batch and
        rejects a tampered one."""
        protocol, ledger, nodes = byron_genesis_setup(3, epoch_length=EPOCH)
        st = ledger.tick(ledger.initial_state(), 0)
        txs = []
        for n in nodes:
            entry = [u for u in st.utxo if u[2] == n["addr"]][0]
            txs.append(make_byron_tx([(entry[0], entry[1])],
                                     [(n["addr"], entry[3])], [],
                                     [n["addr_sk"]]))
        h = make_header(None, 1, tuple(txs), issuer=1)
        h = byron_sign_header(nodes[1]["delegate_sk"], h)
        blk = ProtocolBlock(h, tuple(txs))
        ledger.apply_block(st, blk, backend=BACKEND)   # all good
        # tamper one witness signature
        import dataclasses
        bad_tx = txs[1]
        vk, sig = bad_tx.witnesses[0]
        bad_tx = dataclasses.replace(
            bad_tx, witnesses=((vk, sig[:10] + b"\x00" * 54),))
        bad_body = (txs[0], bad_tx, txs[2])
        h2 = make_header(None, 1, bad_body, issuer=1)
        h2 = byron_sign_header(nodes[1]["delegate_sk"], h2)
        with pytest.raises(LedgerError, match="invalid tx witness"):
            ledger.apply_block(st, ProtocolBlock(h2, bad_body),
                               backend=BACKEND)


# -- parity with the JAX package ------------------------------------------

def _reference_module():
    """tests/test_byron_era.py, the JAX package's own cases: its
    forging helper builds the same chain from the same seeds there."""
    return importlib.import_module("test_byron_era")


def test_forged_chain_equals_the_jax_packages(net):
    ref = _reference_module()
    protocol, ledger, nodes = ref.byron_genesis_setup(3, epoch_length=EPOCH)
    blocks, state = ref.forge_byron_chain(protocol, ledger, nodes, 25)
    assert [b.bytes for b in net["blocks"]] == [b.bytes for b in blocks]
    assert net["state"].ledger.state_hash() == state.ledger.state_hash()
    ext = ExtLedgerRules(net["protocol"], net["ledger"])
    res = validate_blocks_batched(ext, net["blocks"], ext.initial_state(),
                                  backend=BACKEND)
    jext = ref.ExtLedgerRules(protocol, ledger)
    jres = ref.validate_blocks_batched(jext, blocks, jext.initial_state(),
                                       backend=ref.BACKEND)
    assert (res.all_valid, res.final_state.ledger.state_hash()) \
        == (jres.all_valid, jres.final_state.ledger.state_hash())
