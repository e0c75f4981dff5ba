"""Regression tests for round-1 advisor findings on the port: the cases of
tests/test_advice_fixes.py on `ouroboros_tpu_torch`.  The port's default
backend is a TorchBackend on the CUDA card and raises without one, so
each case here runs with the port's CppBackend installed as the default
(the ledger guards call `apply_tx` with no backend).

Regression tests for round-1 advisor findings (ADVICE.md):

- value inflation via negative output amounts (Shelley, Byron, mock)
- duplicate inputs double-counted / KeyError leak
- era-agnostic EBB exemption (TPraos must reject the ebb field;
  validate_envelope gates EBBs on the protocol's accepts_ebb)
- EBB successor may share the EBB's slot (minimumNextSlotNo)
- OCert issue-number jumps beyond current+1
"""
from fractions import Fraction

import pytest

from ouroboros_tpu_torch.consensus.header_validation import (
    HeaderEnvelopeError, HeaderState, ann_tip_of, validate_envelope,
)
from ouroboros_tpu_torch.consensus.headers import make_header
from ouroboros_tpu_torch.consensus.ledger import LedgerError
from ouroboros_tpu_torch.consensus.protocol import ProtocolError
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.eras.byron import (
    ByronPBft, ByronTx, byron_genesis_setup, make_byron_tx, make_ebb,
)
from ouroboros_tpu_torch.eras.shelley import (
    ShelleyTx, TPraos, TPraosConfig, TPraosLedgerView, make_ocert,
    make_shelley_tx, shelley_genesis_setup,
)
from ouroboros_tpu_torch.crypto import backend as backend_mod
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.ledgers.mock import MockLedger, Tx, TxIn, TxOut

CFG = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=20,
                   slots_per_kes_period=5, kes_depth=4,
                   max_kes_evolutions=14)

GEN = b"\x00" * 32


@pytest.fixture(autouse=True)
def cpu_default_backend():
    """A host backend as the default for the cases that name none, the
    one installed before put back after."""
    before = backend_mod._default
    backend_mod.set_default_backend(CppBackend())
    yield
    backend_mod.set_default_backend(before)


# ---------------------------------------------------------------------------
# negative outputs / duplicate inputs
# ---------------------------------------------------------------------------

class TestShelleyLedgerGuards:
    @pytest.fixture()
    def setup(self):
        protocol, ledger, pools = shelley_genesis_setup(1, CFG)
        return ledger, ledger.initial_state(), pools[0]

    def test_negative_output_rejected(self, setup):
        ledger, state, pool = setup
        attacker = b"\xaa" * 32
        tx = make_shelley_tx(
            inputs=[(GEN, 0)],
            outputs=[(attacker, 6000), (pool["addr"], -5000)],
            certs=[], signing_keys=[pool["keys"].addr_sk])
        with pytest.raises(LedgerError, match="negative"):
            ledger.apply_tx(state, tx)

    def test_negative_output_rejected_at_decode(self, setup):
        ledger, state, pool = setup
        tx = make_shelley_tx(
            inputs=[(GEN, 0)], outputs=[(pool["addr"], -1)],
            certs=[], signing_keys=[pool["keys"].addr_sk])
        with pytest.raises(ValueError, match="negative"):
            ShelleyTx.decode(tx.encode())

    def test_duplicate_inputs_ledger_error(self, setup):
        ledger, state, pool = setup
        tx = make_shelley_tx(
            inputs=[(GEN, 0), (GEN, 0)],
            outputs=[(pool["addr"], 2000)],
            certs=[], signing_keys=[pool["keys"].addr_sk])
        # LedgerError, not a raw KeyError that the mempool would leak
        with pytest.raises(LedgerError, match="duplicate"):
            ledger.apply_tx(state, tx)


class TestByronLedgerGuards:
    @pytest.fixture()
    def setup(self):
        protocol, ledger, nodes = byron_genesis_setup(1)
        return ledger, ledger.initial_state(), nodes[0]

    def test_negative_output_rejected(self, setup):
        ledger, state, node = setup
        tx = make_byron_tx(
            inputs=[(GEN, 0)],
            outputs=[(b"\xaa" * 32, 6000), (node["addr"], -5000)],
            certs=[], signing_keys=[node["addr_sk"]])
        with pytest.raises(LedgerError, match="negative"):
            ledger.apply_tx(state, tx)

    def test_negative_output_rejected_at_decode(self, setup):
        ledger, state, node = setup
        tx = make_byron_tx(
            inputs=[(GEN, 0)], outputs=[(node["addr"], -1)],
            certs=[], signing_keys=[node["addr_sk"]])
        with pytest.raises(ValueError, match="negative"):
            ByronTx.decode(tx.encode())

    def test_duplicate_inputs_ledger_error(self, setup):
        ledger, state, node = setup
        tx = make_byron_tx(
            inputs=[(GEN, 0), (GEN, 0)],
            outputs=[(node["addr"], 2000)],
            certs=[], signing_keys=[node["addr_sk"]])
        with pytest.raises(LedgerError, match="duplicate"):
            ledger.apply_tx(state, tx)


class TestMockLedgerGuards:
    def test_negative_output_and_duplicate_inputs(self):
        sk = b"\x01" * 32
        addr = ed25519_ref.public_key(sk)
        ledger = MockLedger({addr: 1000})
        state = ledger.initial_state()

        class Blk:
            body = ()
            slot = 0
            hash = b"\x02" * 32

        blk = Blk()
        blk.body = (Tx((TxIn(GEN, 0),),
                       (TxOut(b"\xaa" * 32, 6000), TxOut(addr, -5000))),)
        with pytest.raises(LedgerError, match="negative"):
            ledger._apply_txs(state, blk)
        blk.body = (Tx((TxIn(GEN, 0), TxIn(GEN, 0)),
                       (TxOut(addr, 2000),)),)
        with pytest.raises(LedgerError, match="duplicate"):
            ledger._apply_txs(state, blk)


# ---------------------------------------------------------------------------
# EBB gating
# ---------------------------------------------------------------------------

class TestEbbGating:
    def test_tpraos_rejects_ebb_field(self):
        protocol = TPraos(CFG)
        hdr = make_header(None, 1, (), issuer=0).with_fields(ebb=1)
        with pytest.raises(ProtocolError, match="EBB"):
            protocol.sequential_checks(protocol.initial_chain_dep_state(),
                                       hdr, TPraosLedgerView({}))

    def test_envelope_rejects_ebb_for_non_ebb_protocol(self):
        protocol = TPraos(CFG)
        ebb = make_ebb(None, 0, CFG.epoch_length)
        with pytest.raises(HeaderEnvelopeError, match="EBB"):
            validate_envelope(ebb, HeaderState.genesis(protocol), protocol)

    def test_envelope_admits_ebb_for_byron(self):
        protocol = ByronPBft(2)
        ebb = make_ebb(None, 0, protocol.epoch_length)
        validate_envelope(ebb, HeaderState.genesis(protocol), protocol)

    def test_ebb_chain_at_same_slot_rejected(self):
        """An EBB may not reuse its predecessor's slot (only the real block
        following an EBB may share it) — no unbounded unsigned EBB chains."""
        protocol = ByronPBft(2)
        ebb = make_ebb(None, 0, protocol.epoch_length)
        st = HeaderState(ann_tip_of(ebb), protocol.initial_chain_dep_state())
        from dataclasses import replace
        ebb2 = make_header(ebb, 0, (), issuer=0)
        ebb2 = replace(ebb2, block_no=ebb.block_no, _cache={})
        ebb2 = ebb2.with_fields(ebb=1)
        with pytest.raises(HeaderEnvelopeError, match="slot"):
            validate_envelope(ebb2, st, protocol)

    def test_ebb_off_boundary_slot_rejected(self):
        """canBeEBB: ByronPBft rejects EBBs away from epoch boundaries."""
        protocol = ByronPBft(2, epoch_length=100)
        from ouroboros_tpu_torch.eras.byron import _EBB_BODY_HASH  # noqa
        hdr = make_header(None, 7, (), issuer=0).with_fields(ebb=1)
        with pytest.raises(ProtocolError, match="boundary"):
            protocol.sequential_checks((), hdr,
                                       None)  # view unused for EBBs

    def test_ebb_successor_may_share_slot(self):
        """minimumNextSlotNo: the real block of the EBB's slot is forgeable."""
        protocol = ByronPBft(2)
        ebb = make_ebb(None, 0, protocol.epoch_length)
        st = HeaderState(ann_tip_of(ebb),
                         protocol.initial_chain_dep_state())
        assert st.tip.is_ebb
        blk = make_header(ebb, 0, (), issuer=0)
        validate_envelope(blk, st, protocol)      # same slot: allowed
        # a NON-EBB tip still forces strict slot increase
        st2 = HeaderState(ann_tip_of(blk), protocol.initial_chain_dep_state())
        nxt = make_header(blk, 0, (), issuer=1)
        with pytest.raises(HeaderEnvelopeError, match="slot"):
            validate_envelope(nxt, st2, protocol)


# ---------------------------------------------------------------------------
# OCert issue-number upper bound
# ---------------------------------------------------------------------------

class TestOcertCounterBound:
    def test_counter_jump_rejected(self):
        protocol, ledger, pools = shelley_genesis_setup(1, CFG)
        pool = pools[0]
        keys = pool["keys"]
        state = protocol.initial_chain_dep_state()
        view = ledger.ledger_view(ledger.initial_state())
        # forge a header whose OCert counter jumps to 5 (current is -1)
        from ouroboros_tpu_torch.crypto import kes as kes_mod
        kes_key = kes_mod.KesSignKey(CFG.kes_depth, keys.kes_seed)
        ocert = make_ocert(keys.cold_sk, kes_key.verification_key,
                           counter=5, kes_period_start=0)
        from ouroboros_tpu_torch.eras.shelley import (
            ETA_VRF_FIELD, ISSUER_FIELD, LEADER_VRF_FIELD, OCERT_FIELD,
        )
        hdr = make_header(None, 1, (), issuer=0).with_fields(**{
            ISSUER_FIELD: keys.cold_vk,
            OCERT_FIELD: ocert.to_bytes(),
            ETA_VRF_FIELD: b"\x00" * 80,
            LEADER_VRF_FIELD: b"\x00" * 80,
            "tp_kes_sig": b"\x00" * 32,
        })
        with pytest.raises(ProtocolError, match="jumps"):
            protocol.sequential_checks(state, hdr, view)

    def test_first_ocert_counter_one_accepted(self):
        """A pool with no recorded counter defaults to m=0, so its first
        OCert may carry issue number 0 or 1 (reference currentIssueNo)."""
        protocol, ledger, pools = shelley_genesis_setup(1, CFG)
        keys = pools[0]["keys"]
        state = protocol.initial_chain_dep_state()
        view = ledger.ledger_view(ledger.initial_state())
        from ouroboros_tpu_torch.crypto import kes as kes_mod
        kes_key = kes_mod.KesSignKey(CFG.kes_depth, keys.kes_seed)
        from ouroboros_tpu_torch.eras.shelley import (
            ETA_VRF_FIELD, ISSUER_FIELD, LEADER_VRF_FIELD, OCERT_FIELD,
        )
        ocert = make_ocert(keys.cold_sk, kes_key.verification_key,
                           counter=1, kes_period_start=0)
        hdr = make_header(None, 1, (), issuer=0).with_fields(**{
            ISSUER_FIELD: keys.cold_vk,
            OCERT_FIELD: ocert.to_bytes(),
            ETA_VRF_FIELD: b"\x00" * 80,
            LEADER_VRF_FIELD: b"\x00" * 80,
            "tp_kes_sig": b"\x00" * 32,
        })
        protocol.sequential_checks(state, hdr, view)  # must not raise
