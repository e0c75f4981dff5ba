"""Shelley ledger depth on the port: the cases of tests/test_shelley_depth.py
on `ouroboros_tpu_torch` (CppBackend where the reference used
OpensslBackend), then the 60-block chain with its rewards, pots and
snapshots held equal to the JAX package's.  Tolerance: none.

Shelley ledger depth (the four former round-2 simplifications):
mark->set->go snapshots, reserves/treasury rewards + exact-balance
withdrawals, the pool-retirement queue, and the full TICKN nonce rule —
each exercised against the independent dual-ledger spec oracle.

Reference rules being modeled: SNAP / RUPD / WDRL / POOLREAP / TICKN of
the Shelley spec reached through applyLedgerBlock = SL.applyBlock
(Shelley/Ledger/Ledger.hs:238-284) and updateChainDepState
(Shelley/Protocol.hs:433-442).
"""
import importlib
from fractions import Fraction

import pytest

from ouroboros_tpu_torch.consensus.headers import ProtocolBlock, make_header
from ouroboros_tpu_torch.consensus.ledger import LedgerError
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.eras.shelley import (
    CERT_RETIRE, TPraosConfig, forge_tpraos_fields, make_shelley_tx,
    pool_id_of, shelley_genesis_setup,
)
from ouroboros_tpu_torch.testing.dual import DualLedgerMismatch, dual_shelley

CFG = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=20,
                   slots_per_kes_period=20, kes_depth=6,
                   max_kes_evolutions=62)
BACKEND = CppBackend()
GEN = b"\x00" * 32


def _forge_chain(n_blocks, pools, protocol, ledger, ext, body_for=None):
    """Forge a valid TPraos chain, returning (blocks, final_ext_state)."""
    state = ext.initial_state()
    blocks, prev, slot = [], None, 0
    while len(blocks) < n_blocks:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        lead = pool = None
        for pool in pools:
            lead = protocol.check_is_leader(pool["can_be_leader"], slot,
                                            ticked, view)
            if lead is not None:
                break
        if lead is None:
            slot += 1
            continue
        body = tuple(body_for(len(blocks), state) if body_for else ())
        h = make_header(prev, slot, body, issuer=0)
        h = forge_tpraos_fields(protocol, pool["hot_key"],
                                pool["can_be_leader"], lead, h)
        blk = ProtocolBlock(h, body)
        state = ext.tick_then_apply(state, blk, backend=BACKEND)
        blocks.append(blk)
        prev = h
        slot += 1
    return blocks, state


class TestRewardsAndSnapshots:
    def test_rewards_accrue_and_pots_conserve(self):
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"rw")
        ext = ExtLedgerRules(protocol, ledger)
        blocks, final = _forge_chain(60, pools, protocol, ledger, ext)
        st = final.ledger
        # crossed several epochs: 3-deep snapshots populated + rewards paid
        assert st.epoch >= 2
        assert st.snap_go and st.snap_set and st.snap_mark
        assert st.rewards, "no rewards accrued after epoch crossings"
        assert st.treasury > 0
        # conservation: reserves + treasury + rewards == initial reserves
        total = (st.reserves + st.treasury
                 + sum(a for _p, a in st.rewards))
        assert total == ledger.initial_reserves
        # per-epoch block production resets: the counts cover exactly the
        # blocks forged since the last epoch boundary
        epoch_start = st.epoch * CFG.epoch_length
        in_epoch = sum(1 for b in blocks if b.slot >= epoch_start)
        assert sum(n for _p, n in st.blocks_made) == in_epoch

    def test_dual_oracle_agrees_across_epochs(self):
        protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"rw")
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        ext = ExtLedgerRules(protocol, ledger)
        blocks, _final = _forge_chain(60, pools, protocol, ledger, ext)
        dual = dual_shelley(
            ledger.genesis, CFG, ledger.initial_pools,
            ledger.initial_delegs,
            initial_reserves=ledger.initial_reserves)
        for b in blocks:
            res = dual.apply_block(b, backend=BACKEND)
            assert res.impl_error is None, res.impl_error
        # the spec recomputed rewards/treasury/snapshots independently and
        # _compare inside apply_block held at every block
        assert dual.spec.rewards
        assert dual.spec.treasury > 0


class TestWithdrawals:
    def _setup_with_rewards(self):
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"wd")
        ext = ExtLedgerRules(protocol, ledger)
        blocks, final = _forge_chain(60, pools, protocol, ledger, ext)
        return protocol, ledger, pools, final.ledger

    def test_exact_balance_withdrawal(self):
        _p, ledger, pools, st = self._setup_with_rewards()
        pool = pools[0]
        pid = pool["keys"].pool_id
        bal = st.reward_of(pid)
        assert bal > 0
        entry = next(u for u in st.utxo if u[2] == pool["addr"])
        tx = make_shelley_tx(
            inputs=[(entry[0], entry[1])],
            outputs=[(pool["addr"], entry[3] + bal)],
            certs=[],
            signing_keys=[pool["keys"].addr_sk, pool["keys"].cold_sk],
            withdrawals=[(pid, bal)])
        out = ledger.apply_tx(st, tx, backend=BACKEND)
        assert out.reward_of(pid) == 0

    def test_wrong_amount_rejected(self):
        _p, ledger, pools, st = self._setup_with_rewards()
        pool = pools[0]
        pid = pool["keys"].pool_id
        bal = st.reward_of(pid)
        entry = next(u for u in st.utxo if u[2] == pool["addr"])
        tx = make_shelley_tx(
            inputs=[(entry[0], entry[1])],
            outputs=[(pool["addr"], entry[3] + bal - 1)],
            certs=[],
            signing_keys=[pool["keys"].addr_sk, pool["keys"].cold_sk],
            withdrawals=[(pid, bal - 1)])
        with pytest.raises(LedgerError, match="withdrawal"):
            ledger.apply_tx(st, tx, backend=BACKEND)

    def test_unwitnessed_withdrawal_rejected(self):
        _p, ledger, pools, st = self._setup_with_rewards()
        pool = pools[0]
        pid = pool["keys"].pool_id
        bal = st.reward_of(pid)
        entry = next(u for u in st.utxo if u[2] == pool["addr"])
        tx = make_shelley_tx(
            inputs=[(entry[0], entry[1])],
            outputs=[(pool["addr"], entry[3] + bal)],
            certs=[], signing_keys=[pool["keys"].addr_sk],  # no cold key
            withdrawals=[(pid, bal)])
        with pytest.raises(LedgerError, match="cold-key"):
            ledger.apply_tx(st, tx, backend=BACKEND)


class TestRetirement:
    def test_pool_retires_at_epoch_and_leaves_election(self):
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"rt")
        ext = ExtLedgerRules(protocol, ledger)
        st = ledger.initial_state()
        pool = pools[1]
        pid = pool["keys"].pool_id
        entry = next(u for u in st.utxo if u[2] == pool["addr"])
        retire_tx = make_shelley_tx(
            inputs=[(entry[0], entry[1])],
            outputs=[(pool["addr"], entry[3])],
            certs=[(CERT_RETIRE, pool["keys"].cold_vk,
                    (2).to_bytes(8, "big"))],
            signing_keys=[pool["keys"].addr_sk, pool["keys"].cold_sk])
        st = ledger.apply_tx(st, retire_tx, backend=BACKEND)
        assert dict(st.retiring)[pid] == 2
        # ticking into epoch 2 removes the pool and its delegations
        st2 = ledger.tick(st, 2 * CFG.epoch_length)
        assert pid not in dict(st2.pools)
        assert all(p != pid for _a, p in st2.delegs)
        assert all(p != pid for p, _e in st2.retiring)

    def test_past_epoch_retirement_rejected(self):
        protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"rt")
        st = ledger.initial_state()
        pool = pools[1]
        entry = next(u for u in st.utxo if u[2] == pool["addr"])
        tx = make_shelley_tx(
            inputs=[(entry[0], entry[1])],
            outputs=[(pool["addr"], entry[3])],
            certs=[(CERT_RETIRE, pool["keys"].cold_vk,
                    (0).to_bytes(8, "big"))],
            signing_keys=[pool["keys"].addr_sk, pool["keys"].cold_sk])
        with pytest.raises(LedgerError, match="retirement epoch"):
            ledger.apply_tx(st, tx, backend=BACKEND)


class TestFullNonceRule:
    def test_eta0_depends_on_last_header_of_prev_epoch(self):
        """Two chains identical except for the final header of epoch 0
        must enter epoch 1 with different active nonces (the eta_ph mix
        of the full TICKN rule)."""
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        protocol, ledger, pools = shelley_genesis_setup(1, CFG, seed=b"nn")
        ext = ExtLedgerRules(protocol, ledger)
        blocks, final = _forge_chain(8, pools, protocol, ledger, ext)
        dep = final.header.chain_dep_state
        boundary = CFG.epoch_length
        t1 = protocol.tick_chain_dep_state(dep, None, boundary)
        # a different last header hash -> different eta0
        from dataclasses import replace
        dep2 = replace(dep, eta_ph=b"\xab" * 32)
        t2 = protocol.tick_chain_dep_state(dep2, None, boundary)
        assert t1.eta0 != t2.eta0
        assert t1.epoch == t2.epoch == 1


# -- parity with the JAX package ------------------------------------------

def _reference_module():
    """tests/test_shelley_depth.py, the JAX package's own cases: its
    forging helper builds the same chain from the same seeds there."""
    return importlib.import_module("test_shelley_depth")


def test_rewards_chain_equals_the_jax_packages():
    from ouroboros_tpu.consensus.ledger import ExtLedgerRules as JaxExt
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    ref = _reference_module()
    protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"rw")
    blocks, final = _forge_chain(60, pools, protocol, ledger,
                                 ExtLedgerRules(protocol, ledger))
    jprotocol, jledger, jpools = ref.shelley_genesis_setup(2, ref.CFG,
                                                           seed=b"rw")
    jblocks, jfinal = ref._forge_chain(60, jpools, jprotocol, jledger,
                                       JaxExt(jprotocol, jledger))
    assert [b.bytes for b in blocks] == [b.bytes for b in jblocks]
    st, jst = final.ledger, jfinal.ledger
    assert st.state_hash() == jst.state_hash()
    assert (st.epoch, st.reserves, st.treasury, st.rewards, st.blocks_made,
            st.snap_mark, st.snap_set, st.snap_go) \
        == (jst.epoch, jst.reserves, jst.treasury, jst.rewards,
            jst.blocks_made, jst.snap_mark, jst.snap_set, jst.snap_go)
