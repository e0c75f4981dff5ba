"""The Shelley-analog era on the port: the cases of tests/test_shelley_era.py
on `ouroboros_tpu_torch` (CppBackend where the reference used
OpensslBackend), then the forged chain's block bytes, the final ledger's
state_hash and the chain-dependent state held equal to the JAX
package's.  Tolerance: none.

Shelley-analog era: TPraos + stake-pool ledger.

Reference test surface: ouroboros-consensus-shelley-test (ThreadNet Shelley,
protocol golden/unit tests) — here: fixed-point leader-threshold math,
dual-VRF + KES + OCert validation, nonce evolution incl. candidate freezing,
VRF tie-breaking, stake-snapshot delegation pipeline, witness multi-verify,
batch-vs-sequential agreement (SURVEY.md §4, BASELINE configs #2-#4).
"""
import importlib
import math
from fractions import Fraction

import pytest

from ouroboros_tpu_torch.consensus import (
    HeaderState, HeaderError, validate_header, validate_headers_batched,
)
from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
from ouroboros_tpu_torch.consensus.headers import (
    ProtocolBlock, body_hash_of, make_header,
)
from ouroboros_tpu_torch.consensus.ledger import (
    ExtLedgerRules, LedgerError, OutsideForecastRange,
)
from ouroboros_tpu_torch.consensus.protocol import ProtocolError
from ouroboros_tpu_torch.crypto import ed25519_ref, vrf_ref
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.eras import nonintegral as ni
from ouroboros_tpu_torch.eras.shelley import (
    CERT_DELEG, CERT_POOL, KES_FIELD, LEADER_VRF_FIELD, OCERT_FIELD,
    ShelleyLedger, TPraos, TPraosConfig, forge_tpraos_fields, make_ocert,
    make_shelley_tx, pool_id_of, shelley_genesis_setup,
)

BACKEND = CppBackend()

CFG = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=20,
                   slots_per_kes_period=5, kes_depth=4,
                   max_kes_evolutions=14)


# ---------------------------------------------------------------------------
# fixed-point math
# ---------------------------------------------------------------------------

class TestNonIntegral:
    def test_ln_exp_match_float(self):
        for x in (0.01, 0.3, 0.5, 0.9, 1.0, 1.5, 2.0, 10.0):
            fp = ni.from_fraction(Fraction(x).limit_denominator(10 ** 12))
            assert math.isclose(ni.fp_ln(fp) / ni.SCALE, math.log(x),
                                rel_tol=1e-12, abs_tol=1e-12)
        for x in (-5.0, -1.0, -0.25, 0.0, 0.25, 1.0, 4.5):
            fp = ni.from_fraction(Fraction(x).limit_denominator(10 ** 12))
            assert math.isclose(ni.fp_exp(fp) / ni.SCALE, math.exp(x),
                                rel_tol=1e-12)

    def test_leader_check_edges(self):
        f = Fraction(1, 2)
        assert ni.check_leader_value(0, 512, Fraction(1, 3), f)
        assert not ni.check_leader_value((1 << 512) - 1, 512,
                                         Fraction(1, 3), f)
        assert not ni.check_leader_value(0, 512, Fraction(0), f)

    def test_threshold_tracks_phi(self):
        """The accept boundary sits at phi = 1-(1-f)^sigma of the range."""
        f, sigma = Fraction(1, 2), Fraction(1, 3)
        phi = 1 - (1 - 0.5) ** (1 / 3)
        lo = int((phi - 1e-9) * (1 << 512))
        hi = int((phi + 1e-9) * (1 << 512))
        assert ni.check_leader_value(lo, 512, sigma, f)
        assert not ni.check_leader_value(hi, 512, sigma, f)


# ---------------------------------------------------------------------------
# chain forging helper
# ---------------------------------------------------------------------------

def forge_chain(protocol, ledger, pools, n_slots, pending_txs=None,
                backend=BACKEND):
    """Forge + fully validate a chain, returning (blocks, final ext state).
    pending_txs are carried by the first forged block (mempool-style)."""
    pending = list(pending_txs or [])
    ext = ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    blocks, prev = [], None
    for slot in range(n_slots):
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            body = tuple(pending)
            pending.clear()
            h = make_header(prev, slot, body, issuer=0)
            h = forge_tpraos_fields(protocol, p["hot_key"],
                                    p["can_be_leader"], lead, h)
            blk = ProtocolBlock(h, body)
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
    return blocks, state


@pytest.fixture(scope="module")
def net():
    protocol, ledger, pools = shelley_genesis_setup(3, CFG)
    blocks, state = forge_chain(protocol, ledger, pools, 45)
    return dict(protocol=protocol, ledger=ledger, pools=pools,
                blocks=blocks, state=state)


# ---------------------------------------------------------------------------
# protocol validation
# ---------------------------------------------------------------------------

class TestTPraosValidation:
    def test_chain_forges_and_validates(self, net):
        # with f=1/2 and 3 equal pools, ~half the slots have a leader
        assert len(net["blocks"]) >= 10
        slots = [b.slot for b in net["blocks"]]
        assert slots == sorted(slots)
        # crossed at least two epoch boundaries (epoch_length=20, 45 slots)
        assert net["state"].ledger.epoch >= 2

    def test_batched_header_window_matches_sequential(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        headers = [b.header for b in net["blocks"]]
        ext = ExtLedgerRules(protocol, ledger)
        view = ledger.ledger_view(ext.initial_state().ledger)
        res = validate_headers_batched(
            protocol, headers, HeaderState.genesis(protocol),
            lambda i, h: view, backend=BACKEND)
        assert res.all_valid, res.error
        assert res.n_valid == len(headers)
        # final chain-dep state identical to the sequentially-validated one
        seq = net["state"].header.chain_dep_state
        assert res.states[-1].chain_dep_state == seq

    def test_batched_blocks_cpuref_parity(self, net):
        """Full-block batch validation agrees between backends and with the
        sequential fold (bit-exactness of the crypto backends)."""
        protocol, ledger = net["protocol"], net["ledger"]
        ext = ExtLedgerRules(protocol, ledger)
        blocks = net["blocks"][:6]
        res_ssl = validate_blocks_batched(ext, blocks, ext.initial_state(),
                                          backend=BACKEND)
        res_ref = validate_blocks_batched(ext, blocks, ext.initial_state(),
                                          backend=CpuRefBackend())
        assert res_ssl.all_valid and res_ref.all_valid
        assert (res_ssl.final_state.ledger.state_hash()
                == res_ref.final_state.ledger.state_hash())

    def test_tampered_kes_sig_rejected(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        blk = net["blocks"][0]
        sig = blk.header.get(KES_FIELD)
        bad = blk.header.with_fields(
            **{KES_FIELD: sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]})
        st = HeaderState.genesis(protocol)
        view = ledger.ledger_view(ledger.initial_state())
        with pytest.raises(HeaderError):
            validate_header(protocol, view, bad, st, backend=BACKEND)

    def test_tampered_leader_vrf_rejected(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        blk = net["blocks"][0]
        pi = blk.header.get(LEADER_VRF_FIELD)
        bad = blk.header.with_fields(
            **{LEADER_VRF_FIELD: pi[:10] + bytes([pi[10] ^ 1]) + pi[10 + 1:]})
        st = HeaderState.genesis(protocol)
        view = ledger.ledger_view(ledger.initial_state())
        with pytest.raises(HeaderError):
            validate_header(protocol, view, bad, st, backend=BACKEND)

    def test_unregistered_pool_rejected(self, net):
        protocol, ledger = net["protocol"], net["ledger"]
        _p2, _l2, other = shelley_genesis_setup(1, CFG, seed=b"other-net")
        view = ledger.ledger_view(ledger.initial_state())
        st = protocol.initial_chain_dep_state()
        h = make_header(None, 0, (), issuer=0)
        # force-forge with an unregistered pool's keys
        import ouroboros_tpu_torch.crypto.vrf_ref as vrf
        cbl = other[0]["can_be_leader"]
        from ouroboros_tpu_torch.eras.shelley import (
            TPraosIsLeader, _vrf_alpha,
        )
        lead = TPraosIsLeader(
            vrf.prove(cbl.vrf_sk, _vrf_alpha(b"eta", 0, st.eta0)),
            vrf.prove(cbl.vrf_sk, _vrf_alpha(b"leader", 0, st.eta0)))
        h = forge_tpraos_fields(protocol, other[0]["hot_key"], cbl, lead, h)
        with pytest.raises(ProtocolError, match="not in the stake"):
            protocol.sequential_checks(st, h, view)

    def test_non_leader_slot_rejected(self, net):
        """A header whose leader-VRF output is above the threshold fails the
        sequential check even if the proof itself verifies."""
        protocol, ledger, pools = shelley_genesis_setup(3, CFG)
        from ouroboros_tpu_torch.eras.shelley import TPraosIsLeader, _vrf_alpha
        view = ledger.ledger_view(ledger.initial_state())
        st = protocol.initial_chain_dep_state()
        p = pools[0]
        cbl = p["can_be_leader"]
        for slot in range(60):
            if protocol.check_is_leader(cbl, slot, st, view) is None:
                lead = TPraosIsLeader(
                    vrf_ref.prove(cbl.vrf_sk,
                                  _vrf_alpha(b"eta", slot, st.eta0)),
                    vrf_ref.prove(cbl.vrf_sk,
                                  _vrf_alpha(b"leader", slot, st.eta0)))
                h = make_header(None, slot, (), issuer=0)
                h = forge_tpraos_fields(protocol, p["hot_key"], cbl, lead, h)
                with pytest.raises(ProtocolError, match="threshold"):
                    protocol.sequential_checks(st, h, view)
                return
        pytest.fail("pool 0 led every slot — astronomically unlikely")

    def test_ocert_counter_regression_rejected(self, net):
        protocol, ledger, pools = shelley_genesis_setup(3, CFG)
        p = pools[0]
        pid = p["keys"].pool_id
        st = protocol.initial_chain_dep_state().with_counter(pid, 5)
        view = ledger.ledger_view(ledger.initial_state())
        h = None
        from ouroboros_tpu_torch.eras.shelley import TPraosIsLeader, _vrf_alpha
        cbl = p["can_be_leader"]   # ocert counter 0 < recorded 5
        for slot in range(60):
            if protocol.check_is_leader(cbl, slot, st, view) is not None:
                lead = protocol.check_is_leader(cbl, slot, st, view)
                h = make_header(None, slot, (), issuer=0)
                h = forge_tpraos_fields(protocol, p["hot_key"], cbl, lead, h)
                break
        assert h is not None
        with pytest.raises(ProtocolError, match="regressed"):
            protocol.sequential_checks(st, h, view)

    def test_kes_period_outside_ocert_window(self, net):
        protocol, ledger, pools = net["protocol"], net["ledger"], net["pools"]
        view = ledger.ledger_view(ledger.initial_state())
        st = protocol.initial_chain_dep_state()
        # slot far beyond max_kes_evolutions*slots_per_kes_period
        slot = CFG.max_kes_evolutions * CFG.slots_per_kes_period + 5
        p = pools[0]
        h = make_header(None, slot, (), issuer=0)
        h = h.with_fields(**{
            "tp_issuer_vk": p["keys"].cold_vk,
            OCERT_FIELD: p["ocert"].to_bytes(),
            "tp_eta_vrf": b"\x00" * 80,
            LEADER_VRF_FIELD: b"\x00" * 80,
            KES_FIELD: b"\x00" * (64 + CFG.kes_depth * 64),
        })
        with pytest.raises(ProtocolError):
            protocol.sequential_checks(st, h, view)


class TestNonceEvolution:
    def test_eta0_changes_at_epoch_boundary(self, net):
        protocol = net["protocol"]
        st0 = protocol.initial_chain_dep_state()
        st1 = protocol.tick_chain_dep_state(st0, None, CFG.epoch_length)
        assert st1.epoch == 1 and st1.eta0 != st0.eta0
        # ticking within an epoch changes nothing
        assert protocol.tick_chain_dep_state(st0, None, 5) == st0

    def test_candidate_freezes_in_stability_window(self, net):
        protocol, ledger, pools = net["protocol"], net["ledger"], net["pools"]
        # freeze point of epoch 0: 20 - 18 < 0 -> frozen from slot 0 with
        # k=3; use a wider config so the window is meaningful
        cfg = TPraosConfig(k=1, f=Fraction(1, 2), epoch_length=20,
                           slots_per_kes_period=5, kes_depth=4,
                           max_kes_evolutions=14)
        protocol2, ledger2, pools2 = shelley_genesis_setup(3, cfg)
        blocks, _ = forge_chain(protocol2, ledger2, pools2, 20)
        st = HeaderState.genesis(protocol2)
        view = ledger2.ledger_view(ledger2.initial_state())
        freeze = protocol2._freeze_slot(0)     # 20 - 6 = 14
        etas = []
        for b in blocks:
            st = validate_header(protocol2, view, b.header, st,
                                 backend=BACKEND)
            etas.append((b.slot, st.chain_dep_state.eta_v,
                         st.chain_dep_state.eta_c))
        before = [e for e in etas if e[0] < freeze]
        after = [e for e in etas if e[0] >= freeze]
        assert before and after, "need blocks on both sides of the freeze"
        # before the freeze, candidate tracks evolving
        for _s, ev, ec in before:
            assert ev == ec
        # after the freeze, candidate stays put while evolving moves on
        frozen = before[-1][2]
        for _s, ev, ec in after:
            assert ec == frozen
            assert ev != ec


class TestTieBreaking:
    def test_lower_leader_vrf_wins(self, net):
        protocol, ledger, pools = shelley_genesis_setup(3, CFG)
        view = ledger.ledger_view(ledger.initial_state())
        st = protocol.initial_chain_dep_state()
        # find a slot with two leaders
        for slot in range(200):
            leads = [(p, protocol.check_is_leader(p["can_be_leader"], slot,
                                                  st, view))
                     for p in pools]
            leads = [(p, l) for p, l in leads if l is not None]
            if len(leads) >= 2:
                headers = []
                for p, l in leads[:2]:
                    h = make_header(None, slot, (), issuer=0)
                    headers.append(forge_tpraos_fields(
                        protocol, p["hot_key"], p["can_be_leader"], l, h))
                v0 = protocol.select_view(headers[0])
                v1 = protocol.select_view(headers[1])
                assert (protocol.prefer_candidate(v0, v1)
                        == (v1.leader_vrf < v0.leader_vrf))
                assert protocol.prefer_candidate(v0, v1) \
                    != protocol.prefer_candidate(v1, v0)
                return
        pytest.fail("no multi-leader slot found in 200 slots")

    def test_same_issuer_higher_counter_wins(self, net):
        protocol, ledger, pools = shelley_genesis_setup(3, CFG)
        from ouroboros_tpu_torch.eras.shelley import TPraosCanBeLeader
        view = ledger.ledger_view(ledger.initial_state())
        st = protocol.initial_chain_dep_state()
        p = pools[0]
        keys = p["keys"]
        ocert2 = make_ocert(keys.cold_sk,
                            p["ocert"].kes_vk, 1, 0)
        cbl2 = TPraosCanBeLeader(cold_sk=keys.cold_sk, vrf_sk=keys.vrf_sk,
                                 ocert=ocert2)
        for slot in range(100):
            lead = protocol.check_is_leader(p["can_be_leader"], slot, st,
                                            view)
            if lead is not None:
                h = make_header(None, slot, (), issuer=0)
                h1 = forge_tpraos_fields(protocol, p["hot_key"],
                                         p["can_be_leader"], lead, h)
                h2 = forge_tpraos_fields(protocol, p["hot_key"], cbl2, lead, h)
                v1, v2 = protocol.select_view(h1), protocol.select_view(h2)
                assert protocol.prefer_candidate(v1, v2)      # counter 1 > 0
                assert not protocol.prefer_candidate(v2, v1)
                return
        pytest.fail("pool 0 never led")

    def test_longer_chain_always_wins(self, net):
        protocol = net["protocol"]
        blocks = net["blocks"]
        v_short = protocol.select_view(blocks[1].header)
        v_long = protocol.select_view(blocks[2].header)
        assert v_long.block_no > v_short.block_no
        assert protocol.prefer_candidate(v_short, v_long)
        assert not protocol.prefer_candidate(v_long, v_short)


# ---------------------------------------------------------------------------
# ledger: delegation pipeline, witnesses, forecast
# ---------------------------------------------------------------------------

class TestShelleyLedger:
    def test_tx_moves_funds_and_witness_enforced(self, net):
        ledger = net["ledger"]
        pools = net["pools"]
        st = ledger.initial_state()
        owner = pools[0]
        addr = owner["addr"]
        dest = ed25519_ref.public_key(b"\x07" * 32)
        # the genesis utxo entry for this addr
        entry = [u for u in st.utxo if u[2] == addr][0]
        tx = make_shelley_tx([(entry[0], entry[1])], [(dest, entry[3])], [],
                             [owner["keys"].addr_sk])
        st2 = ledger.apply_tx(st, tx, backend=BACKEND)
        assert any(u[2] == dest for u in st2.utxo)
        # unwitnessed spend rejected
        tx_bad = make_shelley_tx([(entry[0], entry[1])],
                                 [(dest, entry[3])], [], [])
        with pytest.raises(LedgerError, match="without a witness"):
            ledger.apply_tx(st, tx_bad, backend=BACKEND)

    def test_delegation_takes_two_epochs(self):
        """Register a new pool + delegate to it: the new pool appears in the
        leader-election view only after two epoch boundaries (mark->set)."""
        protocol, ledger, pools = shelley_genesis_setup(2, CFG)
        st = ledger.initial_state()
        keys = pools[0]["keys"]
        new_cold_sk = b"\x21" * 32
        new_cold_vk = ed25519_ref.public_key(new_cold_sk)
        new_pid = pool_id_of(new_cold_vk)
        new_vrf_vk = vrf_ref.public_key(b"\x22" * 32)
        addr = pools[0]["addr"]
        entry = [u for u in st.utxo if u[2] == addr][0]
        tx = make_shelley_tx(
            [(entry[0], entry[1])], [(addr, entry[3])],
            [(CERT_POOL, new_cold_vk, new_vrf_vk),
             (CERT_DELEG, addr, new_pid)],
            [keys.addr_sk, new_cold_sk])
        blk_body = (tx,)
        h = make_header(None, 0, blk_body, issuer=0)
        blk = ProtocolBlock(h, blk_body)
        ticked = ledger.tick(st, 0)
        st1 = ledger.apply_block(ticked, blk, backend=BACKEND)
        assert dict(st1.pools)[new_pid] == new_vrf_vk
        assert dict(st1.delegs)[addr] == new_pid
        # not yet in the election view...
        assert ledger.ledger_view(st1).get(new_pid) is None
        one = ledger.tick(st1, CFG.epoch_length)          # boundary 1: mark
        assert ledger.ledger_view(one).get(new_pid) is None
        two = ledger.tick(one, 2 * CFG.epoch_length)      # boundary 2: set
        got = ledger.ledger_view(two).get(new_pid)
        assert got is not None and got.vrf_vk == new_vrf_vk

    def test_delegation_to_unregistered_pool_rejected(self, net):
        ledger, pools = net["ledger"], net["pools"]
        st = ledger.initial_state()
        addr = pools[0]["addr"]
        entry = [u for u in st.utxo if u[2] == addr][0]
        tx = make_shelley_tx([(entry[0], entry[1])], [(addr, entry[3])],
                             [(CERT_DELEG, addr, b"\x99" * 28)],
                             [pools[0]["keys"].addr_sk])
        with pytest.raises(LedgerError, match="unregistered"):
            ledger.apply_tx(st, tx, backend=BACKEND)

    def test_forecast_horizon(self, net):
        ledger = net["ledger"]
        st = ledger.initial_state()
        ledger.forecast_view(st, CFG.stability_window - 1)
        with pytest.raises(OutsideForecastRange):
            ledger.forecast_view(st, st.slot + CFG.stability_window + 1)

    def test_state_hash_deterministic_and_replayable(self, net):
        """tick_then_reapply (no crypto) reproduces the applied state —
        the replay path the LedgerDB resume uses."""
        protocol, ledger = net["protocol"], net["ledger"]
        ext = ExtLedgerRules(protocol, ledger)
        st_a = ext.initial_state()
        st_b = ext.initial_state()
        for blk in net["blocks"][:8]:
            st_a = ext.tick_then_apply(st_a, blk, backend=BACKEND)
            st_b = ext.tick_then_reapply(st_b, blk)
        assert st_a.ledger.state_hash() == st_b.ledger.state_hash()
        assert st_a.header.tip_point == st_b.header.tip_point

    def test_txs_in_forged_chain(self, net):
        """Forge a chain that carries a funds-moving tx mid-way."""
        protocol, ledger, pools = shelley_genesis_setup(
            3, CFG, seed=b"txnet")
        st = ledger.initial_state()
        addr = pools[1]["addr"]
        entry = [u for u in st.utxo if u[2] == addr][0]
        dest = ed25519_ref.public_key(b"\x0a" * 32)
        tx = make_shelley_tx([(entry[0], entry[1])], [(dest, entry[3])], [],
                             [pools[1]["keys"].addr_sk])
        blocks, state = forge_chain(protocol, ledger, pools, 10,
                                    pending_txs=[tx])
        carried = [b for b in blocks if b.body]
        assert len(carried) == 1 and carried[0].body[0].txid == tx.txid
        assert any(u[2] == dest for u in state.ledger.utxo)


# -- parity with the JAX package ------------------------------------------

def _reference_module():
    """tests/test_shelley_era.py, the JAX package's own cases: its
    forging helper builds the same chain from the same seeds there."""
    return importlib.import_module("test_shelley_era")


def test_forged_chain_equals_the_jax_packages(net):
    ref = _reference_module()
    protocol, ledger, pools = ref.shelley_genesis_setup(3, ref.CFG)
    blocks, state = ref.forge_chain(protocol, ledger, pools, 45)
    assert [b.bytes for b in net["blocks"]] == [b.bytes for b in blocks]
    assert net["state"].ledger.state_hash() == state.ledger.state_hash()
    ours = net["state"].header.chain_dep_state
    theirs = state.header.chain_dep_state
    assert (ours.epoch, ours.eta0, ours.eta_v, ours.eta_c, ours.counters) \
        == (theirs.epoch, theirs.eta0, theirs.eta_v, theirs.eta_c,
            theirs.counters)
