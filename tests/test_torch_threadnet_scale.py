"""ThreadNet at scale, node restarts and rekeying on the port: the cases of
tests/test_threadnet_scale.py on `ouroboros_tpu_torch` (CppBackend where
the reference used OpensslBackend; BASELINE config #1 stays `slow`, as in
the reference), then the restart configuration and the mid-run rekey
driven in both packages at the same seeds: equal chains, encoded
ledgers, block bytes and final state.  Tolerance: none.

ThreadNet at scale + node restarts (NodeRestarts.hs analog) + typed
tracer assertions.

- the fast partition runs a 4-node network with a mid-run restart: the
  restarted node recovers from its own on-disk state and catches up
- the `slow` partition runs BASELINE config #1 (10 nodes / 1k slots
  mock-Praos, the nightly-budget scale) with restarts, deterministic per
  seed — `pytest -m slow`
- tracer test: a two-node sync asserts on TYPED decision events
  (fetch requests, chainsync validation, forging, ChainDB adds) instead
  of end-state only (Node/Tracers.hs:51-62 role)
"""
import importlib
import pytest

from ouroboros_tpu_torch.testing import ThreadNetConfig, run_threadnet


def _run(cfg):
    res = run_threadnet(cfg)
    assert not res.failures, res.failures
    return res


class TestRestarts:
    def test_restarted_node_recovers_and_converges(self):
        cfg = ThreadNetConfig(n_nodes=4, n_slots=60, k=8, f=0.5, seed=11,
                              restart_plan=((25, 1), (40, 2)))
        res = _run(cfg)
        assert res.common_prefix_ok(cfg.k)
        assert res.min_length() >= 15     # restarted nodes caught up
        heads = [c.head_block_no for c in res.chains]
        assert max(heads) - min(heads) <= 3

    def test_restart_determinism_per_seed(self):
        cfg = ThreadNetConfig(n_nodes=3, n_slots=40, k=8, f=0.5, seed=5,
                              restart_plan=((20, 0),))
        a = _run(cfg)
        b = _run(cfg)
        assert [c.head_point for c in a.chains] \
            == [c.head_point for c in b.chains]


class TestRekeying:
    """The KES/OCert rekey-on-restart scenario (Test/ThreadNet/Util/
    NodeRestarts.hs + Rekeying.hs analog; VERDICT r4 next-step 8): a pool
    replaces its KES hot key mid-run with a fresh OCert at counter+1.
    Exercises the OCERT issue-number rules nothing else does: m -> m+1
    accepted, jumps past m+1 rejected, stale certificates rejected once
    the chain has recorded the successor."""

    def _setup(self):
        import hashlib
        from dataclasses import replace as dc_replace
        from fractions import Fraction

        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        from ouroboros_tpu_torch.crypto import kes as kes_mod
        from ouroboros_tpu_torch.consensus.protocols.praos import HotKey
        from ouroboros_tpu_torch.eras.shelley import (
            TPraosConfig, make_ocert, shelley_genesis_setup,
        )
        cfg = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=30,
                           slots_per_kes_period=8, kes_depth=4,
                           max_kes_evolutions=14)
        protocol, ledger, pools = shelley_genesis_setup(2, cfg,
                                                        seed=b"rekey")
        return (cfg, protocol, ledger, pools,
                ExtLedgerRules(protocol, ledger),
                hashlib, dc_replace, kes_mod, HotKey, make_ocert)

    def _forge_span(self, protocol, ledger, ext, pools, state, prev,
                    start_slot, n_blocks):
        from ouroboros_tpu_torch.consensus.headers import (
            ProtocolBlock, make_header,
        )
        from ouroboros_tpu_torch.eras.shelley import forge_tpraos_fields
        from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
        blocks = []
        slot = start_slot
        backend = CppBackend()
        while len(blocks) < n_blocks:
            view = ledger.forecast_view(state.ledger, slot)
            ticked = protocol.tick_chain_dep_state(
                state.header.chain_dep_state, view, slot)
            for p in pools:
                lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                                ticked, view)
                if lead is None:
                    continue
                h = make_header(prev, slot, (), issuer=0)
                h = forge_tpraos_fields(protocol, p["hot_key"],
                                        p["can_be_leader"], lead, h)
                blk = ProtocolBlock(h, ())
                state = ext.tick_then_apply(state, blk, backend=backend)
                blocks.append(blk)
                prev = h
                break
            slot += 1
        return blocks, state, prev, slot

    def _rekey(self, cfg, pools, ix, at_slot, counter, hashlib, dc_replace,
               kes_mod, HotKey, make_ocert):
        """Issue pool ix a fresh KES key + OCert at the given counter."""
        p = pools[ix]
        new_seed = hashlib.blake2b(b"rekey-seed:%d:%d" % (ix, counter),
                                   digest_size=32).digest()
        new_key = kes_mod.KesSignKey(cfg.kes_depth, new_seed)
        period = at_slot // cfg.slots_per_kes_period
        ocert = make_ocert(p["keys"].cold_sk, new_key.verification_key,
                           counter=counter, kes_period_start=period)
        pools[ix] = dict(p, hot_key=HotKey(new_key),
                         can_be_leader=dc_replace(p["can_be_leader"],
                                                  ocert=ocert))

    def test_midrun_rekey_chain_validates_and_counter_advances(self):
        from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
        from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
        (cfg, protocol, ledger, pools, ext,
         hashlib, dc_replace, kes_mod, HotKey, make_ocert) = self._setup()
        b1, state, prev, slot = self._forge_span(
            protocol, ledger, ext, pools, ext.initial_state(), None, 0, 12)
        self._rekey(cfg, pools, 0, slot, counter=1, hashlib=hashlib,
                    dc_replace=dc_replace, kes_mod=kes_mod, HotKey=HotKey,
                    make_ocert=make_ocert)
        b2, state, _prev, _slot = self._forge_span(
            protocol, ledger, ext, pools, state, prev, slot, 12)
        # full replay from genesis across the rekey boundary
        res = validate_blocks_batched(ext, b1 + b2, ext.initial_state(),
                                      backend=CppBackend())
        assert res.all_valid, res.error
        dep = res.final_state.header.chain_dep_state
        pid = pools[0]["can_be_leader"].pool_id
        assert dep.counter_of(pid) == 1          # the new issue number
        # the new hot key actually signed blocks in the second span
        new_kes_vk = pools[0]["can_be_leader"].ocert.kes_vk
        from ouroboros_tpu_torch.eras.shelley import OCERT_FIELD, OCert
        signed_by_new = [
            blk for blk in b2
            if OCert.from_bytes(blk.header.get(OCERT_FIELD)).kes_vk
            == new_kes_vk]
        assert signed_by_new, "pool 0 never led after the rekey"

    def test_rekey_counter_jump_rejected(self):
        from ouroboros_tpu_torch.consensus.header_validation import HeaderError
        (cfg, protocol, ledger, pools, ext,
         hashlib, dc_replace, kes_mod, HotKey, make_ocert) = self._setup()
        _b1, state, prev, slot = self._forge_span(
            protocol, ledger, ext, pools, ext.initial_state(), None, 0, 6)
        # counter 0 -> 2 skips an issue number: OCERT rule must reject
        self._rekey(cfg, pools, 0, slot, counter=2, hashlib=hashlib,
                    dc_replace=dc_replace, kes_mod=kes_mod, HotKey=HotKey,
                    make_ocert=make_ocert)
        with pytest.raises(HeaderError, match="jumps past"):
            self._forge_span(protocol, ledger, ext, [pools[0]], state,
                             prev, slot, 1)

    def test_stale_ocert_after_rekey_rejected(self):
        from ouroboros_tpu_torch.consensus.header_validation import HeaderError
        (cfg, protocol, ledger, pools, ext,
         hashlib, dc_replace, kes_mod, HotKey, make_ocert) = self._setup()
        import copy
        stale = dict(pools[0])            # keeps the counter-0 ocert
        stale["hot_key"] = copy.deepcopy(pools[0]["hot_key"])
        _b1, state, prev, slot = self._forge_span(
            protocol, ledger, ext, pools, ext.initial_state(), None, 0, 6)
        self._rekey(cfg, pools, 0, slot, counter=1, hashlib=hashlib,
                    dc_replace=dc_replace, kes_mod=kes_mod, HotKey=HotKey,
                    make_ocert=make_ocert)
        # advance until the REKEYED pool 0 has signed (counter 1 recorded)
        pid = pools[0]["can_be_leader"].pool_id
        while state.header.chain_dep_state.counter_of(pid) != 1:
            b, state, prev, slot = self._forge_span(
                protocol, ledger, ext, pools, state, prev, slot, 1)
        # the stale counter-0 certificate is now a regression
        with pytest.raises(HeaderError, match="regressed"):
            self._forge_span(protocol, ledger, ext, [stale], state,
                             prev, slot, 1)


@pytest.mark.slow
class TestBaselineScale:
    def test_ten_nodes_thousand_slots_with_restarts(self):
        """BASELINE config #1: 10 nodes / 1k slots mock-Praos, plus two
        mid-run restarts — convergence, bounded forks, chain growth."""
        cfg = ThreadNetConfig(n_nodes=10, n_slots=1000, k=50, f=0.5,
                              seed=42, topology="ring",
                              chain_sync_window=16,
                              restart_plan=((300, 3), (600, 7)))
        res = _run(cfg)
        assert res.common_prefix_ok(cfg.k)
        assert res.max_fork_depth() <= 3
        # chain growth: ~f*n_slots blocks expected; allow generous slack
        assert res.min_length() >= 300
        heads = [c.head_block_no for c in res.chains]
        assert max(heads) - min(heads) <= 3


class TestTypedTracers:
    def test_two_node_sync_emits_decision_events(self):
        from ouroboros_tpu_torch import simharness as sim
        from ouroboros_tpu_torch.node import connect_nodes
        from ouroboros_tpu_torch.testing.threadnet import PraosNetworkFactory
        from ouroboros_tpu_torch.utils.tracer import (
            NodeTracers, Tracer, TraceAddBlock, TraceChainSyncEvent,
            TraceFetchDecision, TraceForgeEvent, collecting,
        )
        cfg = ThreadNetConfig(n_nodes=2, n_slots=20, k=8, f=0.7, seed=3)
        factory = PraosNetworkFactory(cfg)

        async def main():
            forge_tr, forge_ev = collecting()
            fetch_tr, fetch_ev = collecting()
            cs_tr, cs_ev = collecting()
            db_tr, db_ev = collecting()
            a = factory.make_node(0)
            a.tracers = NodeTracers(forge=forge_tr)
            b = factory.make_node(1)
            b.tracers = NodeTracers(fetch=fetch_tr, chain_sync=cs_tr)
            b.chain_db.tracer = db_tr
            # node 1 does NOT forge: it must sync everything from node 0
            b.forgings = []
            a.start()
            b.start()
            connect_nodes(a, b, delay=0.02)
            await sim.sleep(cfg.n_slots * 1.0 + 2.0)
            out = (forge_ev, fetch_ev, cs_ev, db_ev,
                   a.chain_db.tip_point(), b.chain_db.tip_point())
            a.stop()
            b.stop()
            return out

        forge_ev, fetch_ev, cs_ev, db_ev, tip_a, tip_b = sim.run(
            main(), seed=9)
        assert tip_b == tip_a and tip_a.slot > 0
        # the forger traced its forges
        assert forge_ev and all(isinstance(e, TraceForgeEvent)
                                and e.outcome == "forged"
                                for e in forge_ev)
        # the syncing node traced chainsync validation batches ...
        assert cs_ev and all(isinstance(e, TraceChainSyncEvent)
                             for e in cs_ev)
        assert sum(e.n for e in cs_ev) >= len(forge_ev)
        # ... fetch decisions with real request sizes ...
        assert fetch_ev and all(isinstance(e, TraceFetchDecision)
                                and e.n_requested >= 1
                                for e in fetch_ev)
        # ... and ChainDB add events for every adopted block
        adds = [e for e in db_ev if isinstance(e, TraceAddBlock)]
        assert adds and {e.kind for e in adds} <= {
            "extended", "switched", "stored", "duplicate"}
        assert sum(1 for e in adds if e.kind in ("extended", "switched")) \
            >= 1


# -- parity with the JAX package ------------------------------------------

def _reference_module():
    """tests/test_threadnet_scale.py, the JAX package's own cases."""
    return importlib.import_module("test_threadnet_scale")


def test_restart_configuration_equals_the_jax_packages():
    from ouroboros_tpu.testing import ThreadNetConfig as JaxConfig
    from ouroboros_tpu.testing import run_threadnet as jax_run
    from ouroboros_tpu.testing.threadnet import PraosNetworkFactory as JaxF
    from ouroboros_tpu.utils import cbor as jcbor
    from ouroboros_tpu_torch.testing.threadnet import PraosNetworkFactory
    from ouroboros_tpu_torch.utils import cbor
    kw = dict(n_nodes=4, n_slots=60, k=8, f=0.5, seed=11,
              restart_plan=((25, 1), (40, 2)))
    ours, theirs = _run(ThreadNetConfig(**kw)), jax_run(JaxConfig(**kw))
    assert not theirs.failures
    assert [[p.encode() for p in c.points()] for c in ours.chains] \
        == [[p.encode() for p in c.points()] for c in theirs.chains]
    assert [cbor.dumps(PraosNetworkFactory.enc_state(x))
            for x in ours.ledgers] \
        == [jcbor.dumps(JaxF.enc_state(x)) for x in theirs.ledgers]


def _rekey_run(case) -> dict:
    """The mid-run rekey of TestRekeying on `case`'s helpers (this
    module's class or the reference's): its blocks, the replay's verdict,
    final state_hash and recorded counter."""
    (cfg, protocol, ledger, pools, ext,
     hashlib, dc_replace, kes_mod, HotKey, make_ocert) = case._setup()
    b1, state, prev, slot = case._forge_span(
        protocol, ledger, ext, pools, ext.initial_state(), None, 0, 12)
    case._rekey(cfg, pools, 0, slot, counter=1, hashlib=hashlib,
                dc_replace=dc_replace, kes_mod=kes_mod, HotKey=HotKey,
                make_ocert=make_ocert)
    b2, state, _prev, _slot = case._forge_span(
        protocol, ledger, ext, pools, state, prev, slot, 12)
    pid = pools[0]["can_be_leader"].pool_id
    return {"blocks": [b.bytes for b in b1 + b2],
            "state_hash": state.ledger.state_hash(),
            "counter": state.header.chain_dep_state.counter_of(pid)}


def test_midrun_rekey_equals_the_jax_packages():
    ours = _rekey_run(TestRekeying())
    assert ours == _rekey_run(_reference_module().TestRekeying())
    assert ours["counter"] == 1
