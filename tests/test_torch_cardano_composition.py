"""Byron->Shelley composition on the port: the cases of
tests/test_cardano_composition.py on `ouroboros_tpu_torch` (CppBackend
where the reference used OpensslBackend), then the forged cross-era
chain's block bytes, era tags and final state, and the pipelined
replay's result, held equal to the JAX package's.  Tolerance: none.

Byron->Shelley composition (eras/cardano.py): translations, the
ledger-decided fork trigger, and a full cross-era replay through the
batched validation driver.

Reference surface: ouroboros-consensus-cardano CanHardFork.hs:365-422
(translations), Cardano/Block.hs:161-186 (era list), and the ThreadNet
Cardano replay shape (BASELINE config #5).
"""
import importlib
import pytest

from ouroboros_tpu_torch.consensus.batch import (
    replay_blocks_pipelined, validate_blocks_batched,
)
from ouroboros_tpu_torch.consensus.hardfork.combinator import ERA_FIELD
from ouroboros_tpu_torch.consensus.headers import ProtocolBlock, make_header
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.eras.byron import (
    CERT_UPDATE, byron_sign_header, make_byron_tx, make_ebb,
)
from ouroboros_tpu_torch.eras.cardano import (
    BYRON, SHELLEY, cardano_block_decode, cardano_setup,
)
from ouroboros_tpu_torch.eras.shelley import (
    forge_tpraos_fields, make_shelley_tx,
)

BACKEND = CppBackend()
EPOCH = 20
FORK_EPOCH = 2                        # Byron ends at slot 40


def forge_cardano_chain(eras, rules, nodes, n_blocks: int,
                        backend=BACKEND):
    """Forge a chain that announces the fork via a Byron update proposal,
    crosses it, and continues under TPraos.  Returns (blocks, final ext
    state)."""
    byron_era, shelley_era = eras
    state = rules.initial_state()
    blocks = []
    prev = None
    slot = 0
    update_sent = False
    while len(blocks) < n_blocks:
        # view at THIS slot: ticking the ledger decides the era crossing
        view = rules.ledger.ledger_view(rules.ledger.tick(state.ledger,
                                                          slot))
        ticked_dep = rules.protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        era_ix = ticked_dep.era
        if era_ix == BYRON:
            protocol = byron_era.protocol
            # EBB at each epoch start (the Byron quirk)
            if slot % EPOCH == 0 and slot > 0:
                ebb = make_ebb(prev, slot // EPOCH, EPOCH)
                ebb = ebb.with_fields(**{ERA_FIELD: BYRON})
                blk = ProtocolBlock(ebb, ())
                state = rules.tick_then_apply(state, blk, backend=backend)
                blocks.append(blk)
                prev = ebb
            leader_ix = protocol.slot_leader(slot)
            node = nodes[leader_ix]
            body = []
            if not update_sent:
                tx = make_byron_tx(
                    inputs=[], outputs=[],
                    certs=[(CERT_UPDATE, FORK_EPOCH.to_bytes(8, "big"),
                            b"")],
                    signing_keys=[node["genesis_sk"]])
                body.append(tx)
                update_sent = True
            hdr = make_header(prev, slot, body, issuer=leader_ix)
            hdr = hdr.with_fields(**{ERA_FIELD: BYRON})
            hdr = byron_sign_header(node["delegate_sk"], hdr)
            blk = ProtocolBlock(hdr, tuple(body))
        else:
            protocol = shelley_era.protocol
            lead = None
            for node in nodes:
                lead = protocol.check_is_leader(
                    node["can_be_leader"], slot, ticked_dep.inner,
                    view.inner)
                if lead is not None:
                    break
            if lead is None:
                slot += 1
                continue
            hdr = make_header(prev, slot, (), issuer=0)
            hdr = hdr.with_fields(**{ERA_FIELD: SHELLEY})
            hdr = forge_tpraos_fields(protocol, node["hot_key"],
                                      node["can_be_leader"], lead, hdr)
            blk = ProtocolBlock(hdr, ())
        state = rules.tick_then_apply(state, blk, backend=backend)
        blocks.append(blk)
        prev = blk.header
        slot += 1
    return blocks, state


@pytest.fixture(scope="module")
def net():
    eras, rules, nodes = cardano_setup(3, epoch_length=EPOCH)
    blocks, state = forge_cardano_chain(eras, rules, nodes, 60)
    return dict(eras=eras, rules=rules, nodes=nodes, blocks=blocks,
                state=state)


class TestCardanoComposition:
    def test_chain_crosses_fork(self, net):
        tags = [b.header.get(ERA_FIELD) for b in net["blocks"]]
        assert BYRON in tags and SHELLEY in tags
        assert tags == sorted(tags), "era tags must be monotone"
        assert net["state"].ledger.era == SHELLEY
        assert net["state"].ledger.transitions == (FORK_EPOCH,)
        # Shelley blocks start at the boundary slot
        s_slots = [b.slot for b in net["blocks"]
                   if b.header.get(ERA_FIELD) == SHELLEY]
        assert min(s_slots) >= FORK_EPOCH * EPOCH

    def test_utxo_crosses_boundary(self, net):
        """The Byron genesis UTxO funds the Shelley stake snapshots."""
        inner = net["state"].ledger.inner
        assert inner.snap_set, "empty stake distribution after the fork"
        total = sum(s for _p, s, _v in inner.snap_set)
        assert total == 3 * 1000

    def test_batched_replay_matches_sequential(self, net):
        rules, blocks = net["rules"], net["blocks"]
        res = validate_blocks_batched(rules, blocks, rules.initial_state(),
                                      backend=BACKEND)
        assert res.all_valid, res.error
        assert (res.final_state.ledger.inner.state_hash()
                == net["state"].ledger.inner.state_hash())

    def test_pipelined_replay_and_backend_parity(self, net):
        rules, blocks = net["rules"], net["blocks"]
        r1 = replay_blocks_pipelined(rules, blocks, rules.initial_state(),
                                     backend=BACKEND, window=16)
        r2 = replay_blocks_pipelined(rules, blocks, rules.initial_state(),
                                     backend=CpuRefBackend(), window=16)
        assert r1.all_valid and r2.all_valid
        assert (r1.final_state.ledger.inner.state_hash()
                == r2.final_state.ledger.inner.state_hash())

    def test_block_decode_roundtrip_dispatches_era(self, net):
        from ouroboros_tpu_torch.utils import cbor
        for b in (net["blocks"][0], net["blocks"][-1]):
            rt = cardano_block_decode(cbor.loads(b.bytes))
            assert rt.hash == b.hash

    def test_shelley_header_in_byron_era_rejected(self, net):
        """A header tagged for the wrong era must fail validation."""
        rules, blocks = net["rules"], net["blocks"]
        first_shelley = next(b for b in blocks
                             if b.header.get(ERA_FIELD) == SHELLEY)
        bad_hdr = first_shelley.header.with_fields(**{ERA_FIELD: BYRON})
        bad = ProtocolBlock(bad_hdr, first_shelley.body)
        ix = blocks.index(first_shelley)
        res = validate_blocks_batched(rules, blocks[:ix] + [bad],
                                      rules.initial_state(),
                                      backend=BACKEND)
        assert not res.all_valid
        assert res.n_valid == ix

    def test_ebb_in_shelley_era_rejected(self, net):
        rules, blocks = net["rules"], net["blocks"]
        # take the last block (Shelley) and try to extend with an EBB
        res = validate_blocks_batched(rules, blocks, rules.initial_state(),
                                      backend=BACKEND)
        tip_hdr = blocks[-1].header
        ebb = make_ebb(tip_hdr, (tip_hdr.slot // EPOCH) + 1, EPOCH)
        ebb = ebb.with_fields(**{ERA_FIELD: SHELLEY})
        res2 = validate_blocks_batched(
            rules, [ProtocolBlock(ebb, ())], res.final_state,
            backend=BACKEND)
        assert not res2.all_valid


# -- parity with the JAX package ------------------------------------------

def _reference_module():
    """tests/test_cardano_composition.py, the JAX package's own cases: its
    forging helper builds the same chain from the same seeds there."""
    return importlib.import_module("test_cardano_composition")


def test_cross_era_chain_equals_the_jax_packages(net):
    ref = _reference_module()
    eras, rules, nodes = ref.cardano_setup(3, epoch_length=ref.EPOCH)
    blocks, state = ref.forge_cardano_chain(eras, rules, nodes, 60)
    assert [b.bytes for b in net["blocks"]] == [b.bytes for b in blocks]
    assert [b.header.get(ERA_FIELD) for b in net["blocks"]] \
        == [b.header.get(ref.ERA_FIELD) for b in blocks]
    ours, theirs = net["state"].ledger, state.ledger
    assert (ours.era, ours.transitions, ours.inner.state_hash()) \
        == (theirs.era, theirs.transitions, theirs.inner.state_hash())
    r = replay_blocks_pipelined(net["rules"], net["blocks"],
                                net["rules"].initial_state(),
                                backend=BACKEND, window=16)
    jr = ref.replay_blocks_pipelined(rules, blocks, rules.initial_state(),
                                     backend=ref.BACKEND, window=16)
    assert (r.all_valid, r.n_valid, r.final_state.ledger.inner.state_hash()) \
        == (jr.all_valid, jr.n_valid,
            jr.final_state.ledger.inner.state_hash())
