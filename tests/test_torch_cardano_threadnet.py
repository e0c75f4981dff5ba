"""Cross-era ThreadNet on the port, with REAL era protocols: a network of
full nodes running Byron PBFT crosses the ledger-decided fork into
Shelley TPraos mid-run.

The cases of tests/test_cardano_threadnet.py on `ouroboros_tpu_torch`,
every node on the port's CppBackend (the reference's OpensslBackend).
The network, its nodes and its ExtLedgerState codec are chip_smoke.py's
(`cardano_port`, `cardano_network`), which its conformance phase runs on
the card; driven with the JAX package's own test module in the port's
place, the same code gives the reference's network, and both must agree
node by node: block hashes, era tags and the encoded final
ExtLedgerState.  Tolerance: none.

Reference: ouroboros-consensus-cardano-test/test/Test/ThreadNet/Cardano.hs
— the crown-jewel cross-era integration test (SURVEY.md §4.1), here over
eras/cardano.py's composition instead of mock protocols.
"""
import importlib

import pytest

import chip_smoke as CS
from ouroboros_tpu_torch.consensus.hardfork.combinator import ERA_FIELD
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.eras.cardano import (
    ALLEGRA, BYRON, MARY, SHELLEY, cardano_setup,
)

N_NODES = CS.CARDANO_NET_NODES
EPOCH = CS.CARDANO_NET_EPOCH
FORK_EPOCH = CS.CARDANO_NET_FORK      # Byron ends at slot 20
BACKEND = CppBackend()
PORT = CS.cardano_port(BACKEND)


def test_real_era_network_crosses_fork():
    results = CS.cardano_network(PORT)
    for chain, imm_tags, ext, _imm in results:
        tags = imm_tags + [b.header.get(ERA_FIELD) for b in chain.blocks]
        assert BYRON in tags, "no Byron blocks"
        assert SHELLEY in tags, "network never crossed the fork"
        assert tags == sorted(tags), f"era tags not monotone: {tags}"
        assert ext.ledger.era == SHELLEY
        assert ext.ledger.transitions == (FORK_EPOCH,)
        s_slots = [b.slot for b in chain.blocks
                   if b.header.get(ERA_FIELD) == SHELLEY]
        assert all(s >= FORK_EPOCH * EPOCH for s in s_slots)
    heads = [r[0].head_block_no for r in results]
    assert max(heads) - min(heads) <= 2
    assert min(heads) >= 10
    assert CS.cardano_checks(results, False) == []


def test_era_ladder_crosses_three_boundaries():
    """Byron -> Shelley -> Allegra -> Mary in ONE run: the reference's
    4-era composition (Cardano/Block.hs:161-186) with the intra-Shelley
    hops at configured epochs (TriggerHardForkAtEpoch).  Every node must
    converge with monotone era tags and end inside Mary."""
    allegra_epoch, mary_epoch = FORK_EPOCH + 1, FORK_EPOCH + 2
    eras, _rules, _nodes = cardano_setup(
        N_NODES, epoch_length=EPOCH,
        allegra_epoch=allegra_epoch, mary_epoch=mary_epoch)
    assert [e.name for e in eras] == ["byron", "shelley", "allegra", "mary"]
    results = CS.cardano_network(PORT, ladder=True)
    for chain, imm_tags, ext, _imm in results:
        tags = imm_tags + [b.header.get(ERA_FIELD) for b in chain.blocks]
        for era in (BYRON, SHELLEY, ALLEGRA, MARY):
            assert era in tags, f"no blocks in era {era}: {tags}"
        assert tags == sorted(tags), f"era tags not monotone: {tags}"
        assert ext.ledger.era == MARY
        assert ext.ledger.transitions == (FORK_EPOCH, allegra_epoch,
                                          mary_epoch)
    heads = [r[0].head_block_no for r in results]
    assert max(heads) - min(heads) <= 2
    assert CS.cardano_checks(results, True) == []


def test_era_feature_gating_in_ladder():
    """A Mary-only mint tx must be REJECTED by the Allegra-era rules and
    accepted once the ladder reaches Mary (the per-pair translations +
    feature gates of CanHardFork.hs:365-422)."""
    from ouroboros_tpu_torch.consensus.ledger import LedgerError
    from ouroboros_tpu_torch.eras.shelley import make_shelley_tx, pool_id_of
    eras, rules, nodes = cardano_setup(
        2, epoch_length=EPOCH, allegra_epoch=FORK_EPOCH + 1,
        mary_epoch=FORK_EPOCH + 2)
    allegra_rules = eras[ALLEGRA].ledger
    mary_rules = eras[MARY].ledger
    addr = nodes[0]["addr"]
    sk = nodes[0]["keys"].addr_sk
    aid = pool_id_of(addr)
    # a ledger state inside the Shelley family with the genesis funds
    st = eras[SHELLEY].ledger.initial_state()
    entry = next(u for u in st.utxo if u[2] == addr)
    mint_tx = make_shelley_tx(
        inputs=[(entry[0], entry[1])],
        outputs=[(addr, entry[3] - 1), (addr, 1, ((aid, 5),))],
        certs=[], signing_keys=[sk], mint=[(aid, 5)])
    with pytest.raises(LedgerError, match="multi-asset"):
        allegra_rules.apply_tx(st, mint_tx, backend=BACKEND)
    out = mary_rules.apply_tx(st, mint_tx, backend=BACKEND)
    assert any(u[4] for u in out.utxo), "minted asset missing from UTxO"
    # and a validity-interval tx needs Allegra+: Shelley rejects it
    val_tx = make_shelley_tx(
        inputs=[(entry[0], entry[1])], outputs=[(addr, entry[3])],
        certs=[], signing_keys=[sk], validity=(-1, 10_000))
    with pytest.raises(LedgerError, match="validity"):
        eras[SHELLEY].ledger.apply_tx(st, val_tx, backend=BACKEND)
    allegra_rules.apply_tx(st, val_tx, backend=BACKEND)


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("ladder", [False, True], ids=["fork", "ladder"])
def test_network_equals_the_jax_packages(ladder):
    """The same network in both packages at the same seed: every node's
    block hashes, era tags and encoded final ExtLedgerState equal
    (tests/test_cardano_threadnet.py's own nodes and `_enc_state` on the
    JAX side)."""
    ref = importlib.import_module("test_cardano_threadnet")
    ours = CS.cardano_digest(PORT, CS.cardano_network(PORT, ladder))
    theirs = CS.cardano_digest(ref, CS.cardano_network(ref, ladder))
    assert ours == theirs
