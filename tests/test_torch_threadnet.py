"""The port's ThreadNet (`ouroboros_tpu_torch.testing`): multi-node
mock-Praos networks of NodeKernels in the port's simulator.  The cases of
tests/test_threadnet.py, run against the port's copy; and one Praos
ThreadNet (3 nodes, 30 slots, k = 10) run by both packages on their
OpensslBackend and by the port on `TorchBackend(device="cpu")`, whose
final chains, ledgers (`PraosNetworkFactory.enc_state` CBOR bytes), every
ChainSync flush's size in order and every node's sequence of adopted tips
must be equal.

Reference: ouroboros-consensus-test's Test/ThreadNet/General.hs
(`prop_general`), instantiated for mock Praos.

Tolerance: none.  Points, bytes and sizes compare exactly.
"""
import importlib

import pytest

from ouroboros_tpu_torch.ledgers import TxIn, TxOut, make_tx
from ouroboros_tpu_torch.ledgers.mock import MockLedger
from ouroboros_tpu_torch.testing import ThreadNetConfig, run_threadnet


def _no_failures(result):
    assert not result.failures, f"thread failures: {result.failures}"


def test_two_nodes_converge():
    cfg = ThreadNetConfig(n_nodes=2, n_slots=20, k=10, f=0.5, seed=1)
    res = run_threadnet(cfg)
    _no_failures(res)
    assert res.min_length() >= 3, "chain did not grow"
    assert res.common_prefix_ok(cfg.k)
    # quiet network: only end-of-run slot battles may diverge
    assert res.max_fork_depth() <= 3, f"fork too deep: {res.max_fork_depth()}"


def test_three_nodes_mesh_converge():
    cfg = ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.6, seed=2)
    res = run_threadnet(cfg)
    _no_failures(res)
    assert res.min_length() >= 5
    assert res.common_prefix_ok(cfg.k)
    assert res.max_fork_depth() <= 4, f"fork too deep: {res.max_fork_depth()}"


def test_late_join_syncs():
    """A node joining mid-run must sync the existing chain (the node-join
    plan machinery, Util/NodeJoinPlan.hs)."""
    cfg = ThreadNetConfig(n_nodes=3, n_slots=40, k=20, f=0.5, seed=3,
                          join_slots=[0, 0, 20])
    res = run_threadnet(cfg)
    _no_failures(res)
    assert res.common_prefix_ok(cfg.k)
    late = res.chains[2]
    assert late.head_block_no >= 3, "late joiner did not sync"
    assert res.max_fork_depth() <= 4, f"fork too deep: {res.max_fork_depth()}"


def test_ring_topology_converges():
    cfg = ThreadNetConfig(n_nodes=4, n_slots=40, k=20, f=0.5, seed=4,
                          topology="ring")
    res = run_threadnet(cfg)
    _no_failures(res)
    assert res.common_prefix_ok(cfg.k)
    assert res.max_fork_depth() <= 4, f"fork too deep: {res.max_fork_depth()}"


def test_txs_diffuse_and_land_in_blocks():
    """A tx submitted at one node reaches others via TxSubmission and ends
    up in a forged block, mutating every node's final UTxO."""
    def tx_factory(keys, ledger_state):
        # spend node 0's genesis output to node 1
        utxo = ledger_state.utxo_dict()
        gen = MockLedger.GENESIS_TXID
        for (txid, ix), (addr, amount) in sorted(utxo.items()):
            if txid == gen and addr == keys[0].payment_vk:
                return make_tx([TxIn(txid, ix)],
                               [TxOut(keys[1].payment_vk, amount)],
                               [keys[0].payment_sk])
        raise AssertionError("genesis output for node 0 not found")

    cfg = ThreadNetConfig(n_nodes=3, n_slots=40, k=20, f=0.5, seed=5,
                          tx_plan=((5, 0, tx_factory),))
    res = run_threadnet(cfg)
    _no_failures(res)
    assert res.max_fork_depth() <= 4
    for ext in res.ledgers:
        utxo = ext.ledger.utxo_dict()
        owners = [addr for (_txid, _ix), (addr, _amt) in utxo.items()]
        # node 0's genesis coin moved to node 1
        assert owners.count(res.keys[1].payment_vk) == 2
        assert owners.count(res.keys[0].payment_vk) == 0


def test_determinism_same_seed_same_chains():
    cfg = ThreadNetConfig(n_nodes=3, n_slots=20, k=10, f=0.6, seed=7)
    r1 = run_threadnet(cfg)
    r2 = run_threadnet(cfg)
    assert [c.head_point for c in r1.chains] == \
           [c.head_point for c in r2.chains]


# -- the same network in both packages ----------------------------------------

def _traced_threadnet(pkg: str, backend=None) -> dict:
    """run_threadnet(3 nodes, 30 slots, k = 10) in package `pkg`, with
    every ChainSync flush's size and every node's adopted tips recorded;
    `backend` (a callable) replaces the factory's OpensslBackend."""
    tn = importlib.import_module(f"{pkg}.testing.threadnet")
    cs = importlib.import_module(f"{pkg}.node.chain_sync")
    cbor = importlib.import_module(f"{pkg}.utils.cbor")
    flushes, tips = [], {}
    real_batched = cs.validate_headers_batched
    real_make = tn.PraosNetworkFactory.make_node
    real_backend = tn.OpensslBackend

    def batched(protocol, headers, *a, **kw):
        flushes.append(len(headers))
        return real_batched(protocol, headers, *a, **kw)

    def make_node(self, i, fs=None, label=None):
        kern = real_make(self, i, fs=fs, label=label)
        seen = tips.setdefault(kern.label, [])
        db = kern.chain_db
        db.on_change(lambda: seen.append(db.tip_point().encode()))
        return kern

    cs.validate_headers_batched = batched
    tn.PraosNetworkFactory.make_node = make_node
    if backend is not None:
        tn.OpensslBackend = backend
    try:
        res = tn.run_threadnet(tn.ThreadNetConfig(n_nodes=3, n_slots=30,
                                                  k=10))
    finally:
        cs.validate_headers_batched = real_batched
        tn.PraosNetworkFactory.make_node = real_make
        tn.OpensslBackend = real_backend
    return {
        "failures": [(n, t, repr(e)) for n, t, e in res.failures],
        "chains": [[p.encode() for p in c.points()] for c in res.chains],
        "ledgers": [cbor.dumps(tn.PraosNetworkFactory.enc_state(x))
                    for x in res.ledgers],
        "flushes": flushes, "tips": tips}


@pytest.fixture(scope="module")
def jax_threadnet():
    return _traced_threadnet("ouroboros_tpu")


@pytest.mark.parametrize("which", ["openssl", "torch-cpu"])
def test_threadnet_equals_the_jax_packages(jax_threadnet, which,
                                           monkeypatch):
    backend = None
    if which == "torch-cpu":
        from ouroboros_tpu_torch.crypto import torch_backend
        # the plain forms on the CPU cost a lane each: pad a call to 16
        # lanes, not the card's 128 (padding lanes' verdicts are dropped)
        monkeypatch.setattr(torch_backend, "MIN_BUCKET", 16)
        backend = lambda: torch_backend.TorchBackend(      # noqa: E731
            device="cpu")
    got = _traced_threadnet("ouroboros_tpu_torch", backend)
    want = jax_threadnet
    assert want["failures"] == [] and len(want["flushes"]) > 0
    assert min(len(c) for c in want["chains"]) > 10
    for key in ("failures", "chains", "ledgers", "flushes", "tips"):
        assert got[key] == want[key], key
