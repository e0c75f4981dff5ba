"""The port's Shelley replay (`ouroboros_tpu_torch`: consensus/, eras/,
chainsynth.py, replay.py) against the JAX package's.

- Forging: chains forged by both packages are byte-identical block for
  block, with the same reapplied ledger `state_hash`.
- Replays: the chains of tests/test_replay_pipeline.py (valid, a KES
  signature flipped, a block dropped, an OutsideForecastRange stop and
  resume) and a bad witness on a chain with transactions give the JAX
  package's `ReplayResult` (all_valid, n_valid, error class, state_hash)
  through both of the port's drivers: the threaded one on
  `TorchBackend(device="cpu")` (fold=True, the plain PyTorch versions of
  the kernels) and the synchronous one on the port's `CpuRefBackend`.
- Driver semantics (first error wins, the on_window hook, no leaked
  producer, the flight record), mirrored from test_replay_pipeline.py on
  the port's own stub backends.

Tolerance: none.  Bytes, counts, hashes and error classes compare exactly.
"""
import dataclasses
import json
import threading
import time
from fractions import Fraction
from types import SimpleNamespace

import pytest

import ouroboros_tpu.consensus.batch as j_batch
import ouroboros_tpu.consensus.headers as j_headers
import ouroboros_tpu.consensus.ledger as j_ledger
import ouroboros_tpu.crypto.backend as j_backend
import ouroboros_tpu.crypto.kes as j_kes
import ouroboros_tpu.eras.shelley as j_shelley
from ouroboros_tpu_torch import chainsynth, replay
from ouroboros_tpu_torch.consensus import batch as p_batch
from ouroboros_tpu_torch.consensus import headers as p_headers
from ouroboros_tpu_torch.consensus import ledger as p_ledger
from ouroboros_tpu_torch.consensus.batch import replay_blocks_pipelined
from ouroboros_tpu_torch.consensus.header_validation import HeaderError
from ouroboros_tpu_torch.consensus.ledger import (LedgerError,
                                                  OutsideForecastRange)
from ouroboros_tpu_torch.crypto import backend as p_backend
from ouroboros_tpu_torch.crypto import edwards as ed
from ouroboros_tpu_torch.crypto import kes as p_kes
from ouroboros_tpu_torch.crypto.backend import (GLOBAL_BETA_CACHE,
                                                CpuRefBackend,
                                                OpensslBackend,
                                                WindowVerdict)
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.eras import shelley as p_shelley
from ouroboros_tpu_torch.eras.shelley import KES_FIELD
from ouroboros_tpu_torch.observe import metrics as _metrics

JAX = SimpleNamespace(shelley=j_shelley, headers=j_headers, ledger=j_ledger,
                      backend=j_backend, batch=j_batch, kes=j_kes)
PORT = SimpleNamespace(shelley=p_shelley, headers=p_headers,
                       ledger=p_ledger, backend=p_backend, batch=p_batch,
                       kes=p_kes)


def _rp_config(pkg):
    """tests/test_replay_pipeline.py's CFG, in `pkg`'s types."""
    return pkg.shelley.TPraosConfig(
        k=3, f=Fraction(1, 2), epoch_length=20, slots_per_kes_period=5,
        kes_depth=4, max_kes_evolutions=14)


def _forge_rp(pkg, n=24):
    """tests/test_replay_pipeline.py's fixture chain (seed b"rp", KES
    depth 4, empty bodies), forged with `pkg`: every block applied with
    full crypto as it is made.  Returns (ext, blocks, state, pools)."""
    protocol, ledger, pools = pkg.shelley.shelley_genesis_setup(
        2, _rp_config(pkg), seed=b"rp")
    ext = pkg.ledger.ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    backend = pkg.backend.OpensslBackend()
    blocks, prev, slot = [], None, 0
    while len(blocks) < n:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            h = pkg.headers.make_header(prev, slot, (), issuer=0)
            h = pkg.shelley.forge_tpraos_fields(
                protocol, p["hot_key"], p["can_be_leader"], lead, h)
            blk = pkg.headers.ProtocolBlock(h, ())
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
        slot += 1
    return ext, blocks, state, pools


# the chain with transactions: db_synth's loop, cut to 40 blocks over
# epochs of 10 slots (snapshot rotations, rewards and the nonce rule
# run), KES depth 3
TX_BLOCKS, TX_EPOCH, TX_DEPTH = 40, 10, 3
BAD_WITNESS_AT = 25


def _forge_tx_jax():
    """The JAX package's chain with two transactions a block, built from
    its forge_tpraos_fields / make_shelley_tx as tools/db_synth.py's
    synth_shelley loop does.  Returns (ext, blocks, state)."""
    f = Fraction(4, 5)
    spp = max(1, int(TX_BLOCKS * 2 / f)
              // j_kes.total_periods(TX_DEPTH) + 1)
    cfg = j_shelley.TPraosConfig(
        k=2160, f=f, epoch_length=TX_EPOCH, slots_per_kes_period=spp,
        kes_depth=TX_DEPTH,
        max_kes_evolutions=j_kes.total_periods(TX_DEPTH) - 2)
    protocol, ledger, pools = j_shelley.shelley_genesis_setup(
        2, cfg, stake_per_pool=100_000, seed=b"db-synth")
    ext = j_ledger.ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    gen_order = sorted(p["addr"] for p in pools)
    spendable = {i: [(ledger.GENESIS_TXID, gen_order.index(p["addr"]),
                      100_000)] for i, p in enumerate(pools)}
    blocks, prev, slot = [], None, 0
    while len(blocks) < TX_BLOCKS:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        lead = None
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is not None:
                break
        if lead is None:
            slot += 1
            continue
        body = []
        for t in range(2):
            owner = (len(blocks) * 2 + t) % len(pools)
            txid, ix, amount = spendable[owner].pop(0)
            op = pools[owner]
            tx = j_shelley.make_shelley_tx(
                inputs=[(txid, ix)], outputs=[(op["addr"], amount)],
                certs=[], signing_keys=[op["keys"].addr_sk])
            spendable[owner].append((tx.txid, 0, amount))
            body.append(tx)
        hdr = j_headers.make_header(prev, slot, body, issuer=0)
        signed = j_shelley.forge_tpraos_fields(
            protocol, p["hot_key"], p["can_be_leader"], lead, hdr)
        block = j_headers.ProtocolBlock(signed, tuple(body))
        state = ext.tick_then_reapply(state, block)
        blocks.append(block)
        prev = signed
        slot += 1
    return ext, blocks, state


@pytest.fixture(scope="module")
def rp():
    """Both packages' 24-block fixture chains."""
    return SimpleNamespace(jax=_forge_rp(JAX), port=_forge_rp(PORT))


@pytest.fixture(scope="module")
def txc():
    """Both packages' 40-block chains with transactions; the port's from
    chainsynth.forge_shelley, with the witness-tampered variant of block
    BAD_WITNESS_AT."""
    ext, blocks, state, variant = chainsynth.forge_shelley(
        TX_BLOCKS, epoch_length=TX_EPOCH, kes_depth=TX_DEPTH,
        bad_witness_at=BAD_WITNESS_AT)
    return SimpleNamespace(jax=_forge_tx_jax(),
                           port=(ext, blocks, state, variant))


def _kes_tamper(pkg, blocks, ix, byte=8):
    blk = blocks[ix]
    sig = bytearray(blk.header.get(KES_FIELD))
    sig[byte] ^= 1
    out = list(blocks)
    out[ix] = pkg.headers.ProtocolBlock(
        blk.header.with_fields(**{KES_FIELD: bytes(sig)}), blk.body)
    return out


def _summary(res):
    return (res.all_valid, res.n_valid, type(res.error).__name__,
            None if res.final_state is None
            else res.final_state.ledger.state_hash())


def _three_ways(jax_case, port_case, window):
    """ReplayResult summaries: the JAX package's CpuRefBackend (sync),
    the port's CpuRefBackend (sync) and TorchBackend(device="cpu")
    (threaded, fold=True).  Each case is (ext, blocks, start state)."""
    j_backend.GLOBAL_BETA_CACHE.clear()
    want = _summary(j_batch.replay_blocks_pipelined(
        *jax_case, backend=j_backend.CpuRefBackend(), window=window))
    got = []
    for backend in (CpuRefBackend(), TorchBackend(device="cpu")):
        GLOBAL_BETA_CACHE.clear()
        got.append(_summary(replay_blocks_pipelined(
            *port_case, backend=backend, window=window)))
    return want, got


# -- forging ------------------------------------------------------------------

def _same_chain(jblocks, pblocks):
    assert len(jblocks) == len(pblocks)
    for j, p in zip(jblocks, pblocks):
        assert p.bytes == j.bytes
        assert p.hash == j.hash


def test_fixture_chain_forged_byte_identical(rp):
    _same_chain(rp.jax[1], rp.port[1])
    assert (rp.port[2].ledger.state_hash()
            == rp.jax[2].ledger.state_hash())


def test_tx_chain_forged_byte_identical(txc):
    _same_chain(txc.jax[1], txc.port[1])
    assert (txc.port[2].ledger.state_hash()
            == txc.jax[2].ledger.state_hash())
    # the chain crosses epochs and carries two witnessed transactions a
    # block; the variant differs from block BAD_WITNESS_AT only in the
    # flipped witness (and so in its body hash and KES signature)
    blocks, variant = txc.port[1], txc.port[3]
    assert blocks[-1].slot // TX_EPOCH >= 3
    assert all(len(b.body) == 2 and len(b.body[0].witnesses) == 1
               for b in blocks)
    orig = blocks[BAD_WITNESS_AT]
    assert variant.header.prev_hash == orig.header.prev_hash
    assert variant.slot == orig.slot and variant.hash != orig.hash
    assert variant.body[0].txid == orig.body[0].txid
    assert variant.body[0].witnesses != orig.body[0].witnesses


def test_chainsynth_config_is_db_synths():
    cfg = chainsynth.tpraos_config(10_000, Fraction(4, 5), 600, 10)
    assert (cfg.k, cfg.epoch_length, cfg.kes_depth) == (2160, 600, 10)
    assert cfg.slots_per_kes_period == int(10_000 * 2 / Fraction(4, 5)) \
        // 1024 + 1
    assert cfg.max_kes_evolutions == 1022
    assert len(chainsynth.forge_shelley(3, kes_depth=2)) == 3


# -- replays: the JAX package's ReplayResult through both port drivers --------

def test_replay_valid_chain(rp):
    want, got = _three_ways(
        (rp.jax[0], rp.jax[1], rp.jax[0].initial_state()),
        (rp.port[0], rp.port[1], rp.port[0].initial_state()), 8)
    assert want[:3] == (True, 24, "NoneType")
    assert want[3] == rp.jax[2].ledger.state_hash()
    assert got == [want, want]


def test_replay_kes_tamper_at_13(rp):
    want, got = _three_ways(
        (rp.jax[0], _kes_tamper(JAX, rp.jax[1], 13), rp.jax[0]
         .initial_state()),
        (rp.port[0], _kes_tamper(PORT, rp.port[1], 13), rp.port[0]
         .initial_state()), 8)
    # the proof failure at 13 wins over the envelope break at 14
    assert want == (False, 13, "LedgerError", None)
    assert got == [want, want]


def test_replay_truncated_at_10(rp):
    want, got = _three_ways(
        (rp.jax[0], rp.jax[1][:10] + rp.jax[1][11:],
         rp.jax[0].initial_state()),
        (rp.port[0], rp.port[1][:10] + rp.port[1][11:],
         rp.port[0].initial_state()), 8)
    assert want == (False, 10, "HeaderEnvelopeError", None)
    assert got == [want, want]


class _HorizonOnce:
    """Ledger proxy whose forecast fails ONCE at `stop_slot` (as
    test_replay_pipeline.py's), raising `exc`."""

    def __init__(self, inner, stop_slot, exc):
        self._inner = inner
        self._stop = stop_slot
        self._exc = exc
        self.armed = True

    def forecast_view(self, state, slot):
        if self.armed and slot == self._stop:
            self.armed = False
            raise self._exc(f"horizon at {slot}")
        return self._inner.forecast_view(state, slot)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _resume(pkg, ext, blocks, backend, stop_ix=15):
    proxy = pkg.ledger.ExtLedgerRules(ext.protocol, _HorizonOnce(
        ext.ledger, blocks[stop_ix].slot, pkg.ledger.OutsideForecastRange))
    run = pkg.batch.replay_blocks_pipelined
    pkg.backend.GLOBAL_BETA_CACHE.clear()
    first = run(proxy, blocks, ext.initial_state(), backend=backend,
                window=4)
    pkg.backend.GLOBAL_BETA_CACHE.clear()
    second = run(proxy, blocks[first.n_valid:], first.final_state,
                 backend=backend, window=4)
    return _summary(first)[:3], _summary(second)


def test_replay_outside_forecast_range_resume_at_15(rp):
    want = _resume(JAX, rp.jax[0], rp.jax[1], j_backend.CpuRefBackend())
    assert want[0] == (False, 15, "OutsideForecastRange")
    assert want[1] == (True, 9, "NoneType", rp.jax[2].ledger.state_hash())
    for backend in (CpuRefBackend(), TorchBackend(device="cpu")):
        assert _resume(PORT, rp.port[0], rp.port[1], backend) == want


def test_replay_bad_witness_on_the_tx_chain(txc):
    """A witness flipped before its header was forged: the header is
    valid, so the failure is the witness's proof, at its block."""
    j_ext, j_blocks, _ = txc.jax
    p_ext, p_blocks, _, variant = txc.port
    # the JAX package's variant, made from the same bytes
    j_variant = j_headers.ProtocolBlock.from_bytes(
        variant.bytes, tx_decode=j_shelley.ShelleyTx.decode)
    assert j_variant.hash == variant.hash
    want, got = _three_ways(
        (j_ext, j_blocks[:BAD_WITNESS_AT] + [j_variant],
         j_ext.initial_state()),
        (p_ext, p_blocks[:BAD_WITNESS_AT] + [variant],
         p_ext.initial_state()), 8)
    assert want == (False, BAD_WITNESS_AT, "LedgerError", None)
    assert got == [want, want]


def _flip_witness_after_forging(pkg, blocks, ix):
    blk = blocks[ix]
    tx = blk.body[0]
    (vk, sig), = tx.witnesses
    bad = dataclasses.replace(
        tx, witnesses=((vk, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]),))
    return blocks[:ix] + [pkg.headers.ProtocolBlock(
        blk.header, (bad,) + blk.body[1:])] + blocks[ix + 1:]


def test_replay_witness_flipped_after_forging(txc):
    """A witness flipped in a forged block: no replay checks the header's
    body hash, so the header and every later block stay valid, the proof
    fails at its block, and the windows past it are submitted and then
    discarded."""
    j_ext, j_blocks, _ = txc.jax
    p_ext, p_blocks, _, _ = txc.port
    want, got = _three_ways(
        (j_ext, _flip_witness_after_forging(JAX, j_blocks, 12),
         j_ext.initial_state()),
        (p_ext, _flip_witness_after_forging(PORT, p_blocks, 12),
         p_ext.initial_state()), 8)
    assert want == (False, 12, "LedgerError", None)
    assert got == [want, want]


def test_replay_tx_chain_valid_matches_the_forgers_state(txc):
    p_ext, p_blocks, p_state, _ = txc.port
    GLOBAL_BETA_CACHE.clear()
    res = replay_blocks_pipelined(p_ext, p_blocks, p_ext.initial_state(),
                                  backend=TorchBackend(device="cpu"),
                                  window=16)
    assert res.all_valid and res.n_valid == TX_BLOCKS
    assert (res.final_state.ledger.state_hash()
            == p_state.ledger.state_hash()
            == txc.jax[2].ledger.state_hash())


def _short_key_chain(pkg, ext, blocks, pools, ix):
    """blocks[:ix] and block ix re-forged by its own pool with an OCert
    whose KES root key is 31 bytes (cold-signed, so only the KES proof
    can fail), from a fresh hot key."""
    sh = pkg.shelley
    blk = blocks[ix]
    issuer = blk.header.get(sh.ISSUER_FIELD)
    p = next(p for p in pools if p["keys"].cold_vk == issuer)
    ocert = sh.make_ocert(p["keys"].cold_sk,
                          p["can_be_leader"].ocert.kes_vk[:31], 0, 0)
    cbl = sh.TPraosCanBeLeader(p["keys"].cold_sk, p["keys"].vrf_sk, ocert)
    lead = sh.TPraosIsLeader(blk.header.get(sh.ETA_VRF_FIELD),
                             blk.header.get(sh.LEADER_VRF_FIELD))
    hot = pkg.shelley.HotKey(pkg.kes.KesSignKey(4, p["keys"].kes_seed))
    hdr = sh.forge_tpraos_fields(
        ext.protocol, hot, cbl, lead,
        pkg.headers.make_header(blocks[ix - 1].header, blk.slot, (),
                                issuer=0))
    return blocks[:ix] + [pkg.headers.ProtocolBlock(hdr, ())]


def test_short_kes_root_key_through_a_block(rp):
    """A block whose OCert carries a 31-byte KES key: n_valid is its
    index on both port backends, as on the JAX package's CpuRefBackend,
    and the port's TorchBackend schedules no job and caches nothing for
    that key."""
    ix = 11
    j_chain = _short_key_chain(JAX, rp.jax[0], rp.jax[1], rp.jax[3], ix)
    p_chain = _short_key_chain(PORT, rp.port[0], rp.port[1], rp.port[3], ix)
    assert p_chain[-1].bytes == j_chain[-1].bytes
    tb = TorchBackend(device="cpu")
    want = None
    for pkg, chain, backend in ((JAX, j_chain, j_backend.CpuRefBackend()),
                                (PORT, p_chain, CpuRefBackend()),
                                (PORT, p_chain, tb)):
        ext = rp.jax[0] if pkg is JAX else rp.port[0]
        pkg.backend.GLOBAL_BETA_CACHE.clear()
        got = _summary(pkg.batch.replay_blocks_pipelined(
            ext, chain, ext.initial_state(), backend=backend, window=8))
        want = want or got
        assert got == want == (False, ix, "LedgerError", None)
    short = p_chain[-1].header
    kes_vk = p_shelley.OCert.from_bytes(
        short.get(p_shelley.OCERT_FIELD)).kes_vk
    assert len(kes_vk) == 31
    assert tb.cache._kes and all(k[2] != kes_vk for k in tb.cache._kes)


# -- the replay entry point -----------------------------------------------------

def test_replay_run_on_the_cpu_reports_every_window():
    out = replay.run(blocks=20, window=8, device="cpu", runs=2,
                     kes_depth=3)
    assert len(out["blocks"]) == 20 and out["forge_s"] > 0
    for r in out["runs"]:
        assert r["result"].all_valid and r["state_hash_match"]
        assert r["proofs_per_s"] == pytest.approx(
            r["blocks_per_s"] * (4 + 2))
        # three windows: one host pass, submit (its fill and fold inside
        # it) and drain each
        for name in replay.SPANS:
            assert len(r["spans"][name]) == 3, name
        assert all(t > 0 for t in r["spans"]["window.fold"])
        # window 0 fills every key; later ones the new KES leaf keys
        assert r["spans"]["precompute.fill"][0] > 0


def test_replay_main_prints_the_runs(capsys):
    assert replay.main(["--device", "cpu", "--blocks", "9", "--window", "8",
                        "--kes-depth", "3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["blocks"] == 9 and line["state_hash_match"] == [True]
    assert set(line["spans_s"][0]) == set(replay.SPANS)


# -- driver semantics on the port's stub backends ------------------------------

class AsyncStubBackend(OpensslBackend):
    """submit/finish-capable CPU backend: the two-deep window pipeline
    without a device (test_replay_pipeline.py's, on the port's types)."""

    def __init__(self):
        self.submitted = 0
        self.finished = 0
        self.max_in_flight = 0

    def submit_window(self, reqs, next_beta_proofs=()):
        self.submitted += 1
        self.max_in_flight = max(self.max_in_flight,
                                 self.submitted - self.finished)
        return {"reqs": list(reqs),
                "beta_proofs": list(dict.fromkeys(next_beta_proofs))}

    def finish_window(self, state):
        ok = self.verify_mixed(state["reqs"])
        betas = dict(zip(state["beta_proofs"],
                         self.vrf_betas_batch(state["beta_proofs"])))
        self.finished += 1
        return ok, betas


class FoldStubBackend(AsyncStubBackend):
    """AsyncStubBackend speaking fold=True: a WindowVerdict."""

    supports_window_fold = True

    def __init__(self):
        super().__init__()
        self.fold_submissions = 0

    def submit_window(self, reqs, next_beta_proofs=(), fold=False):
        st = super().submit_window(reqs, next_beta_proofs)
        st["fold"] = fold
        if fold:
            self.fold_submissions += 1
        return st

    def finish_window(self, state):
        ok, betas = super().finish_window(state)
        if not state.get("fold"):
            return ok, betas
        first_bad = ok.index(False) if False in ok else None
        return WindowVerdict(len(ok), first_bad), betas


def _producer_threads_alive():
    return [t for t in threading.enumerate()
            if t.name == "ouro-replay-producer" and t.is_alive()]


def _producer_counters():
    return (_metrics.counter("pipeline.producers_started",
                             always=True).value,
            _metrics.counter("pipeline.producers_finished",
                             always=True).value)


@pytest.fixture(scope="module")
def chain(rp):
    ext, blocks, state, _pools = rp.port
    return ext, blocks, state


def test_two_deep_stub_backend(chain):
    ext, blocks, final = chain
    sb = AsyncStubBackend()
    GLOBAL_BETA_CACHE.clear()
    res = replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                  backend=sb, window=4)
    assert res.all_valid, res.error
    assert res.n_valid == len(blocks)
    assert (res.final_state.ledger.state_hash()
            == final.ledger.state_hash())
    assert sb.max_in_flight == 2
    assert sb.submitted == sb.finished == (len(blocks) + 3) // 4


def test_two_deep_failure_index(chain):
    ext, blocks, _final = chain
    GLOBAL_BETA_CACHE.clear()
    res = replay_blocks_pipelined(ext, _kes_tamper(PORT, blocks, 5, 3),
                                  ext.initial_state(),
                                  backend=AsyncStubBackend(), window=4)
    assert not res.all_valid
    assert res.n_valid == 5


def test_threaded_result_identical_to_sync_driver(chain):
    ext, blocks, _final = chain
    for blks in (list(blocks), _kes_tamper(PORT, blocks, 9, 3),
                 blocks[:7] + blocks[8:]):
        GLOBAL_BETA_CACHE.clear()
        sync = replay_blocks_pipelined(ext, blks, ext.initial_state(),
                                       backend=OpensslBackend(), window=4)
        GLOBAL_BETA_CACHE.clear()
        thr = replay_blocks_pipelined(ext, blks, ext.initial_state(),
                                      backend=AsyncStubBackend(), window=4)
        assert _summary(thr) == _summary(sync)


def test_fold_verdict_path_matches_vector_path(chain):
    ext, blocks, _final = chain
    for blks in (list(blocks), _kes_tamper(PORT, blocks, 13, 3),
                 _kes_tamper(PORT, blocks, 0, 3)):
        GLOBAL_BETA_CACHE.clear()
        vec = replay_blocks_pipelined(ext, blks, ext.initial_state(),
                                      backend=AsyncStubBackend(), window=4)
        GLOBAL_BETA_CACHE.clear()
        fb = FoldStubBackend()
        fold = replay_blocks_pipelined(ext, blks, ext.initial_state(),
                                       backend=fb, window=4)
        assert fb.fold_submissions == fb.submitted > 0
        assert _summary(fold) == _summary(vec)


def test_on_window_hook_identical_on_both_drivers(chain):
    ext, blocks, _final = chain

    def run(backend):
        calls = []
        GLOBAL_BETA_CACHE.clear()
        res = replay_blocks_pipelined(
            ext, blocks, ext.initial_state(), backend=backend, window=4,
            on_window=lambda st, n, pt: calls.append(
                (n, pt.slot, st.ledger.state_hash())))
        assert res.all_valid
        return calls, res

    threaded, rt = run(AsyncStubBackend())
    sync, _rs = run(OpensslBackend())
    assert threaded == sync
    assert [n for n, _s, _h in threaded] == [4, 8, 12, 16, 20, 24]
    assert threaded[-1][2] == rt.final_state.ledger.state_hash()
    assert threaded[-1][1] == blocks[-1].slot


def test_on_window_hook_not_called_past_first_error(chain):
    ext, blocks, _final = chain
    for blks in (_kes_tamper(PORT, blocks, 9, 3), blocks[:10] + blocks[11:]):
        for backend in (AsyncStubBackend(), OpensslBackend()):
            calls = []
            GLOBAL_BETA_CACHE.clear()
            res = replay_blocks_pipelined(
                ext, blks, ext.initial_state(), backend=backend, window=4,
                on_window=lambda st, n, pt: calls.append(n))
            assert not res.all_valid
            assert calls == [4, 8]


def test_on_window_hook_exception_is_clean_stop(chain):
    ext, blocks, _final = chain

    class SnapshotDied(Exception):
        pass

    def hook(st, n, pt):
        if n >= 8:
            raise SnapshotDied(f"disk full at block {n}")

    sb = AsyncStubBackend()
    s0, f0 = _producer_counters()
    with pytest.raises(SnapshotDied):
        replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                backend=sb, window=4, on_window=hook)
    assert sb.submitted == sb.finished > 0
    s1, f1 = _producer_counters()
    assert (s1 - s0, f1 - f0) == (1, 1)
    assert not _producer_threads_alive()


def test_error_with_producer_ahead_no_leaks(chain):
    ext, blocks, _final = chain
    tampered = _kes_tamper(PORT, blocks, 1, 3)
    for mk in (AsyncStubBackend, FoldStubBackend):
        GLOBAL_BETA_CACHE.clear()
        sb = mk()
        s0, f0 = _producer_counters()
        res = replay_blocks_pipelined(ext, tampered, ext.initial_state(),
                                      backend=sb, window=4)
        assert not res.all_valid
        assert res.n_valid == 1
        assert res.final_state is None
        assert sb.submitted == sb.finished > 0
        s1, f1 = _producer_counters()
        assert (s1 - s0, f1 - f0) == (1, 1)
        assert not _producer_threads_alive()


def test_torch_backend_error_with_producer_ahead_finishes_every_window(
        chain):
    """The first-error teardown on TorchBackend: the windows submitted
    past the bad one are finished (their results read), and the producer
    is joined."""
    ext, blocks, _final = chain
    tb = TorchBackend(device="cpu")
    finished = []
    finish = tb.finish_window

    def held_finish(st):
        # the first drain waits until the producer has submitted the
        # next window, so that it is ahead when the error is seen
        deadline = time.monotonic() + 60
        while not finished and tb.padding_stats()["windows"] < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        finished.append(st)
        return finish(st)

    tb.finish_window = held_finish
    GLOBAL_BETA_CACHE.clear()
    s0, f0 = _producer_counters()
    # the last block of window 0: its successor's envelope breaks in
    # window 1, which is still submitted
    res = replay_blocks_pipelined(ext, _kes_tamper(PORT, blocks, 3, 3),
                                  ext.initial_state(), backend=tb, window=4)
    assert (res.all_valid, res.n_valid, res.final_state) == (False, 3, None)
    assert tb.padding_stats()["windows"] == len(finished) >= 2
    s1, f1 = _producer_counters()
    assert (s1 - s0, f1 - f0) == (1, 1)
    assert not _producer_threads_alive()


def test_forced_failure_dumps_flight_record(chain, tmp_path, monkeypatch):
    from ouroboros_tpu_torch.observe.flight import FLIGHT
    ext, blocks, _final = chain
    tampered = _kes_tamper(PORT, blocks, 9, 3)
    monkeypatch.setenv("OURO_FLIGHT_DIR", str(tmp_path / "flight"))
    FLIGHT.arm()
    try:
        res = replay_blocks_pipelined(ext, tampered, ext.initial_state(),
                                      backend=AsyncStubBackend(), window=4)
    finally:
        FLIGHT.disarm()
        FLIGHT.clear()
    assert not res.all_valid and res.n_valid == 9
    doc = json.loads((tmp_path / "flight" / "flight.trace.json").read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {"window.host_seq", "pipeline.drain"} <= {e["name"]
                                                     for e in events}
    assert all(e["dur"] >= 0 for e in events)
    lines = (tmp_path / "flight" / "flight.jsonl").read_text().splitlines()
    head = json.loads(lines[0])
    assert head["kind"] == "flight" and "block 9" in head["reason"]
    assert head["entries"] == len(lines) - 1
    assert {"span", "metric"} <= {json.loads(ln)["kind"]
                                  for ln in lines[1:]}
    res2 = replay_blocks_pipelined(ext, tampered, ext.initial_state(),
                                   backend=AsyncStubBackend(), window=4)
    assert not res2.all_valid
    assert json.loads((tmp_path / "flight" / "flight.jsonl").read_text()
                      .splitlines()[0]) == head


def test_producer_crash_reraises_on_caller(chain):
    ext, blocks, _final = chain

    class ExplodingBackend(AsyncStubBackend):
        def submit_window(self, reqs, next_beta_proofs=()):
            if self.submitted >= 2:
                raise RuntimeError("submit machinery broke")
            return super().submit_window(reqs, next_beta_proofs)

    s0, f0 = _producer_counters()
    with pytest.raises(RuntimeError, match="submit machinery broke"):
        replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                backend=ExplodingBackend(), window=4)
    s1, f1 = _producer_counters()
    assert (s1 - s0, f1 - f0) == (1, 1)
    assert not _producer_threads_alive()


def test_sequential_errors_keep_their_class(chain):
    """The drivers hand a sequential failure through as HeaderError /
    LedgerError and a horizon stop as OutsideForecastRange."""
    ext, blocks, _final = chain
    cut = blocks[:3] + blocks[4:]
    for backend in (AsyncStubBackend(), OpensslBackend()):
        GLOBAL_BETA_CACHE.clear()
        res = replay_blocks_pipelined(ext, cut, ext.initial_state(),
                                      backend=backend, window=4)
        assert isinstance(res.error, HeaderError)
        assert not isinstance(res.error, (LedgerError,
                                          OutsideForecastRange))


# -- the pieces the replay added to the port's crypto -------------------------

def test_kes_evolution_signs_as_the_jax_package_does():
    seed = bytes(range(32))
    pk, jk = p_kes.KesSignKey(3, seed), j_kes.KesSignKey(3, seed)
    assert pk.verification_key == jk.verification_key
    for period in range(8):
        assert pk.period == jk.period == period
        assert (pk.sign(b"m%d" % period).to_bytes()
                == jk.sign(b"m%d" % period).to_bytes())
        if period < 7:
            pk.evolve()
            jk.evolve()
    with pytest.raises(ValueError):
        pk.evolve()
    # the evolved key's signatures verify at their period
    sig = p_kes.KesSig.from_bytes(3, pk.sign(b"x").to_bytes())
    assert p_kes.verify_prepare(3, pk.verification_key, 7, sig) is not None


@pytest.mark.parametrize("s", [0, 1, 15, 16, ed.L - 1, 2 ** 255 - 1,
                               2 ** 256 - 1, 2 ** 256 + 5])
def test_scalar_mult_base_equals_scalar_mult(s):
    assert ed.compress(ed.scalar_mult_base(s)) == \
        ed.compress(ed.scalar_mult(s, ed.BASE))


def test_forgers_signer_and_prover_give_the_pure_bytes():
    """The forger's fast signer and prover (fixed-base table, memoised
    keys) against the port's pure functions and the JAX package's."""
    from ouroboros_tpu.crypto import vrf_ref as j_vrf
    from ouroboros_tpu_torch.crypto import ed25519_ref, vrf_ref
    for i in range(3):
        sk = bytes([i + 1]) * 32
        msg = b"msg %d" % i
        assert ed25519_ref.public_key(sk) == ed25519_ref.public_key_pure(sk)
        assert ed25519_ref.sign(sk, msg) == ed25519_ref.sign_pure(sk, msg)
        assert vrf_ref.prove(sk, msg) == j_vrf.prove_pure(sk, msg)
        assert vrf_ref.public_key(sk) == j_vrf.public_key(sk)


def test_backend_additions_match_the_jax_package():
    from ouroboros_tpu_torch.crypto import ed25519_ref, vrf_ref
    sk = bytes(32)
    vk = ed25519_ref.public_key(sk)
    ksk = p_kes.KesSignKey(2, bytes([7] * 32))
    ksig = ksk.sign(b"hdr").to_bytes()
    reqs = [p_backend.Ed25519Req(vk, b"m", ed25519_ref.sign(sk, b"m")),
            p_backend.KesReq(2, ksk.verification_key, 0, b"hdr", ksig),
            p_backend.KesReq(2, ksk.verification_key[:31], 0, b"hdr", ksig),
            p_backend.KesReq(2, ksk.verification_key, 1, b"hdr", ksig)]
    assert CpuRefBackend().split_mixed_cached(reqs) == \
        CpuRefBackend().split_mixed(reqs)
    assert CpuRefBackend().verify_mixed(reqs) == \
        j_backend.CpuRefBackend().verify_mixed(
            [getattr(j_backend, type(r).__name__)(**r.__dict__)
             for r in reqs]) == [True, True, False, False]
    assert OpensslBackend().verify_ed25519_batch(reqs[:1]) == [True]
    wv = WindowVerdict(3, 1)
    assert wv.as_bools() == [True, False, True]
    assert WindowVerdict(2).as_bools() == [True, True]
    pi = vrf_ref.prove(bytes(32), b"alpha")
    assert CpuRefBackend().vrf_proof_to_hash(pi) == vrf_ref.proof_to_hash(pi)


def test_default_backend_is_what_was_installed():
    cpu = CpuRefBackend()
    p_backend.set_default_backend(cpu)
    try:
        assert p_backend.default_backend() is cpu
    finally:
        p_backend.set_default_backend(None)
