"""The port's storage layer and hard-fork combinator
(`ouroboros_tpu_torch.storage`, `.consensus.hardfork`, `.eras.cardano`)
against the JAX package's.

- The streaming replay engine (storage/stream.py): the scenarios of
  tests/test_stream.py on a 60-block Byron->Shelley DB, run on the port:
  parity with the JAX package's reapplied `state_hash`, the era crossing
  inside the stream, the resumed reopen, a kill mid-stream resumed to the
  same hash, a torn snapshot, a snapshot past a truncated DB, the
  reference-format fallback path, the snapshot interval, and the
  prefetcher's order, early close and decode errors.  The replays verify
  through a submit/finish stub over the port's `OpensslBackend` (the
  threaded pipeline without a device) and once through
  `TorchBackend(device="cpu")`.
- The snapshot codec admits only the port's classes: a JAX-package state
  is refused, and `LedgerDB.iter_snapshots` skips it.
- refformat.py's layout and golden fixture (tests/test_refformat.py).
- The era history and the combinator (tests/test_hardfork.py), on the
  Byron->Shelley composition, each result held against the JAX package's.

Tolerance: none.  Bytes, counts, slots and hashes compare exactly.
"""
import dataclasses
import hashlib
import os
import pickle
import shutil
import struct
from types import SimpleNamespace
from zlib import crc32

import pytest

import ouroboros_tpu.consensus.batch as j_batch
import ouroboros_tpu.eras.cardano as j_cardano
import ouroboros_tpu.eras.shelley as j_shelley
import ouroboros_tpu.utils.cbor as j_cbor
from ouroboros_tpu.storage import MockFS as JMockFS
from ouroboros_tpu.storage.refformat import RefDbWriter as JRefDbWriter
from ouroboros_tpu_torch import db_analyser, db_synth
from ouroboros_tpu_torch.consensus.batch import validate_blocks_batched
from ouroboros_tpu_torch.consensus.hardfork import (
    Bound, EraParams, PastHorizon, Summary, hard_fork_rules,
)
from ouroboros_tpu_torch.consensus.hardfork.combinator import ERA_FIELD
from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
from ouroboros_tpu_torch.crypto.backend import (GLOBAL_BETA_CACHE,
                                                OpensslBackend)
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.eras.cardano import SHELLEY
from ouroboros_tpu_torch.observe.flight import FLIGHT
from ouroboros_tpu_torch.storage import (
    DiskPolicy, ImmutableDB, IoFS, LedgerDB, MockFS, StreamConfig,
    StreamingReplayEngine, stream,
)
from ouroboros_tpu_torch.storage.refformat import (
    ENTRY_SIZE, RefDbReader, RefDbWriter, RefEntry, chunk_file,
    is_reference_db, primary_file, secondary_file,
)
from ouroboros_tpu_torch.storage.stream import (
    BlockPrefetcher, pickle_decode, pickle_encode, prefetcher_threads_alive,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth_cardano(out, blocks=60, fmt="native"):
    """tests/test_stream.py's DB: 60 blocks, Byron -> Shelley, epochs and
    chunks of 10 slots, written by the port's db_synth."""
    args = db_synth.parser().parse_args([
        "--out", out, "--protocol", "cardano", "--blocks", str(blocks),
        "--txs-per-block", "1", "--pools", "2", "--epoch-length", "10",
        "--kes-depth", "5", "--chunk-size", "10", "--format", fmt,
        "--seed", "stream-test", "--eras", "byron-shelley"])
    return db_synth.synth_cardano(args)


class AsyncStubBackend:
    """submit/finish over the port's OpensslBackend: drives the threaded
    pipeline (windows in flight, the producer ahead) without a device."""

    def __init__(self):
        self._inner = OpensslBackend()
        self.finished = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def submit_window(self, reqs, next_beta_proofs=()):
        return {"reqs": list(reqs),
                "bp": list(dict.fromkeys(next_beta_proofs))}

    def finish_window(self, st):
        self.finished += 1
        return (self._inner.verify_mixed(st["reqs"]),
                dict(zip(st["bp"],
                         self._inner.vrf_betas_batch(st["bp"]))))


class HardStop(BaseException):
    """The kill: not an Exception, so nothing swallows it."""


class KillBackend(AsyncStubBackend):
    """Hard-stops the replay at its Nth drain, once."""

    def __init__(self, kill_at_window):
        super().__init__()
        self.kill_at = kill_at_window

    def finish_window(self, st):
        if self.kill_at is not None and self.finished + 1 >= self.kill_at:
            self.kill_at = None
            raise HardStop(f"hard stop at drain {self.finished + 1}")
        return super().finish_window(st)


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("streamdb"))
    assert _synth_cardano(d)["blocks"] == 60
    return d


@pytest.fixture(scope="module")
def reference_hash(chain_dir):
    """The JAX package's reapplied fold over the port-written DB, loaded
    by the JAX package's db_analyser."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "j_db_analyser", os.path.join(REPO, "tools", "db_analyser.py"))
    j_dba = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_dba)
    db, rules, decode, _cfg = j_dba.load_db(chain_dir)
    st = rules.initial_state()
    for _e, raw in db.stream():
        st = rules.tick_then_reapply(st, decode(raw))
    return st.ledger.state_hash()


def _fresh_db_dir(chain_dir, tmp_path):
    d = str(tmp_path / "db")
    shutil.copytree(chain_dir, d)
    return d


def _engine(db_dir, backend, window=8, resume=False, interval=16,
            num_snapshots=2, read_ahead=2):
    db, rules, decode, _cfg = db_analyser.load_db(db_dir)
    return StreamingReplayEngine(
        IoFS(db_dir), db, rules, decode, backend=backend,
        config=StreamConfig(
            window=window, read_ahead=read_ahead,
            policy=DiskPolicy(num_snapshots=num_snapshots,
                              snapshot_interval_slots=interval),
            resume=resume))


# ---------------------------------------------------------------------------
# The streaming engine: parity, era crossing, accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["stub", "torch-cpu"])
def test_stream_engine_matches_the_jax_package(chain_dir, tmp_path,
                                               reference_hash, backend):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    be = AsyncStubBackend() if backend == "stub" \
        else TorchBackend(device="cpu")
    res = _engine(d, be).replay()
    assert res.all_valid and res.n_valid == 60
    assert res.final_state.ledger.state_hash() == reference_hash
    st = res.stats
    assert st["blocks_decoded"] == 60
    assert st["chunks_read"] >= 2
    assert st["bytes_read"] > 0
    assert st["era_crossings"] == 1
    assert st["host_seq_secs"] > 0
    assert st["disk_secs"] > 0
    assert 0.0 <= st["disk_hidden_frac"] <= 1.0
    assert st["snapshots_written"] >= 2
    assert len(LedgerDB.snapshot_names(IoFS(d))) == 2
    assert prefetcher_threads_alive() == 0


def test_stream_crosses_fork_to_shelley(chain_dir, tmp_path):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    res = _engine(d, AsyncStubBackend()).replay()
    assert res.all_valid
    assert res.final_state.ledger.era == SHELLEY
    assert res.final_state.header.chain_dep_state.era == SHELLEY


def test_era_field_matches_both_combinators():
    from ouroboros_tpu.consensus.hardfork.combinator import \
        ERA_FIELD as J_ERA_FIELD
    assert stream.ERA_FIELD == ERA_FIELD == J_ERA_FIELD


def test_resumed_reopen_restores_tip_instantly(chain_dir, tmp_path,
                                               reference_hash):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    assert _engine(d, AsyncStubBackend()).replay().all_valid
    GLOBAL_BETA_CACHE.clear()
    again = _engine(d, AsyncStubBackend(), resume=True).replay()
    assert again.all_valid and again.n_valid == 0
    assert again.stats["resumed_from_slot"] is not None
    assert again.final_state.ledger.state_hash() == reference_hash
    assert again.stats["snapshots_written"] == 0


def test_kill_and_resume_byte_identical(chain_dir, tmp_path,
                                        reference_hash):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    eng = _engine(d, KillBackend(kill_at_window=3), interval=8)
    with pytest.raises(HardStop):
        eng.replay()
    assert eng.snapshots_written >= 1
    assert prefetcher_threads_alive() == 0
    assert LedgerDB.snapshot_names(IoFS(d))
    GLOBAL_BETA_CACHE.clear()
    FLIGHT.arm()
    try:
        res = _engine(d, AsyncStubBackend(), resume=True).replay()
    finally:
        FLIGHT.disarm()
        FLIGHT.clear()
    assert res.all_valid
    assert res.stats["resumed_from_slot"] is not None
    assert 0 < res.n_valid < 60
    assert res.final_state.ledger.state_hash() == reference_hash
    assert prefetcher_threads_alive() == 0


def test_kill_during_snapshot_write_keeps_previous(chain_dir, tmp_path,
                                                   reference_hash):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    first = _engine(d, AsyncStubBackend(), num_snapshots=3).replay()
    assert first.all_valid and first.stats["snapshots_written"] >= 2
    snaps = LedgerDB.snapshot_names(IoFS(d))
    path = os.path.join(d, "ledger", snaps[-1])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) // 2])
    GLOBAL_BETA_CACHE.clear()
    res = _engine(d, AsyncStubBackend(), resume=True).replay()
    assert res.all_valid
    assert res.stats["resumed_from_slot"] == int(snaps[-2].split("-")[1])
    assert res.final_state.ledger.state_hash() == reference_hash


def test_snapshot_past_truncated_db_falls_back(chain_dir, tmp_path):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    first = _engine(d, AsyncStubBackend(), num_snapshots=4,
                    interval=12).replay()
    assert first.all_valid and first.stats["snapshots_written"] >= 3
    fs = IoFS(d)
    chunks = sorted(n for n in fs.list_dir(("immutable",))
                    if n.endswith(".chunk"))
    path = os.path.join(d, "immutable", chunks[-1])
    raw = bytearray(open(path, "rb").read())
    raw[3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    _db, rules, decode, _cfg = db_analyser.load_db(d)
    db2 = ImmutableDB.open(IoFS(d), chunk_size=10)       # validating open
    assert db2.tip.slot < first.final_state.header.tip.slot
    GLOBAL_BETA_CACHE.clear()
    res = StreamingReplayEngine(
        fs, db2, rules, decode, backend=AsyncStubBackend(),
        config=StreamConfig(window=8, read_ahead=2,
                            policy=DiskPolicy(num_snapshots=4,
                                              snapshot_interval_slots=12),
                            resume=True)).replay()
    assert res.all_valid
    assert res.stats["resumed_from_slot"] is not None
    assert res.stats["resumed_from_slot"] <= db2.tip.slot
    assert res.final_state.header.tip.slot == db2.tip.slot


def test_reference_format_db_streams_and_resumes(tmp_path):
    d = str(tmp_path / "refdb")
    assert _synth_cardano(d, blocks=40, fmt="reference")["blocks"] == 40
    db, rules, decode, _cfg = db_analyser.load_db(d)
    assert not hasattr(db, "chunk_blocks")               # the fallback path
    fs = IoFS(d)
    GLOBAL_BETA_CACHE.clear()
    first = StreamingReplayEngine(
        fs, db, rules, decode, backend=AsyncStubBackend(),
        config=StreamConfig(window=8, read_ahead=2,
                            policy=DiskPolicy(num_snapshots=2,
                                              snapshot_interval_slots=16),
                            resume=False)).replay()
    assert first.all_valid and first.n_valid == 40
    assert first.stats["era_crossings"] == 1
    GLOBAL_BETA_CACHE.clear()
    again = StreamingReplayEngine(
        fs, db, rules, decode, backend=AsyncStubBackend(),
        config=StreamConfig(window=8, read_ahead=2, resume=True)).replay()
    assert again.all_valid and again.n_valid == 0
    assert again.stats["resumed_from_slot"] is not None
    assert (again.final_state.ledger.state_hash()
            == first.final_state.ledger.state_hash())
    assert prefetcher_threads_alive() == 0


def test_snapshot_interval_counts_from_stream_start(chain_dir, tmp_path):
    d = _fresh_db_dir(chain_dir, tmp_path)
    GLOBAL_BETA_CACHE.clear()
    res = _engine(d, AsyncStubBackend(), interval=1 << 62).replay()
    assert res.all_valid
    assert res.stats["snapshots_written"] == 1               # tip only
    snaps = LedgerDB.snapshot_names(IoFS(d))
    assert len(snaps) == 1
    assert int(snaps[0].split("-")[1]) == res.final_state.header.tip.slot


def test_engine_decode_error_aborts_without_leaks(chain_dir, tmp_path):
    d = _fresh_db_dir(chain_dir, tmp_path)
    db, rules, decode, _cfg = db_analyser.load_db(d)
    calls = {"n": 0}

    def exploding(raw):
        calls["n"] += 1
        if calls["n"] == 30:
            raise ValueError("mid-stream decode failure")
        return decode(raw)

    GLOBAL_BETA_CACHE.clear()
    eng = StreamingReplayEngine(
        IoFS(d), db, rules, exploding, backend=AsyncStubBackend(),
        config=StreamConfig(window=8, read_ahead=2, resume=False))
    with pytest.raises(ValueError, match="mid-stream decode failure"):
        eng.replay()
    assert prefetcher_threads_alive() == 0


# ---------------------------------------------------------------------------
# The prefetcher
# ---------------------------------------------------------------------------

def _mock_db(n=20, chunk_size=4):
    db = ImmutableDB.open(MockFS(), chunk_size=chunk_size)
    prev = b"\x00" * 32
    for i in range(n):
        h = bytes([i, 0]) + bytes(30)
        db.append_block(i, i, h, prev, b"raw-%04d" % i)
        prev = h
    return db


def test_prefetcher_yields_all_blocks_in_order():
    pre = BlockPrefetcher(_mock_db(), lambda raw: raw, window=3,
                          depth=2).start()
    try:
        got = list(pre)
    finally:
        pre.close()
    assert got == [b"raw-%04d" % i for i in range(20)]
    assert pre.chunks_read == 5
    assert pre.blocks_decoded == 20
    assert prefetcher_threads_alive() == 0


def test_prefetcher_early_close_joins_thread():
    pre = BlockPrefetcher(_mock_db(n=40), lambda raw: raw, window=2,
                          depth=1).start()
    it = iter(pre)
    assert next(it) == b"raw-0000"
    pre.close()
    assert prefetcher_threads_alive() == 0
    assert pre.blocks_decoded < 40


def test_prefetcher_decode_error_surfaces_on_consumer():
    def decode(raw):
        if raw.endswith(b"0007"):
            raise ValueError("decode broke")
        return raw

    pre = BlockPrefetcher(_mock_db(), decode, window=3, depth=2).start()
    got = []
    try:
        with pytest.raises(ValueError, match="decode broke"):
            for b in pre:
                got.append(b)
    finally:
        pre.close()
    assert got == [b"raw-%04d" % i for i in range(len(got))]
    assert len(got) < 8
    assert prefetcher_threads_alive() == 0


# ---------------------------------------------------------------------------
# The snapshot codec
# ---------------------------------------------------------------------------

def test_snapshot_codec_round_trips_the_ports_states(chain_dir):
    db, rules, decode, _cfg = db_analyser.load_db(chain_dir)
    st = rules.initial_state()
    for _e, raw in db.stream():
        st = rules.tick_then_reapply(st, decode(raw))
    back = pickle_decode(pickle_encode(st))
    assert back == st
    assert back.ledger.state_hash() == st.ledger.state_hash()


def test_snapshot_codec_refuses_the_jax_packages_states(chain_dir, tmp_path):
    """A state pickled by the JAX package names `ouroboros_tpu.*`
    classes: the port's decoder refuses it, and iter_snapshots skips the
    snapshot as it skips a corrupt one."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "j_db_analyser", os.path.join(REPO, "tools", "db_analyser.py"))
    j_dba = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_dba)
    _db, j_rules, _dec, _cfg = j_dba.load_db(chain_dir)
    raw = pickle.dumps(j_rules.initial_state(),
                       protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(pickle.UnpicklingError, match="ouroboros_tpu"):
        pickle_decode(raw)
    # a global that would run code is refused too
    with pytest.raises(pickle.UnpicklingError, match="builtins.eval"):
        pickle_decode(b"cbuiltins\neval\n(S'1'\ntR.")
    fs = IoFS(str(tmp_path))
    _db, rules, _dec, _cfg = db_analyser.load_db(chain_dir)
    genesis = rules.initial_state()
    point = rules.tip(genesis)
    LedgerDB.take_snapshot(fs, 5, point, genesis, pickle_encode,
                           DiskPolicy(num_snapshots=3))
    LedgerDB.take_snapshot(fs, 7, point, j_rules.initial_state(),
                           pickle_encode, DiskPolicy(num_snapshots=3))
    got = list(LedgerDB.iter_snapshots(fs, pickle_decode))
    assert [slot for slot, _p, _s in got] == [5]
    assert got[0][2] == genesis


# ---------------------------------------------------------------------------
# refformat.py: layout, round trip, golden fixture
# ---------------------------------------------------------------------------

H1 = hashlib.blake2b(b"one", digest_size=32).digest()
H2 = hashlib.blake2b(b"two", digest_size=32).digest()
HE = hashlib.blake2b(b"ebb", digest_size=32).digest()
GOLDEN = os.path.join(REPO, "tests", "golden", "refdb")


def test_refformat_secondary_entry_golden_bytes():
    e = RefEntry(block_offset=0x1122334455667788, header_offset=0x0102,
                 header_size=0x0304, checksum=0xDEADBEEF,
                 header_hash=H1, slot_or_epoch=42, is_ebb=False)
    raw = e.encode()
    assert len(raw) == ENTRY_SIZE == 56
    assert raw[:8] == bytes.fromhex("1122334455667788")
    assert raw[8:10] == bytes.fromhex("0102")
    assert raw[10:12] == bytes.fromhex("0304")
    assert raw[12:16] == bytes.fromhex("deadbeef")
    assert raw[16:48] == H1
    assert raw[48:56] == (42).to_bytes(8, "big")
    assert RefEntry.decode(raw, is_ebb=False) == e


def test_refformat_primary_index_golden_bytes():
    fs = MockFS()
    w = RefDbWriter(fs, chunk_size=4)
    w.append_block(0, H1, b"AAA")
    w.append_block(2, H2, b"BBBB")
    w.close()
    primary = fs.read_file(primary_file(0))
    assert primary[0] == 1
    assert struct.unpack(">6I", primary[1:]) == (0, 0, 56, 56, 112, 112)
    assert fs.read_file(chunk_file(0)) == b"AAABBBB"
    sec = fs.read_file(secondary_file(0))
    assert len(sec) == 2 * ENTRY_SIZE
    e0 = RefEntry.decode(sec[:ENTRY_SIZE], is_ebb=False)
    assert e0.block_offset == 0 and e0.slot_or_epoch == 0
    assert e0.checksum == crc32(b"AAA")
    e1 = RefEntry.decode(sec[ENTRY_SIZE:], is_ebb=False)
    assert e1.block_offset == 3 and e1.slot_or_epoch == 2


def _ref_blocks(w):
    w.append_block(0, HE, b"EBB-DATA", is_ebb=True)
    w.append_block(0, H1, b"BLOCK-0")
    w.append_block(3, H2, b"BLOCK-3")
    w.append_block(7, H1, b"BLOCK-7")
    w.close()


def test_refformat_round_trip_with_ebb_and_gaps_equals_the_jax_writer():
    fs, jfs = MockFS(), JMockFS()
    _ref_blocks(RefDbWriter(fs, chunk_size=5))
    _ref_blocks(JRefDbWriter(jfs, chunk_size=5))
    for n in (0, 1):
        for path in (chunk_file(n), primary_file(n), secondary_file(n)):
            assert fs.read_file(path) == jfs.read_file(path)
    assert is_reference_db(fs)
    got = list(RefDbReader(fs, chunk_size=5))
    assert [b.data for b in got] == [b"EBB-DATA", b"BLOCK-0", b"BLOCK-3",
                                     b"BLOCK-7"]
    assert [b.entry.is_ebb for b in got] == [True, False, False, False]
    assert [b.entry.slot(b.chunk_no, 5) for b in got] == [0, 0, 3, 7]


def test_refformat_corrupt_tail_truncates():
    fs = MockFS()
    w = RefDbWriter(fs, chunk_size=10)
    w.append_block(0, H1, b"GOOD-BLOCK")
    w.append_block(1, H2, b"BAD-BLOCK!")
    w.close()
    blob = bytearray(fs.read_file(chunk_file(0)))
    blob[-1] ^= 0xFF
    fs.write_file(chunk_file(0), bytes(blob))
    assert [b.data for b in RefDbReader(fs, chunk_size=10)] \
        == [b"GOOD-BLOCK"]


def test_refformat_reader_parses_the_golden_fixture():
    fs = IoFS(GOLDEN)
    assert is_reference_db(fs)
    got = list(RefDbReader(fs, chunk_size=4))
    assert [b.data for b in got] == [
        b"EBB-EPOCH-ZERO", b"BLOCK-AT-SLOT-ONE!", b"block@2",
        b"SIXTH-SLOT-BLOCK"]
    assert [b.entry.is_ebb for b in got] == [True, False, False, False]
    assert [b.entry.slot(b.chunk_no, 4) for b in got] == [0, 1, 2, 6]
    assert [b.chunk_no for b in got] == [0, 0, 0, 1]
    assert got[0].entry.header_hash == bytes(range(32))
    for b in got:
        assert b.entry.checksum == crc32(b.data)


# ---------------------------------------------------------------------------
# The era history and the combinator
# ---------------------------------------------------------------------------

def _summary():
    return Summary.from_era_params(
        [EraParams(10, 1.0), EraParams(5, 0.5)], [2])


def test_history_boundary_and_slot_epoch_round_trip():
    s = _summary()
    e0, e1 = s.eras
    assert e0.end == Bound(20.0, 20, 2)
    assert e1.start == e0.end and e1.end is None
    assert s.slot_to_epoch(0) == (0, 0)
    assert s.slot_to_epoch(19) == (1, 9)
    assert s.slot_to_epoch(20) == (2, 0)
    assert s.slot_to_epoch(27) == (3, 2)
    for slot in (0, 7, 19, 20, 24, 25, 99):
        ep, off = s.slot_to_epoch(slot)
        assert s.epoch_to_first_slot(ep) + off == slot


def test_history_wallclock_translation():
    s = _summary()
    assert s.slot_to_wallclock(19) == 19.0
    assert s.slot_to_wallclock(20) == 20.0
    assert s.slot_to_wallclock(22) == 21.0
    for t in (0.0, 5.5, 19.9, 20.0, 23.75):
        assert s.slot_to_wallclock(s.wallclock_to_slot(t)) <= t
    assert s.slot_length_at(5) == 1.0 and s.slot_length_at(25) == 0.5


def test_history_past_horizon_on_closed_summary():
    closed = Summary.from_era_params(
        [EraParams(10, 1.0), EraParams(5, 0.5)], [1])
    e1 = closed.eras[1]
    closed.eras[1] = type(e1)(e1.start, e1.next_bound(4), e1.params)
    with pytest.raises(PastHorizon):
        closed.slot_to_epoch(closed.eras[1].end.slot)


@pytest.fixture(scope="module")
def cardano_chain(chain_dir):
    """The port's Byron->Shelley rules and the 60 decoded blocks, and the
    JAX package's rules for the same DB."""
    db, rules, decode, cfg = db_analyser.load_db(chain_dir)
    blocks = [decode(raw) for _e, raw in db.stream()]
    _eras, j_rules, _nodes = j_cardano.cardano_setup(
        cfg["nodes"], epoch_length=cfg["epoch_length"],
        shelley_config=j_shelley.TPraosConfig(
            k=8, epoch_length=cfg["epoch_length"],
            slots_per_kes_period=cfg["slots_per_kes_period"],
            kes_depth=5, max_kes_evolutions=30),
        seed=cfg["seed"].encode())
    return SimpleNamespace(rules=rules, blocks=blocks, cfg=cfg,
                           j_rules=j_rules)


def test_combinator_chain_crosses_era_boundary(cardano_chain):
    c = cardano_chain
    tags = [b.header.get(ERA_FIELD) for b in c.blocks]
    switch = tags.index(SHELLEY)
    fork_slot = 2 * c.cfg["epoch_length"]           # fork_epoch 2
    assert c.blocks[switch].slot >= fork_slot > c.blocks[switch - 1].slot
    assert all(t == 0 for t in tags[:switch])
    assert all(t == SHELLEY for t in tags[switch:])
    st = c.rules.initial_state()
    for b in c.blocks:
        st = c.rules.tick_then_reapply(st, b)
    assert st.ledger.era == SHELLEY and st.ledger.transitions == (2,)
    assert st.header.chain_dep_state.era == SHELLEY


def test_combinator_degenerate_single_era(cardano_chain):
    """A one-era combinator (Byron alone) applies Byron blocks as the
    two-era one does before its fork."""
    c = cardano_chain
    one = hard_fork_rules(c.rules.ledger.eras[:1])
    st1, st2 = one.initial_state(), c.rules.initial_state()
    for b in c.blocks[:5]:
        st1 = one.tick_then_apply(st1, b, backend=OpensslBackend())
        st2 = c.rules.tick_then_apply(st2, b, backend=OpensslBackend())
    assert st1.header.chain_dep_state.era == 0
    assert st1.ledger.state_hash() == st2.ledger.state_hash()


@pytest.mark.parametrize("era_tag", [SHELLEY, None])
def test_combinator_rejects_a_wrong_or_missing_era_tag(cardano_chain,
                                                       era_tag):
    c = cardano_chain
    blk = c.blocks[1]
    if era_tag is None:
        hdr = dataclasses.replace(
            blk.header, _cache={}, fields=tuple(
                (k, v) for k, v in blk.header.fields if k != ERA_FIELD))
    else:
        hdr = blk.header.with_fields(**{ERA_FIELD: era_tag})
    with pytest.raises(Exception):
        c.rules.tick_then_apply(c.rules.initial_state(),
                                ProtocolBlock(hdr, blk.body),
                                backend=OpensslBackend())


def test_combinator_batched_validation_across_boundary(cardano_chain):
    """One window holds proofs of both eras; the batched fold ends where
    the JAX package's does."""
    c = cardano_chain
    res = validate_blocks_batched(c.rules, c.blocks, c.rules.initial_state(),
                                  backend=OpensslBackend())
    assert res.all_valid, res.error
    assert res.n_valid == len(c.blocks)
    j_blocks = [j_cardano.cardano_block_decode(j_cbor.loads(b.bytes))
                for b in c.blocks]
    from ouroboros_tpu.crypto.backend import OpensslBackend as JOpenssl
    j_res = j_batch.validate_blocks_batched(
        c.j_rules, j_blocks, c.j_rules.initial_state(), backend=JOpenssl())
    assert j_res.all_valid and j_res.n_valid == len(c.blocks)
    assert res.final_state.ledger.state_hash() \
        == j_res.final_state.ledger.state_hash()


def test_combinator_translation_hook_applied(cardano_chain):
    c = cardano_chain
    eras = list(c.rules.ledger.eras)
    marker = {}
    inner = eras[0].translate_ledger

    def translating(state):
        marker["ran"] = True
        return inner(state) if inner is not None else state

    eras[0] = dataclasses.replace(eras[0], translate_ledger=translating)
    rules = hard_fork_rules(eras)
    st = rules.initial_state()
    for b in c.blocks:
        st = rules.tick_then_reapply(st, b)
    assert marker.get("ran")
    assert st.ledger.era == SHELLEY
