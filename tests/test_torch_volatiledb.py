"""The port's VolatileDB (`ouroboros_tpu_torch.storage.volatiledb`): the
`TestVolatileDB` cases of tests/test_storage.py and
`test_volatiledb_state_machine` of tests/test_storage_qsm.py (random
command sequences, corruption and reopen included, against a pure model,
shrunk on a mismatch), run against the port's copy; and the same command
sequences through both packages' VolatileDBs, whose files must be equal
byte for byte after every command.

Reference: the VolatileDB state machine of ouroboros-consensus-test
(Test/Ouroboros/Storage/VolatileDB/StateMachine.hs).

Tolerance: none.  Bytes, lengths and successor sets compare exactly.
"""
import hashlib
import random

import pytest

from ouroboros_tpu.storage import MockFS as JMockFS
from ouroboros_tpu.storage import VolatileDB as JVolatileDB
from ouroboros_tpu_torch.storage import MockFS, VolatileDB
from ouroboros_tpu_torch.storage.volatiledb import _file as _vol_file


def _blk(i: int, prev: bytes) -> tuple:
    h = bytes([i % 256, (i >> 8) % 256]) + bytes(30)
    data = b"block-%06d-" % i + b"x" * (i % 97)
    return h, prev, data


class TestVolatileDB:
    def test_put_get_successors(self):
        fs = MockFS()
        db = VolatileDB.open(fs, max_blocks_per_file=3)
        g = b"\x00" * 32
        h1, _, d1 = _blk(1, g)
        h2, _, d2 = _blk(2, h1)
        h3, _, d3 = _blk(3, h1)          # fork off h1
        db.put_block(h1, g, 1, 0, d1)
        db.put_block(h2, h1, 2, 1, d2)
        db.put_block(h3, h1, 3, 1, d3)
        assert db.get_block(h2) == d2
        assert db.filter_by_predecessor(h1) == {h2, h3}
        assert db.filter_by_predecessor(h2) == frozenset()
        db.put_block(h1, g, 1, 0, d1)     # idempotent
        assert len(db) == 3

    def test_reopen_reindexes(self):
        fs = MockFS()
        db = VolatileDB.open(fs, max_blocks_per_file=2)
        g = b"\x00" * 32
        hashes = []
        prev = g
        for i in range(7):
            h, p, d = _blk(i, prev)
            db.put_block(h, p, i, i, d)
            hashes.append((h, d))
            prev = h
        db2 = VolatileDB.open(fs, max_blocks_per_file=2)
        assert len(db2) == 7
        for h, d in hashes:
            assert db2.get_block(h) == d
        # can still add after reopen
        h, p, d = _blk(100, prev)
        db2.put_block(h, p, 100, 7, d)
        assert db2.get_block(h) == d

    def test_torn_tail_recovered(self):
        fs = MockFS()
        db = VolatileDB.open(fs, max_blocks_per_file=100)
        g = b"\x00" * 32
        h1, _, d1 = _blk(1, g)
        h2, _, d2 = _blk(2, h1)
        db.put_block(h1, g, 1, 0, d1)
        db.put_block(h2, h1, 2, 1, d2)
        path = ("volatile", "vol-00000.dat")
        fs.files[path] = fs.files[path][:-5]          # torn write on h2
        db2 = VolatileDB.open(fs, max_blocks_per_file=100)
        assert h1 in db2 and h2 not in db2
        # re-put works
        db2.put_block(h2, h1, 2, 1, d2)
        assert db2.get_block(h2) == d2

    def test_gc_by_slot(self):
        fs = MockFS()
        db = VolatileDB.open(fs, max_blocks_per_file=2)
        g = b"\x00" * 32
        prev = g
        hs = []
        for i in range(6):
            h, p, d = _blk(i, prev)
            db.put_block(h, p, i, i, d)
            hs.append(h)
            prev = h
        db.garbage_collect(4)      # files [0,1],[2,3] go; [4,5] stays
        assert hs[0] not in db and hs[3] not in db
        assert hs[4] in db and hs[5] in db
        assert not fs.exists(("volatile", "vol-00000.dat"))

    def test_model_random_ops(self):
        rng = random.Random(42)
        fs = MockFS()
        db = VolatileDB.open(fs, max_blocks_per_file=3)
        model: dict[bytes, bytes] = {}
        g = b"\x00" * 32
        all_blocks = []
        prev = g
        for i in range(60):
            h, p, d = _blk(i, prev)
            all_blocks.append((h, p, i, i, d))
            prev = h
        for step in range(200):
            op = rng.random()
            if op < 0.5 and all_blocks:
                h, p, s, bn, d = all_blocks[rng.randrange(len(all_blocks))]
                db.put_block(h, p, s, bn, d)
                model[h] = d
            elif op < 0.8 and model:
                h = rng.choice(list(model))
                assert db.get_block(h) == model[h]
            elif op < 0.9:
                # reopen round-trip
                db = VolatileDB.open(fs, max_blocks_per_file=3)
                assert len(db) == len(model)
            else:
                cut = rng.randrange(60)
                db.garbage_collect(cut)
                # model: file-granular GC only removes what db removed
                model = {h: d for h, d in model.items() if h in db}
        for h, d in model.items():
            assert db.get_block(h) == d


H = lambda i: hashlib.blake2b(b"qsm-%d" % i, digest_size=32).digest()


def run_qsm(suite_cls, seeds, n_cmds):
    for seed in seeds:
        rng = random.Random(seed)
        cmds = suite_cls.generate(rng, n_cmds)
        bad = _first_mismatch(suite_cls, cmds)
        if bad is None:
            continue
        cmds = _shrink(suite_cls, cmds)
        real_obs = suite_cls().run_real(cmds)
        model_obs = suite_cls().run_model(cmds)
        lines = [
            f"seed {seed}: real/model diverge (shrunk to "
            f"{len(cmds)} commands):"
        ]
        for c, r, m in zip(cmds, real_obs, model_obs):
            mark = "  " if r == m else "->"
            lines.append(f"{mark} {c!r}: real={r!r} model={m!r}")
        pytest.fail("\n".join(lines))


def _first_mismatch(suite_cls, cmds):
    real = suite_cls().run_real(cmds)
    model = suite_cls().run_model(cmds)
    for i, (r, m) in enumerate(zip(real, model)):
        if r != m:
            return i
    return None


def _shrink(suite_cls, cmds):
    """ddmin-style: repeatedly try removing spans, keeping the mismatch."""
    span = max(1, len(cmds) // 2)
    while span >= 1:
        i = 0
        while i < len(cmds):
            candidate = cmds[:i] + cmds[i + span:]
            if candidate and _first_mismatch(suite_cls, candidate) \
                    is not None:
                cmds = candidate
            else:
                i += span
        span //= 2
    return cmds


VOL_PER_FILE = 3


class VolSuite:
    """Model: insertion-ordered dict hash -> (prev, slot, block_no, data)
    plus file assignment by insertion order; GC drops whole files of
    old-enough blocks; torn-tail truncation drops the last file's torn
    records."""

    @staticmethod
    def generate(rng, n):
        cmds = []
        for _ in range(n):
            r = rng.random()
            if r < 0.4:
                cmds.append(("put", rng.randint(0, 30), rng.randint(0, 30),
                             rng.randint(0, 50), rng.randint(0, 40)))
            elif r < 0.55:
                cmds.append(("get", rng.randint(0, 30)))
            elif r < 0.65:
                cmds.append(("succ", rng.randint(0, 30)))
            elif r < 0.72:
                cmds.append(("len",))
            elif r < 0.82:
                cmds.append(("gc", rng.randint(0, 55)))
            elif r < 0.92:
                cmds.append(("reopen",))
            else:
                cmds.append(("truncate_tail", rng.randint(1, 30)))
        return cmds

    def __init__(self, fs_cls=MockFS, db_cls=VolatileDB):
        self.db_cls = db_cls
        self.fs = fs_cls()
        self.db = db_cls.open(self.fs, max_blocks_per_file=VOL_PER_FILE)
        self.model = {}        # hash -> (prev, slot, block_no, data)
        # explicit disk/rotation state mirroring the implementation:
        self.file_recs = {}    # file_no -> [hashes] physically in the file
        self.disk_files = set()
        self.cur_file = 0
        self.cur_count = 0

    def run_real(self, cmds):
        obs = []
        for cmd in cmds:
            op = cmd[0]
            if op == "put":
                _, hi, pi, slot, nonce = cmd
                data = b"v-%d-%d" % (hi, nonce)
                self.db.put_block(H(hi), H(pi), slot, 0, data)
                obs.append("ok")
            elif op == "get":
                obs.append(self.db.get_block(H(cmd[1])))
            elif op == "succ":
                obs.append(self.db.filter_by_predecessor(H(cmd[1])))
            elif op == "len":
                obs.append(len(self.db))
            elif op == "gc":
                self.db.garbage_collect(cmd[1])
                obs.append(len(self.db))
            elif op == "reopen":
                self.db = self.db_cls.open(self.fs,
                                           max_blocks_per_file=VOL_PER_FILE)
                obs.append(len(self.db))
            elif op == "truncate_tail":
                n = self._last_file_real()
                if n is None:
                    obs.append(None)
                    continue
                size = self.fs.file_size(_vol_file(n))
                self.fs.truncate_file(_vol_file(n), max(0, size - cmd[1]))
                self.db = self.db_cls.open(self.fs,
                                           max_blocks_per_file=VOL_PER_FILE)
                obs.append(len(self.db))
        return obs

    def _last_file_real(self):
        nos = [int(name.split("-")[1].split(".")[0])
               for name in self.fs.list_dir(("volatile",))
               if name.startswith("vol-")]
        return max(nos) if nos else None

    def run_model(self, cmds):
        obs = []
        for cmd in cmds:
            op = cmd[0]
            if op == "put":
                _, hi, pi, slot, nonce = cmd
                h = H(hi)
                if h not in self.model:
                    self.model[h] = (H(pi), slot, 0,
                                     b"v-%d-%d" % (hi, nonce))
                    self.file_recs.setdefault(self.cur_file, []).append(h)
                    self.disk_files.add(self.cur_file)
                    self.cur_count += 1
                    if self.cur_count >= VOL_PER_FILE:
                        self.cur_file += 1
                        self.cur_count = 0
                obs.append("ok")
            elif op == "get":
                e = self.model.get(H(cmd[1]))
                obs.append(None if e is None else e[3])
            elif op == "succ":
                p = H(cmd[1])
                obs.append(frozenset(h for h, e in self.model.items()
                                     if e[0] == p))
            elif op == "len":
                obs.append(len(self.model))
            elif op == "gc":
                for fn in sorted(self.disk_files):
                    if fn == self.cur_file:
                        continue
                    hashes = self.file_recs.get(fn, [])
                    if hashes and all(self.model[h][1] < cmd[1]
                                      for h in hashes):
                        for h in hashes:
                            del self.model[h]
                        del self.file_recs[fn]
                        self.disk_files.discard(fn)
                obs.append(len(self.model))
            elif op == "reopen":
                # current file/count recomputed from the disk listing
                if self.disk_files:
                    last = max(self.disk_files)
                    self.cur_file = last
                    self.cur_count = len(self.file_recs.get(last, []))
                    if self.cur_count >= VOL_PER_FILE:
                        self.cur_file += 1
                        self.cur_count = 0
                else:
                    self.cur_file, self.cur_count = 0, 0
                obs.append(len(self.model))
            elif op == "truncate_tail":
                if not self.disk_files:
                    obs.append(None)
                    continue
                last = max(self.disk_files)
                recs = self.file_recs.get(last, [])
                # record layout: header CBOR + data per record; a cut of k
                # bytes drops every record whose end lies past the new
                # length (parsing stops at the first torn record)
                from ouroboros_tpu_torch.storage.fs import crc32
                from ouroboros_tpu_torch.utils import cbor as C
                pos = 0
                ends = []
                for h in recs:
                    prev, slot, bn, data = self.model[h]
                    header = C.dumps([h, prev, slot, bn, crc32(data),
                                      len(data)])
                    pos += len(header) + len(data)
                    ends.append((h, pos))
                new_len = max(0, pos - cmd[1])
                cut_from = None
                for i, (h, end) in enumerate(ends):
                    if end > new_len:
                        cut_from = i
                        break
                if cut_from is not None:
                    for h, _end in ends[cut_from:]:
                        del self.model[h]
                    self.file_recs[last] = recs[:cut_from]
                # reopen recomputes rotation state
                self.cur_file = last
                self.cur_count = len(self.file_recs.get(last, []))
                if self.cur_count >= VOL_PER_FILE:
                    self.cur_file += 1
                    self.cur_count = 0
                obs.append(len(self.model))
        return obs


def test_volatiledb_state_machine():
    run_qsm(VolSuite, seeds=range(200), n_cmds=60)


@pytest.mark.parametrize("seed", range(4))
def test_volatiledb_files_equal_the_jax_packages(seed):
    """VolSuite's commands through both packages' VolatileDBs: every
    observation equal, and the files on each MockFS equal byte for byte
    after every command (the on-disk format is shared)."""
    cmds = VolSuite.generate(random.Random(1000 + seed), 120)
    port, ref = VolSuite(), VolSuite(JMockFS, JVolatileDB)
    for i, cmd in enumerate(cmds):
        assert port.run_real([cmd]) == ref.run_real([cmd]), (i, cmd)
        assert port.fs.files == ref.fs.files, (i, cmd)
