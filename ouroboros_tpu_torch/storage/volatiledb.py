"""VolatileDB — unordered block store for the tip region.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/VolatileDB/
(SURVEY.md §2): append to the current file, rotating after
max_blocks_per_file (Impl.hs); in-memory reverse index hash→location and
successor map prev_hash→{hash} for `filterByPredecessor` (Impl/Index.hs,
Impl/State.hs); GC whole files by slot (`garbageCollect`);
corruption-tolerant parse that truncates a torn tail (Impl/Parser.hs).

Record format per block: CBOR [hash, prev_hash, slot, block_no, crc]
followed by the raw block bytes.

Ported from `ouroboros_tpu/storage/volatiledb.py` (the port imports nothing
of the JAX package). Copied whole: the port writes the JAX package's files
byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from ..utils import cbor
from .fs import FsApi, FsError, crc32

DIR = ("volatile",)


@dataclass(frozen=True)
class BlockInfo:
    hash: bytes
    prev_hash: bytes
    slot: int
    block_no: int
    file_no: int
    offset: int          # offset of the block bytes (after the header)
    size: int


def _file(n: int) -> tuple:
    return DIR + (f"vol-{n:05d}.dat",)


class VolatileDB:
    def __init__(self, fs: FsApi, max_blocks_per_file: int = 50):
        self.fs = fs
        self.max_blocks_per_file = max_blocks_per_file
        self._index: dict[bytes, BlockInfo] = {}
        self._successors: dict[bytes, set] = {}
        self._file_blocks: dict[int, list[bytes]] = {}   # file -> hashes
        self._current_file = 0
        self._current_count = 0

    # -- open + reindex -------------------------------------------------------
    @classmethod
    def open(cls, fs: FsApi, max_blocks_per_file: int = 50) -> "VolatileDB":
        db = cls(fs, max_blocks_per_file)
        fs.mkdirs(DIR)
        file_nos = sorted(int(name.split("-")[1].split(".")[0])
                          for name in fs.list_dir(DIR)
                          if name.startswith("vol-"))
        for n in file_nos:
            db._load_file(n)
        if file_nos:
            db._current_file = file_nos[-1]
            db._current_count = len(db._file_blocks.get(file_nos[-1], []))
            if db._current_count >= max_blocks_per_file:
                db._current_file += 1
                db._current_count = 0
        return db

    def _load_file(self, n: int) -> None:
        """Parse one file, truncating at the first corrupt record."""
        fs = self.fs
        raw = fs.read_file(_file(n))
        pos = 0
        while pos < len(raw):
            try:
                hdr, used = cbor.loads_prefix(raw[pos:])
                h, prev, slot, block_no, crc = (bytes(hdr[0]), bytes(hdr[1]),
                                                int(hdr[2]), int(hdr[3]),
                                                int(hdr[4]))
                size = int(hdr[5])
                start = pos + used
                data = raw[start:start + size]
                if len(data) < size or crc32(data) != crc:
                    raise ValueError("corrupt record")
            except (cbor.CBORError, ValueError, IndexError, TypeError):
                fs.truncate_file(_file(n), pos)
                break
            self._add_index(BlockInfo(h, prev, slot, block_no, n, start,
                                      size))
            pos = start + size

    def _add_index(self, info: BlockInfo) -> None:
        self._index[info.hash] = info
        self._successors.setdefault(info.prev_hash, set()).add(info.hash)
        self._file_blocks.setdefault(info.file_no, []).append(info.hash)

    # -- writes ---------------------------------------------------------------
    def put_block(self, h: bytes, prev_hash: bytes, slot: int, block_no: int,
                  data: bytes) -> None:
        """Idempotent (duplicate puts ignored, as in the reference)."""
        if h in self._index:
            return
        n = self._current_file
        header = cbor.dumps([h, prev_hash, slot, block_no, crc32(data),
                             len(data)])
        try:
            base = self.fs.file_size(_file(n))
        except FsError:
            base = 0
        self.fs.append_file(_file(n), header + data)
        self._add_index(BlockInfo(h, prev_hash, slot, block_no, n,
                                  base + len(header), len(data)))
        self._current_count += 1
        if self._current_count >= self.max_blocks_per_file:
            self._current_file += 1
            self._current_count = 0

    # -- queries --------------------------------------------------------------
    def __contains__(self, h: bytes) -> bool:
        return h in self._index

    def __len__(self) -> int:
        return len(self._index)

    def get_block(self, h: bytes) -> Optional[bytes]:
        info = self._index.get(h)
        if info is None:
            return None
        return self.fs.read_range(_file(info.file_no), info.offset, info.size)

    def block_info(self, h: bytes) -> Optional[BlockInfo]:
        return self._index.get(h)

    def filter_by_predecessor(self, prev_hash: bytes) -> frozenset:
        """Successor hashes of `prev_hash` (candidate-construction seed,
        Impl/Index.hs successor map)."""
        return frozenset(self._successors.get(prev_hash, ()))

    # -- GC -------------------------------------------------------------------
    def garbage_collect(self, slot: int) -> None:
        """Drop whole files whose blocks are all older than `slot`
        (file-granular GC, as in the reference)."""
        for n in list(self._file_blocks):
            if n == self._current_file:
                continue
            hashes = self._file_blocks[n]
            if all(self._index[h].slot < slot for h in hashes):
                for h in hashes:
                    info = self._index.pop(h)
                    succ = self._successors.get(info.prev_hash)
                    if succ:
                        succ.discard(h)
                        if not succ:
                            del self._successors[info.prev_hash]
                del self._file_blocks[n]
                self.fs.remove(_file(n))
