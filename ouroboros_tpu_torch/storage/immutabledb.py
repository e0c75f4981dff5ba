"""ImmutableDB — append-only chunked block store with recovery.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/ImmutableDB/
(SURVEY.md §2): 3 files per chunk — `.chunk` concatenated blobs,
`.primary`/`.secondary` indices (Impl/Index/{Primary,Secondary}.hs) with
per-block CRC; chunk layout maps slots to files (Chunks/Layout.hs); startup
validation CRCs every block and truncates the corrupt tail
(Impl/Validation.hs); streaming iterators (Impl/Iterator.hs).

A simplification that keeps the semantics: one `.secondary` CBOR
index per chunk (offset/size/crc/hash/slot/block_no per entry); the primary
(slot→entry) mapping is rebuilt in memory at open — the LRU index cache of
the reference collapses into the in-memory dict.

Ported from `ouroboros_tpu/storage/immutabledb.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from ..utils import cbor
from .fs import FsApi, FsError, crc32

DIR = ("immutable",)


@dataclass(frozen=True)
class SecondaryEntry:
    """One block's index record (Impl/Index/Secondary.hs entry).

    is_ebb mirrors the reference's per-entry EBB marker: an epoch-boundary
    block may SHARE its slot with the following real block (the two
    relative slots of Chunks/Layout.hs)."""
    offset: int
    size: int
    crc: int
    hash: bytes
    prev_hash: bytes
    slot: int
    block_no: int
    is_ebb: int = 0

    def encode(self):
        return [self.offset, self.size, self.crc, self.hash, self.prev_hash,
                self.slot, self.block_no, self.is_ebb]

    @classmethod
    def decode(cls, obj):
        return cls(int(obj[0]), int(obj[1]), int(obj[2]), bytes(obj[3]),
                   bytes(obj[4]), int(obj[5]), int(obj[6]),
                   int(obj[7]) if len(obj) > 7 else 0)


def _slot_ok(tip: SecondaryEntry, slot: int, is_ebb: bool) -> bool:
    """Strictly increasing slots, except the real block following an EBB
    may share its slot (Chunks/Layout.hs relative-slot pair)."""
    if slot > tip.slot:
        return True
    return slot == tip.slot and bool(tip.is_ebb) and not is_ebb


def _chunk_file(n: int) -> tuple:
    return DIR + (f"{n:05d}.chunk",)


def _secondary_file(n: int) -> tuple:
    return DIR + (f"{n:05d}.secondary",)


class ImmutableDB:
    """Append-only store; blocks enter in strictly increasing slot order
    (they are ≥k deep, so reorgs never touch them)."""

    def __init__(self, fs: FsApi, chunk_size: int = 100):
        self.fs = fs
        self.chunk_size = chunk_size
        # chunk -> [SecondaryEntry]; slot -> (chunk, idx); hash -> slot
        self._chunks: dict[int, list[SecondaryEntry]] = {}
        self._by_slot: dict[int, tuple] = {}
        self._by_hash: dict[bytes, int] = {}
        self._tip: Optional[SecondaryEntry] = None

    # -- open + validation ----------------------------------------------------
    @classmethod
    def open(cls, fs: FsApi, chunk_size: int = 100,
             validate_all: bool = True) -> "ImmutableDB":
        """Open, validating chunks in order; the first corrupt entry
        truncates the DB there (Impl/Validation.hs tail truncation).

        Chunk numbers come from BOTH file kinds: an orphan `.secondary`
        whose `.chunk` is gone (a crash between the two deletes, or a
        lost data file) is corruption at that chunk — its stale index
        must not survive to mis-describe a future append, and every
        later chunk is past the corruption point."""
        db = cls(fs, chunk_size)
        fs.mkdirs(DIR)
        chunk_nos = sorted(
            {int(name.split(".")[0]) for name in fs.list_dir(DIR)
             if name.endswith((".chunk", ".secondary"))})
        good = True
        for n in chunk_nos:
            if not good:
                fs.remove(_chunk_file(n))          # past corruption: drop
                fs.remove(_secondary_file(n))
                continue
            good = db._load_chunk(n, validate_all)
        return db

    def _load_chunk(self, n: int, validate: bool) -> bool:
        """Load chunk n; returns False if a corrupt tail was truncated."""
        fs = self.fs
        try:
            raw_idx = fs.read_file(_secondary_file(n))
        except FsError:
            raw_idx = b""
        entries: list[SecondaryEntry] = []
        pos = 0
        while pos < len(raw_idx):
            try:
                obj, used = cbor.loads_prefix(raw_idx[pos:])
                entries.append(SecondaryEntry.decode(obj))
                pos += used
            except (cbor.CBORError, ValueError, IndexError):
                break
        try:
            chunk_len = fs.file_size(_chunk_file(n))
        except FsError:
            chunk_len = 0
        keep: list[SecondaryEntry] = []
        for e in entries:
            if e.offset + e.size > chunk_len:
                break
            if validate:
                data = fs.read_range(_chunk_file(n), e.offset, e.size)
                if crc32(data) != e.crc:
                    break
            if self._tip is not None and not _slot_ok(self._tip, e.slot,
                                                      bool(e.is_ebb)):
                break                               # non-monotone: corrupt
            keep.append(e)
            self._index(n, e)
        end_of_entries = keep[-1].offset + keep[-1].size if keep else 0
        clean = (len(keep) == len(entries) and pos >= len(raw_idx)
                 and chunk_len == end_of_entries)   # orphan chunk bytes
                                                    # (lost index) = corrupt
        if not clean:
            end = keep[-1].offset + keep[-1].size if keep else 0
            if chunk_len > end:
                fs.truncate_file(_chunk_file(n), end)
            if keep or fs.exists(_chunk_file(n)):
                fs.write_file(_secondary_file(n),
                              b"".join(cbor.dumps(e.encode())
                                       for e in keep))
            else:
                # orphan index: no data file at all — drop it rather
                # than leave an empty stub behind
                fs.remove(_secondary_file(n))
        return clean

    def _index(self, n: int, e: SecondaryEntry) -> None:
        self._chunks.setdefault(n, []).append(e)
        loc = (n, len(self._chunks[n]) - 1)
        # an EBB and its successor share a slot; the real block wins the
        # slot index (appended second), hashes stay unique
        self._by_slot[e.slot] = loc
        self._by_hash[e.hash] = loc
        self._tip = e

    # -- queries --------------------------------------------------------------
    @property
    def tip(self) -> Optional[SecondaryEntry]:
        return self._tip

    def __contains__(self, h: bytes) -> bool:
        return h in self._by_hash

    def chunk_of(self, slot: int) -> int:
        return slot // self.chunk_size

    def get_by_slot(self, slot: int) -> Optional[bytes]:
        """Block bytes at `slot`.  When an EBB shares the slot with its
        successor, this resolves to the non-EBB block (the real block wins
        the slot index); use get_by_hash/stream to reach the EBB itself."""
        loc = self._by_slot.get(slot)
        if loc is None:
            return None
        n, i = loc
        e = self._chunks[n][i]
        return self.fs.read_range(_chunk_file(n), e.offset, e.size)

    def get_by_hash(self, h: bytes) -> Optional[bytes]:
        loc = self._by_hash.get(h)
        if loc is None:
            return None
        n, i = loc
        e = self._chunks[n][i]
        return self.fs.read_range(_chunk_file(n), e.offset, e.size)

    def slot_of_hash(self, h: bytes) -> Optional[int]:
        loc = self._by_hash.get(h)
        if loc is None:
            return None
        n, i = loc
        return self._chunks[n][i].slot

    def _entry_at(self, n: int, j: int
                  ) -> Optional[tuple[SecondaryEntry, bytes]]:
        while n <= (max(self._chunks) if self._chunks else -1):
            chunk = self._chunks.get(n, [])
            if j < len(chunk):
                e = chunk[j]
                return e, self.fs.read_range(_chunk_file(n), e.offset,
                                             e.size)
            n, j = n + 1, 0
        return None

    def next_after_hash(self, h: Optional[bytes]
                        ) -> Optional[tuple[SecondaryEntry, bytes]]:
        """Chain successor of the block with hash `h` (None/unknown hash =
        start of the chain) — EBB-safe: walks chunk order, not slots."""
        if h is None:
            return self._entry_at(min(self._chunks), 0) if self._chunks \
                else None
        loc = self._by_hash.get(h)
        if loc is None:
            return None
        return self._entry_at(loc[0], loc[1] + 1)

    def entry_by_hash(self, h: bytes) -> Optional[SecondaryEntry]:
        loc = self._by_hash.get(h)
        if loc is None:
            return None
        n, i = loc
        return self._chunks[n][i]

    def stream(self, from_slot: int = 0,
               to_slot: Optional[int] = None
               ) -> Iterator[tuple[SecondaryEntry, bytes]]:
        """Iterate (entry, block bytes) in slot order (Impl/Iterator.hs)."""
        for n in sorted(self._chunks):
            for e in self._chunks[n]:
                if e.slot < from_slot:
                    continue
                if to_slot is not None and e.slot > to_slot:
                    return
                yield e, self.fs.read_range(_chunk_file(n), e.offset, e.size)

    # -- chunk-granular streaming (the storage/stream.py read path) ----------
    def chunk_numbers(self) -> list:
        return sorted(self._chunks)

    def chunk_blocks(self, n: int,
                     from_index: int = 0) -> list:
        """Chunk n's (entry, block bytes) pairs from ONE whole-file read
        — the streaming replay's disk unit (one fs op per chunk instead
        of one per block; the reference's iterator equally reads chunk
        files sequentially, Impl/Iterator.hs)."""
        entries = self._chunks.get(n, ())
        if from_index >= len(entries):
            return []
        raw = self.fs.read_file(_chunk_file(n))
        return [(e, bytes(raw[e.offset:e.offset + e.size]))
                for e in entries[from_index:]]

    def start_after(self, h: Optional[bytes]) -> Optional[tuple]:
        """(chunk, index) of the first block AFTER the one with hash `h`
        (None/genesis: the very first block) — the resume cursor for
        chunk-granular streaming.  None when `h` is unknown or nothing
        follows it."""
        if h is None:
            return (min(self._chunks), 0) if self._chunks else None
        loc = self._by_hash.get(h)
        if loc is None:
            return None
        n, j = loc[0], loc[1] + 1
        while n <= max(self._chunks):
            if j < len(self._chunks.get(n, ())):
                return (n, j)
            n, j = n + 1, 0
        return None

    def __len__(self) -> int:
        # count entries, not slots: an EBB and its successor share a slot
        # so len(self._by_slot) would undercount by one per EBB
        return sum(len(c) for c in self._chunks.values())

    # -- append ---------------------------------------------------------------
    def append_block(self, slot: int, block_no: int, h: bytes,
                     prev_hash: bytes, data: bytes,
                     is_ebb: bool = False) -> None:
        if self._tip is not None and not _slot_ok(self._tip, slot, is_ebb):
            raise ValueError(
                f"append slot {slot} not after tip slot {self._tip.slot}")
        n = self.chunk_of(slot)
        try:
            offset = self.fs.file_size(_chunk_file(n))
        except FsError:
            offset = 0
        e = SecondaryEntry(offset, len(data), crc32(data), h, prev_hash,
                           slot, block_no, int(is_ebb))
        self.fs.append_file(_chunk_file(n), data)
        self.fs.append_file(_secondary_file(n), cbor.dumps(e.encode()))
        self._index(n, e)
