"""Reference ImmutableDB on-disk format — reader + writer.

The reference stores the immutable chain as three files per chunk
(SURVEY.md §2 ImmutableDB; files named %05d.{chunk,primary,secondary},
Impl/Util.hs:60-73):

- NNNNN.chunk      the raw block bytes, concatenated
- NNNNN.primary    version byte 0x01, then (numSlots+1) Word32 BE offsets
                   into the secondary file, non-decreasing, starting at 0;
                   a repeated offset means the relative slot is empty
                   (Impl/Index/Primary.hs:82-136)
- NNNNN.secondary  fixed-size entries: Word64 BE block offset, Word16 BE
                   header offset, Word16 BE header size, Word32 BE CRC-32
                   of the block bytes, the 32-byte header hash, and
                   Word64 BE slotNo (or epochNo for an EBB)
                   (Impl/Index/Secondary.hs:59-135)

Chunk layout: `simpleChunkInfo` (uniform chunk size, EBBs allowed —
Chunks/Internal.hs:73-74): relative slot 0 of chunk N is reserved for the
EBB of epoch N, and a regular block in slot s lives in chunk s // size at
relative slot (s mod size) + 1 (Chunks/Layout.hs:185-203).  The primary
index of a chunk therefore has size+2 offsets (EBB slot + size regular
slots + the final end offset).

This module is the interop bridge of SURVEY.md §7 P2: db_synth can WRITE
this format and db_analyser can READ it (auto-detected), so our replay
tooling speaks the same on-disk dialect as the reference's db-analyser.

Ported from `ouroboros_tpu/storage/refformat.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence
from zlib import crc32

from .fs import FsApi, FsError

VERSION = 1
HASH_LEN = 32
ENTRY_SIZE = 8 + 2 + 2 + 4 + HASH_LEN + 8

DIR = ("immutable",)        # same directory our own ImmutableDB uses


def chunk_file(n: int) -> tuple:
    return DIR + ("%05d.chunk" % n,)


def primary_file(n: int) -> tuple:
    return DIR + ("%05d.primary" % n,)


def secondary_file(n: int) -> tuple:
    return DIR + ("%05d.secondary" % n,)


@dataclass(frozen=True)
class RefEntry:
    """One secondary-index entry (Secondary.hs Entry)."""
    block_offset: int                  # into the chunk file
    header_offset: int                 # header start within the block
    header_size: int
    checksum: int                      # CRC-32 of the block bytes
    header_hash: bytes
    slot_or_epoch: int                 # slotNo; epochNo when is_ebb
    is_ebb: bool

    def encode(self) -> bytes:
        return struct.pack(">QHHI", self.block_offset, self.header_offset,
                           self.header_size, self.checksum) \
            + self.header_hash + struct.pack(">Q", self.slot_or_epoch)

    @classmethod
    def decode(cls, raw: bytes, is_ebb: bool) -> "RefEntry":
        boff, hoff, hsize, crc = struct.unpack_from(">QHHI", raw, 0)
        h = raw[16:16 + HASH_LEN]
        (soe,) = struct.unpack_from(">Q", raw, 16 + HASH_LEN)
        return cls(boff, hoff, hsize, crc, h, soe, is_ebb)

    def slot(self, chunk_no: int, chunk_size: int) -> int:
        """Absolute slot number (an EBB shares the slot of the first slot
        of its epoch — slotNoOfEBB)."""
        if self.is_ebb:
            return self.slot_or_epoch * chunk_size
        return self.slot_or_epoch


class RefChunkWriter:
    """Accumulates one chunk's blocks, then emits the three files."""

    def __init__(self, chunk_no: int, chunk_size: int):
        self.chunk_no = chunk_no
        self.chunk_size = chunk_size
        self.blocks = bytearray()
        self.entries: list[RefEntry] = []
        self.rel_slots: list[int] = []

    def append(self, slot: int, header_hash: bytes, data: bytes,
               is_ebb: bool = False,
               header_offset: int = 0, header_size: int = 0) -> None:
        if is_ebb:
            # the simpleChunkInfo layout identifies chunks with epochs
            # (EBB of epoch N at relative slot 0 of chunk N); an EBB off a
            # chunk boundary would record the wrong epochNo on disk
            if slot % self.chunk_size != 0:
                raise ValueError(
                    f"EBB at slot {slot} is not on a chunk boundary: the "
                    f"reference format needs chunk_size == epoch_length "
                    f"for EBB-bearing chains (got chunk_size "
                    f"{self.chunk_size})")
            rel = 0
            soe = self.chunk_no                     # epoch number
        else:
            rel = slot % self.chunk_size + 1
            soe = slot
        self.entries.append(RefEntry(
            len(self.blocks), header_offset, header_size,
            crc32(data), header_hash, soe, is_ebb))
        self.rel_slots.append(rel)
        self.blocks += data

    def primary_bytes(self) -> bytes:
        """Version byte + the sparse offset vector (Primary.hs layout)."""
        n_slots = self.chunk_size + 1               # EBB slot + regular
        offsets = [0]
        j = 0
        cur = 0
        for rel in range(n_slots):
            if j < len(self.rel_slots) and self.rel_slots[j] == rel:
                cur += ENTRY_SIZE
                j += 1
            offsets.append(cur)
        return bytes([VERSION]) + b"".join(
            struct.pack(">I", o) for o in offsets)

    def write(self, fs: FsApi) -> None:
        fs.write_file(chunk_file(self.chunk_no), bytes(self.blocks))
        fs.write_file(secondary_file(self.chunk_no),
                      b"".join(e.encode() for e in self.entries))
        fs.write_file(primary_file(self.chunk_no), self.primary_bytes())


class RefDbWriter:
    """Streaming writer: append blocks in chain order, chunks are emitted
    as they fill (db_synth --format reference)."""

    def __init__(self, fs: FsApi, chunk_size: int,
                 epoch_length: Optional[int] = None):
        """epoch_length, when known, is validated on the first EBB: the
        reference's EBB layout identifies chunks with epochs (EBB of epoch
        N at relative slot 0 of chunk N), so EBB-bearing chains need
        chunk_size == epoch_length or the on-disk epochNo would be wrong.
        EBB-free chains (Shelley-only) may use any chunk size."""
        self.fs = fs
        self.chunk_size = chunk_size
        self.epoch_length = epoch_length
        self._cur: Optional[RefChunkWriter] = None
        fs.mkdirs(DIR)

    def _chunk_for(self, n: int) -> RefChunkWriter:
        if self._cur is not None and self._cur.chunk_no != n:
            self._cur.write(self.fs)
            self._cur = None
        if self._cur is None:
            self._cur = RefChunkWriter(n, self.chunk_size)
        return self._cur

    def append_block(self, slot: int, header_hash: bytes, data: bytes,
                     is_ebb: bool = False, header_offset: int = 0,
                     header_size: int = 0) -> None:
        if is_ebb and self.epoch_length is not None \
                and self.epoch_length != self.chunk_size:
            raise ValueError(
                f"reference format with EBBs requires chunk_size == "
                f"epoch_length (got {self.chunk_size} vs "
                f"{self.epoch_length}); pass --chunk-size equal to the "
                f"epoch length")
        n = (slot // self.chunk_size)
        self._chunk_for(n).append(slot, header_hash, data, is_ebb,
                                  header_offset, header_size)

    def close(self) -> None:
        if self._cur is not None:
            self._cur.write(self.fs)
            self._cur = None


def _chunk_numbers(fs: FsApi) -> list[int]:
    out = []
    for name in fs.list_dir(DIR):
        if name.endswith(".primary"):
            out.append(int(name[:-8]))
    return sorted(out)


def is_reference_db(fs: FsApi) -> bool:
    """True when the directory holds reference-format index files."""
    try:
        return bool(_chunk_numbers(fs))
    except FsError:
        return False


@dataclass
class RefBlock:
    entry: RefEntry
    chunk_no: int
    data: bytes


class RefDbReader:
    """Reads a reference-format ImmutableDB, CRC-validated.

    Corruption semantics mirror the reference's startup validation
    (Impl/Validation.hs): a CRC mismatch or torn index truncates the
    chain at the previous good block."""

    def __init__(self, fs: FsApi, chunk_size: int):
        self.fs = fs
        self.chunk_size = chunk_size

    def read_chunk(self, n: int) -> list[RefBlock]:
        primary = self.fs.read_file(primary_file(n))
        if not primary or primary[0] != VERSION:
            raise ValueError(f"chunk {n}: bad primary index version")
        offs = [struct.unpack_from(">I", primary, 1 + 4 * i)[0]
                for i in range((len(primary) - 1) // 4)]
        secondary = self.fs.read_file(secondary_file(n))
        blob = self.fs.read_file(chunk_file(n))
        blocks: list[RefBlock] = []
        for rel in range(len(offs) - 1):
            if offs[rel + 1] <= offs[rel]:
                continue                            # empty relative slot
            raw = secondary[offs[rel]:offs[rel] + ENTRY_SIZE]
            if len(raw) < ENTRY_SIZE:
                break                               # torn secondary tail
            blocks.append(RefBlock(
                RefEntry.decode(raw, is_ebb=(rel == 0)), n, b""))
        # second pass: slice block bytes using consecutive block offsets
        for i, rb in enumerate(blocks):
            start = rb.entry.block_offset
            end = (blocks[i + 1].entry.block_offset
                   if i + 1 < len(blocks) else len(blob))
            data = blob[start:end]
            if crc32(data) != rb.entry.checksum:
                return blocks[:i]                   # corrupt tail
            blocks[i] = RefBlock(rb.entry, n, data)
        return blocks

    def stream(self) -> Iterator[RefBlock]:
        for n in _chunk_numbers(self.fs):
            yield from self.read_chunk(n)

    def iter_entries(self) -> Iterator[RefEntry]:
        """Secondary-index entries only — no chunk blobs, no CRC: the
        cheap membership scan resume needs (is this snapshot point
        still on the chain?) without replaying the data files."""
        for n in _chunk_numbers(self.fs):
            primary = self.fs.read_file(primary_file(n))
            if not primary or primary[0] != VERSION:
                return
            offs = [struct.unpack_from(">I", primary, 1 + 4 * i)[0]
                    for i in range((len(primary) - 1) // 4)]
            secondary = self.fs.read_file(secondary_file(n))
            for rel in range(len(offs) - 1):
                if offs[rel + 1] <= offs[rel]:
                    continue
                raw = secondary[offs[rel]:offs[rel] + ENTRY_SIZE]
                if len(raw) < ENTRY_SIZE:
                    return
                yield RefEntry.decode(raw, is_ebb=(rel == 0))

    def __iter__(self) -> Iterator[RefBlock]:
        return self.stream()


class RefImmutableView:
    """Duck-typed read-only stand-in for ImmutableDB on the analyser
    path: stream() yields (entry, block bytes) like ImmutableDB.stream,
    so db_analyser replays reference-format DBs unchanged.  Membership
    (`hash in view` — the streaming engine's is-this-snapshot-point-
    still-on-chain check) scans the index files only, never the chunk
    blobs."""

    def __init__(self, reader: RefDbReader):
        self._r = reader

    def stream(self):
        for rb in self._r:
            yield rb.entry, rb.data

    def __contains__(self, h: bytes) -> bool:
        return any(e.header_hash == h for e in self._r.iter_entries())

    def __len__(self) -> int:
        return sum(1 for _ in self._r)
