"""Storage layer: injectable FS, ImmutableDB, VolatileDB, LedgerDB, ChainDB
and the streaming replay engine.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/ (SURVEY.md §2
L5 storage trio + ChainDB).  Every component takes an `FsApi` so tests run
on the in-memory MockFS with fault injection (the HasFS lesson,
Storage/FS/API.hs).

Ported from `ouroboros_tpu/storage/__init__.py` (the port imports nothing of
the JAX package), with the same exports.
"""
from .fs import FsApi, IoFS, MockFS, FsError, crc32
from .immutabledb import ImmutableDB
from .volatiledb import VolatileDB
from .ledgerdb import LedgerDB, DiskPolicy
from .stream import (
    BlockPrefetcher, StreamConfig, StreamingReplayEngine,
    StreamReplayResult,
)

__all__ = [
    "FsApi", "IoFS", "MockFS", "FsError", "crc32",
    "ImmutableDB", "VolatileDB", "LedgerDB", "DiskPolicy",
    "BlockPrefetcher", "StreamConfig", "StreamingReplayEngine",
    "StreamReplayResult",
]
