"""LedgerDB — in-memory k-bounded ledger snapshots + on-disk checkpoints.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/LedgerDB/
InMemory.hs:250-449 (anchored sequence of ledger states per block up to k,
`ledgerDbPush`/`ledgerDbSwitch`), OnDisk.hs:27-421 (CBOR snapshots
`takeSnapshot`/`readSnapshot`/`trimSnapshots` named by slot, replay from
newest snapshot at open), DiskPolicy.hs.

The in-memory sequence keeps a state per block so any rollback ≤ k is a
list truncation, not a replay.  The batched validation path
(consensus/batch.py validate_blocks_batched) plugs in via `switch`'s
`apply` callback returning the window's states at once.

Ported from `ouroboros_tpu/storage/ledgerdb.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..chain.block import Point
from ..utils import cbor
from .fs import FsApi, FsError, crc32

DIR = ("ledger",)


@dataclass(frozen=True)
class DiskPolicy:
    """How many snapshots to keep, and how often to take them
    (DiskPolicy.hs)."""
    num_snapshots: int = 2
    snapshot_interval_slots: int = 100


class LedgerDB:
    """Anchored sequence: anchor state (at the immutable tip) + one state
    per volatile block (≤ k of them, newest last)."""

    def __init__(self, k: int, anchor_point: Point, anchor_state: Any):
        self.k = k
        self.anchor_point = anchor_point
        self.anchor_state = anchor_state
        self._states: list[tuple[Point, Any]] = []

    # -- queries --------------------------------------------------------------
    @property
    def current(self) -> Any:
        return self._states[-1][1] if self._states else self.anchor_state

    @property
    def tip_point(self) -> Point:
        return self._states[-1][0] if self._states else self.anchor_point

    def __len__(self) -> int:
        return len(self._states)

    def state_at(self, point: Point) -> Optional[Any]:
        """State whose tip is `point` (LocalStateQuery acquire semantics)."""
        if point == self.anchor_point:
            return self.anchor_state
        for p, s in self._states:
            if p == point:
                return s
        return None

    def past_points(self) -> list[Point]:
        return [self.anchor_point] + [p for p, _ in self._states]

    # -- updates --------------------------------------------------------------
    def push(self, point: Point, state: Any) -> None:
        """ledgerDbPush + implicit prune to k."""
        self._states.append((point, state))
        if len(self._states) > self.k:
            # the oldest state becomes the new anchor (copy-to-immutable)
            self.anchor_point, self.anchor_state = self._states[0]
            del self._states[0]

    def prune_to_slot(self, slot: int) -> None:
        """Advance the anchor until it is at or past `slot` (called when the
        immutable tip advances — the copy-to-immutable path)."""
        while self.anchor_point.slot < slot and self._states:
            self.anchor_point, self.anchor_state = self._states[0]
            del self._states[0]

    def rollback(self, n: int) -> bool:
        """Drop the newest n states; False if n > len (deeper than k)."""
        if n > len(self._states):
            return False
        if n:
            del self._states[-n:]
        return True

    def switch(self, rollback_n: int,
               apply_window: Callable[[Any], Sequence[tuple[Point, Any]]]
               ) -> bool:
        """ledgerDbSwitch: rollback n then apply a window of new blocks.

        apply_window(state_at_fork) returns the new (point, state) pairs —
        typically produced by ONE batched validate_blocks_batched call.
        """
        if rollback_n > len(self._states):
            return False
        saved = self._states[len(self._states) - rollback_n:]
        if rollback_n:
            del self._states[-rollback_n:]
        try:
            new = apply_window(self.current)
        except Exception:
            self._states.extend(saved)
            raise
        for p, s in new:
            self.push(p, s)
        return True

    # -- on-disk snapshots ----------------------------------------------------
    # Checksummed snapshot framing: MAGIC + CRC-32(body) +
    # body, where body = CBOR [point, state].  The CRC is what makes a
    # torn write DETECTABLE on filesystems without atomic whole-file
    # writes; the tmp-file + rename below is what makes the common case
    # atomic.  Files without the magic are read as the legacy unframed
    # format, so pre-existing snapshots stay restorable.
    SNAP_MAGIC = b"OSNAP1"

    @staticmethod
    def _snap_file(slot: int) -> tuple:
        return DIR + (f"snap-{slot:012d}",)

    @staticmethod
    def take_snapshot(fs: FsApi, slot: int, point: Point, state: Any,
                      encode_state: Callable[[Any], Any],
                      policy: DiskPolicy = DiskPolicy()) -> None:
        """Write a snapshot named by slot, crash-consistently: the bytes
        land in a `.tmp` sibling first and only an atomic rename
        publishes the name readers look for — a kill mid-write leaves
        the previous snapshot set intact (OnDisk.hs takeSnapshot
        discipline).  Old snapshots are trimmed to the policy
        (OnDisk.hs:343 trimSnapshots)."""
        fs.mkdirs(DIR)
        body = cbor.dumps([point.encode(), encode_state(state)])
        payload = (LedgerDB.SNAP_MAGIC
                   + crc32(body).to_bytes(4, "big") + body)
        final = LedgerDB._snap_file(slot)
        tmp = DIR + (final[-1] + ".tmp",)
        fs.write_file(tmp, payload)
        fs.rename(tmp, final)
        snaps = LedgerDB.snapshot_names(fs)
        for name in snaps[:-policy.num_snapshots]:
            fs.remove(DIR + (name,))
        # sweep staging files orphaned by earlier crashes (kill between
        # write and rename) — readers already ignore them, but each one
        # holds a full ledger state of disk forever.  Single-writer
        # discipline: one engine owns a DB dir at a time, so no live
        # .tmp can be swept out from under a concurrent writer.
        for name in fs.list_dir(DIR):
            if name.endswith(".tmp"):
                fs.remove(DIR + (name,))

    @staticmethod
    def snapshot_names(fs: FsApi) -> list:
        """Published snapshot file names, oldest first (`.tmp` staging
        files are not snapshots — a crash may leave one behind)."""
        return sorted(n for n in fs.list_dir(DIR)
                      if n.startswith("snap-") and not n.endswith(".tmp"))

    @staticmethod
    def iter_snapshots(fs: FsApi, decode_state: Callable[[Any], Any]):
        """Yield (slot, point, state) for each READABLE snapshot, newest
        first.  A corrupt or partial snapshot — bad magic-framed CRC,
        torn CBOR, undecodable state — is skipped, falling back to the
        next older one (OnDisk.hs resume; the engine also needs the
        fallback when the newest snapshot points past a truncated
        ImmutableDB)."""
        for name in reversed(LedgerDB.snapshot_names(fs)):
            try:
                raw = fs.read_file(DIR + (name,))
                magic = LedgerDB.SNAP_MAGIC
                if raw[:len(magic)] == magic:
                    want = int.from_bytes(raw[len(magic):len(magic) + 4],
                                          "big")
                    body = raw[len(magic) + 4:]
                    if crc32(body) != want:
                        continue               # torn/corrupt: fall back
                else:
                    body = raw                 # legacy unframed snapshot
                obj = cbor.loads(body)
                point = Point.decode(obj[0])
                try:
                    state = decode_state(obj[1])
                except Exception:
                    # the promise is skip-and-fall-back, whatever the
                    # codec raises: pickle.UnpicklingError on garbage
                    # legacy bytes, AttributeError/ImportError when a
                    # state class moved, anything a custom codec throws
                    continue
                yield int(name.split("-")[1]), point, state
            except (cbor.CBORError, FsError, ValueError, IndexError,
                    EOFError):
                continue

    @staticmethod
    def read_latest_snapshot(fs: FsApi,
                             decode_state: Callable[[Any], Any]
                             ) -> Optional[tuple[int, Point, Any]]:
        """Newest readable snapshot: (slot, point, state); corrupt
        snapshots are skipped, falling back to older ones."""
        for found in LedgerDB.iter_snapshots(fs, decode_state):
            return found
        return None
