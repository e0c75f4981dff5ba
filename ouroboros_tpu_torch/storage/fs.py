"""Injectable file-system API with a real impl and a fault-injecting mock.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Storage/FS/API.hs
(HasFS record-of-functions), FS/IO.hs (real impl), FS/CRC.hs, and the test
mock with error injection Test/Util/FS/Sim/{MockFS,Error}.hs — the seam
that lets every storage component run against simulated disks with
injected faults (SURVEY.md §4.3).

Paths are tuples of str components relative to the FS root.

Ported from `ouroboros_tpu/storage/fs.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

import os
import zlib
from typing import Iterable, Optional


class FsError(OSError):
    """Storage-layer file system error."""


def crc32(data: bytes, prev: int = 0) -> int:
    return zlib.crc32(data, prev) & 0xFFFFFFFF


class FsApi:
    """Abstract FS: whole-file and append-oriented ops (the subset the
    storage layer needs; handles are kept internal to discourage stateful
    handle leaks — the ResourceRegistry lesson)."""

    def read_file(self, path: tuple) -> bytes:
        raise NotImplementedError

    def write_file(self, path: tuple, data: bytes) -> None:
        """Atomic whole-file write (write temp + rename)."""
        raise NotImplementedError

    def append_file(self, path: tuple, data: bytes) -> None:
        raise NotImplementedError

    def truncate_file(self, path: tuple, size: int) -> None:
        raise NotImplementedError

    def read_range(self, path: tuple, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def file_size(self, path: tuple) -> int:
        raise NotImplementedError

    def exists(self, path: tuple) -> bool:
        raise NotImplementedError

    def list_dir(self, path: tuple) -> list[str]:
        raise NotImplementedError

    def mkdirs(self, path: tuple) -> None:
        raise NotImplementedError

    def remove(self, path: tuple) -> None:
        raise NotImplementedError

    def rename(self, src: tuple, dst: tuple) -> None:
        raise NotImplementedError


class IoFS(FsApi):
    """Real directory-rooted FS (FS/IO.hs analog)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, path: tuple) -> str:
        return os.path.join(self.root, *path)

    def read_file(self, path):
        try:
            with open(self._p(path), "rb") as f:
                return f.read()
        except OSError as e:
            raise FsError(str(e)) from e

    def write_file(self, path, data):
        p = self._p(path)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def append_file(self, path, data):
        with open(self._p(path), "ab") as f:
            f.write(data)

    def truncate_file(self, path, size):
        with open(self._p(path), "r+b") as f:
            f.truncate(size)

    def read_range(self, path, offset, size):
        with open(self._p(path), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def file_size(self, path):
        try:
            return os.path.getsize(self._p(path))
        except OSError as e:
            raise FsError(str(e)) from e

    def exists(self, path):
        return os.path.exists(self._p(path))

    def list_dir(self, path):
        try:
            return sorted(os.listdir(self._p(path)))
        except FileNotFoundError:
            return []

    def mkdirs(self, path):
        os.makedirs(self._p(path), exist_ok=True)

    def remove(self, path):
        try:
            os.remove(self._p(path))
        except FileNotFoundError:
            pass

    def rename(self, src, dst):
        os.replace(self._p(src), self._p(dst))


class MockFS(FsApi):
    """In-memory FS with injectable faults (Test/Util/FS/Sim analog).

    Fault hooks:
      fail_after_ops:   raise FsError once the op counter passes N
      partial_writes:   append/write only writes a prefix once armed
    Both model the crash/torn-write scenarios the reference's storage
    state-machine tests inject (SURVEY.md §4.2 corruption commands).
    """

    def __init__(self):
        self.files: dict[tuple, bytearray] = {}
        self.dirs: set[tuple] = {()}
        self.ops = 0
        self.fail_after_ops: Optional[int] = None
        self.partial_write_next: Optional[int] = None   # keep this many bytes

    # -- fault machinery ------------------------------------------------------
    def _tick(self):
        self.ops += 1
        if self.fail_after_ops is not None and self.ops > self.fail_after_ops:
            raise FsError(f"injected failure at op {self.ops}")

    def _maybe_truncate(self, data: bytes) -> bytes:
        if self.partial_write_next is not None:
            keep = self.partial_write_next
            self.partial_write_next = None
            return data[:keep]
        return data

    def snapshot(self) -> dict:
        """Copy of all file contents — crash-recovery tests restore this."""
        return {p: bytes(d) for p, d in self.files.items()}

    def restore(self, snap: dict) -> None:
        self.files = {p: bytearray(d) for p, d in snap.items()}

    # -- FsApi ----------------------------------------------------------------
    def read_file(self, path):
        self._tick()
        if path not in self.files:
            raise FsError(f"no such file {path}")
        return bytes(self.files[path])

    def write_file(self, path, data):
        self._tick()
        self.files[path] = bytearray(self._maybe_truncate(data))

    def append_file(self, path, data):
        self._tick()
        self.files.setdefault(path, bytearray()).extend(
            self._maybe_truncate(data))

    def truncate_file(self, path, size):
        self._tick()
        if path not in self.files:
            raise FsError(f"no such file {path}")
        del self.files[path][size:]

    def read_range(self, path, offset, size):
        self._tick()
        if path not in self.files:
            raise FsError(f"no such file {path}")
        return bytes(self.files[path][offset:offset + size])

    def file_size(self, path):
        if path not in self.files:
            raise FsError(f"no such file {path}")
        return len(self.files[path])

    def exists(self, path):
        return path in self.files or path in self.dirs

    def list_dir(self, path):
        n = len(path)
        names = {p[n] for p in list(self.files) + list(self.dirs)
                 if len(p) > n and p[:n] == path}
        return sorted(names)

    def mkdirs(self, path):
        for i in range(len(path) + 1):
            self.dirs.add(path[:i])

    def remove(self, path):
        self.files.pop(path, None)

    def rename(self, src, dst):
        if src in self.files:
            self.files[dst] = self.files.pop(src)
