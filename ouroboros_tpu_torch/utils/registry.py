"""ResourceRegistry, RAWLock, FileLock — resource-ownership utilities.

Reference:
- ouroboros-consensus/src/Ouroboros/Consensus/Util/ResourceRegistry.hs:20-208
  — scoped ownership of resources and threads: everything allocated in a
  registry is released (in reverse allocation order) when the registry
  scope closes; leaks become errors instead of silent drips.
- ouroboros-consensus/src/Ouroboros/Consensus/Util/MonadSTM/RAWLock.hs —
  Read-Append-Write lock: many readers ∥ one appender; writer exclusive.
- ouroboros-consensus/src/Ouroboros/Consensus/Node/DbLock.hs — advisory
  on-disk lock guarding the ChainDB directory against double-open.

Ported from `ouroboros_tpu/utils/registry.py` (the port imports nothing of
the JAX package). Copied whole, over the port's `simharness`.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional

from .. import simharness as sim


class RegistryClosedError(Exception):
    """Allocation against a closed registry (ResourceRegistry.hs's
    RegistryClosedException)."""


class RegistryCloseError(Exception):
    """One or more releases failed while closing a registry (the
    ResourceRegistryThreadException aggregate)."""

    def __init__(self, errors):
        super().__init__(f"{len(errors)} release(s) failed: {errors!r}")
        self.errors = errors


class ResourceRegistry:
    """Scoped resource + thread ownership.

    Use as `async with ResourceRegistry() as reg:`; on exit every thread is
    cancelled and every resource released, newest first — the withRegistry
    bracket.  `allocate` returns a key usable for early `release`.
    """

    def __init__(self, label: str = ""):
        self.label = label
        self._next_key = 0
        self._resources: dict[int, tuple[str, Callable[[], Any]]] = {}
        self._threads: dict[int, Any] = {}
        self._closed = False

    # -- resources ------------------------------------------------------------
    def allocate(self, acquire: Callable[[], Any],
                 release: Callable[[Any], Any], label: str = "") -> tuple:
        """Acquire a resource under this registry; returns (key, resource).
        `release(resource)` runs at close (or at explicit release())."""
        self._check_open()
        resource = acquire()
        key = self._next_key
        self._next_key += 1
        self._resources[key] = (label, lambda: release(resource))
        return key, resource

    def release(self, key: int) -> None:
        """Release one resource early (ResourceRegistry.hs `release`)."""
        entry = self._resources.pop(key, None)
        if entry is not None:
            entry[1]()

    # -- threads --------------------------------------------------------------
    def fork_thread(self, coro, label: str = ""):
        """Spawn a thread owned by this registry (forkThread): it is
        cancelled when the registry closes; if it is still registered when
        it finishes, it unregisters itself."""
        self._check_open()
        key = self._next_key
        self._next_key += 1
        task = sim.spawn(self._reap(key, coro), label=label)
        self._threads[key] = task
        return task

    async def _reap(self, key: int, coro):
        try:
            return await coro
        finally:
            self._threads.pop(key, None)

    # -- lifecycle ------------------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise RegistryClosedError(
                f"registry {self.label or id(self)} is closed")

    @property
    def n_live(self) -> int:
        """Live resources + threads — the leak-detection observable
        (ResourceRegistry.hs:156-208 turns nonzero-at-close into errors;
        tests assert on this)."""
        return len(self._resources) + len(self._threads)

    async def close(self) -> list:
        """Cancel owned threads, release resources newest-first; returns
        exceptions raised by releases (collected, not rethrown — the
        reference collects into a ResourceRegistryThreadException)."""
        if self._closed:
            return []
        self._closed = True
        errors = []
        for key in sorted(self._threads, reverse=True):
            # a thread may finish (and self-unregister) while we await
            # cancellation of a later-keyed one
            task = self._threads.pop(key, None)
            if task is None:
                continue
            try:
                await task.cancel_wait()
            except Exception as e:          # noqa: BLE001 — collect, report
                errors.append(e)
        for key in sorted(self._resources, reverse=True):
            _, rel = self._resources.pop(key)
            try:
                rel()
            except Exception as e:          # noqa: BLE001
                errors.append(e)
        return errors

    async def __aenter__(self):
        return self

    async def __aexit__(self, exc_type, exc, tb):
        errors = await self.close()
        if errors and exc_type is None:
            # the reference rethrows collected release failures wrapped in
            # ResourceRegistryThreadException; don't mask an in-flight one
            raise RegistryCloseError(errors)
        if errors:
            sim.trace_event(("registry.close_errors", errors), "registry")
        return False


class PoisonedError(Exception):
    """RAWLock was poisoned by an exception in a critical section."""


class RAWLock:
    """Read-Append-Write lock over a protected value.

    Concurrency matrix (RAWLock.hs header): readers run concurrently with
    each other and with the single appender; the writer is exclusive.  A
    writer *waiting* to take the lock already blocks new readers/appenders
    (the reference's WaitingToWrite state — writers cannot be starved).
    State is one TVar of (readers, appender, writer, waiting, poisoned)
    driven through STM retry, the same shape as the reference's
    unsafeAcquire*/unsafeRelease* internals.
    """

    def __init__(self, value: Any = None):
        self._state = sim.TVar((0, False, False, False, None),
                               label="rawlock")
        self._value = sim.TVar(value, label="rawlock.value")

    # -- acquire/release internals -------------------------------------------
    async def acquire_read(self) -> Any:
        def tx(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            if poison is not None:
                raise PoisonedError(str(poison))
            t.check(not writer and not waiting)
            t.write(self._state,
                    (readers + 1, appender, writer, waiting, poison))
            return t.read(self._value)
        return await sim.atomically(tx)

    async def release_read(self) -> None:
        def tx(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            t.write(self._state,
                    (readers - 1, appender, writer, waiting, poison))
        await sim.atomically(tx)

    async def acquire_append(self) -> Any:
        def tx(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            if poison is not None:
                raise PoisonedError(str(poison))
            t.check(not appender and not writer and not waiting)
            t.write(self._state, (readers, True, writer, waiting, poison))
            return t.read(self._value)
        return await sim.atomically(tx)

    async def release_append(self, new_value: Any) -> None:
        def tx(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            t.write(self._state, (readers, False, writer, waiting, poison))
            t.write(self._value, new_value)
        await sim.atomically(tx)

    async def acquire_write(self) -> Any:
        # phase 1: announce intent — blocks new readers/appenders
        def claim(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            if poison is not None:
                raise PoisonedError(str(poison))
            t.check(not writer and not waiting)
            t.write(self._state, (readers, appender, writer, True, poison))
        await sim.atomically(claim)

        # phase 2: wait for current readers/appender to drain, then write
        def take(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            if poison is not None:
                raise PoisonedError(str(poison))
            t.check(readers == 0 and not appender)
            t.write(self._state, (0, False, True, False, poison))
            return t.read(self._value)

        try:
            return await sim.atomically(take)
        except BaseException:
            # cancelled (or poisoned) while waiting: drop the waiting flag
            # so readers/appenders aren't blocked forever.  Done without
            # awaiting (a cancelled task cannot await again); the sync
            # read-modify-write is atomic under cooperative scheduling.
            readers, appender, writer, _, poison = self._state.value
            self._state.set_notify((readers, appender, writer, False,
                                    poison))
            raise

    async def release_write(self, new_value: Any) -> None:
        def tx(t):
            readers, appender, writer, waiting, poison = t.read(self._state)
            t.write(self._state, (readers, appender, False, waiting, poison))
            t.write(self._value, new_value)
        await sim.atomically(tx)

    # -- brackets -------------------------------------------------------------
    async def with_read_access(self, fn):
        v = await self.acquire_read()
        try:
            return await fn(v)
        finally:
            await self.release_read()

    async def with_append_access(self, fn):
        """fn(value) -> (result, new_value)."""
        v = await self.acquire_append()
        try:
            result, new_v = await fn(v)
        except BaseException as e:
            await self.poison(e)
            raise
        await self.release_append(new_v)
        return result

    async def with_write_access(self, fn):
        """fn(value) -> (result, new_value)."""
        v = await self.acquire_write()
        try:
            result, new_v = await fn(v)
        except BaseException as e:
            await self.poison(e)
            raise
        await self.release_write(new_v)
        return result

    async def read(self) -> Any:
        """Read the protected value without taking the lock (RAWLock.hs
        `read`): succeeds even while a writer is *waiting* (no IO follows),
        retries only while a write is in progress."""
        def tx(t):
            _, _, writer, _, poison = t.read(self._state)
            if poison is not None:
                raise PoisonedError(str(poison))
            t.check(not writer)
            return t.read(self._value)
        return await sim.atomically(tx)

    async def poison(self, exc: BaseException) -> None:
        """Mark the lock broken: all subsequent acquires raise
        (RAWLock.hs `poison` — turns deadlock-after-crash into an error)."""
        def tx(t):
            readers, appender, writer, waiting, _ = t.read(self._state)
            t.write(self._state,
                    (readers, appender, writer, waiting, repr(exc)))
        await sim.atomically(tx)


class FileLockError(Exception):
    pass


class FileLock:
    """Advisory exclusive file lock (Node/DbLock.hs over flock).

    Non-blocking acquire: a second holder raises FileLockError immediately,
    the double-open guard for on-disk DB directories."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None

    def acquire(self) -> None:
        import fcntl
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(fd)
            raise FileLockError(
                f"lock {self.path} is held by another process") from e
        self._fd = fd

    def release(self) -> None:
        import fcntl
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
