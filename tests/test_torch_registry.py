"""The port's ResourceRegistry, RAWLock and FileLock
(`ouroboros_tpu_torch.utils.registry`, over the port's simharness):
tests/test_registry.py's cases, run against the port's copies.

Reference: Util/ResourceRegistry.hs, Util/MonadSTM/RAWLock.hs,
Node/DbLock.hs.
"""
import os

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.utils.registry import (
    FileLock, FileLockError, PoisonedError, RAWLock, RegistryClosedError,
    ResourceRegistry,
)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

class TestResourceRegistry:
    def test_release_reverse_order_at_close(self):
        order = []

        async def main():
            async with ResourceRegistry() as reg:
                reg.allocate(lambda: "a", lambda r: order.append(r))
                reg.allocate(lambda: "b", lambda r: order.append(r))
                reg.allocate(lambda: "c", lambda r: order.append(r))
            return True

        assert sim.run(main())
        assert order == ["c", "b", "a"]

    def test_early_release_and_leak_count(self):
        async def main():
            reg = ResourceRegistry()
            k1, _ = reg.allocate(lambda: 1, lambda r: None)
            k2, _ = reg.allocate(lambda: 2, lambda r: None)
            assert reg.n_live == 2
            reg.release(k1)
            assert reg.n_live == 1
            await reg.close()
            assert reg.n_live == 0
            with pytest.raises(RegistryClosedError):
                reg.allocate(lambda: 3, lambda r: None)
            return True

        assert sim.run(main())

    def test_threads_cancelled_at_close(self):
        cancelled = []

        async def main():
            async with ResourceRegistry() as reg:
                async def forever(tag):
                    try:
                        while True:
                            await sim.sleep(1.0)
                    except sim.AsyncCancelled:
                        cancelled.append(tag)
                        raise

                reg.fork_thread(forever("t1"), label="t1")
                reg.fork_thread(forever("t2"), label="t2")
                await sim.sleep(0.5)
                assert reg.n_live == 2
            return True

        assert sim.run(main())
        assert sorted(cancelled) == ["t1", "t2"]

    def test_finished_thread_unregisters(self):
        async def main():
            async with ResourceRegistry() as reg:
                async def quick():
                    await sim.sleep(0.1)
                    return 42

                t = reg.fork_thread(quick(), label="quick")
                assert await t.wait() == 42
                await sim.yield_()
                return reg.n_live

        assert sim.run(main()) == 0

    def test_release_errors_collected(self):
        async def main():
            reg = ResourceRegistry()

            def boom(_r):
                raise RuntimeError("release failed")

            reg.allocate(lambda: 1, boom)
            reg.allocate(lambda: 2, lambda r: None)
            errors = await reg.close()
            return errors

        errors = sim.run(main())
        assert len(errors) == 1 and "release failed" in str(errors[0])

    def test_aexit_raises_aggregate_on_release_failure(self):
        from ouroboros_tpu_torch.utils.registry import RegistryCloseError

        async def main():
            async with ResourceRegistry() as reg:
                reg.allocate(lambda: 1,
                             lambda r: (_ for _ in ()).throw(
                                 RuntimeError("bad release")))
            return True

        with pytest.raises(RegistryCloseError, match="bad release"):
            sim.run(main())


class TestRAWLock:
    def test_readers_concurrent_with_appender(self):
        async def main():
            lock = RAWLock(value=0)
            events = []

            async def reader(tag):
                async def body(v):
                    events.append(("r-in", tag))
                    await sim.sleep(1.0)
                    events.append(("r-out", tag))
                    return v
                return await lock.with_read_access(body)

            async def appender():
                async def body(v):
                    events.append(("a-in", None))
                    await sim.sleep(1.0)
                    events.append(("a-out", None))
                    return None, v + 1
                return await lock.with_append_access(body)

            ts = [sim.spawn(reader(i), label=f"r{i}") for i in range(2)]
            ta = sim.spawn(appender(), label="a")
            for t in ts:
                await t.wait()
            await ta.wait()
            # all three entered before any left => fully concurrent
            ins = [e for e, _ in events[:3]]
            assert sorted(ins) == ["a-in", "r-in", "r-in"]
            return await lock.read()

        assert sim.run(main()) == 1

    def test_writer_exclusive(self):
        async def main():
            lock = RAWLock(value=0)
            events = []

            async def writer():
                async def body(v):
                    events.append("w-in")
                    await sim.sleep(1.0)
                    events.append("w-out")
                    return None, v + 100
                await lock.with_write_access(body)

            async def reader():
                await sim.sleep(0.1)    # arrive while writer holds the lock
                async def body(v):
                    events.append(("r", v))
                    return v
                return await lock.with_read_access(body)

            tw = sim.spawn(writer(), label="w")
            tr = sim.spawn(reader(), label="r")
            await tw.wait()
            await tr.wait()
            # reader entered only after the writer finished, saw new value
            assert events == ["w-in", "w-out", ("r", 100)]
            return True

        assert sim.run(main())

    def test_waiting_writer_blocks_new_readers(self):
        async def main():
            lock = RAWLock(value=0)
            order = []

            async def slow_reader():
                async def body(v):
                    order.append("r1-in")
                    await sim.sleep(2.0)
                    order.append("r1-out")
                    return v
                await lock.with_read_access(body)

            async def writer():
                await sim.sleep(0.5)   # r1 holds the lock; we queue up
                async def body(v):
                    order.append("w-in")
                    return None, v + 1
                await lock.with_write_access(body)

            async def late_reader():
                await sim.sleep(1.0)   # writer already waiting -> we block
                async def body(v):
                    order.append(("r2", v))
                    return v
                await lock.with_read_access(body)

            t1 = sim.spawn(slow_reader(), label="r1")
            t2 = sim.spawn(writer(), label="w")
            t3 = sim.spawn(late_reader(), label="r2")
            for t in (t1, t2, t3):
                await t.wait()
            # late reader must run AFTER the waiting writer (no starvation)
            assert order == ["r1-in", "r1-out", "w-in", ("r2", 1)]
            return True

        assert sim.run(main())

    def test_cancelled_waiting_writer_releases_claim(self):
        async def main():
            lock = RAWLock(value=0)

            async def hold_read():
                async def body(v):
                    await sim.sleep(5.0)
                    return v
                await lock.with_read_access(body)

            tr = sim.spawn(hold_read(), label="r")
            await sim.sleep(0.1)

            async def writer():
                async def body(v):
                    return None, v + 1
                await lock.with_write_access(body)

            tw = sim.spawn(writer(), label="w")
            await sim.sleep(0.1)        # writer now waiting on the reader
            tw.cancel()
            await sim.sleep(0.1)
            # the waiting flag must be gone: a new reader gets in while
            # the original reader still holds the lock
            async def quick(v):
                return v
            got = await lock.with_read_access(quick)
            await tr.wait()
            return got

        assert sim.run(main()) == 0

    def test_poisoned_lock_raises(self):
        async def main():
            lock = RAWLock(value=0)

            async def bad(v):
                raise ValueError("crashed in critical section")

            with pytest.raises(ValueError):
                await lock.with_write_access(bad)
            with pytest.raises(PoisonedError):
                await lock.acquire_read()
            with pytest.raises(PoisonedError):
                await lock.read()
            return True

        assert sim.run(main())


class TestFileLock:
    def test_exclusive_between_lock_objects(self, tmp_path):
        path = str(tmp_path / "db.lock")
        with FileLock(path):
            # same-process second flock on a separate fd succeeds on some
            # platforms only across processes; emulate via subprocess
            import subprocess
            import sys
            code = (
                "import sys; sys.path.insert(0, %r); "
                "from ouroboros_tpu_torch.utils.registry import FileLock, "
                "FileLockError\n"
                "try:\n"
                "    FileLock(%r).acquire()\n"
                "    print('ACQUIRED')\n"
                "except FileLockError:\n"
                "    print('BLOCKED')\n" % (REPO, path))
            out = subprocess.run([sys.executable, "-c", code],
                                 capture_output=True, text=True)
            assert out.stdout.strip() == "BLOCKED"
        # after release, a fresh lock can be taken
        fl = FileLock(path)
        fl.acquire()
        fl.release()
