"""The stream trio's race model, held against the port's simharness and
ouro-race: tests/test_stream.py's
`test_stream_trio_sim_model_race_free_at_k16`, the three-stage
coordination of the port's `storage/stream.py` (the bounded prefetch
queue of `BlockPrefetcher` in front of `consensus/pipeline.py`'s
permit-gated producer, DEPTH windows in flight, and its oldest-first
consumer) modeled in the simulator and explored with K = 16 seeded
schedules: no unordered access pair, no deadlock, a deterministic
report, every batch drained in order, and on an early stop (a mid-stream
failure) all three threads at a terminal state.  The same model under
the JAX package's explorer gives the same report byte for byte.

Reference: tests/test_stream.py:450-453.

Tolerance: none.  Reports compare as text.
"""
import importlib

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.consensus.pipeline import DEPTH
from ouroboros_tpu_torch.storage.stream import BlockPrefetcher, StreamConfig

READ_AHEAD = 2


def make_model(sim, DEPTH, READ_AHEAD, n_batches=6, fail_at=None):
    async def main():
        batches = sim.TVar((), label="stream.batches")
        eof = sim.TVar(False, label="stream.eof")
        pending = sim.TVar((), label="pipe.pending")
        submitted = sim.TVar(0, label="pipe.submitted")
        drained = sim.TVar(0, label="pipe.drained")
        stop = sim.TVar(False, label="pipe.stop")
        done = sim.TVar(False, label="pipe.done")
        order = sim.TVar((), label="pipe.drain-order")

        async def prefetcher():
            for b in range(n_batches):
                def put(tx, b=b):
                    if tx.read(stop):
                        return True
                    tx.check(len(tx.read(batches)) < READ_AHEAD)
                    tx.write(batches, tx.read(batches) + (b,))
                    return False
                await sim.yield_()          # the read+decode
                if await sim.atomically(put):
                    break
            await sim.atomically(lambda tx: tx.write(eof, True))

        async def producer():
            while True:
                def take(tx):
                    if tx.read(stop):
                        return ("stop", None)
                    bs = tx.read(batches)
                    if bs:
                        if not (tx.read(submitted) - tx.read(drained)
                                < DEPTH):
                            tx.check(False)
                        tx.write(batches, bs[1:])
                        return ("batch", bs[0])
                    tx.check(tx.read(eof))
                    return ("eof", None)
                kind, w = await sim.atomically(take)
                if kind != "batch":
                    break
                await sim.yield_()          # the sequential pass
                await sim.atomically(lambda tx, w=w: (
                    tx.write(pending, tx.read(pending) + (w,)),
                    tx.write(submitted, tx.read(submitted) + 1)))
            await sim.atomically(lambda tx: tx.write(done, True))

        async def consumer():
            while True:
                def pop(tx):
                    p = tx.read(pending)
                    if p:
                        tx.write(pending, p[1:])
                        return p[0]
                    tx.check(tx.read(done))
                    return None
                w = await sim.atomically(pop)
                if w is None:
                    break
                await sim.yield_()          # the blocking drain
                err = fail_at is not None and w == fail_at
                await sim.atomically(lambda tx, w=w, err=err: (
                    tx.write(order, tx.read(order) + (w,)),
                    tx.write(drained, tx.read(drained) + 1),
                    err and tx.write(stop, True)))
                if err:
                    break

        pf = sim.spawn(prefetcher(), label="stream-prefetch")
        p = sim.spawn(producer(), label="pipe-producer")
        c = sim.spawn(consumer(), label="pipe-consumer")
        await p.wait()
        await c.wait()
        # the engine's finally: close() the prefetcher (it observes
        # stop at its next put) and join it
        await sim.atomically(lambda tx: tx.write(stop, True))
        await pf.wait()
        got = order.value
        assert got == tuple(range(len(got))), f"order broke: {got}"
        if fail_at is None:
            assert len(got) == n_batches
    return main


def test_the_model_is_the_ports_coordination():
    """The model's constants are the port's: the producer's permit gate
    at DEPTH windows, the prefetcher's bounded queue (`depth`, the
    engine's `read_ahead`)."""
    assert DEPTH == 2
    assert StreamConfig().read_ahead >= READ_AHEAD
    import inspect
    assert "depth" in inspect.signature(BlockPrefetcher).parameters


@pytest.mark.parametrize("fail_at", [None, 2])
def test_stream_trio_sim_model_race_free_at_k16(fail_at):
    rep = sim.explore_races(make_model(sim, DEPTH, READ_AHEAD,
                                       fail_at=fail_at), k=16, seed=0)
    assert not rep.failures, rep.render()
    assert not rep.found, rep.render()
    rep2 = sim.explore_races(make_model(sim, DEPTH, READ_AHEAD,
                                        fail_at=fail_at), k=16, seed=0)
    assert rep.render() == rep2.render()


def test_early_stop_leaks_no_sim_thread():
    _res, trace = sim.run_trace(make_model(sim, DEPTH, READ_AHEAD,
                                           fail_at=2)())
    assert not sim.leaked_threads(trace)


@pytest.mark.parametrize("fail_at", [None, 2])
def test_report_equals_the_jax_packages(fail_at):
    ref_sim = importlib.import_module("ouroboros_tpu.simharness")
    port = sim.explore_races(make_model(sim, DEPTH, READ_AHEAD,
                                        fail_at=fail_at), k=16, seed=0)
    ref = ref_sim.explore_races(make_model(ref_sim, DEPTH, READ_AHEAD,
                                           fail_at=fail_at), k=16, seed=0)
    assert port.render() == ref.render()
    _r, pt = sim.run_trace(make_model(sim, DEPTH, READ_AHEAD,
                                      fail_at=fail_at)())
    _r, rt = ref_sim.run_trace(make_model(ref_sim, DEPTH, READ_AHEAD,
                                          fail_at=fail_at)())
    assert [repr(e) for e in pt] == [repr(e) for e in rt]
