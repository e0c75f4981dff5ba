"""The port's NTP client (`ouroboros_tpu_torch.node.ntp_client`): the
seven cases of tests/test_ntp_client.py against the port's copy; packets
with numpy-seeded times encoded to the JAX package's bytes and decoded to
the same fields; and a seeded run of the poll loop (quorum, dropped and
spoofing servers, forced re-queries, error backoff) in both packages'
simulators with the same statuses, offsets, trace and end time.

Reference: ntp-client/src/Network/NTP/Client.hs, Client/{Query,Packet}.hs.

Tolerance: none for bytes, statuses and virtual times; offsets compare
exactly (the same float operations on the same inputs).
"""
import importlib

import numpy as np
import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.node.ntp_client import (
    Drift, NtpClient, NtpPacket, NtpSettings, PENDING, UNAVAILABLE,
    clock_offset, minimum_of_some,
)


# -- tests/test_ntp_client.py ------------------------------------------------

def test_packet_roundtrip():
    p = NtpPacket(origin_time=1_000_000.5, receive_time=1_000_010.25,
                  transmit_time=1_000_010.75)
    q = NtpPacket.decode(p.encode())
    for a, b in [(p.origin_time, q.origin_time),
                 (p.receive_time, q.receive_time),
                 (p.transmit_time, q.transmit_time)]:
        assert abs(a - b) < 1e-6
    with pytest.raises(ValueError):
        NtpPacket.decode(b"short")


def test_clock_offset_symmetric_path():
    # server clock 2.0s ahead; symmetric 0.1s path each way
    t0 = 100.0
    reply = NtpPacket(origin_time=t0, receive_time=t0 + 0.1 + 2.0,
                      transmit_time=t0 + 0.1 + 2.0)
    t3 = t0 + 0.2
    assert abs(clock_offset(reply, t3) - 2.0) < 1e-9


def test_minimum_of_some_quorum():
    assert minimum_of_some(3, [0.5, -0.2, 1.0]) == -0.2
    assert minimum_of_some(3, [0.5, -0.2]) is None
    assert minimum_of_some(0, [0.7]) == 0.7


def _server_transport(offsets, drop=frozenset()):
    """Scripted transport: server i replies with its clock shifted by
    offsets[i]; indices in `drop` never answer."""
    async def transport(server, data, timeout):
        if server in drop:
            await sim.sleep(timeout)
            return None
        req = NtpPacket.decode(data)
        await sim.sleep(0.05)                      # one-way delay
        now = sim.now() + offsets[server]
        # RFC 5905: server echoes the request's TRANSMIT time as origin
        reply = NtpPacket(origin_time=req.transmit_time,
                          receive_time=now, transmit_time=now)
        await sim.sleep(0.05)                      # return path
        return reply.encode()
    return transport


def test_query_once_measures_drift():
    async def main():
        client = NtpClient(
            NtpSettings(servers=(0, 1, 2), required_results=3),
            _server_transport({0: 1.5, 1: 1.52, 2: 1.48}))
        return await client.query_once()

    status = sim.run(main())
    assert isinstance(status, Drift)
    assert abs(status.offset - 1.48) < 1e-6      # min |offset| of the three


def test_query_unavailable_below_quorum():
    async def main():
        client = NtpClient(
            NtpSettings(servers=(0, 1, 2), required_results=3,
                        response_timeout=0.5),
            _server_transport({0: 1.0, 1: 1.0, 2: 1.0}, drop={1, 2}))
        return await client.query_once()

    assert sim.run(main()) == UNAVAILABLE


def test_poll_loop_and_forced_requery():
    async def main():
        client = NtpClient(
            NtpSettings(servers=(0,), required_results=1, poll_delay=100.0),
            _server_transport({0: 3.0}))
        client.start()
        st1 = await client.query_blocking()
        t_first = sim.now()
        # force an early re-query long before poll_delay elapses
        await sim.sleep(5.0)
        st2 = await client.query_blocking()
        client.stop()
        return st1, st2, sim.now() - t_first

    st1, st2, dt = sim.run(main())
    assert isinstance(st1, Drift) and isinstance(st2, Drift)
    assert dt < 10.0       # re-query happened without waiting 100s


def test_spoofed_origin_rejected():
    async def main():
        async def spoofing(server, data, timeout):
            now = sim.now() + 1.0
            # origin does NOT echo our transmit -> must be dropped
            return NtpPacket(origin_time=12345.0, receive_time=now,
                             transmit_time=now).encode()

        client = NtpClient(
            NtpSettings(servers=(0,), required_results=1), spoofing)
        return await client.query_once()

    assert sim.run(main()) == UNAVAILABLE


def test_error_backoff_doubles():
    delays = []

    async def main():
        client = NtpClient(
            NtpSettings(servers=(0,), required_results=1,
                        response_timeout=0.1, initial_error_delay=5.0),
            _server_transport({0: 0.0}, drop={0}),
            tracer=lambda ev: delays.append(ev[1])
            if ev[0] == "ntp.retry_delay" else None)
        client.start()
        await sim.sleep(40.0)
        client.stop()
        return client.get_status()

    status = sim.run(main())
    assert status == UNAVAILABLE
    assert delays[:3] == [5.0, 10.0, 20.0]


# -- the JAX package's bytes and runs -----------------------------------------

def _ntp(pkg: str):
    return importlib.import_module(f"{pkg}.node.ntp_client")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packets_encode_to_the_jax_packages_bytes(seed):
    rng = np.random.default_rng(seed)
    port, ref = _ntp("ouroboros_tpu_torch"), _ntp("ouroboros_tpu")
    for _ in range(16):
        t = [float(x) for x in rng.uniform(0, 4e9, 3)]
        poll = int(rng.integers(-128, 128))
        a = port.NtpPacket(poll=poll, origin_time=t[0], receive_time=t[1],
                           transmit_time=t[2])
        b = ref.NtpPacket(poll=poll, origin_time=t[0], receive_time=t[1],
                          transmit_time=t[2])
        raw = a.encode()
        assert raw == b.encode() and len(raw) == port.NTP_PACKET_SIZE
        raw = raw + rng.integers(0, 256, int(rng.integers(0, 8)),
                                 dtype=np.uint8).tobytes()
        assert port.NtpPacket.decode(raw) == port.NtpPacket(
            **vars(ref.NtpPacket.decode(raw)))
        dest = float(rng.uniform(0, 4e9))
        assert port.clock_offset(a, dest) == ref.clock_offset(b, dest)


def _seeded_run(pkg: str, seed: int):
    """Five servers with seeded clock offsets and delays, one dropping and
    one spoofing from a seeded time on; a client polling with a quorum
    of three, forced re-queries at seeded times, then all servers lost:
    the statuses seen, the trace and the end time."""
    rng = np.random.default_rng(seed)
    psim = importlib.import_module(f"{pkg}.simharness")
    ntp = _ntp(pkg)
    offsets = [float(x) for x in rng.normal(0, 2, 5)]
    delays = [float(x) for x in rng.uniform(0.01, 0.2, 5)]
    spoof_from = float(rng.uniform(50, 200))
    lost_at = float(rng.uniform(400, 600))
    requery = sorted(float(x) for x in rng.uniform(1, 300, 3))
    trace = []

    async def transport(server, data, timeout):
        if server == 4 or psim.now() > lost_at:
            await psim.sleep(timeout)
            return None
        req = ntp.NtpPacket.decode(data)
        await psim.sleep(delays[server])
        now = psim.now() + offsets[server]
        origin = (req.transmit_time + 1.0
                  if server == 3 and psim.now() > spoof_from
                  else req.transmit_time)
        reply = ntp.NtpPacket(origin_time=origin, receive_time=now,
                              transmit_time=now)
        await psim.sleep(delays[server] * 1.5)
        return reply.encode()

    async def main():
        client = ntp.NtpClient(
            ntp.NtpSettings(servers=(0, 1, 2, 3, 4), required_results=3,
                            response_timeout=0.5, poll_delay=120.0,
                            initial_error_delay=5.0,
                            max_error_delay=40.0),
            transport, tracer=lambda ev: trace.append(
                (round(psim.now(), 9),) + tuple(ev)))
        client.start()
        seen = []
        for t in requery:
            await psim.sleep(t - psim.now())
            seen.append(await client.query_blocking())
        await psim.sleep(lost_at + 200 - psim.now())
        seen.append(client.get_status())
        client.stop()
        return [s.offset if isinstance(s, ntp.Drift) else s for s in seen]

    statuses = psim.run(main(), seed=seed)
    return statuses, trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_poll_loop_equals_the_jax_packages(seed):
    port = _seeded_run("ouroboros_tpu_torch", seed)
    ref = _seeded_run("ouroboros_tpu", seed)
    assert port == ref
    statuses, trace = port
    assert all(isinstance(s, float) for s in statuses[:-1])
    assert statuses[-1] == UNAVAILABLE
    assert any(ev[1] == "ntp.retry_delay" for ev in trace)
