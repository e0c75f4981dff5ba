"""NTP client — wall-clock drift measurement for the node.

Reference: ntp-client/src/Network/NTP/Client.hs:35-120 (withNtpClient:
status TVar, poll loop, exponential error backoff capped at 600s, forced
re-query by setting the status back to pending) and Client/{Query,Packet}.hs
(48-byte RFC-5905 packet, offset = ((t1-t0)+(t2-t3))/2, IPv4+IPv6 racing,
`minimumOfSome` requiring a quorum of responses).

The transport is injectable (the Snocket lesson): production uses UDP
sockets under the IO runtime; tests drive the same client with a scripted
transport under the simulator.

Ported from `ouroboros_tpu/node/ntp_client.py` (the port imports nothing of
the JAX package). Copied whole: it runs on the port's simharness, and
`udp_transport` opens real UDP sockets only under `io_run`, as in the
reference.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from .. import simharness as sim

NTP_PACKET_SIZE = 48
NTP_UNIX_OFFSET = 2_208_988_800          # seconds 1900-01-01 .. 1970-01-01
_MODE_CLIENT = 3
_VERSION = 4


def _to_ntp(t: float) -> tuple[int, int]:
    """Unix seconds -> (ntp seconds, ntp fraction) 32.32 fixed point."""
    sec = int(t) + NTP_UNIX_OFFSET
    frac = int((t - int(t)) * (1 << 32))
    return sec & 0xFFFFFFFF, frac & 0xFFFFFFFF


def _from_ntp(sec: int, frac: int) -> float:
    return (sec - NTP_UNIX_OFFSET) + frac / (1 << 32)


@dataclass(frozen=True)
class NtpPacket:
    """The fields the client cares about (Packet.hs NtpPacket)."""
    params: int = (_VERSION << 3) | _MODE_CLIENT   # LI=0, VN=4, mode=client
    poll: int = 0
    origin_time: float = 0.0      # t0: when the client sent the request
    receive_time: float = 0.0     # t1: when the server received it
    transmit_time: float = 0.0    # t2: when the server sent the reply

    def encode(self) -> bytes:
        o_s, o_f = _to_ntp(self.origin_time)
        r_s, r_f = _to_ntp(self.receive_time)
        t_s, t_f = _to_ntp(self.transmit_time)
        return struct.pack(
            ">BBbb" + "II" + "I" + "IIIIIIII",
            self.params, 0, self.poll, 0,
            0, 0,                     # root delay, root dispersion
            0,                        # reference id
            0, 0,                     # reference timestamp
            o_s, o_f, r_s, r_f, t_s, t_f)

    @classmethod
    def decode(cls, raw: bytes) -> "NtpPacket":
        if len(raw) < NTP_PACKET_SIZE:
            raise ValueError(f"NTP packet too short: {len(raw)}")
        fields = struct.unpack(">BBbbIIIIIIIIIII", raw[:NTP_PACKET_SIZE])
        params, _stratum, poll = fields[0], fields[1], fields[2]
        o_s, o_f, r_s, r_f, t_s, t_f = fields[9:15]
        return cls(params=params, poll=poll,
                   origin_time=_from_ntp(o_s, o_f),
                   receive_time=_from_ntp(r_s, r_f),
                   transmit_time=_from_ntp(t_s, t_f))


def clock_offset(reply: NtpPacket, destination_time: float) -> float:
    """((t1 - t0) + (t2 - t3)) / 2 (Packet.hs clockOffsetPure)."""
    return ((reply.receive_time - reply.origin_time)
            + (reply.transmit_time - destination_time)) / 2.0


def minimum_of_some(threshold: int,
                    offsets: Sequence[float]) -> Optional[float]:
    """Smallest-magnitude offset, provided a quorum responded
    (Query.hs minimumOfSome)."""
    if len(offsets) < max(1, threshold):
        return None
    return min(offsets, key=abs)


# --- status ------------------------------------------------------------------

PENDING = "pending"          # NtpSyncPending
UNAVAILABLE = "unavailable"  # NtpSyncUnavailable


@dataclass(frozen=True)
class Drift:
    """NtpDrift: successfully measured offset (seconds; + = we are behind)."""
    offset: float


@dataclass(frozen=True)
class NtpSettings:
    """Query.hs NtpSettings."""
    servers: tuple                      # opaque server addresses
    required_results: int = 3           # ntpRequiredNumberOfResults
    response_timeout: float = 1.0       # per-query wait for replies
    poll_delay: float = 300.0           # between successful queries
    initial_error_delay: float = 5.0    # fast-retry start
    max_error_delay: float = 600.0      # backoff cap (Client.hs:118)


class NtpClient:
    """Poll-loop NTP client with an injectable transport.

    transport(server, request_bytes, timeout) -> response bytes | None.
    Servers of both address families are queried concurrently — the
    reference's IPv4/IPv6 racing (Query.hs:226-271) generalised to a list.
    """

    def __init__(self, settings: NtpSettings,
                 transport: Callable, tracer=None):
        self.settings = settings
        self.transport = transport
        self.tracer = tracer
        self.status = sim.TVar(PENDING, label="ntp.status")
        self._task = None

    def _trace(self, ev):
        if self.tracer:
            self.tracer(ev)

    # -- one query round ------------------------------------------------------
    async def query_once(self) -> object:
        """Query all servers concurrently; quorum of replies -> Drift."""
        st = self.settings

        async def one(server):
            # RFC 5905: the client puts t0 in the TRANSMIT field; the server
            # echoes it back as the reply's ORIGIN field (Packet.hs
            # mkNtpPacket does the same).
            t0 = sim.now()
            req = NtpPacket(transmit_time=t0)
            try:
                raw = await self.transport(server, req.encode(),
                                           st.response_timeout)
            except Exception as e:       # noqa: BLE001 — trace and continue
                self._trace(("ntp.send_error", server, repr(e)))
                return None
            if raw is None:
                return None
            try:
                reply = NtpPacket.decode(raw)
            except ValueError as e:
                self._trace(("ntp.bad_packet", server, str(e)))
                return None
            if abs(reply.origin_time - t0) > 1e-6:
                # origin must echo our transmit — drop spoofed/stale replies
                self._trace(("ntp.origin_mismatch", server))
                return None
            return clock_offset(reply, sim.now())

        tasks = [sim.spawn(one(s), label=f"ntp.query.{i}")
                 for i, s in enumerate(st.servers)]
        offsets = [o for o in [await t.wait() for t in tasks]
                   if o is not None]
        best = minimum_of_some(st.required_results, offsets)
        if best is None:
            self._trace(("ntp.unavailable", len(offsets)))
            return UNAVAILABLE
        self._trace(("ntp.drift", best))
        return Drift(best)

    # -- client thread --------------------------------------------------------
    async def _await_pending_with_timeout(self, t: float) -> None:
        """Sleep t seconds, woken early if someone forces a re-query by
        setting the status to PENDING (Client.hs awaitPendingWithTimeout)."""
        async def waiter():
            await sim.atomically(
                lambda tx: tx.check(tx.read(self.status) == PENDING))

        await sim.timeout(t, waiter())

    async def run(self):
        """The ntpClientThread loop: query, publish, sleep; on failure
        publish UNAVAILABLE and retry with doubling delay."""
        error_delay = self.settings.initial_error_delay
        while True:
            status = await self.query_once()
            if isinstance(status, Drift):
                await sim.atomically(
                    lambda t: t.write(self.status, status))
                await self._await_pending_with_timeout(
                    self.settings.poll_delay)
                error_delay = self.settings.initial_error_delay
            else:
                await sim.atomically(
                    lambda t: t.write(self.status, UNAVAILABLE))
                self._trace(("ntp.retry_delay", error_delay))
                await self._await_pending_with_timeout(error_delay)
                error_delay = min(2 * error_delay,
                                  self.settings.max_error_delay)

    # -- public API (NtpClient record) ----------------------------------------
    def get_status(self):
        return self.status.value

    async def query_blocking(self):
        """Force a re-query and wait for its result (ntpQueryBlocking)."""
        def force(t):
            if t.read(self.status) != PENDING:
                t.write(self.status, PENDING)
        await sim.atomically(force)

        def wait_done(t):
            s = t.read(self.status)
            t.check(s != PENDING)
            return s
        return await sim.atomically(wait_done)

    def start(self):
        self._task = sim.spawn(self.run(), label="ntp.client")
        return self._task

    def stop(self):
        if self._task is not None:
            self._task.cancel()


def udp_transport(resolve=None):
    """Production transport over real UDP sockets (IO runtime only).

    Returns an async callable (server, data, timeout) -> bytes | None.
    `server` is a (host, port) pair; resolve defaults to the identity.
    """
    import asyncio
    import socket

    async def transport(server, data, timeout):
        addr = resolve(server) if resolve else server

        def blocking_io():
            family = (socket.AF_INET6 if ":" in str(addr[0])
                      else socket.AF_INET)
            s = socket.socket(family, socket.SOCK_DGRAM)
            try:
                s.settimeout(timeout)
                s.sendto(data, addr)
                raw, _ = s.recvfrom(NTP_PACKET_SIZE)
                return raw
            except OSError:
                return None
            finally:
                s.close()

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, blocking_io)

    return transport
