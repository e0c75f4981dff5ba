"""Snocket — the transport abstraction: one dial/serve surface over TCP,
Unix sockets, and in-sim bearers.

Reference: ouroboros-network-framework/src/Ouroboros/Network/Snocket.hs:
163-214 (the record of getLocalAddr/getRemoteAddr/openToConnect/connect/
bind/listen/accept/close; socketSnocket :216, localSnocket :20, the accept
loop berkeleyAccept :110), Server/ConnectionTable.hs (live-connection
tracking + duplicate refusal), Server/RateLimiting.hs (accept rate limits:
soft limit delays accepts, hard limit blocks until a connection closes).

The same node code (handshake -> mux -> mini-protocols) runs over every
implementation; deterministic tests use SimSnocket, real deployments pick
TCP or Unix by address — exactly the property the reference's record
encodes.

Ported from `ouroboros_tpu/network/snocket.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .. import simharness as sim
from ..simharness import TBQueue
from .mux import QueueBearer


class SnocketError(Exception):
    pass


class Snocket:
    """The transport record.  Bearers returned by connect/accept speak the
    mux SDU interface (write(SDU)/read() + sdu_size)."""

    async def connect(self, addr) -> Any:
        """openToConnect + connect: dial, return a bearer."""
        raise NotImplementedError

    async def listen(self, addr) -> "Listener":
        """bind + listen: return a Listener whose accept() yields
        (bearer, remote_addr)."""
        raise NotImplementedError


class Listener:
    addr: Any

    async def accept(self) -> tuple:
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# In-sim transport (the Bearer/Queues.hs analog behind the same record)
# ---------------------------------------------------------------------------

class SimSnocket(Snocket):
    """Address registry of in-memory bearer pairs; fully deterministic
    under the simulator."""

    def __init__(self, delay: float = 0.0, sdu_size: int = 12288):
        self.delay = delay
        self.sdu_size = sdu_size
        self._listeners: Dict[Any, "_SimListener"] = {}
        self._next_ephemeral = 1

    async def connect(self, addr):
        lst = self._listeners.get(addr)
        if lst is None or lst.closed:
            raise SnocketError(f"connection refused: {addr!r}")
        a2b = TBQueue(256, label=f"snocket.{addr}.c2s")
        b2a = TBQueue(256, label=f"snocket.{addr}.s2c")
        local = ("ephemeral", self._next_ephemeral)
        self._next_ephemeral += 1
        server_bearer = QueueBearer(b2a, a2b, self.sdu_size, self.delay)
        client_bearer = QueueBearer(a2b, b2a, self.sdu_size, self.delay)
        await sim.atomically(
            lambda tx: lst.pending.put(tx, (server_bearer, local)))
        return client_bearer

    async def listen(self, addr):
        if addr in self._listeners and not self._listeners[addr].closed:
            raise SnocketError(f"address in use: {addr!r}")
        lst = _SimListener(addr)
        self._listeners[addr] = lst
        return lst


class _SimListener(Listener):
    def __init__(self, addr):
        self.addr = addr
        self.pending = TBQueue(64, label=f"snocket.{addr}.accept")
        self.closed = False

    async def accept(self):
        return await sim.atomically(self.pending.get)

    def close(self):
        self.closed = True


# ---------------------------------------------------------------------------
# Real-socket transports (IO runtime only)
# ---------------------------------------------------------------------------

class TcpSnocket(Snocket):
    """socketSnocket: addr = (host, port)."""

    async def connect(self, addr):
        import asyncio

        from .socket_bearer import SocketBearer
        host, port = addr
        reader, writer = await asyncio.open_connection(host, port)
        return SocketBearer(reader, writer)

    async def listen(self, addr):
        import asyncio
        host, port = addr
        lst = _AsyncioListener()
        server = await asyncio.start_server(lst._on_conn, host, port)
        lst.server = server
        lst.addr = (host, server.sockets[0].getsockname()[1])
        return lst


class UnixSnocket(Snocket):
    """localSnocket: addr = filesystem path (the node-to-client IPC
    transport; named pipes on Windows are out of scope)."""

    async def connect(self, addr):
        import asyncio

        from .socket_bearer import SocketBearer
        reader, writer = await asyncio.open_unix_connection(addr)
        return SocketBearer(reader, writer)

    async def listen(self, addr):
        import asyncio
        lst = _AsyncioListener()
        server = await asyncio.start_unix_server(lst._on_conn, addr)
        lst.server = server
        lst.addr = addr
        return lst


class _AsyncioListener(Listener):
    def __init__(self):
        import asyncio
        self.server = None
        self.addr = None
        self._pending: "asyncio.Queue" = asyncio.Queue()
        self._conn_seq = 0

    async def _on_conn(self, reader, writer):
        from .socket_bearer import SocketBearer
        remote = writer.get_extra_info("peername")
        if not remote:
            # AF_UNIX clients are unbound (peername is "" for every one);
            # a sequence number keeps ConnectionTable keys unique
            self._conn_seq += 1
            remote = ("unix-peer", self._conn_seq)
        await self._pending.put((SocketBearer(reader, writer), remote))

    async def accept(self):
        return await self._pending.get()

    def close(self):
        if self.server is not None:
            self.server.close()


def snocket_for(addr, sim_registry: Optional[SimSnocket] = None) -> Snocket:
    """Address-family dispatch (Snocket.hs AddressFamily): tuples are TCP,
    strings are Unix paths, anything else resolves against the sim
    registry."""
    if isinstance(addr, tuple) and len(addr) == 2 \
            and isinstance(addr[1], int):
        return TcpSnocket()
    if isinstance(addr, str) and addr.startswith("/"):
        return UnixSnocket()
    if sim_registry is not None:
        return sim_registry
    raise SnocketError(f"no transport for address {addr!r}")


# ---------------------------------------------------------------------------
# ConnectionTable + accept rate limiting (the server side of Socket.hs)
# ---------------------------------------------------------------------------

class ConnectionTable:
    """Live-connection bookkeeping (Server/ConnectionTable.hs): refuse a
    second connection to the same remote, expose counts for limits."""

    def __init__(self):
        self._conns: Dict[Any, Any] = {}

    def __len__(self) -> int:
        return len(self._conns)

    def include(self, remote, handle=None) -> bool:
        """Register; False if the remote is already connected."""
        if remote in self._conns:
            return False
        self._conns[remote] = handle
        return True

    def remove(self, remote) -> None:
        self._conns.pop(remote, None)

    def __contains__(self, remote) -> bool:
        return remote in self._conns


@dataclass(frozen=True)
class AcceptLimits:
    """Server/RateLimiting.hs AcceptedConnectionsLimit."""
    hard_limit: int = 512              # block accepts at this many live
    soft_limit: int = 384              # above this, delay each accept
    delay: float = 5.0                 # the soft-limit pacing delay


async def run_server(listener: Listener, handler: Callable,
                     table: Optional[ConnectionTable] = None,
                     limits: AcceptLimits = AcceptLimits()) -> None:
    """The accept loop (berkeleyAccept + rate limiting): accept, apply
    limits, register in the table, fork the handler.  `handler(bearer,
    remote)` runs as its own thread; the table slot frees when it ends."""
    table = table if table is not None else ConnectionTable()
    while True:
        while len(table) >= limits.hard_limit:
            await sim.sleep(limits.delay)      # hard limit: stop accepting
        bearer, remote = await listener.accept()
        if len(table) >= limits.soft_limit:
            await sim.sleep(limits.delay)      # soft limit: pace accepts
        if not table.include(remote):
            close = getattr(bearer, "close", None)
            if close:
                close()
            sim.trace_event(("server-duplicate-conn", remote))
            continue

        async def run(bearer=bearer, remote=remote):
            try:
                await handler(bearer, remote)
            finally:
                table.remove(remote)
                close = getattr(bearer, "close", None)
                if close:
                    close()

        sim.spawn(run(), label=f"server-conn-{remote}")
