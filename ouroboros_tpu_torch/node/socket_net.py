"""Real-socket node networking — serve and dial over TCP/Unix sockets.

Reference: the Snocket + Socket layer (ouroboros-network-framework/src/
Ouroboros/Network/{Snocket.hs:163,Socket.hs:187} — `connectToNode` runs the
handshake then the mux over the accepted fd; `withServerNode` accepts and
runs responders).  Runs ONLY under the IO runtime (simharness.io_run);
in-sim tests use the in-memory bearers.

Ported from `ouroboros_tpu/node/socket_net.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from .. import simharness as sim
from ..network.mux import Mux
from ..network.socket_bearer import SocketBearer
from .kernel import NodeKernel, _run_initiator, _run_responder


async def serve_node(kernel: NodeKernel, host: str = "127.0.0.1",
                     port: int = 0) -> tuple[asyncio.AbstractServer, int]:
    """withServerNode: accept connections, run the responder application
    on each (handshake first, then mini-protocols)."""
    async def on_conn(reader, writer):
        peername = writer.get_extra_info("peername")
        peer_id = f"{kernel.label}<-{peername}"
        bearer = SocketBearer(reader, writer)
        mux = Mux(bearer, f"{peer_id}.mux")
        mux.start()
        try:
            outcome = await _run_responder(kernel, mux, peer_id)
            if outcome != "refused":
                # hold the fd while the responder protocols run; the
                # demuxer's end (EOF/error) is the connection-down signal
                await mux.wait_closed()
        finally:
            mux.stop()
            bearer.close()

    server = await asyncio.start_server(on_conn, host, port)
    actual_port = server.sockets[0].getsockname()[1]
    return server, actual_port


def dial_node(kernel: NodeKernel, host: str, port: int):
    """connectToNode: dial, then run the initiator application.  Returns
    the connection runner handle (completes when the connection ends)."""
    async def conn():
        reader, writer = await asyncio.open_connection(host, port)
        bearer = SocketBearer(reader, writer)
        peer_id = f"{kernel.label}->{host}:{port}"
        mux = Mux(bearer, f"{peer_id}.mux")
        mux.start()
        try:
            await _run_initiator(kernel, mux, peer_id)
        finally:
            mux.stop()
            bearer.close()

    return sim.spawn(conn(), label=f"{kernel.label}-dial-{host}:{port}")
