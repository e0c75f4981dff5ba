"""Socket mux bearer — SDU framing over a real TCP/Unix stream.

Reference: network-mux/src/Network/Mux/Bearer/Socket.hs (socket bearer,
12288-byte SDUs, recv timeouts) with the wire format of Codec.hs:16-40
(8-byte header: 32-bit timestamp, mode bit + 15-bit protocol number,
16-bit length, big-endian) — byte-compatible with the in-sim QueueBearer's
SDU encoding.

IO-runtime only: reading awaits asyncio streams, which the deterministic
simulator rejects by design (tests use QueueBearer there).

Ported from `ouroboros_tpu/network/socket_bearer.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import asyncio

from .. import simharness as sim
from .mux import SDU, MuxError


class SocketBearer:
    """MuxBearer over an asyncio (reader, writer) stream pair."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, sdu_size: int = 12288,
                 read_timeout: float = 300.0):
        self.reader = reader
        self.writer = writer
        self.sdu_size = sdu_size
        self.read_timeout = read_timeout

    def _timestamp(self) -> int:
        return int(sim.now() * 1e6) & 0xFFFFFFFF

    async def write(self, sdu: SDU) -> None:
        raw = SDU(self._timestamp(), sdu.mode, sdu.num,
                  sdu.payload).encode()
        self.writer.write(raw)
        await self.writer.drain()

    async def read(self) -> SDU:
        try:
            header = await asyncio.wait_for(self.reader.readexactly(8),
                                            self.read_timeout)
            ts, mode, num, length = SDU.decode_header(header)
            payload = await asyncio.wait_for(
                self.reader.readexactly(length), self.read_timeout)
        except asyncio.IncompleteReadError as e:
            raise MuxError("bearer closed") from e
        except asyncio.TimeoutError as e:
            raise MuxError("bearer read timeout") from e
        return SDU(ts, mode, num, payload)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass
