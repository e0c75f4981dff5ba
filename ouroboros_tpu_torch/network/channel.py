"""Channels — in-memory duplex links used by drivers, tests, and ThreadNet.

Reference: ouroboros-network-framework/src/Ouroboros/Network/Channel.hs
(createConnectedChannels + delay/loss variants used by ThreadNet,
SURVEY.md §4.3).  Built on simharness STM queues, so whole networks run
deterministically in simulation.

Ported from `ouroboros_tpu/network/channel.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from .. import simharness as sim
from ..simharness import TBQueue


class Channel:
    """One direction-pair endpoint: send/recv of opaque items (bytes for
    wire-level channels, message objects for Direct-style tests)."""

    def __init__(self, outq: TBQueue, inq: TBQueue, delay: float = 0.0,
                 label: str = ""):
        self._out = outq
        self._in = inq
        self._delay = delay
        self.label = label

    async def send(self, item: Any) -> None:
        if self._delay:
            await sim.sleep(self._delay)
        await sim.atomically(lambda tx: self._out.put(tx, item))

    async def recv(self) -> Any:
        return await sim.atomically(self._in.get)

    async def wait_ready(self, timeout: float) -> bool:
        """Block until recv() would not block (True) or `timeout` elapses
        (False) — WITHOUT consuming anything.  The cancellation-free way to
        poll a possibly-quiescent peer (vs wrapping recv in sim.timeout,
        which can lose state in the cancelled continuation)."""
        return await sim.wait_pred(lambda tx: self._in.size(tx) > 0, timeout)



def channel_pair(capacity: int = 64, delay: float = 0.0,
                 label: str = "chan") -> Tuple[Channel, Channel]:
    """Two connected endpoints; what A sends, B receives (and vice versa)."""
    ab = TBQueue(capacity, label=f"{label}.ab")
    ba = TBQueue(capacity, label=f"{label}.ba")
    return (Channel(ab, ba, delay, label + ".A"),
            Channel(ba, ab, delay, label + ".B"))
