"""Live metrics scrape endpoint + periodic emitter — over the project's
OWN network stack.

The reference ships no metrics server (SURVEY.md §5: "everything is
tracer events"); a production node serving millions of users needs its
queue-latency quantiles and replay progress observable WHILE it runs.
Rather than bolt on an HTTP stack, the endpoint speaks the mux SDU
framing over a Snocket bearer — the exact transport every mini-protocol
uses — which buys three properties for free:

- **one implementation, two interpreters**: under `SimSnocket` the whole
  request/response cycle is deterministic simulation (tested, race-
  explored); under `TcpSnocket`/`UnixSnocket` the SAME code serves real
  scrapes through network/socket_bearer.py;
- **sim-aware time**: the periodic emitter sleeps on the runtime clock,
  so tests see exact virtual emission times;
- **clean shutdown**: server/emitter are runtime threads with explicit
  `stop()` — cancel-and-join on every exit path, no leaked threads
  (asserted by tests and the bench --smoke scrape probe).

Wire format (protocol number 0x7A50, outside every mini-protocol's
range): the client sends one SDU whose payload is ``GET /metrics``; the
server replies with the Prometheus text exposition chunked into SDUs
and terminates with one empty-payload SDU.  Anything else closes the
connection.  `scrape()` is the matching client.

Ported from `ouroboros_tpu/observe/scrape.py` (the port imports nothing
of the JAX package). Copied whole; the JAX package's `tools/obsreport.py`
is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

from .. import simharness as sim
from ..network.mux import SDU
from ..network.snocket import Snocket
from . import export as _export
from . import metrics as _metrics

#: mux protocol number of the scrape endpoint (15-bit space; mini-
#: protocols live in 0..~20, so the top of the range is ours)
SCRAPE_PROTOCOL_NUM = 0x7A50
SCRAPE_REQUEST = b"GET /metrics"

_SCRAPES = _metrics.counter("observe.scrapes_served")
_EMITS = _metrics.counter("observe.emitter_ticks")


class ScrapeServer:
    """Serve `prometheus_text(registry)` to scrapers over a Snocket.

    Lifecycle: ``await start()`` binds + spawns the accept loop;
    ``await stop()`` closes the listener and cancel-joins the accept
    loop AND every in-flight connection handler — a handler blocked on
    a silent client must not outlive the server."""

    def __init__(self, snocket: Snocket, addr,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 include_unstable: bool = True):
        self.snocket = snocket
        self.addr = addr
        self.registry = (registry if registry is not None
                         else _metrics.REGISTRY)
        self.include_unstable = include_unstable
        self.listener = None
        self._accept_task = None
        self._conns: set = set()
        self._stopping = False

    async def start(self) -> "ScrapeServer":
        self.listener = await self.snocket.listen(self.addr)
        self._accept_task = sim.spawn(self._accept_loop(),
                                      label="scrape-accept")
        return self

    async def stop(self) -> None:
        self._stopping = True
        if self.listener is not None:
            self.listener.close()
        if self._accept_task is not None:
            await self._accept_task.cancel_wait()
        for conn in list(self._conns):
            await conn.cancel_wait()
        self._conns.clear()

    async def _accept_loop(self) -> None:
        while not self._stopping:
            bearer, remote = await self.listener.accept()
            # prune finished handlers so a long-lived endpoint holds
            # only live connections
            self._conns = {c for c in self._conns if not c.done}
            conn = sim.spawn(self._handle(bearer),
                             label=f"scrape-conn-{remote}")
            self._conns.add(conn)

    async def _handle(self, bearer) -> None:
        try:
            req = await bearer.read()
            if req.num != SCRAPE_PROTOCOL_NUM \
                    or req.payload != SCRAPE_REQUEST:
                return
            text = _export.prometheus_text(
                self.registry, include_unstable=self.include_unstable)
            await send_chunked(bearer, text.encode())
            _SCRAPES.inc()
        finally:
            close = getattr(bearer, "close", None)
            if close:
                close()


async def send_chunked(bearer, payload: bytes) -> None:
    """Chunk `payload` into SDUs sized to the bearer and terminate with
    one empty SDU (the end-of-exposition marker)."""
    chunk = min(getattr(bearer, "sdu_size", 12288), 0xFFFF - 8)
    for off in range(0, len(payload), chunk):
        await bearer.write(SDU(0, 0, SCRAPE_PROTOCOL_NUM,
                               payload[off:off + chunk]))
    await bearer.write(SDU(0, 0, SCRAPE_PROTOCOL_NUM, b""))


async def scrape(snocket: Snocket, addr) -> str:
    """Dial `addr` and fetch the exposition text (the Prometheus-scraper
    analog; parse with export.parse_prometheus_text)."""
    bearer = await snocket.connect(addr)
    try:
        await bearer.write(SDU(0, 0, SCRAPE_PROTOCOL_NUM, SCRAPE_REQUEST))
        chunks = []
        while True:
            sdu = await bearer.read()
            if not sdu.payload:
                break
            chunks.append(sdu.payload)
        return b"".join(chunks).decode()
    finally:
        close = getattr(bearer, "close", None)
        if close:
            close()


class PeriodicEmitter:
    """Emit a registry snapshot every `interval` runtime seconds.

    `emit(text)` receives the Prometheus exposition (default) or
    whatever `render(registry)` returns — e.g. a JSONL line per tick
    for a log pipeline.  Runs as a runtime thread on the active clock:
    exact virtual cadence under simharness, wall cadence in production.
    ``await stop()`` cancel-joins the thread — clean shutdown on every
    exit path."""

    def __init__(self, interval: float, emit: Callable[[str], None],
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 render: Optional[Callable] = None):
        self.interval = interval
        self.emit = emit
        self.registry = (registry if registry is not None
                         else _metrics.REGISTRY)
        self.render = render or _export.prometheus_text
        self._task = None
        self._stopping = False

    async def start(self) -> "PeriodicEmitter":
        self._task = sim.spawn(self._loop(), label="observe-emitter")
        return self

    async def _loop(self) -> None:
        while not self._stopping:
            await sim.sleep(self.interval)
            if self._stopping:
                return
            self.emit(self.render(self.registry))
            _EMITS.inc()

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            await self._task.cancel_wait()
            self._task = None
