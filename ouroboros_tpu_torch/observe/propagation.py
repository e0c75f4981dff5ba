"""Block-propagation lifecycle tracking + fleet-wide aggregation.

The only question that matters on an O(100)-node diffusion net is "did
the fleet converge, and how fast did a block propagate" — the reference
answers it with per-peer network tracers whose timestamps an offline
tool correlates.  Here each node keeps a :class:`PropagationTracker`: a
bounded per-block-hash timeline of lifecycle stages on the RUNTIME
clock (exact virtual times under simharness, monotonic host time in
production):

    header_seen    first ChainSync roll-forward carrying the header
    fetch_decided  BlockFetch decision logic assigned the block to a peer
    body_arrived   the block body landed from a BlockFetch response
    validated      the header passed batched validation
    adopted        chain selection made the block part of our chain

Each mark feeds the ``net.propagation.*`` stage-delta histograms and
(when a tracer is attached) emits a typed :class:`TraceBlockPropagation`
event, so the lifecycle is visible live on the scrape endpoint AND in
the typed event log.

:class:`FleetTelemetry` merges per-node timelines into the fleet
report: time-to-50%/95%-adoption quantiles, per-edge delivery latency
(receiver's first-header-seen minus the sender's adoption), partition
healing times (first cross-partition delivery after the window closes),
and the per-peer mux byte accounting from
:mod:`observe.netmetrics`.  Every aggregate is a pure sorted-order
function of the recorded virtual timestamps, so two replays of one
seeded chaos run produce byte-identical reports (the chaos
fleet's determinism gate).

Ported from `ouroboros_tpu/observe/propagation.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import netmetrics as _net
from .spans import monotonic_now as _now

STAGES = ("header_seen", "fetch_decided", "body_arrived", "validated",
          "adopted")

# stage-delta histograms, pre-bound (OBS002); only recorded when BOTH
# endpoints of the pair were marked on this node
_STAGE_HISTS: Dict[Tuple[str, str], _metrics.Histogram] = {
    ("header_seen", "fetch_decided"):
        _metrics.latency_histogram("net.propagation.header_to_decided_secs"),
    ("fetch_decided", "body_arrived"):
        _metrics.latency_histogram("net.propagation.decided_to_body_secs"),
    ("header_seen", "validated"):
        _metrics.latency_histogram("net.propagation.header_to_validated_secs"),
    ("body_arrived", "adopted"):
        _metrics.latency_histogram("net.propagation.body_to_adopted_secs"),
    ("header_seen", "adopted"):
        _metrics.latency_histogram("net.propagation.header_to_adopted_secs"),
}
_BLOCKS_TRACKED = _metrics.counter("net.propagation.blocks_tracked",
                                   stable=False)


@dataclass(frozen=True)
class TraceBlockPropagation:
    """Typed tracer event: one lifecycle stage of one block on one node.
    `t` is the runtime-clock reading the stage was recorded at."""
    node: str
    stage: str
    hash: bytes
    t: float
    peer: Any = None


class PropagationTracker:
    """One node's per-block lifecycle timeline, keyed by block hash.

    Bounded: at most `cap` block hashes are tracked; the oldest entry is
    evicted when a new hash arrives at capacity (a long-lived node must
    not accumulate a timeline per historical block).  `mark` records the
    FIRST time a stage is reached — later duplicates are ignored, so
    `header_seen` really is first-header-seen even with many peers."""

    def __init__(self, node: str = "node", cap: int = 4096, tracer=None):
        self.node = node
        self.cap = cap
        self.tracer = tracer
        # hash -> {stage: (t, peer)}
        self.timeline: "OrderedDict[bytes, dict]" = OrderedDict()

    def mark(self, stage: str, h: bytes, peer=None,
             t: Optional[float] = None) -> bool:
        """Record `stage` for block `h` at `t` (default: now on the
        runtime clock).  True when the stage was newly recorded."""
        entry = self.timeline.get(h)
        if entry is None:
            if len(self.timeline) >= self.cap:
                self.timeline.popitem(last=False)
            entry = self.timeline[h] = {}
            _BLOCKS_TRACKED.inc()
        if stage in entry:
            return False
        t = _now() if t is None else t
        entry[stage] = (t, peer)
        for (a, b), hist in _STAGE_HISTS.items():
            if b == stage and a in entry:
                hist.observe(t - entry[a][0])
        tracer = self.tracer
        if tracer is not None and tracer.active:
            tracer.trace(TraceBlockPropagation(
                node=self.node, stage=stage, hash=h, t=t, peer=peer))
        return True

    def stage_time(self, h: bytes, stage: str) -> Optional[float]:
        rec = self.timeline.get(h, {}).get(stage)
        return rec[0] if rec is not None else None

    def stage_peer(self, h: bytes, stage: str):
        rec = self.timeline.get(h, {}).get(stage)
        return rec[1] if rec is not None else None


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Deterministic nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return None
    i = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return round(sorted_vals[i], 9)


def _dist(vals: List[float]) -> dict:
    vals = sorted(vals)
    return {"n": len(vals),
            "p50": _quantile(vals, 0.50),
            "p95": _quantile(vals, 0.95),
            "max": round(vals[-1], 9) if vals else None}


class FleetTelemetry:
    """Merge per-node :class:`PropagationTracker` timelines into the
    fleet report.  `partitions` are the run's scheduled partitions
    (objects with ``start``/``end``/``groups``) so healing times can be
    attributed to the window that caused them."""

    def __init__(self, partitions=()):
        self.partitions = tuple(partitions)
        self.trackers: "OrderedDict[str, PropagationTracker]" = OrderedDict()

    def tracker(self, node: str, cap: int = 4096,
                tracer=None) -> PropagationTracker:
        """Create (or return) the tracker for `node` and register it."""
        t = self.trackers.get(node)
        if t is None:
            t = self.trackers[node] = PropagationTracker(
                node=node, cap=cap, tracer=tracer)
        return t

    def attach(self, tracker: PropagationTracker) -> None:
        self.trackers[tracker.node] = tracker

    # -- delivery edges ------------------------------------------------------
    def _deliveries(self) -> List[tuple]:
        """(t_received, sender, receiver, hash) for every first-header
        delivery whose sender had already adopted the block — the
        cross-node propagation events edge latency and partition healing
        are computed from.  The receiver's ChainSync peer id is
        `receiver->sender` (the initiator dials the server it pulls
        headers from)."""
        out = []
        for receiver in sorted(self.trackers):
            tr = self.trackers[receiver]
            for h in tr.timeline:
                rec = tr.timeline[h].get("header_seen")
                if rec is None or rec[1] is None:
                    continue
                t, peer = rec
                peer = str(peer)
                sender = peer.split("->", 1)[1] if "->" in peer else peer
                out.append((t, sender, receiver, h))
        out.sort(key=lambda d: (d[0], d[1], d[2], d[3]))
        return out

    def _group_of(self, partition, node: str) -> Optional[int]:
        for i, g in enumerate(partition.groups):
            if node in g:
                return i
        return None

    # -- the report ----------------------------------------------------------
    def report(self) -> dict:
        """The fleet report: a plain JSON-safe dict, byte-identical (via
        ``json.dumps(..., sort_keys=True)``) across replays of one
        seeded run."""
        nodes = sorted(self.trackers)
        n = len(nodes)
        need_50 = math.ceil(0.5 * n) if n else 0
        need_95 = math.ceil(0.95 * n) if n else 0

        # -- adoption quantiles ---------------------------------------------
        all_hashes = sorted({h for tr in self.trackers.values()
                             for h in tr.timeline})
        per_block: List[dict] = []
        to_50: List[float] = []
        to_95: List[float] = []
        for h in all_hashes:
            times = sorted(t for t in
                           (tr.stage_time(h, "adopted")
                            for tr in self.trackers.values())
                           if t is not None)
            if not times:
                continue
            t0 = times[0]
            row = {"hash": h.hex(), "nodes_adopted": len(times),
                   "t_first_adopted": round(t0, 9),
                   "to_50": None, "to_95": None}
            if need_50 and len(times) >= need_50:
                row["to_50"] = round(times[need_50 - 1] - t0, 9)
                to_50.append(row["to_50"])
            if need_95 and len(times) >= need_95:
                row["to_95"] = round(times[need_95 - 1] - t0, 9)
                to_95.append(row["to_95"])
            per_block.append(row)
        per_block.sort(key=lambda r: (r["t_first_adopted"], r["hash"]))

        # -- per-edge delivery latency --------------------------------------
        deliveries = self._deliveries()
        edge_lat: Dict[str, List[float]] = {}
        for t, sender, receiver, h in deliveries:
            sender_tr = self.trackers.get(sender)
            if sender_tr is None:
                continue
            st = sender_tr.stage_time(h, "adopted")
            if st is None or t < st:
                continue
            edge_lat.setdefault(f"{sender}->{receiver}",
                                []).append(t - st)

        # -- partition healing ----------------------------------------------
        healing: List[dict] = []
        for p in self.partitions:
            healed: Optional[float] = None
            for t, sender, receiver, _h in deliveries:
                if t < p.end:
                    continue
                gs = self._group_of(p, sender)
                gr = self._group_of(p, receiver)
                if gs is not None and gr is not None and gs != gr:
                    healed = round(t - p.end, 9)
                    break
            healing.append({"start": p.start, "end": p.end,
                            "healed_after_secs": healed})

        return {
            "nodes": nodes,
            "adoption": {
                "blocks": len(per_block),
                "fully_adopted_blocks": sum(
                    1 for r in per_block if r["nodes_adopted"] == n),
                "time_to_50": _dist(to_50),
                "time_to_95": _dist(to_95),
                "per_block": per_block,
            },
            "per_edge_delivery": {
                edge: _dist(edge_lat[edge]) for edge in sorted(edge_lat)},
            "partitions": healing,
            "mux": _net.mux_accounting(),
        }

    def report_json(self) -> str:
        import json
        return json.dumps(self.report(), sort_keys=True,
                          separators=(",", ":"))
