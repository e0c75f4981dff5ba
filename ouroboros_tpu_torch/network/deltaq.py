"""DeltaQ/GSV — per-peer latency model driving BlockFetch peer ordering.

Reference: ouroboros-network/src/Ouroboros/Network/DeltaQ.hs:175-328
(`GSV` = G geographic/propagation delay + S size-scaled serialisation time
+ V variance; `PeerGSV` {outbound, inbound}; `gsvRequestResponseDuration`
estimating a request/response exchange), fed online by KeepAlive RTT
probes (KeepAlive.hs:41-55) and mux SDU timestamps
(network-mux/src/Network/Mux/DeltaQ/TraceStats.hs one-way-delay mins).

Ported from `ouroboros_tpu/network/deltaq.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..observe import metrics as _metrics
from ..observe import netmetrics as _net

# per-protocol round-trip latency: the KeepAlive probe is the
# protocol that measures a true RTT; BlockFetch/handshake request
# latencies live beside it under the same net.rtt.* namespace (bound in
# node/block_fetch.py and node/kernel.py).  Handles pre-bound (OBS002).
_RTT_KEEPALIVE = _metrics.latency_histogram("net.rtt.keepalive_secs")
_OWD_SECS = _metrics.latency_histogram("net.deltaq.owd_secs")


@dataclass(frozen=True)
class GSV:
    """One direction's latency model.

    g -- propagation delay (seconds), the minimum observed
    s -- serialisation time per byte (seconds/byte)
    v -- variance proxy: mean positive deviation from g (seconds)
    """
    g: float = 0.0
    s: float = 2e-6          # ~4 Mb/s default until measured (DeltaQ.hs
                             # defaultGSV ballpark)
    v: float = 0.0

    def duration(self, nbytes: int) -> float:
        return self.g + self.s * nbytes + self.v


@dataclass(frozen=True)
class PeerGSV:
    """Both directions (DeltaQ.hs:187 `PeerGSV`)."""
    outbound: GSV = GSV()
    inbound: GSV = GSV()

    def request_response_duration(self, req_bytes: int,
                                  resp_bytes: int) -> float:
        """gsvRequestResponseDuration: one exchange's expected time."""
        return (self.outbound.duration(req_bytes)
                + self.inbound.duration(resp_bytes))


class PeerGSVTracker:
    """Online estimator: min-tracking for G, EWMA for V, differential
    size fit for S (TraceStats.hs accumulates per-SDU samples the same
    way: min one-way-delay as the G estimate, deviations as V)."""

    def __init__(self, alpha: float = 0.2,
                 label: Optional[str] = None):
        self.alpha = alpha
        self.gsv = PeerGSV()
        self._rtt_count = 0
        self._owd_count = 0
        # when labelled, every accepted sample publishes the inbound GSV
        # estimate as per-peer gauges (net.deltaq.{g,s,v}) through the
        # bounded-label helper — live DeltaQ state on the scrape endpoint
        self._label = label
        self._gauges = None

    def _publish(self) -> None:
        if self._label is None or not _metrics.REGISTRY.enabled:
            return
        g = self._gauges
        if g is None:
            peer = _net.peer_label(self._label)
            g = self._gauges = (
                _net.labeled_gauge("net.deltaq.g_secs", peer=peer),
                _net.labeled_gauge("net.deltaq.s_secs_per_byte",
                                   peer=peer),
                _net.labeled_gauge("net.deltaq.v_secs", peer=peer))
        inn = self.gsv.inbound
        g[0].set(inn.g)
        g[1].set(inn.s)
        g[2].set(inn.v)

    def observe_rtt(self, rtt: float) -> None:
        """A KeepAlive round-trip for a tiny payload: attribute half to
        each direction's G (the probe body is ~bytes, S negligible)."""
        _RTT_KEEPALIVE.observe(rtt)
        half = rtt / 2.0
        self._rtt_count += 1
        out, inn = self.gsv.outbound, self.gsv.inbound
        if self._rtt_count == 1:
            # keep a better inbound G already learned from SDU timestamps
            in_g = min(inn.g, half) if self._owd_count else half
            self.gsv = PeerGSV(replace(out, g=half), replace(inn, g=in_g))
            self._publish()
            return
        new_out = self._update_dir(out, half)
        new_in = self._update_dir(inn, half)
        self.gsv = PeerGSV(new_out, new_in)
        self._publish()

    def _update_dir(self, d: GSV, sample_g: float) -> GSV:
        g = min(d.g, sample_g)
        dev = max(0.0, sample_g - g)
        v = (1 - self.alpha) * d.v + self.alpha * dev
        return replace(d, g=g, v=v)

    def observe_owd(self, owd: float, nbytes: int) -> None:
        """A per-SDU one-way-delay sample from the mux demuxer's
        timestamp difference (DeltaQ/TraceStats.hs): min-tracked G,
        deviations into V, and for sized SDUs a per-byte S refinement —
        passive estimation with no KeepAlive traffic needed."""
        inn = self.gsv.inbound
        # first inbound sample initialises G (0.0 default = "unmeasured");
        # a separate counter so RTT/transfer initialisation stays intact
        first = self._owd_count == 0 and self._rtt_count == 0
        g = owd if first else min(inn.g, owd)
        dev = max(0.0, owd - g)
        v = (1 - self.alpha) * inn.v + self.alpha * dev
        s = inn.s
        if nbytes >= 4096 and owd > g:
            s_sample = (owd - g) / nbytes
            s = min(s, s_sample)
        self.gsv = PeerGSV(self.gsv.outbound,
                           replace(inn, g=g, v=v, s=s))
        self._owd_count += 1
        _OWD_SECS.observe(owd)
        self._publish()

    def observe_transfer(self, nbytes: int, duration: float) -> None:
        """A sized inbound transfer (a BlockFetch batch): refine S as the
        best (minimum) observed per-byte rate beyond G."""
        if nbytes <= 0:
            return
        inn = self.gsv.inbound
        s_sample = max(0.0, (duration - inn.g) / nbytes)
        s = min(inn.s, s_sample) if self._rtt_count else s_sample
        self.gsv = PeerGSV(self.gsv.outbound, replace(inn, s=s))
        self._publish()

    @property
    def measured(self) -> bool:
        """True once ANY real sample (RTT probe or SDU one-way delay)
        landed — before that the GSV is the optimistic default and must
        not be used to set deadlines (an unmeasured peer would get an
        impossibly tight watchdog)."""
        return self._rtt_count > 0 or self._owd_count > 0

    def expected_fetch_time(self, nbytes: int,
                            req_bytes: int = 100) -> float:
        return self.gsv.request_response_duration(req_bytes, nbytes)
