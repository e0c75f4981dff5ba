"""ping — handshake + KeepAlive RTT probe against a running node.

The cardano-ping demo analog (network-mux/demo/cardano-ping.hs +
SURVEY.md §2 "mux demos"): dial an address through the Snocket layer, run
the version-negotiation handshake on protocol 0, then KeepAlive probes,
and print negotiated version + RTT statistics as one JSON line.

Usage:
  python -m ouroboros_tpu_torch.ping HOST PORT [--count N] [--magic M]
      [--unix PATH]

Ported from `tools/ping.py` (the port imports nothing of the JAX package
or of `tools/`). Copied whole, over the port's handshake, KeepAlive, mux
and snockets under its IO runtime.
"""
from __future__ import annotations

import argparse
import json


async def ping(snocket, addr, magic: int, count: int) -> dict:
    from .network import node_to_node as n2n
    from .network.mux import INITIATOR, CodecChannel, Mux
    from .network.protocols import handshake as hs_proto
    from .network.protocols import keepalive as ka_proto
    from .network.typed import CLIENT, Session

    bearer = await snocket.connect(addr)
    mux = Mux(bearer, "ping.mux")
    mux.start()
    try:
        hs = Session(
            hs_proto.SPEC, CLIENT,
            CodecChannel(mux.channel(n2n.HANDSHAKE_NUM, INITIATOR),
                         hs_proto.CODEC))
        res = await hs_proto.client_propose(
            hs, n2n.node_to_node_versions(magic))
        if res[0] != "accepted":
            return {"ok": False, "refused": str(res[1])}
        _, version, params = res
        rtts: list = []
        ka = Session(
            ka_proto.SPEC, CLIENT,
            CodecChannel(mux.channel(n2n.KEEPALIVE_NUM, INITIATOR),
                         ka_proto.CODEC))
        await ka_proto.client_probe(ka, count, 0.05,
                                    on_rtt=rtts.append)
        return {
            "ok": True, "version": version,
            "params": {k: v for k, v in dict(params or {}).items()},
            "probes": len(rtts),
            "rtt_min_ms": round(min(rtts) * 1000, 3),
            "rtt_avg_ms": round(sum(rtts) / len(rtts) * 1000, 3),
            "rtt_max_ms": round(max(rtts) * 1000, 3),
        }
    finally:
        mux.stop()
        close = getattr(bearer, "close", None)
        if close:
            close()


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m ouroboros_tpu_torch.ping",
                                 description=__doc__)
    ap.add_argument("host", nargs="?", default="127.0.0.1")
    ap.add_argument("port", nargs="?", type=int, default=3001)
    ap.add_argument("--unix", help="dial a Unix socket path instead")
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--magic", type=int, default=0)
    args = ap.parse_args()

    from .network.snocket import TcpSnocket, UnixSnocket
    from .simharness import io_run

    if args.unix:
        snocket, addr = UnixSnocket(), args.unix
    else:
        snocket, addr = TcpSnocket(), (args.host, args.port)
    out = io_run(ping(snocket, addr, args.magic, args.count))
    print(json.dumps(out))
    if not out.get("ok"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
