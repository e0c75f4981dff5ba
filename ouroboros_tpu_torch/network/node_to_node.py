"""NodeToNode — version bundle + protocol numbering for node links.

Reference: ouroboros-network/src/Ouroboros/Network/NodeToNode.hs:211-212,
382-391 (protocol numbers: handshake=0, chainsync=2, blockfetch=3,
txsubmission=4, keepalive=8), NodeToNode/Version.hs:27-48 (version enum +
`NodeToNodeVersionData` = network magic), and the acceptableVersion policy
of Protocol/Handshake/Version.hs:86 (same magic required).

Ported from `ouroboros_tpu/network/node_to_node.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from typing import Optional

from .protocols.handshake import Versions

HANDSHAKE_NUM = 0
CHAINSYNC_NUM = 2
BLOCKFETCH_NUM = 3
TXSUBMISSION_NUM = 4
KEEPALIVE_NUM = 8

# node-to-client protocol numbers (NodeToNode.hs:382-391)
LOCAL_CHAINSYNC_NUM = 5
LOCAL_TXSUBMISSION_NUM = 6
LOCAL_STATEQUERY_NUM = 7

NODE_TO_NODE_V1 = 1
NODE_TO_NODE_V2 = 2          # adds tx-submission (mirrors the enum growth)

# per-protocol ingress byte limits (the mux parameter sets of
# NodeToNode.hs:157+ — bounded per-protocol flow control, §5)
INGRESS_LIMITS = {
    CHAINSYNC_NUM: 0x9_0000,
    BLOCKFETCH_NUM: 0x10_0000,
    TXSUBMISSION_NUM: 0x2_0000,
    KEEPALIVE_NUM: 0x1000,
}


def node_to_node_versions(network_magic: int = 0) -> Versions:
    """The default version offer: all known versions, same magic."""
    vs = Versions()
    for v in (NODE_TO_NODE_V1, NODE_TO_NODE_V2):
        vs.add(v, {"magic": network_magic})
    return vs


def accept_same_magic(local: Versions, proposed) -> Optional[int]:
    """acceptableVersion: highest common number whose network magic equals
    ours (Version.hs:86 — a magic mismatch is a refusal)."""
    prop = dict(proposed)
    best = None
    for v in local.numbers():
        if v in prop:
            local_params = local.get(v)[0]
            offered = prop[v] or {}
            if dict(offered).get("magic") == local_params.get("magic"):
                best = v
    return best
