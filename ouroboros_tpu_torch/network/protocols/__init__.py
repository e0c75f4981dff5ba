"""Mini-protocols: ChainSync, BlockFetch, TxSubmission(+2 via Hello),
KeepAlive, Handshake, LocalStateQuery, LocalTxSubmission, LocalTxMonitor,
TipSample, plus the PingPong/ReqResp teaching protocols.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/*/Type.hs state
machines, rebuilt as ProtocolSpecs + message dataclasses + async peers.

Ported from `ouroboros_tpu/network/protocols/__init__.py` (the port imports
nothing of the JAX package). Copied whole: like the reference, it imports
no submodule, so `from ouroboros_tpu_torch.network.protocols import
tipsample` loads only what it names.
"""
