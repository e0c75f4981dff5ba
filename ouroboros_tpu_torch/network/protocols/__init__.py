"""Mini-protocols: ChainSync, BlockFetch, TxSubmission, KeepAlive and
Handshake, each with its codec (`codec.py`).

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/*/Type.hs state
machines, rebuilt as ProtocolSpecs + message dataclasses + async peers.

Ported from `ouroboros_tpu/network/protocols/__init__.py` (the port imports
nothing of the JAX package): the node-to-node protocols. Not ported yet: the
node-to-client ones (LocalStateQuery, LocalTxSubmission, LocalTxMonitor),
TipSample, TxSubmission2 with Hello, and the PingPong / ReqResp examples.
"""
