"""Mini-protocols: ChainSync, BlockFetch, TxSubmission, KeepAlive,
Handshake, LocalStateQuery and LocalTxSubmission, each with its codec
(`codec.py`).

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/*/Type.hs state
machines, rebuilt as ProtocolSpecs + message dataclasses + async peers.

Ported from `ouroboros_tpu/network/protocols/__init__.py` (the port imports
nothing of the JAX package): the node-to-node protocols and the two
node-to-client ones the local socket serves (LocalStateQuery,
LocalTxSubmission). Not ported yet: LocalTxMonitor, TipSample, TxSubmission2
with Hello, and the PingPong / ReqResp examples.
"""
