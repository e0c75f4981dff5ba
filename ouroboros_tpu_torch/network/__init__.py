"""network — typed protocols, channels, the mux and the node-to-node
mini-protocols.

Reference layers L1-L4 (SURVEY.md §1): typed-protocols, network-mux,
ouroboros-network-framework, ouroboros-network.

Ported from `ouroboros_tpu/network/__init__.py` (the port imports nothing of
the JAX package): the channels (`channel.py`), typed sessions (`typed.py`),
the mux (`mux.py`), DeltaQ (`deltaq.py`), the node-to-node versions
(`node_to_node.py`) and six mini-protocols under `protocols/`. Not ported
yet: diffusion, subscription, peer selection, the error policy, the snocket,
socket bearer and CDDL checks.
"""
