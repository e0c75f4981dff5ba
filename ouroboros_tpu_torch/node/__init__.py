"""Node layer — the NodeKernel and its hot loops.

Rebuilds the reference ouroboros-consensus's node tier (SURVEY.md §2 L5:
NodeKernel.hs, MiniProtocol/ChainSync/Client.hs, BlockFetch logic) the
batched way: the ChainSync client validates headers in *batched windows*
(one device call per window instead of per header), and block
forging/fetching run as
simharness threads coordinated through STM TVars exactly like the
reference's IOLike threads.

Ported from `ouroboros_tpu/node/__init__.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from .blockchain_time import BlockchainTime
from .kernel import BlockForging, NodeKernel, connect_nodes
from .chain_sync import CandidateState, ChainSyncClientError
from .run import (
    NodeHandle, RunNodeArgs, WrongNetworkError, check_db_marker, run_node,
    was_clean_shutdown,
)

__all__ = [
    "BlockchainTime", "BlockForging", "NodeKernel", "connect_nodes",
    "CandidateState", "ChainSyncClientError",
    "NodeHandle", "RunNodeArgs", "WrongNetworkError", "check_db_marker",
    "run_node", "was_clean_shutdown",
]
