"""Consensus core — protocol abstraction, header/ledger validation, batching
and the pipelined replay.

Ported from `ouroboros_tpu/consensus/__init__.py`, with the mempool.
The `ConsensusProtocol` class (Protocol/Abstract.hs:50) has an explicit
proof-extraction hook, so that a *window* of headers can have its
VRF/KES/Ed25519 proofs verified as one device batch.
"""
from .protocol import ConsensusProtocol, NullProtocol
from .header_validation import (
    HeaderError, HeaderState, HeaderStateHistory, validate_header,
    revalidate_header,
)
from .ledger import (
    LedgerError, LedgerRules, ExtLedgerState, ExtLedgerRules,
    OutsideForecastRange,
)
from .batch import (BatchValidationResult, ReplayResult,
                    replay_blocks_pipelined, validate_blocks_batched,
                    validate_headers_batched)
from .mempool import Mempool, MempoolReader, MempoolSnapshot

__all__ = [
    "Mempool", "MempoolReader", "MempoolSnapshot",
    "ConsensusProtocol", "NullProtocol",
    "HeaderError", "HeaderState", "HeaderStateHistory", "validate_header",
    "revalidate_header",
    "LedgerError", "LedgerRules", "ExtLedgerState", "ExtLedgerRules",
    "OutsideForecastRange",
    "BatchValidationResult", "ReplayResult", "replay_blocks_pipelined",
    "validate_blocks_batched", "validate_headers_batched",
]
