"""Ledger instantiations (the ouroboros-consensus-{mock,shelley,...} analog).

Ported from `ouroboros_tpu/ledgers/__init__.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from .mock import MockLedger, MockLedgerState, Tx, TxIn, TxOut, make_tx

__all__ = ["MockLedger", "MockLedgerState", "Tx", "TxIn", "TxOut", "make_tx"]
