"""Era instantiations.

- shelley.py — TPraos protocol + stake-pool UTxO ledger
- byron.py   — PBFT era with EBBs + delegation
- cardano.py — the mainnet-shaped hard-fork composition (Byron -> Shelley,
  and on to Allegra and Mary)

Ported from `ouroboros_tpu/eras/__init__.py` (the port imports nothing of
the JAX package).
"""
from .byron import (                                       # noqa: F401
    ByronLedger, ByronLedgerState, ByronLedgerView, ByronPBft, ByronTx,
    byron_genesis_setup, byron_sign_header, make_byron_tx, make_ebb,
)
from .shelley import (                                     # noqa: F401
    OCert, PoolInfo, ShelleyLedger, ShelleyLedgerState, ShelleyTx,
    TPraos, TPraosCanBeLeader, TPraosConfig, TPraosIsLeader,
    TPraosLedgerView, TPraosState, forge_tpraos_fields, make_ocert,
    make_shelley_tx, pool_id_of, shelley_genesis_setup,
)
