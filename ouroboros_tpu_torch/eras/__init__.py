"""Era instantiations: so far Shelley (TPraos protocol + stake-pool UTxO
ledger).

Ported from `ouroboros_tpu/eras/__init__.py`; the Byron era and the
Cardano hard-fork composition are not ported yet.
"""
from .shelley import (                                     # noqa: F401
    OCert, PoolInfo, ShelleyLedger, ShelleyLedgerState, ShelleyTx,
    TPraos, TPraosCanBeLeader, TPraosConfig, TPraosIsLeader,
    TPraosLedgerView, TPraosState, forge_tpraos_fields, make_ocert,
    make_shelley_tx, pool_id_of, shelley_genesis_setup,
)
