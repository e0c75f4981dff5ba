"""Test harness library — the ouroboros-consensus-test analog.

ThreadNet (multi-node network-in-the-simulator) lives here so test suites
and benchmarks share one harness (reference: ouroboros-consensus-test/src/
Test/ThreadNet/{General,Network}.hs).

Ported from `ouroboros_tpu/testing/__init__.py` (the port imports nothing
of the JAX package): the dual ledger (`dual.py`) and ThreadNet up to
`run_threadnet` (`threadnet.py`).  The chaos layer (`ChaosConfig`,
`run_chaos_threadnet`) waits for the diffusion slice.
"""
from .threadnet import (
    PraosNetworkFactory, ThreadNetConfig, ThreadNetResult, praos_node_keys,
    run_threadnet,
)

__all__ = ["PraosNetworkFactory", "ThreadNetConfig", "ThreadNetResult",
           "praos_node_keys", "run_threadnet"]
