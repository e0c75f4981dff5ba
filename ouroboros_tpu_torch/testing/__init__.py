"""Test harness library — the ouroboros-consensus-test analog.

ThreadNet (multi-node network-in-the-simulator) lives here so test suites
and benchmarks share one harness (reference: ouroboros-consensus-test/src/
Test/ThreadNet/{General,Network}.hs).  The chaos layer runs the same
network under a seeded FaultPlan with subscription-based recovery.

Ported from `ouroboros_tpu/testing/__init__.py` (the port imports nothing
of the JAX package): the dual ledger (`dual.py`) and ThreadNet with its
chaos layer (`threadnet.py`).
"""
from .threadnet import (
    ChaosConfig, ChaosResult, PraosNetworkFactory, ThreadNetConfig,
    ThreadNetResult, chaos_error_policies, chaos_time_limits,
    praos_node_keys, run_chaos_threadnet, run_threadnet,
)

__all__ = ["ChaosConfig", "ChaosResult", "PraosNetworkFactory",
           "ThreadNetConfig", "ThreadNetResult", "chaos_error_policies",
           "chaos_time_limits", "praos_node_keys", "run_chaos_threadnet",
           "run_threadnet"]
