"""Test harness library — the ouroboros-consensus-test analog.

Ported from `ouroboros_tpu/testing/__init__.py` (the port imports nothing
of the JAX package). So far only the dual ledger (`testing/dual.py`);
ThreadNet (`threadnet.py`) waits for the node layer (ROADMAP queue 1 item
7.5), so nothing is exported here.
"""
