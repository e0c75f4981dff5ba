"""simharness — so far only the runtime registry (`runtime.py`), which the
observability spans read their clock from.  The simulator, STM and the IO
runtime of `ouroboros_tpu/simharness/` are not ported yet."""
