"""utils — CBOR, the typed tracers and the resource registry (copies of
the JAX package's)."""
