"""utils — CBOR and the typed tracers (copies of the JAX package's)."""
