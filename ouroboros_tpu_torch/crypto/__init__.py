"""crypto — the port's batched verification primitives.

CPU references (edwards / ed25519_ref / vrf_ref / kes, copied from the
JAX package so the port imports none of it), the plain PyTorch field and
curve code (field / ed25519 / vrf / blake2b / sha512), the hand-written
CUDA kernels and their wrappers (kernels.py, ../csrc/), the per-key
precompute cache (precompute.py) and the `TorchBackend` window seam
(torch_backend.py).
"""
