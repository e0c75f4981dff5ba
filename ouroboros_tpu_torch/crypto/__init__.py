"""crypto — the port's batched verification primitives.

CPU references (edwards / ed25519_ref / vrf_ref / kes, copied from the
JAX package so the port imports none of it), the plain PyTorch field and
curve code (field / ed25519 / vrf / blake2b / sha512), the hand-written
CUDA kernels and their wrappers (kernels.py, ../csrc/), the per-key
precompute cache (precompute.py) and the `TorchBackend` window seam
(torch_backend.py).

The names below mirror `ouroboros_tpu/crypto/__init__.py`, plus
`TorchBackend`, which is resolved at first use so that importing this
package does no CUDA work.
"""
from .backend import (
    CpuRefBackend, CryptoBackend, Ed25519Req, KesReq, OpensslBackend,
    VrfReq, default_backend, set_default_backend,
)

__all__ = [
    "CpuRefBackend", "CryptoBackend", "Ed25519Req", "KesReq",
    "OpensslBackend", "TorchBackend", "VrfReq", "default_backend",
    "set_default_backend",
]


def __getattr__(name):
    if name == "TorchBackend":
        from .torch_backend import TorchBackend
        return TorchBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
