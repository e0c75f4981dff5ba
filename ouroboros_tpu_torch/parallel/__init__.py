"""parallel — a window's proof lanes split over a mesh of devices.

Ported from `ouroboros_tpu/parallel/`.  The reference shards a window's
independent proofs over a `jax.sharding.Mesh` axis with `shard_map` and
aggregates with a `psum`; the port splits the lanes of each kernel
launch over a list of torch devices, one CUDA stream a shard, and
gathers the outputs onto the first device (sharded_verify.py).
`enable_compile_cache` is not ported: there is no XLA cache (mesh.py).
"""
from .mesh import log_compile_time, make_mesh
from .sharded_verify import (
    ShardedTorchBackend, build_sharded_verifier, sharded_batch_verify,
)

__all__ = ["ShardedTorchBackend", "log_compile_time", "make_mesh",
           "build_sharded_verifier", "sharded_batch_verify"]
