"""Sharded batched verification: a window's lanes split over a mesh.

Ported from `ouroboros_tpu/parallel/sharded_verify.py`.  The reference
`shard_map`s the per-lane cores over the mesh's window axis and `psum`s
a count; here each shard launches the port's hand kernels
(crypto/kernels.py) on its contiguous block of lanes, on a CUDA stream
of its mesh's, and the outputs are gathered onto the first device in
lane order.  The proofs are independent, so no shard reads another's
lanes: the only cross-shard steps are the gather and, on a window, the
verdict fold over the gathered buffer (torch_backend.fold_window,
unchanged).

`ShardLauncher.launch` is the one place that splits lanes, and there is
one launcher a mesh (`launcher`).  For each shard, under its device and
its stream: the block is sliced on the host (a column block of an
(8, N) array is not contiguous, and the wrappers take only contiguous
tensors), staged through pinned memory, launched, copied to the first
device (a copy across devices runs on the source device's current
stream, so it is this shard's) and an event recorded.  The caller's
stream on the first device waits on every shard's event before it
concatenates; each gathered output is marked used on that stream
(`record_stream`), so the caching allocator does not hand its memory to
a later allocation on the shard's stream while the concatenation may
still read it.  The streams come from PyTorch's pool (32 a device, handed
out in turn): a mesh's shards get distinct ones while a device holds at
most 32 shards, but one may be the stream of another backend; ordering
rests on the events alone.  On the CPU (`["cpu"] * d`) the shards run
the plain versions one after another: same split, same gather.

`ShardedTorchBackend` is `TorchBackend` over a mesh: the window path
(the split, submit_window / finish_window, the fold) is inherited and
only the lane launches are split, `kes_hash`'s with the rest; padding
rounds to a mesh multiple past `min_bucket`.  (The reference hashes KES
on the host there, to keep its fused shard_map program small enough to
compile; the port compiles no program per shape.)
"""
from __future__ import annotations

import functools

import torch

from ..crypto import ed25519 as E
from ..crypto import kernels as K
from ..crypto.torch_backend import TorchBackend, stage
from .mesh import Mesh


class ShardLauncher:
    """Launches a kernel once per shard of `mesh` on the shard's block of
    lanes.  `counts` counts those launches: `kernels.LAUNCHES` on the
    card (each wrapper counts where it launches), `cpu_calls` on CPU
    shards (one a plain-version call)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.device = mesh.devices[0]
        self._cuda = self.device.type == "cuda"
        self.streams = (tuple(torch.cuda.Stream(d) for d in mesh.devices)
                        if self._cuda else ())
        self.cpu_calls = dict.fromkeys(K.KERNELS, 0)

    @property
    def counts(self) -> dict:
        return K.LAUNCHES if self._cuda else self.cpu_calls

    def launch(self, kernel: str, arrays) -> torch.Tensor:
        """`kernel` over host arrays whose last axis holds N lanes, N a
        multiple of the mesh size; returns the output on the first device
        with its N lanes on axis 0, in lane order, ready on the caller's
        current stream."""
        d = self.mesh.size
        n = arrays[0].shape[-1]
        if n % d:
            raise ValueError(f"{kernel}: {n} lanes do not split over {d} "
                             f"shards")
        w = n // d
        blocks = [[a[..., s * w:(s + 1) * w] for a in arrays]
                  for s in range(d)]
        fn = getattr(K, kernel)
        if not self._cuda:
            outs = []
            for dev, blk in zip(self.mesh.devices, blocks):
                outs.append(fn(*(stage(b, dev) for b in blk)))
                self.cpu_calls[kernel] += 1
            return torch.cat(outs)
        gather = torch.cuda.current_stream(self.device)
        outs, events = [], []
        for dev, stream, blk in zip(self.mesh.devices, self.streams, blocks):
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                out = fn(*(stage(b, dev) for b in blk))
                out = out.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            outs.append(out)
            events.append(event)
        for out, event in zip(outs, events):
            gather.wait_event(event)
            out.record_stream(gather)
        return torch.cat(outs)


@functools.lru_cache(maxsize=8)
def launcher(mesh: Mesh) -> ShardLauncher:
    """The mesh's one launcher: its streams and CPU counts, shared by the
    builders and every ShardedTorchBackend on the mesh."""
    return ShardLauncher(mesh)


def _verifier(shards: ShardLauncher):
    def run(Aw, signA, Rw, signR, sw, kw):
        ok = shards.launch("ed25519_verify", (Aw, signA, Rw, signR, sw,
                                                kw))
        return ok, ok.sum()
    return run


def build_sharded_verifier(mesh: Mesh):
    """The full 256-bit Ed25519 verify (`kernels.ed25519_verify`) over the
    mesh: a callable on host arrays (Aw, signA, Rw, signR, sw, kw) of
    `ed25519.prepare_words_batch`, lanes a multiple of the mesh size ->
    (ok (N,) int32, total accepted) on the first device; `total` stands
    for the reference's psum."""
    return _verifier(launcher(mesh))


def build_sharded_vrf(mesh: Mesh):
    """`kernels.vrf_verify` over the mesh: host arrays (Yw, xYw, Gw,
    signG, rw, cw, sw) -> (N, 130) uint8 rows on the first device."""
    launch = launcher(mesh).launch
    return lambda *args: launch("vrf_verify", args)


def build_sharded_gamma8(mesh: Mesh):
    """`kernels.gamma8` over the mesh: host arrays (Gw, signG) -> (N, 33)
    uint8 rows on the first device."""
    launch = launcher(mesh).launch
    return lambda *args: launch("gamma8", args)


def _full_verify(verify, vks, msgs, sigs, d: int,
                 pad_to: int | None) -> list[bool]:
    n = len(vks)
    if n == 0:
        return []
    m = pad_to if pad_to and pad_to >= n else n
    m = ((m + d - 1) // d) * d
    arrays, parse_ok = E.prepare_words_batch(
        list(vks) + [b"\x00" * 32] * (m - n), list(msgs) + [b""] * (m - n),
        list(sigs) + [b"\x00" * 64] * (m - n))
    ok, _total = verify(*arrays)
    ok = ok.cpu().numpy()
    return [bool(o) and bool(p) for o, p in zip(ok[:n], parse_ok[:n])]


def sharded_batch_verify(vks, msgs, sigs, mesh: Mesh,
                         pad_to: int | None = None) -> list[bool]:
    """End-to-end sharded verify: host prep, the batch padded to a mesh
    multiple (at least `pad_to`), one `ed25519_verify` launch a shard,
    the verdicts masked with the host parse."""
    return _full_verify(build_sharded_verifier(mesh), vks, msgs, sigs,
                        mesh.size, pad_to)


class ShardedTorchBackend(TorchBackend):
    """TorchBackend over a mesh: every kernel launch of a window and of
    the batch calls goes through `_launch_lanes`, which splits its lanes
    over the shards; packing, the fold and finish_window are the
    single-device path's.  The per-key fill runs once, on the first
    device (the cache's entries are host arrays)."""

    def __init__(self, mesh: Mesh, min_bucket: int = 128):
        super().__init__(device=mesh.devices[0])
        self.mesh = mesh
        self.min_bucket = min_bucket
        self.name = f"torch-mesh-{mesh.size}"
        self._shards = launcher(mesh)

    @property
    def n_shards(self) -> int:
        """padding_stats() reports lane occupancy per shard: _pad rounds
        every batch to a mesh multiple, so each shard carries
        padded/n_shards lanes."""
        return self.mesh.size

    def _pad(self, n: int) -> int:
        d = self.mesh.size
        m = max(self.min_bucket, n)
        return ((m + d - 1) // d) * d

    def _launch_lanes(self, kernel: str, arrays) -> torch.Tensor:
        return self._shards.launch(kernel, arrays)

    def verify_ed25519_batch(self, reqs):
        """The full 256-bit verify, sharded (the reference's
        `sharded_batch_verify` at this backend's padding)."""
        if not reqs:
            return []
        with self._on_stream():
            return _full_verify(_verifier(self._shards), [r.vk for r in reqs],
                                [r.msg for r in reqs], [r.sig for r in reqs],
                                self.mesh.size, self._pad(len(reqs)))
