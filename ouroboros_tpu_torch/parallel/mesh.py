"""The device mesh for sharded batch validation.

Ported from `ouroboros_tpu/parallel/mesh.py`.  The port's mesh is one
axis of torch devices, named like the reference's (`WINDOW_AXIS`): the
lanes of a window's proof batch are split over it in contiguous blocks,
one a device.  A device may appear more than once: each entry is a shard
with a CUDA stream of the mesh's (parallel/sharded_verify.py), so
`["cuda:0", "cuda:0"]` runs two shards on one card, as the JAX package's
tests run several shards on forced host-platform devices; `["cpu"] * 8`
runs eight shards of the plain PyTorch versions.

`enable_compile_cache` is not ported: the port compiles no XLA program,
and its kernel library is built once per source hash
(crypto/kernels.py:build).  `log_compile_time` times what stands in for
a compile in the port: the kernel library's build or load and a first
launch.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .. import device as device_mod
from ..observe import metrics as _metrics
from ..observe import spans as _spans

WINDOW_AXIS = "window"   # the header-window (proof-batch) axis

_LAST_COMPILE = _metrics.gauge("parallel.last_compile_secs", stable=False)


@contextmanager
def log_compile_time(what: str, stream=None):
    """Wall-time a build-heavy block and print one log line before and
    one after it, so a long build shows in the log tail instead of
    looking like a hang.

    Also records a `compile.<what>` span, sets the
    `parallel.last_compile_secs` gauge and yields a dict whose ``secs``
    field holds the elapsed seconds once the block exits:
    ``with log_compile_time(...) as ct: ...; ct["secs"]``."""
    stream = stream if stream is not None else sys.stderr
    out = {"what": what, "secs": None}
    t0 = time.perf_counter()
    print(f"[parallel] {what}: compiling...", file=stream, flush=True)
    span_cm = _spans.span(f"compile.{what}", cat="compile")
    span_cm.__enter__()
    try:
        yield out
    finally:
        span_cm.__exit__(None, None, None)
        out["secs"] = round(time.perf_counter() - t0, 3)
        _LAST_COMPILE.set(out["secs"])
        print(f"[parallel] {what}: done in {out['secs']:.1f}s",
              file=stream, flush=True)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the shards' devices in lane order, and the axis name.
    Hashable, so builders can cache per mesh."""
    devices: tuple
    axis_names: tuple = (WINDOW_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = WINDOW_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` of `devices`, by default the
    CUDA cards `cuda:0 .. cuda:k-1` (raises without a card).

    An explicit `devices` list may repeat a device (several shards on
    one card, or on the CPU); it must not mix device types.  Asking for
    more devices than there are raises ValueError, as the reference
    does."""
    if devices is None:
        device_mod.default_device()            # raises without a card
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"a mesh must not mix device types: {kinds}")
        if kinds[0] not in ("cpu", "cuda"):
            raise ValueError(f"no mesh over {kinds[0]} devices")
        if kinds[0] == "cuda":
            device_mod.resolve("cuda")         # raises without a card
            devs = [d if d.index is not None
                    else torch.device("cuda", torch.cuda.current_device())
                    for d in devs]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), (axis,))
