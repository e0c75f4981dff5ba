"""Cross-window per-key precomputation cache.

Ported from `ouroboros_tpu/crypto/precompute.py`.  A chain has few stake
pools, so the same verification keys recur in every replay window and
their per-key precomputation is pure:

- Ed25519 keys: the affine x of A and the affine coordinates of
  [2^128]A (the split table's variable half), computed by
  `ed25519.a128_core` at first sighting;
- VRF pool keys: the affine x of Y (the cached-Y verify kernel);
- KES hash paths: the Blake2b Merkle walk of a (depth, period, vk,
  merkle-path) tuple is independent of the signed message, so a pool's
  per-period path has ONE answer for every header it signs.

Entries are the port's "weights": `import_entries` loads them in the
shape of the JAX cache's `_c` / `_kes` entries.  Undecodable keys are
cached as negative entries.

Counters, as the reference keeps them: `hits`, `misses`, `device_fills`
(batched fills run: flat across a warm window), `filled_keys` and
`evictions`, counted whether or not observation is enabled (`always`
instruments), and `lock_wait` (a namespace lock that was not free at
once; timing-shaped, so `stable=False`).  Each reads and writes as a
plain int attribute, and `stats()` gives them with the entry counts.

`shared_cache(device)` is the process-wide instance of a device, the one
the standalone batch APIs use (the JAX package's
GLOBAL_PRECOMPUTE_CACHE).  Only those register their counters as the
registry's `precompute.*` metrics; the registry makes an instrument once
a name, so every device's shared cache counts into the same ones, the
process's totals, as the reference's one global cache does.  A
`TorchBackend` keeps its own cache, whose counters are private.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..observe import metrics as _metrics
from ..observe import spans as _spans
from . import ed25519 as E
from . import field as F

# sentinel for keys whose decompression failed: assemble() keeps reporting
# known=False for them without refilling
_BAD = object()
_MISSING = object()


class _Stripe:
    """One namespace's lock; an acquire that has to wait adds one to its
    cache's `lock_wait` first."""

    __slots__ = ("_lock", "_owner")

    def __init__(self, owner: "PrecomputeCache"):
        self._lock = threading.Lock()
        self._owner = owner

    def __enter__(self) -> "_Stripe":
        if not self._lock.acquire(blocking=False):
            self._owner.lock_wait += 1
            self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()


class PrecomputeCache:
    """vk bytes -> (xA, x128, y128) words or `_BAD`, LRU-bounded, filled
    on `device` in one batch per assemble; plus the KES hash-path
    outcome namespace.  One lock per namespace: the pipelined window
    replay assembles on its producer thread while the consumer records
    KES outcomes."""

    COUNTERS = ("hits", "misses", "device_fills", "filled_keys",
                "evictions")

    def __init__(self, device, max_entries: int = 200_000,
                 register: bool = False):
        self.device = torch.device(device)
        self._c: OrderedDict = OrderedDict()
        self._kes: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        mk = ((lambda n, **kw: _metrics.counter(n, always=True, **kw))
              if register
              else (lambda n, **kw: _metrics.Counter(n, always=True, **kw)))
        self._counters = {name: mk(f"precompute.{name}")
                          for name in self.COUNTERS}
        self._counters["lock_wait"] = mk("precompute.lock_wait",
                                         stable=False)
        self._lock_c = _Stripe(self)
        self._lock_kes = _Stripe(self)
        # fills run on their own stream: their copy back to the host must
        # not wait for window kernels queued on the backend's stream
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # -- counters as int attributes ----------------------------------------
    def _alias(name):  # noqa: N805 (a property factory, not a method)
        def _get(self):
            return self._counters[name].value

        def _set(self, v):
            self._counters[name].value = v
        return property(_get, _set)

    hits = _alias("hits")
    misses = _alias("misses")
    device_fills = _alias("device_fills")
    filled_keys = _alias("filled_keys")
    evictions = _alias("evictions")
    lock_wait = _alias("lock_wait")
    del _alias

    def stats(self) -> dict:
        return {"entries": len(self._c), "kes_entries": len(self._kes),
                "hits": self.hits, "misses": self.misses,
                "device_fills": self.device_fills,
                "filled_keys": self.filled_keys,
                "evictions": self.evictions,
                "lock_wait": self.lock_wait}

    # -- point entries (Ed25519 A / VRF Y) ----------------------------------
    def assemble(self, vks):
        """((8, N) uint32 xA words, x128 words, y128 words, known (N,) bool)
        for a batch of keys, filling every missing key in one batch.
        `known` is False for keys that do not decompress; callers must mask
        those lanes, since the kernels trust the cached x."""
        local: dict = {}
        missing = []
        with self._lock_c:
            for vk in vks:
                if vk in local:
                    continue
                ent = self._c.get(vk, _MISSING)
                if ent is not _MISSING:
                    self._c.move_to_end(vk)
                    self.hits += 1
                    local[vk] = ent
                else:
                    missing.append(vk)
                    local[vk] = _BAD   # overwritten by the fill below
        self.misses += len(missing)
        if missing:
            local.update(self._fill(missing))
        n = len(vks)
        xa = np.empty((8, n), dtype=np.uint32)
        xs = np.empty((8, n), dtype=np.uint32)
        ys = np.empty((8, n), dtype=np.uint32)
        known = np.zeros(n, dtype=bool)
        for j, vk in enumerate(vks):
            ent = local[vk]
            if ent is _BAD:
                xa[:, j] = E._GX_W
                xs[:, j] = E._B128X_W
                ys[:, j] = E._B128Y_W
            else:
                xa[:, j], xs[:, j], ys[:, j] = ent
                known[j] = True
        return xa, xs, ys, known

    def _fill(self, missing) -> dict:
        """One batched `a128_core` over every missing key, padded to a
        power-of-two bucket (floor 128).  Returns the fresh {vk: entry}
        map; assemble reads it directly, so LRU eviction during the
        inserts cannot lose this batch's entries."""
        m = 128
        while m < len(missing):
            m *= 2
        arr, len_ok = E._bytes_rows(missing + [b"\x00" * 32] *
                                    (m - len(missing)), 32)
        yw, sign, y_ok = E._decode_compressed(arr)
        self.device_fills += 1
        self.filled_keys += len(missing)
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()), \
                _spans.span("precompute.fill", cat="device"):
            yA = F.limbs_from_words(torch.from_numpy(yw).to(self.device))
            xa, x, y, ok = E.a128_core(
                yA, torch.from_numpy(sign).to(self.device))
            rows = torch.cat([F.bytes_from_canon(c) for c in (xa, x, y)])
            rows = rows.T.contiguous().to(torch.uint8).cpu().numpy()
            ok = ok.cpu().numpy() & len_ok & y_ok
        words = rows.view(np.uint32)                     # (m, 24) words
        fresh: dict = {}
        for j, vk in enumerate(missing):
            fresh[vk] = ((words[j, 0:8].copy(), words[j, 8:16].copy(),
                          words[j, 16:24].copy()) if ok[j] else _BAD)
            self._insert(self._c, self._lock_c, vk, fresh[vk])
        return fresh

    def import_entries(self, points: dict, kes: dict) -> None:
        """Load entries in the shape of the JAX cache's: `points` maps vk
        bytes to a tuple of three (8,) uint32 word arrays (xA, x128, y128)
        or None for an undecodable key; `kes` maps kes.hash_path_key tuples
        to (leaf_vk, path_ok)."""
        for vk, ent in points.items():
            if ent is None:
                self._insert(self._c, self._lock_c, vk, _BAD)
            else:
                self._insert(self._c, self._lock_c, vk, tuple(
                    np.asarray(w, dtype=np.uint32).reshape(8).copy()
                    for w in ent))
        for key, (leaf_vk, path_ok) in kes.items():
            self.kes_put(key, leaf_vk, path_ok)

    # -- KES hash-path outcomes ---------------------------------------------
    def kes_get(self, key):
        """(leaf_vk, path_ok) for a hash-path identity, or None."""
        with self._lock_kes:
            ent = self._kes.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._kes.move_to_end(key)
            self.hits += 1
            return ent

    def kes_put(self, key, leaf_vk, path_ok: bool) -> None:
        self._insert(self._kes, self._lock_kes, key,
                     (leaf_vk, bool(path_ok)))

    # -- plumbing ------------------------------------------------------------
    def _insert(self, od: OrderedDict, lock, key, value) -> None:
        with lock:
            od[key] = value
            od.move_to_end(key)
            while len(od) > self.max_entries:
                od.popitem(last=False)
                self.evictions += 1


_SHARED: dict = {}
_SHARED_LOCK = threading.Lock()


def shared_cache(device) -> PrecomputeCache:
    """The process-wide cache of `device`, made at first use."""
    dev = torch.device(device)
    with _SHARED_LOCK:
        if dev not in _SHARED:
            _SHARED[dev] = PrecomputeCache(dev, register=True)
        return _SHARED[dev]
