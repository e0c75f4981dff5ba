"""graft_entry — the compile-probe entry point: one single-card step.

    from ouroboros_tpu_torch.graft_entry import entry
    fn, args = entry()            # the card; entry(device="cpu") here
    d1, d2 = fn(*args)

Ported from `__graft_entry__.py:entry()` (the file's other two entry
points, `dryrun_multichip` and `mesh_scaling_report`, are `multichip.py`'s).
It returns the r3 form's 256-bit Ed25519 ladder (`crypto/ed25519.py`
`verify_kernel`) with example arguments: 128 signatures by one key from
sha256(b"graft-entry") over b"hdr-0" .. b"hdr-127", prepared by
`ed25519.prepare_batch` into tensors on the device.  Every one verifies,
so `ed25519.finalize(d1, d2, [True] * 128)` is 128 x True.  Without a
card it raises unless given `device="cpu"`.
"""
from __future__ import annotations

import hashlib

from . import device as D
from .crypto import ed25519 as E
from .crypto import ed25519_ref

N = 128
SEED = b"graft-entry"


def entry_batch(n: int = N):
    """(vks, msgs, sigs) of the entry's batch: n signatures by one key."""
    sk = hashlib.sha256(SEED).digest()
    vk = ed25519_ref.public_key(sk)
    msgs = [b"hdr-%d" % i for i in range(n)]
    return [vk] * n, msgs, [ed25519_ref.sign(sk, m) for m in msgs]


def entry(device=None):
    """(fn, example_args): the r3 verify ladder and its 128-lane batch on
    `device` (the card by default)."""
    dev = D.resolve(device)
    arrays, _valid = E.prepare_batch(*entry_batch(), device=dev)
    return E.verify_kernel, tuple(arrays)
