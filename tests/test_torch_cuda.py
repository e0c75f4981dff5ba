"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA card (decided inside the
fixture).  Run them on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's lane counts.
"""
import hashlib

import numpy as np
import pytest
import torch

from ouroboros_tpu_torch.crypto import blake2b as B2
from ouroboros_tpu_torch.crypto import ed25519_ref, kes, vrf_ref
from ouroboros_tpu_torch.crypto import kernels as K
from ouroboros_tpu_torch.crypto.backend import (CpuRefBackend, Ed25519Req,
                                                KesReq, VrfReq)
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend

pytestmark = pytest.mark.cuda
N = 96


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K.library()
    return torch.device("cuda")


def _words(rng, rows, dev, clear_top=True):
    a = rng.integers(0, 2**32, (rows, N), dtype=np.uint64).astype(np.uint32)
    if clear_top:
        a[-1] &= 0x7FFFFFFF
    return torch.from_numpy(a).to(dev)


def _sign(rng, dev):
    return torch.from_numpy(rng.integers(0, 2, N).astype(np.int32)).to(dev)


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_equals_plain_version_on_random_lanes(dev, name):
    """Random words exercise every formula on off-curve garbage too: the
    kernel must reproduce the plain version byte for byte."""
    rng = np.random.default_rng(sorted(K.KERNELS).index(name))
    if name == "ed25519_split":
        args = [_words(rng, 8, dev) for _ in range(5)] + [_sign(rng, dev)] \
            + [_words(rng, 8, dev, False) for _ in range(2)]
    elif name == "vrf_verify":
        args = [_words(rng, 8, dev) for _ in range(3)] + [_sign(rng, dev),
                                                          _words(rng, 8, dev),
                                                          _words(rng, 4, dev,
                                                                 False),
                                                          _words(rng, 8, dev,
                                                                 False)]
    elif name == "ed25519_verify":
        args = [_words(rng, 8, dev), _sign(rng, dev), _words(rng, 8, dev),
                _sign(rng, dev), _words(rng, 8, dev, False),
                _words(rng, 8, dev, False)]
    elif name == "gamma8":
        args = [_words(rng, 8, dev), _sign(rng, dev)]
    else:
        msgs = rng.integers(0, 256, (N, 64), dtype=np.uint8)
        digs = np.stack([np.frombuffer(hashlib.blake2b(
            m.tobytes(), digest_size=32).digest(), np.uint8) for m in msgs])
        digs[::3, 0] ^= 1
        args = [torch.from_numpy(B2.msg_words(msgs)).to(dev),
                torch.from_numpy(B2.digest_words(digs)).to(dev)]
    before = K.LAUNCHES[name]
    got = getattr(K, name)(*args)
    want = K.KERNELS[name].plain(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want.cpu())


def test_window_on_the_card_matches_cpu_ref(dev):
    sk = hashlib.sha256(b"card-ed").digest()
    vsk = hashlib.sha256(b"card-vrf").digest()
    ksk = kes.KesSignKey(3, hashlib.sha256(b"card-kes").digest())
    vk, vvk = ed25519_ref.public_key(sk), vrf_ref.public_key(vsk)
    reqs = [Ed25519Req(vk, b"m%d" % i, ed25519_ref.sign(sk, b"m%d" % i))
            for i in range(5)]
    reqs.append(Ed25519Req(vk, b"x", ed25519_ref.sign(sk, b"y")))
    reqs += [VrfReq(vvk, b"a%d" % i, vrf_ref.prove(vsk, b"a%d" % i))
             for i in range(3)]
    reqs.append(VrfReq(vvk, b"zz", vrf_ref.prove(vsk, b"a0")))
    sig = ksk.sign(b"hdr")
    reqs += [KesReq(3, ksk.verification_key, 0, b"hdr", sig.to_bytes()),
             KesReq(3, ksk.verification_key, 1, b"hdr", sig.to_bytes())]
    want = CpuRefBackend().verify_mixed(reqs)
    be = TorchBackend(device=dev)
    assert be.verify_mixed(reqs) == want
    proofs = [r.proof for r in reqs if isinstance(r, VrfReq)]
    verdict, betas = be.finish_window(be.submit_window(reqs, proofs,
                                                       fold=True))
    assert verdict.first_bad == want.index(False)
    assert all(betas[p] == vrf_ref.proof_to_hash(p) for p in proofs)
