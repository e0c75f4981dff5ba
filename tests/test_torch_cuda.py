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

from ouroboros_tpu_torch import csrc_compare as CC
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


# the chain kernels' operations (microbench_field's path)
CHAIN_OPS = CC.CHAIN_OPS


def _limbs(rng, dev, n):
    """Two (10, n) int32 carried limb arrays of random radix-2^13 digits."""
    return CC.random_limbs(rng, dev, n)


def _random_args(name, rng, dev, n=N):
    """Random words for each of the kernel's inputs, n lanes."""
    return CC.random_args(name, rng, dev, n)


def _launch_and_compare(dev, name, args):
    before = K.LAUNCHES[name]
    got = getattr(K, name)(*args)
    want = K.KERNELS[name].plain(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_equals_plain_version_on_random_lanes(dev, name):
    """Random words exercise every formula on off-curve garbage too: the
    kernel must reproduce the plain version byte for byte."""
    rng = np.random.default_rng(sorted(K.KERNELS).index(name))
    _launch_and_compare(dev, name, _random_args(name, rng, dev))


@pytest.mark.parametrize("n", [1, 7, 97, 4099])
@pytest.mark.parametrize("name", ["ed25519_split", "ed25519_verify",
                                  "gamma8", "kes_hash", "vrf_verify"])
def test_multi_thread_kernel_on_ragged_lane_counts(dev, name, n):
    """Several threads a lane: lane counts that no block size divides
    leave part of the last block past the end, where threads run on
    clamped inputs and store nothing."""
    rng = np.random.default_rng(n)
    _launch_and_compare(dev, name, _random_args(name, rng, dev, n))


@pytest.mark.parametrize("n", [1, 7, 97, 4099])
@pytest.mark.parametrize("name", sorted(CHAIN_OPS))
def test_chain_kernels_on_every_operation(dev, name, n):
    """Every operation of each chain kernel on random limbs, at lane
    counts that no block divides; kernel and plain version limb for
    limb."""
    rng = np.random.default_rng(n)
    a, b = _limbs(rng, dev, n)
    for op in CHAIN_OPS[name]:
        _launch_and_compare(dev, name, [a, b, op, 9])


@pytest.mark.parametrize("name", ["field_chain", "field_chain_lp"])
def test_field_chains_on_garbage_limbs(dev, name):
    """Uncarried limbs anywhere in the range the products accept (sums of
    four carried elements, |limb| <= 2^27 + 2^10), the extremes included,
    at 4099 lanes: kernel and plain version limb for limb, every
    operation."""
    rng = np.random.default_rng(27)
    bound = (1 << 27) + (1 << 10)
    a, b = (rng.integers(-bound, bound + 1, (10, 4099)) for _ in range(2))
    a[:, :64] = rng.choice((-bound, bound), (10, 64))
    b[:, 32:96] = rng.choice((-bound, bound), (10, 64))
    a, b = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (a, b))
    for op in CHAIN_OPS[name]:
        for k in (1, 9):
            _launch_and_compare(dev, name, [a, b, op, k])


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
