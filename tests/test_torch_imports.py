"""Import discipline of the PyTorch/CUDA port, and its refusal to run on
the CPU unless asked.

The port (`ouroboros_tpu_torch`) must import neither JAX nor anything of
the JAX package, so it runs where JAX is not installed; its entry points
run on the CUDA card and raise without one.
"""
import subprocess
import sys

import pytest
import torch

_CHECK = r"""
import importlib, pkgutil, sys
import ouroboros_tpu_torch
names = ["ouroboros_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ouroboros_tpu_torch.__path__,
                                          "ouroboros_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ouroboros_tpu" or m.startswith("ouroboros_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 76          # every module of every slice imported


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")


def test_default_device_raises_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import device
    with pytest.raises(RuntimeError):
        device.default_device()
    with pytest.raises(RuntimeError):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"


def test_backend_and_validate_raise_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import validate
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    with pytest.raises(RuntimeError):
        TorchBackend()
    with pytest.raises(RuntimeError):
        validate.run(n_windows=1, window=1, pools=1)
    with pytest.raises(RuntimeError):
        validate.main(["--windows", "1", "--window", "1", "--pools", "1",
                       "--workers", "1"])
    assert TorchBackend(device="cpu").device_kind == "cpu"


def test_replay_and_default_backend_raise_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import replay
    from ouroboros_tpu_torch.crypto import backend
    backend.set_default_backend(None)
    with pytest.raises(RuntimeError):
        backend.default_backend()
    with pytest.raises(RuntimeError):
        replay.run(blocks=1, window=1)
    with pytest.raises(RuntimeError):
        replay.main(["--blocks", "1", "--window", "1"])


@pytest.mark.cuda
def test_default_backend_on_the_card_is_a_torch_backend():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ouroboros_tpu_torch.crypto import backend
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    backend.set_default_backend(None)
    got = backend.default_backend()
    assert isinstance(got, TorchBackend) and got.device.type == "cuda"
    assert backend.default_backend() is got


def test_serve_raises_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import serve
    with pytest.raises(RuntimeError):
        serve.run(blocks=1)
    with pytest.raises(RuntimeError):
        serve.main(["--blocks", "1", "--scale", "0.01"])


def test_standalone_apis_and_probe_raise_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import perf_probe
    from ouroboros_tpu_torch.crypto import ed25519, kernels, vrf
    with pytest.raises(RuntimeError):
        kernels.batch_verify_ed25519([b"\x00" * 32], [b""], [b"\x00" * 64])
    with pytest.raises(RuntimeError):
        ed25519.batch_verify([], [], [])
    with pytest.raises(RuntimeError):
        vrf.batch_verify_vrf([], [], [])
    with pytest.raises(RuntimeError):
        vrf.batch_betas([])
    with pytest.raises(RuntimeError):
        perf_probe.main(["--n-ed", "1", "--n-vrf", "1", "--reps", "1"])


def test_microbench_field_raises_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import microbench_field
    with pytest.raises(RuntimeError):
        microbench_field.main(["--ops", "--lanes", "8", "--reps", "1"])
    with pytest.raises(RuntimeError):
        microbench_field.main(["--e2e", "--n-ed", "1", "--n-vrf", "1",
                               "--n-kes", "1", "--reps", "1"])


def test_db_analyser_torch_backend_raises_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import db_analyser
    with pytest.raises(RuntimeError):
        db_analyser.make_backend("torch")
    with pytest.raises(RuntimeError):
        db_analyser.make_backend("torch", "cuda")
    assert db_analyser.make_backend("torch", "cpu").device.type == "cpu"
    assert db_analyser.make_backend("ref").name == "cpu-ref"


def test_mesh_and_multichip_raise_without_a_card():
    _require_no_card()
    from ouroboros_tpu_torch import multichip
    from ouroboros_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError):
        multichip.dryrun_multichip(2)
    with pytest.raises(RuntimeError):
        multichip.mesh_scaling_report(2, window=1)
    with pytest.raises(RuntimeError):
        multichip.main(["2", "--devices", "cuda:0,cuda:0"])
