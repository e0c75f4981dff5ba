"""Import discipline of the PyTorch/CUDA port, and its refusal to run on
the CPU unless asked.

The port (`ouroboros_tpu_torch`) must import neither JAX nor anything of
the JAX package, so it runs where JAX is not installed; its entry points
run on the CUDA card and raise without one.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

_ROOT = pathlib.Path(__file__).resolve().parent.parent

# the chain database's slice, each named so that a module the walk misses
# still fails the check
_NAMED = [
    "ouroboros_tpu_torch.consensus.protocols.bft",
    "ouroboros_tpu_torch.consensus.protocols.pbft",
    "ouroboros_tpu_torch.consensus.protocols.leader_schedule",
    "ouroboros_tpu_torch.testing",
    "ouroboros_tpu_torch.testing.dual",
    "ouroboros_tpu_torch.chain.chain",
    "ouroboros_tpu_torch.chain.fragment",
    "ouroboros_tpu_torch.utils.registry",
    "ouroboros_tpu_torch.storage.volatiledb",
    "ouroboros_tpu_torch.storage.chaindb",
    # the node-to-node sync path's slice
    "ouroboros_tpu_torch.network",
    "ouroboros_tpu_torch.network.channel",
    "ouroboros_tpu_torch.network.typed",
    "ouroboros_tpu_torch.network.mux",
    "ouroboros_tpu_torch.network.deltaq",
    "ouroboros_tpu_torch.network.node_to_node",
    "ouroboros_tpu_torch.network.protocols",
    "ouroboros_tpu_torch.network.protocols.codec",
    "ouroboros_tpu_torch.network.protocols.handshake",
    "ouroboros_tpu_torch.network.protocols.chainsync",
    "ouroboros_tpu_torch.network.protocols.blockfetch",
    "ouroboros_tpu_torch.network.protocols.txsubmission",
    "ouroboros_tpu_torch.network.protocols.keepalive",
    "ouroboros_tpu_torch.node",
    "ouroboros_tpu_torch.node.watchdog",
    "ouroboros_tpu_torch.node.blockchain_time",
    "ouroboros_tpu_torch.node.chain_sync",
    "ouroboros_tpu_torch.node.block_fetch",
    "ouroboros_tpu_torch.node.tx_submission",
    "ouroboros_tpu_torch.node.kernel",
    "ouroboros_tpu_torch.node.run",
    "ouroboros_tpu_torch.observe.netmetrics",
    "ouroboros_tpu_torch.testing.threadnet",
]

_CHECK = r"""
import importlib, pkgutil, sys
import ouroboros_tpu_torch
names = ["ouroboros_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ouroboros_tpu_torch.__path__,
                                          "ouroboros_tpu_torch.")]
named = sys.argv[1:]
missing = [n for n in named if n not in names]
assert not missing, missing
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ouroboros_tpu" or m.startswith("ouroboros_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK, *_NAMED],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 109         # every module of every slice imported


_BANNED = ("jax", "jaxlib", "ouroboros_tpu")


def _banned(name) -> bool:
    """A module name that is JAX's or the JAX package's (a relative import,
    whose name is None or relative, is the port's own)."""
    return isinstance(name, str) and name.split(".")[0] in _BANNED


def banned_imports(source: str, filename: str = "<source>") -> list:
    """(line, name) of every import in `source`, at any depth (module
    level, in a function, a class or a branch), that names JAX or the
    JAX package: `import x`, `from x import y` (absolute only; a relative
    one stays in the port), and `importlib.import_module` or
    `__import__` of a constant string.  `ouroboros_tpu_torch` is allowed."""
    out = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names
                    if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _banned(node.module):
                out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name in ("import_module", "__import__") and \
                    _banned(node.args[0].value):
                out.append((node.lineno, node.args[0].value))
    return out


def _port_sources() -> list:
    files = sorted((_ROOT / "ouroboros_tpu_torch").rglob("*.py"))
    return files + [_ROOT / "chip_smoke.py"]


def test_no_import_at_any_depth_names_jax_or_the_jax_package():
    """An AST scan of every file of the port and of chip_smoke.py: the
    import check above sees only what importing a module imports, not an
    import inside a function body that runs later."""
    files = _port_sources()
    assert len(files) > 100
    bad = {str(f.relative_to(_ROOT)): found for f in files
           if (found := banned_imports(f.read_text(), str(f)))}
    assert not bad, bad


@pytest.mark.parametrize("line, caught", [
    # the reference's lazy imports in node/chain_sync.py, copied literally
    ("from ouroboros_tpu.consensus.ledger import OutsideForecastRange", True),
    ("from ouroboros_tpu.crypto.batching import (\n"
     "    validate_headers_coalesced,\n)", True),
    ("import jax.numpy as jnp", True),
    ("import jaxlib", True),
    ("import importlib\nimportlib.import_module('ouroboros_tpu.node')", True),
    ("__import__('jax')", True),
    ("from ..consensus.ledger import OutsideForecastRange", False),
    ("from ouroboros_tpu_torch.node import NodeKernel", False),
    ("import ouroboros_tpu_torch.node", False),
    ("importlib.import_module('ouroboros_tpu_torch.node')", False),
])
def test_the_scan_catches_a_lazy_import(line, caught):
    body = "\n".join("        " + x for x in line.split("\n"))
    src = f"async def flush():\n    if True:\n{body}\n"
    assert bool(banned_imports(src)) == caught


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


def test_chaindb_default_backend_raises_without_a_card():
    """A ChainDB given no backend validates on `default_backend()`, the
    card: adding a block raises without one, and nothing falls back to
    the CPU."""
    _require_no_card()
    import hashlib

    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       make_header)
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.consensus.protocols import Bft, bft_sign_header
    from ouroboros_tpu_torch.crypto import backend, ed25519_ref
    from ouroboros_tpu_torch.ledgers import MockLedger, Tx
    from ouroboros_tpu_torch.storage import MockFS
    from ouroboros_tpu_torch.storage.chaindb import ChainDB
    from ouroboros_tpu_torch.storage.stream import (pickle_decode,
                                                    pickle_encode)
    from ouroboros_tpu_torch.utils import cbor
    backend.set_default_backend(None)
    sk = hashlib.sha256(b"bft-0").digest()
    ext = ExtLedgerRules(Bft([ed25519_ref.public_key(sk)]), MockLedger({}))
    db = ChainDB.open(MockFS(), ext, pickle_encode, pickle_decode,
                      lambda raw: ProtocolBlock.decode(cbor.loads(raw),
                                                       tx_decode=Tx.decode))
    blk = ProtocolBlock(bft_sign_header(sk, make_header(None, 0, (),
                                                        issuer=0)), ())
    with pytest.raises(RuntimeError):
        db.add_block(blk)


def test_run_node_default_backend_raises_without_a_card():
    """`run_node` with `backend=None` over a DB whose volatile blocks need
    validation: ChainDB.open's initial selection validates them on
    `default_backend()`, the card, and raises without one; nothing falls
    back to the CPU."""
    _require_no_card()
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.consensus.protocols.praos import Praos
    from ouroboros_tpu_torch.crypto import backend
    from ouroboros_tpu_torch.ledgers.mock import MockLedger
    from ouroboros_tpu_torch.node import BlockchainTime, RunNodeArgs, run_node
    from ouroboros_tpu_torch.storage import MockFS, VolatileDB
    from ouroboros_tpu_torch.testing.threadnet import (PraosNetworkFactory,
                                                       ThreadNetConfig)
    backend.set_default_backend(None)
    fac = PraosNetworkFactory(ThreadNetConfig(n_nodes=1, f=1.0))
    rules = ExtLedgerRules(Praos(fac.protocol_cfg), MockLedger(fac.genesis))
    fs = MockFS()
    vol = VolatileDB.open(fs, 50)
    for b in fac.forge_chain_from(0, rules.initial_state(), 3):
        vol.put_block(b.hash, b.prev_hash, b.slot, b.block_no, b.bytes)
    args = RunNodeArgs(
        fs=fs, ext_rules=rules, encode_state=fac.enc_state,
        decode_state=fac.dec_state, block_decode=fac.block_decode,
        btime=BlockchainTime(1.0), with_mempool=False)

    async def main():
        run_node(args)

    with pytest.raises(RuntimeError):
        sim.run(main())
