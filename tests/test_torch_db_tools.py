"""The port's db_synth and db_analyser (`python -m ouroboros_tpu_torch.
db_synth` / `.db_analyser`) against the JAX package's tools/db_synth.py
and tools/db_analyser.py.

- db_synth: for the same arguments the port writes the same files, byte
  for byte, for mock-praos, shelley and cardano (the era ladder and
  Byron->Shelley), in the native and the reference format.
- db_analyser: on each of those DBs the port prints the reference's text
  for the three listing analyses, and the reference's `validate` JSON
  line less the timings, rates and backend name (`--validate reapply`,
  and `full` with `--backend ref`; on a Shelley and a Cardano DB also
  `--backend torch --device cpu`, the plain PyTorch versions).
- A DB written by one package replays in the other to the same
  state_hash, and a snapshot directory written by the JAX package does
  not make the port import it: the port resumes from genesis there, in
  a fresh process, to the same hash.
- `--backend torch` without `--device cpu` raises where there is no card.

Tolerance: none.  Files, text and hashes compare exactly.
"""
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from ouroboros_tpu_torch import db_analyser, db_synth
from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"j_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_SYNTH = _tool("db_synth")
J_ANALYSER = _tool("db_analyser")

# (name, protocol arguments): small chains, 10-slot epochs and chunks
CHAINS = {
    "mock-praos": ["--protocol", "mock-praos"],
    "shelley": ["--protocol", "shelley"],
    "cardano-ladder": ["--protocol", "cardano", "--eras", "ladder"],
    "cardano-byron-shelley": ["--protocol", "cardano", "--eras",
                              "byron-shelley"],
}
FORMATS = ("native", "reference")
CASES = [(c, f) for c in CHAINS for f in FORMATS]
LISTINGS = ("show-slot-block-no", "count-tx-outputs", "show-header-size")
# fields of the validate line that are timings, rates or the backend name
UNSTABLE = {"secs", "blocks_per_sec", "proofs_per_sec", "backend"}
UNSTABLE_STREAM = {"replay_secs", "disk_secs", "disk_hidden_secs",
                   "disk_hidden_frac", "host_seq_secs", "host_hidden_secs",
                   "prefetch_stalls", "snapshot_write_secs", "restore_secs"}


def _args(chain, fmt, out):
    return db_synth.parser().parse_args(
        ["--out", out, "--blocks", "30", "--epoch-length", "10",
         "--chunk-size", "10", "--kes-depth", "4", "--format", fmt]
        + CHAINS[chain])


def _synth(mod, args):
    proto = args.protocol
    fn = {"shelley": mod.synth_shelley, "cardano": mod.synth_cardano,
          "mock-praos": mod.synth_mock_praos}[proto]
    return fn(args)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Every case written by both packages: name -> (port dir, JAX dir)."""
    root = tmp_path_factory.mktemp("dbs")
    out = {}
    for chain, fmt in CASES:
        port_dir = str(root / f"port-{chain}-{fmt}")
        jax_dir = str(root / f"jax-{chain}-{fmt}")
        assert _synth(db_synth, _args(chain, fmt, port_dir)) \
            == _synth(J_SYNTH, _args(chain, fmt, jax_dir))
        out[(chain, fmt)] = (port_dir, jax_dir)
    return out


def _files(d):
    got = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            got[os.path.relpath(path, d)] = open(path, "rb").read()
    return got


@pytest.mark.parametrize("chain,fmt", CASES)
def test_db_synth_writes_the_jax_packages_bytes(dbs, chain, fmt):
    port_dir, jax_dir = dbs[(chain, fmt)]
    port, ref = _files(port_dir), _files(jax_dir)
    assert sorted(port) == sorted(ref)
    assert "config.json" in port and len(port) > 3
    for name in ref:
        assert port[name] == ref[name], name


def test_db_synth_cli_and_the_writer_of_a_forged_chain(tmp_path, capsys):
    """The CLI's Shelley DB equals `write_chain` of `forge_shelley`'s
    chain, and `shelley_config_for` is the config.json it writes."""
    from ouroboros_tpu_torch import chainsynth
    argv = ["--out", str(tmp_path / "cli"), "--protocol", "shelley",
            "--blocks", "20", "--epoch-length", "40", "--kes-depth", "4",
            "--chunk-size", "10"]
    assert db_synth.main(argv) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["blocks"] == 20 and info["protocol"] == "shelley"
    ext, blocks, _st = chainsynth.forge_shelley(20, epoch_length=40,
                                                kes_depth=4)
    db_synth.write_chain(str(tmp_path / "mem"),
                         db_synth.shelley_config(ext, 10), blocks)
    assert _files(str(tmp_path / "cli")) == _files(str(tmp_path / "mem"))
    with open(tmp_path / "cli" / "config.json") as fh:
        assert json.load(fh) == db_synth.shelley_config_for(
            db_synth.parser().parse_args(argv))


def _port_cli(argv, capsys) -> str:
    capsys.readouterr()
    assert db_analyser.main(argv) == 0
    return capsys.readouterr().out


def _reference(d, analysis, **kw) -> str:
    db, rules, decode, cfg = J_ANALYSER.load_db(d)
    out = io.StringIO()
    if analysis == "validate":
        GLOBAL_BETA_CACHE.clear()
        J_ANALYSER.analysis_validate(
            db, rules, decode, kw.get("backend", "ref"), kw["mode"],
            kw.get("window", 8), out,
            hdr_proofs=J_ANALYSER.HEADER_PROOFS.get(cfg["protocol"], 2),
            db_dir=d)
    else:
        getattr(J_ANALYSER, "analysis_" + analysis.replace("-", "_"))(
            db, decode, out)
    return out.getvalue()


def _stable(line: str) -> dict:
    rec = json.loads(line)
    for k in UNSTABLE:
        rec.pop(k)
    if "stream" in rec:
        rec["stream"] = {k: v for k, v in rec["stream"].items()
                         if k not in UNSTABLE_STREAM}
    return rec


@pytest.mark.parametrize("chain,fmt", CASES)
def test_db_analyser_listings_equal_the_jax_packages(dbs, chain, fmt,
                                                     capsys):
    port_dir, jax_dir = dbs[(chain, fmt)]
    for analysis in LISTINGS:
        assert _port_cli([port_dir, "--analysis", analysis], capsys) \
            == _reference(jax_dir, analysis)


@pytest.mark.parametrize("chain,fmt", CASES)
@pytest.mark.parametrize("mode", ["reapply", "full"])
def test_db_analyser_validate_equals_the_jax_packages(dbs, chain, fmt, mode,
                                                      capsys):
    port_dir, jax_dir = dbs[(chain, fmt)]
    GLOBAL_BETA_CACHE.clear()
    got = _stable(_port_cli([port_dir, "--validate", mode, "--backend",
                             "ref", "--window", "8"], capsys))
    want = _stable(_reference(jax_dir, "validate", mode=mode))
    assert got == want
    assert got["blocks"] == 30 and got["proofs"] > 30


@pytest.mark.parametrize("chain,fmt", [("shelley", "native"),
                                       ("cardano-byron-shelley",
                                        "reference")])
def test_db_analyser_torch_backend_on_the_cpu(dbs, chain, fmt, capsys):
    """The TorchBackend's plain forms give the reference's line."""
    port_dir, jax_dir = dbs[(chain, fmt)]
    GLOBAL_BETA_CACHE.clear()
    line = _port_cli([port_dir, "--backend", "torch", "--device", "cpu",
                      "--window", "8"], capsys)
    assert json.loads(line)["backend"] == "torch"
    assert _stable(line) == _stable(_reference(jax_dir, "validate",
                                               mode="full"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_db_of_one_package_replays_in_the_other(dbs, writer, capsys):
    """The port replays the JAX package's Cardano DB, and the JAX package
    the port's, each to the writer's own reapplied state_hash."""
    port_dir, jax_dir = dbs[("cardano-ladder", "native")]
    d = jax_dir if writer == "jax" else port_dir
    own = json.loads((_reference(d, "validate", mode="reapply")
                      if writer == "jax" else
                      _port_cli([d, "--validate", "reapply"], capsys)))
    GLOBAL_BETA_CACHE.clear()
    other = json.loads(
        _port_cli([d, "--backend", "ref", "--window", "8"], capsys)
        if writer == "jax" else _reference(d, "validate", mode="full"))
    assert other["state_hash"] == own["state_hash"]
    assert other["blocks"] == own["blocks"] == 30


_RESUME = r"""
import json, sys
from ouroboros_tpu_torch import db_analyser
db_analyser.main([sys.argv[1], "--backend", "ref", "--window", "8",
                  "--resume"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ouroboros_tpu" or m.startswith("ouroboros_tpu."))
print(json.dumps(bad))
"""


def test_a_jax_snapshot_does_not_import_the_jax_package(dbs, tmp_path):
    """The JAX package snapshots its replay of a Shelley DB; the port,
    resuming there in a fresh process, imports none of it, finds no
    usable snapshot and replays from genesis to the same state_hash."""
    import shutil

    from ouroboros_tpu.storage import LedgerDB, IoFS
    _port_dir, jax_dir = dbs[("shelley", "native")]
    d = str(tmp_path / "db")
    shutil.copytree(jax_dir, d)
    GLOBAL_BETA_CACHE.clear()
    db, rules, decode, cfg = J_ANALYSER.load_db(d)
    out = io.StringIO()
    J_ANALYSER.analysis_validate(
        db, rules, decode, "ref", "full", 8, out,
        hdr_proofs=J_ANALYSER.HEADER_PROOFS[cfg["protocol"]], db_dir=d,
        snapshot_every=10)
    want = json.loads(out.getvalue())
    assert want["stream"]["snapshots_written"] >= 2
    assert len(LedgerDB.snapshot_names(IoFS(d))) >= 2
    r = subprocess.run([sys.executable, "-c", _RESUME, d],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    line, imported = r.stdout.strip().splitlines()[-2:]
    assert json.loads(imported) == []
    got = json.loads(line)
    assert got["stream"]["resumed_from_slot"] is None
    assert got["blocks"] == 30
    assert got["state_hash"] == want["state_hash"]


def test_db_analyser_torch_backend_raises_without_a_card(dbs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    port_dir, _jax_dir = dbs[("shelley", "native")]
    with pytest.raises(RuntimeError):
        db_analyser.main([port_dir, "--window", "8"])
    with pytest.raises(RuntimeError):
        db_analyser.main([port_dir, "--backend", "torch", "--device",
                          "cuda", "--window", "8"])
    with pytest.raises(RuntimeError):
        db_analyser.make_backend("torch")
    # reapply needs no backend, and the listings none either
    assert _port_cli([port_dir, "--validate", "reapply"], capsys)
