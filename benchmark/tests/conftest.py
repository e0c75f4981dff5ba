"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the repository.  They import the harness as `benchmark/run.py`
does (its folder and the repository's root on sys.path, one thread a
pool) and build cells of a few blocks for the CPU."""
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]
import run  # noqa: E402,F401  (the thread pools and caches, as a run sets them)

TINY = {"chainBlocks": 8, "window": 2, "txsPerBlock": 3,
        "check": {"full_blocks": 3, "vrf_outputs": 4}}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A root whose BENCHMARK.json adds cells `tiny-<traffic>` over an
    8-block light chain in four 2-block windows, beside the real ones."""
    root = tmp_path_factory.mktemp("bench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(BENCH, "configs",
                           "shelley-sum6-light.json")) as fh:
        config = dict(json.load(fh), **TINY)
    (root / "tiny.json").write_text(json.dumps(config))
    manifest["configs"].append({"name": "tiny", "source": "test",
                                "file": str(root / "tiny.json"),
                                "reduced": [], "why": "test"})
    for traffic in sorted(os.listdir(os.path.join(BENCH, "traffic"))):
        name = traffic.rsplit(".", 1)[0]
        manifest["workloads"].append({"name": f"tiny-{name}",
                                      "config": "tiny", "traffic": name,
                                      "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(root)


@pytest.fixture
def cuda_card():
    """Skips a test where this machine has no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cpu_run(workload, root, seed=2 ** 31 + 11, seconds=0.5, **kw):
    """One run of a tiny cell on the CPU (the plain kernels, 16-lane
    buckets), its lines not printed."""
    import harness
    return harness.run(workload, seed, seconds, kw.pop("trace", False),
                       device="cpu", root=root, min_bucket=16, workers=2,
                       say=lambda line: None, **kw)
