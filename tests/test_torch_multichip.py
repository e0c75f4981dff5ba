"""The port's multichip entry points (`ouroboros_tpu_torch/multichip.py`)
on CPU shards: `dryrun_multichip` and `mesh_scaling_report`, ported from
`__graft_entry__.py`, over `["cpu", "cpu"]` (and the scaling report over
three shards, a ragged split).  Each leg holds the sharded replay to the
CPU reference's state_hash; the scaling report checks one launch a shard
of each kernel a window carries.  The budget's overrun stops the run with
exit code 3 and the observations so far.

Tolerance: none.  Hashes and counts compare exactly.
"""
import json

import pytest
import torch

from ouroboros_tpu_torch import multichip

# the plain versions run many small ops: one thread per test worker
torch.set_num_threads(1)


def _line(out: str, tag: str) -> dict:
    rows = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert len(rows) == 1, rows
    return json.loads(rows[0][len(tag) + 1:])


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    obs, scaling = multichip.dryrun_multichip(2, devices=["cpu", "cpu"])
    out = capsys.readouterr().out
    printed = _line(out, "MULTICHIP_OBS")
    assert printed == json.loads(json.dumps(obs, sort_keys=True))
    assert obs["devices"] == ["cpu", "cpu"] and obs["state_hash_parity"]
    rp = obs["sharded_replay"]
    assert (rp["blocks"], rp["window"]) == (24, 4)
    assert rp["state_hash_parity"] and rp["proofs"] == 24 * 4
    # six windows of 4 headers: 8 Ed25519 and 8 VRF lanes padded to the
    # bucket of 16; five carry cold KES paths (3 to 6 Blake2b jobs, one
    # more bucket of 16); no beta slot (prefetched)
    assert rp["padding"]["shards"] == 2
    assert rp["padding"]["windows"] == 6
    assert rp["padding"]["lanes_padded"] == 5 * 48 + 32
    assert rp["padding"]["lanes_per_shard_per_window"] == 272 // 12 == 22
    assert "single_device_replay" in obs
    assert "parallel.last_compile_secs" in obs["metrics"]
    assert _line(out, "MESH_SCALING") == scaling
    assert scaling["dispatches_per_window"] == {
        "2": {"ed25519_split": 2.0, "vrf_verify": 2.0},
        "1": {"ed25519_split": 1.0, "vrf_verify": 1.0}}
    assert scaling["window_reqs"] == 20 and scaling["n_windows"] == 4
    assert scaling["relative_wall_n_vs_1"] is not None


def test_mesh_scaling_report_over_three_shards(capsys):
    out = multichip.mesh_scaling_report(3, window=8, n_windows=2,
                                        devices=["cpu"] * 3)
    assert out["dispatches_per_window"] == {
        "3": {"ed25519_split": 3.0, "vrf_verify": 3.0},
        "1": {"ed25519_split": 1.0, "vrf_verify": 1.0}}
    assert set(out["compile_secs"]) == {"1", "3"}
    assert _line(capsys.readouterr().out, "MESH_SCALING") == out


def test_budget_overrun_exits_3_with_the_observations(monkeypatch, capsys):
    monkeypatch.setenv("OURO_MULTICHIP_BUDGET_SECS", "0.001")
    with pytest.raises(SystemExit) as exc:
        multichip.main(["2", "--devices", "cpu,cpu"])
    assert exc.value.code == 3
    obs = _line(capsys.readouterr().out, "MULTICHIP_OBS")
    assert obs["over_budget_after"] == "forge + cpu reference"
    assert obs["n_devices"] == 2 and obs["budget_secs"] == 0.001
