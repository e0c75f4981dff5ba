"""BENCHMARK.json against the limits of its contract, and the harness
finding every configuration, traffic mix and metric reader by name."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == KEYS
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for word in cmd[1:]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            if group == "end_to_end":
                allowed.add("bound")
            else:
                allowed |= {"layer", "moves"}
            assert set(m) <= allowed
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_cells_configs_and_metrics_cross_refer(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    cells = {w["name"]: w for w in manifest["workloads"]}
    assert {w["config"] for w in cells.values()} == configs
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert _line(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", []):
            assert w in cells
    for cell in cells:
        reported = [m for m in manifest["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in manifest["per_layer"])


def test_configuration_files_state_source_cuts_and_guarantee(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["source"] == c["source"]
        assert set(cfg["reduced_from_source"]) == set(c["reduced"])
        assert cfg["assumed"] and cfg["validation"].startswith("full")


def test_discovery_by_name(manifest, tiny_root):
    import harness
    for w in manifest["workloads"]:
        cell, config, traffic = harness.cell_of(manifest, w["name"])
        assert config["name"] == w["config"]
        assert traffic["name"] == w["traffic"]
        for trace in (False, True):
            for m in harness.metrics_of(manifest, w["name"], trace):
                assert callable(harness.reader(m["name"]))
    # a cell added as data alone (the tiny root's) is found too
    tiny = harness.load_manifest(tiny_root)
    cell, config, traffic = harness.cell_of(tiny, "tiny-warm", tiny_root)
    assert config["chainBlocks"] == 8 and traffic["witness_keys"]


def test_every_traffic_mix_and_reader_has_its_file(manifest):
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as fh:
            mix = json.load(fh)
        assert {"why", "witness_keys", "backend", "warmup_passes"} \
            <= set(mix)
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))
